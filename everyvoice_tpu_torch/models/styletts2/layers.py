"""StyleTTS2's building blocks in PyTorch (counterpart of
everyvoice_tpu/models/styletts2/layers.py): AdaIN, the AdaIN + snake
ResBlock, the text encoder, the style encoder, the prosody predictor, the
harmonic-plus-noise source, the AdaIN iSTFT decoder and the style
diffusion's transformer denoiser.

Numerics follow flax, and with them the JAX package's padded shapes, which
the numbers depend on:

- AdaIN takes a population mean and variance (eps 1e-5) in float32 over the
  whole time axis, pads included;
- both LSTMs of a BiLSTM run over the padded length (pads zeroed, the state
  not reset), and the backward half is returned in reversed time order:
  flax's ``nn.RNN(..., reverse=True)`` keeps ``keep_order=False``, so the
  JAX package joins the forward state at t with the backward state at
  N-1-t (``bilstm``);
- the source's downsampling is ``jax.image.resize(method="linear")``, which
  low-pass filters with a widened triangle when it shrinks
  (``linear_resize``), not ``F.interpolate``;
- convs are flax's "SAME" convs with flax's ``WeightNorm`` where the JAX
  package has one; LayerNorm eps is 1e-6 and ``gelu`` the tanh one.

The decoder's conv stack and the style encoders' convs run in the compute
dtype; AdaIN statistics, the LSTMs, the source's phase, the iSTFT head and
the denoiser run in float32. The decoder runs on (B, C, T), the text side
on (B, T, C). Dropout acts in training mode only, at the JAX package's
rates: 0.2 in the text encoder, 0.5 in the prosody predictor.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.dsp.spectral import _on_device, istft
from everyvoice_tpu_torch.models.hifigan.model import (
    LRELU_SLOPE,
    WNConv1d,
    WNConvTranspose1d,
    conv1d_same,
)
from everyvoice_tpu_torch.models.layers import (
    NORM_EPS,
    Dropout,
    MultiHeadAttention,
    conv2d_same_stride2,
    layer_norm,
)

ADAIN_EPS = 1e-5


class AdaIN1d(nn.Module):
    """Adaptive instance norm on (B, C, T): per-channel scale and shift
    from the style; output in ``dtype``."""

    def __init__(self, style_dim: int, channels: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x, style, dtype=torch.float32):
        gamma, beta = F.linear(style.float(), self.fc.weight, self.fc.bias).chunk(2, dim=-1)
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        normed = (x32 - mean) * torch.rsqrt(var + ADAIN_EPS)
        return ((1.0 + gamma[..., None]) * normed + beta[..., None]).to(dtype)


def snake(y, alpha):
    return y + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * y) ** 2


class AdaINResBlock1(nn.Module):
    """HiFiGAN's ResBlock1 with AdaIN and snake activations on (B, C, T):
    per dilation, AdaIN → snake → dilated conv → AdaIN → snake → conv,
    added to the input. ``alpha1``/``alpha2`` are (1, C, 1)."""

    def __init__(self, channels: int, kernel_size: int, dilations, style_dim: int):
        super().__init__()
        self.dilations = tuple(dilations)
        n = len(self.dilations)
        self.adain1 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in range(n))
        self.adain2 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in range(n))
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1)) for _ in range(n))
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1)) for _ in range(n))
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in self.dilations)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size) for _ in self.dilations)

    def forward(self, x, style, dtype):
        for u in range(len(self.dilations)):
            y = snake(self.adain1[u](x, style, dtype), self.alpha1[u].to(dtype))
            y = self.convs1[u](y)
            y = snake(self.adain2[u](y, style, dtype), self.alpha2[u].to(dtype))
            x = x + self.convs2[u](y)
        return x


def bilstm(fwd: nn.LSTM, bwd: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """flax's ``concat([RNN(x), RNN(x, reverse=True)])`` on (B, N, C): the
    backward LSTM reads x from its end, and its outputs stay in the order
    it produced them (position t holds the state after x[N-1-t])."""
    return torch.cat([fwd(x)[0], bwd(x.flip(1))[0]], dim=-1)


def lstm_pair(in_dim: int, hidden: int) -> tuple:
    return (nn.LSTM(in_dim, hidden, batch_first=True),
            nn.LSTM(in_dim, hidden, batch_first=True))


class TextEncoder(nn.Module):
    """Symbol embedding → ``n_convs`` × (weight-normed conv → LayerNorm →
    leaky-relu 0.2 → dropout 0.2) → BiLSTM, every step re-masked; float32."""

    def __init__(self, n_symbols: int, channels: int = 512, kernel_size: int = 5,
                 n_convs: int = 3):
        super().__init__()
        self.embed = nn.Embedding(n_symbols, channels)
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size) for _ in range(n_convs))
        self.norms = nn.ModuleList(nn.LayerNorm(channels, eps=NORM_EPS) for _ in range(n_convs))
        self.drop = Dropout(0.2)
        self.lstm_fwd, self.lstm_bwd = lstm_pair(channels, channels // 2)

    def forward(self, tokens, mask):
        m = mask[..., None]
        zero = torch.zeros((), device=tokens.device)
        x = torch.where(m, self.embed(tokens), zero)
        for conv, norm in zip(self.convs, self.norms):
            x = conv(x.transpose(1, 2)).transpose(1, 2)
            x = self.drop(F.leaky_relu(layer_norm(x, norm, torch.float32), 0.2))
            x = torch.where(m, x, zero)
        return torch.where(m, bilstm(self.lstm_fwd, self.lstm_bwd, x), zero)


class StyleEncoder(nn.Module):
    """Mel (B, T, M) → style (B, style_dim): a 2-D conv pyramid over the mel
    as an image, in ``dtype``; a float32 mean over (T, M) and dense head.
    ``convs`` are in flax's order: the stem, then per down (conv, strided
    conv, strided 1x1 skip), then the last conv."""

    def __init__(self, style_dim: int = 128, base_channels: int = 64, max_channels: int = 512,
                 n_downs: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_downs = n_downs
        ch = base_channels
        convs = [nn.Conv2d(1, ch, 3)]
        for _ in range(n_downs):
            out_ch = min(ch * 2, max_channels)
            convs += [nn.Conv2d(ch, ch, 3), nn.Conv2d(ch, out_ch, 3), nn.Conv2d(ch, out_ch, 1)]
            ch = out_ch
        convs.append(nn.Conv2d(ch, max_channels, 3))
        self.convs = nn.ModuleList(convs)
        self.head = nn.Linear(max_channels, style_dim)

    def _conv3(self, x, conv):
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1)

    def forward(self, mel):
        dt = self.dtype
        x = self._conv3(mel[:, None].to(dt), self.convs[0])  # (B, C, T, M)
        root2 = torch.tensor(math.sqrt(2.0)).to(dt)
        for i in range(self.n_downs):
            conv, down, skip = self.convs[1 + 3 * i : 4 + 3 * i]
            y = self._conv3(F.leaky_relu(x, 0.2), conv)
            y = conv2d_same_stride2(F.leaky_relu(y, 0.2), down, dt)
            s = F.conv2d(x, skip.weight.to(dt), skip.bias.to(dt), stride=2)
            x = (y + s) / root2
        x = self._conv3(F.leaky_relu(x, 0.2), self.convs[-1])
        return F.linear(x.float().mean(dim=(2, 3)), self.head.weight, self.head.bias)


class ProsodyPredictor(nn.Module):
    """Text encodings and a prosodic style → BiLSTM → dropout 0.5 →
    duration logits over ``max_dur`` classes, and F0 and energy per token;
    float32."""

    def __init__(self, style_dim: int = 128, hidden: int = 512, max_dur: int = 50):
        super().__init__()
        self.lstm_fwd, self.lstm_bwd = lstm_pair(hidden + style_dim, hidden // 2)
        self.drop = Dropout(0.5)
        self.duration = nn.Linear(hidden, max_dur)
        self.adain = AdaIN1d(style_dim, hidden)
        self.f0_hidden = nn.Linear(hidden, hidden)
        self.f0_out = nn.Linear(hidden, 1)
        self.energy_hidden = nn.Linear(hidden, hidden)
        self.energy_out = nn.Linear(hidden, 1)

    def forward(self, text_enc, style, mask):
        s = style[:, None, :].expand(-1, text_enc.shape[1], -1)
        x = self.drop(bilstm(self.lstm_fwd, self.lstm_bwd, torch.cat([text_enc, s], dim=-1)))
        zero = torch.zeros((), device=x.device)
        dur_logits = torch.where(mask[..., None], self.duration(x), zero)
        y = self.adain(x.transpose(1, 2), style).transpose(1, 2)
        f0 = self.f0_out(F.leaky_relu(self.f0_hidden(y), 0.2))[..., 0]
        energy = self.energy_out(F.leaky_relu(self.energy_hidden(y), 0.2))[..., 0]
        return dur_logits, torch.where(mask, f0, zero), torch.where(mask, energy, zero)


def harmonic_noise_source(f0_frames: torch.Tensor, hop: int, sample_rate: int,
                          noise: torch.Tensor, n_harmonics: int = 8) -> torch.Tensor:
    """NSF excitation (B, T·hop): eight harmonic sines of the per-frame F0
    where it is voiced (above 10 Hz), plus 0.003 × ``noise``, a (B, T·hop)
    standard normal draw the caller makes. The phase's running sum is taken
    in float64 and rounded to float32 once, so it does not depend on the
    order a device sums 200,000 samples in."""
    f0_up = torch.repeat_interleave(f0_frames.float(), hop, dim=1)
    cycles = torch.cumsum((f0_up / sample_rate).double(), dim=1).float()
    phase = (2.0 * math.pi) * cycles
    k = torch.arange(1, n_harmonics + 1, device=f0_up.device, dtype=torch.float32)
    amp = 0.1 * (f0_up > 10.0).float()
    harmonics = torch.sin(phase[..., None] * k) * amp[..., None] / n_harmonics
    return harmonics.sum(dim=-1) + 0.003 * noise


@lru_cache(maxsize=16)
def _resize_taps(m: int, n: int) -> tuple:
    """(index, weight), each (n, taps), of ``jax.image.resize(method=
    "linear")`` from m to n samples: a triangle widened by m/n when it
    shrinks, normalized to sum 1 over the inputs it covers; weights
    computed in float32 as JAX computes them."""
    f32 = np.float32
    scale = n / m
    inv = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    taps = 2 * int(math.ceil(kernel_scale)) + 2
    start = np.floor(sample_f - kernel_scale).astype(np.int64)
    index = start[:, None] + np.arange(taps)[None, :]
    x = np.abs(sample_f[:, None] - index.astype(f32)) / kernel_scale
    weight = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    inside = (index >= 0) & (index < m)
    weight = np.where(inside, weight, f32(0.0))
    total = weight.sum(axis=1, keepdims=True, dtype=f32)
    weight = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                      weight / np.where(total != 0, total, f32(1.0)), f32(0.0))
    valid = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    weight = np.where(valid[:, None], weight, f32(0.0)).astype(f32)
    return np.clip(index, 0, m - 1), weight


def _resize_part(m: int, n: int, part: int) -> np.ndarray:
    return _resize_taps(m, n)[part]


def linear_resize(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, n), method="linear")`` (antialiased) on a
    (B, m) float32 tensor."""
    m = x.shape[-1]
    if m == n:
        return x
    index = _on_device(_resize_part, (m, n, 0), x.device)
    weight = _on_device(_resize_part, (m, n, 1), x.device)
    return (x[:, index] * weight).sum(dim=-1)


class StyleDecoder(nn.Module):
    """The AdaIN iSTFT-HiFiGAN decoder: frame features (B, T, C_in), F0
    (B, T), an acoustic style (B, S) and the source's noise (B, T·hop) →
    wav (B, T·hop). Per upsampling stage: leaky-relu → weight-normed
    transposed conv → plus a conv of the source resized to the stage's rate
    → the mean of the AdaIN ResBlocks; then a float32 conv to log-magnitude
    and phase and an inverse STFT of hop ``gen_istft_hop_size``."""

    def __init__(self, in_dim: int, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3, gen_istft_n_fft: int = 16,
                 gen_istft_hop_size: int = 4, style_dim: int = 128, sample_rate: int = 22050,
                 hop: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hop = hop
        self.sample_rate = sample_rate
        self.n_fft = gen_istft_n_fft
        self.istft_hop = gen_istft_hop_size
        self.n_chains = len(resblock_kernel_sizes)
        ch = upsample_initial_channel
        self.conv_pre = WNConv1d(in_dim, ch, 7)
        self.ups = nn.ModuleList()
        self.source_convs = nn.ModuleList()
        # resblocks[i * n_chains + r] is chain r of stage i.
        self.resblocks = nn.ModuleList()
        for rate, kernel in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(WNConvTranspose1d(ch, ch // 2, kernel, rate))
            ch //= 2
            self.source_convs.append(nn.Conv1d(1, ch, 7))
            for k, dils in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(ch, k, dils, style_dim))
        self.conv_post = WNConv1d(ch, 2 * (gen_istft_n_fft // 2 + 1), 7)

    def forward(self, features, f0_frames, style, noise):
        return self.head(self.stack(features, f0_frames, style, noise),
                         features.shape[1] * self.hop)

    def stack(self, features, f0_frames, style, noise):
        """Everything before the head: (B, C, T·prod(rates)) in the compute
        dtype."""
        dt = self.dtype
        x = self.conv_pre(features.transpose(1, 2).to(dt))
        source = harmonic_noise_source(f0_frames, self.hop, self.sample_rate, noise)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            conv = self.source_convs[i]
            src = linear_resize(source, x.shape[-1])[:, None].to(dt)
            x = x + conv1d_same(src, conv.weight.to(dt), conv.bias.to(dt))
            acc = None
            for chain in self.resblocks[i * self.n_chains : (i + 1) * self.n_chains]:
                y = chain(x, style, dt)
                acc = y if acc is None else acc + y
            x = acc / self.n_chains
        return x

    def head(self, x, length: int):
        """The float32 iSTFT head: a conv to log-magnitude and phase, then
        the inverse STFT to ``length`` samples."""
        y = self.conv_post(F.leaky_relu(x, LRELU_SLOPE).float())
        n_bins = self.n_fft // 2 + 1
        mag = torch.exp(torch.clamp(y[:, :n_bins], -10.0, 8.0))
        phase = math.pi * torch.sin(y[:, n_bins:])
        return istft(mag * torch.cos(phase), mag * torch.sin(phase), self.n_fft, self.n_fft,
                     self.istft_hop, center=True, length=length)


# The denoiser's Fourier frequencies of log σ.
SIGMA_FREQS = np.exp(np.linspace(0, 6, 32)).astype(np.float32)


class DiffusionDenoiser(nn.Module):
    """The style diffusion's transformer denoiser: the noisy style, Fourier
    features of log σ and the text embedding as three tokens through
    pre-norm self-attention blocks; the first token's output projected back
    to the style. Float32."""

    def __init__(self, style_dim: int, text_dim: int, num_layers: int = 3, num_heads: int = 8,
                 head_features: int = 64, multiplier: int = 2):
        super().__init__()
        dim = num_heads * head_features
        self.style_in = nn.Linear(style_dim, dim)
        self.sigma_in = nn.Linear(64, dim)
        self.text_in = nn.Linear(text_dim, dim)
        self.norms1 = nn.ModuleList(nn.LayerNorm(dim, eps=NORM_EPS) for _ in range(num_layers))
        self.attns = nn.ModuleList(MultiHeadAttention(dim, num_heads) for _ in range(num_layers))
        self.norms2 = nn.ModuleList(nn.LayerNorm(dim, eps=NORM_EPS) for _ in range(num_layers))
        self.ff1 = nn.ModuleList(nn.Linear(dim, dim * multiplier) for _ in range(num_layers))
        self.ff2 = nn.ModuleList(nn.Linear(dim * multiplier, dim) for _ in range(num_layers))
        self.out = nn.Linear(dim, style_dim)
        self.register_buffer("freqs", torch.from_numpy(SIGMA_FREQS), persistent=False)

    def forward(self, noisy_style, sigma, text_embedding):
        log_sigma = torch.log(sigma)[:, None] * self.freqs[None, :]
        sigma_feat = torch.cat([torch.sin(log_sigma), torch.cos(log_sigma)], dim=-1)
        x = torch.stack([self.style_in(noisy_style), self.sigma_in(sigma_feat),
                         self.text_in(text_embedding)], dim=1)
        f32 = torch.float32
        for norm1, attn, norm2, ff1, ff2 in zip(self.norms1, self.attns, self.norms2,
                                                self.ff1, self.ff2):
            x = x + attn(layer_norm(x, norm1, f32))
            x = x + ff2(F.gelu(ff1(layer_norm(x, norm2, f32)), approximate="tanh"))
        return self.out(x[:, 0])

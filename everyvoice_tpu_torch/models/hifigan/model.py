"""HiFiGAN generator and discriminators in PyTorch (counterpart of
everyvoice_tpu/models/hifigan/model.py).

Generator: mel (B, T, n_mels) → pre-conv 7 → per upsample stage: leaky-relu →
transposed conv → MRF (the mean of parallel ResBlock1 or ResBlock2 chains) →
leaky-relu → post-conv 7 → tanh → wav (B, T·prod(rates)); or, with the
iSTFTNet head, a conv to magnitude and phase and an inverse STFT of hop
``istft_hop``. Two forwards share the parameters:

- ``forward`` (inference, no gradient): for resblock "1", each MRF stage runs
  through ``everyvoice_tpu_torch.ops.mrf.mrf_stage``, the hand-written CUDA
  kernel on a card, from weights folded and packed once per device, dtype and
  parameter version (an optimizer step in place re-folds them); resblock "2"
  runs torch convs, as the JAX package's fused path covers resblock "1" only.
- ``train_forward``: every conv as a differentiable torch conv, weight norm
  folded on each call. The MRF kernel has no backward, in either package.

Weight norm is flax's ``WeightNorm``: one scale per output feature, the norm
over every other axis, eps 1e-12. Convs pad as flax's ``padding="SAME"``,
which is asymmetric for strided convs. The iSTFT head and the post conv run
in float32, the other convs in the compute dtype.

Discriminators: ``MultiPeriodDiscriminator`` folds the wav into (T/p, p) and
runs 2-D (k, 1) convs; ``MultiScaleDiscriminator`` runs grouped strided 1-D
convs on the wav and on two average-pooled copies, the first scale with the
JAX package's stateless spectral norm. Features are (B, C, T[, p]), the JAX
package's transposed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.dsp.spectral import istft
from everyvoice_tpu_torch.ops.mrf import mrf_stage, pack_mrf_weights
from everyvoice_tpu_torch.utils.precision import no_tf32, torch_dtype

LRELU_SLOPE = 0.1
WN_EPS = 1e-12  # flax WeightNorm epsilon
SN_EPS = 1e-12  # SpectralNormConv epsilon
SN_POWER_ITERATIONS = 8


def same_padding(length: int, kernel_size: int, stride: int = 1, dilation: int = 1) -> tuple:
    """(left, right) zero padding of lax's ``padding="SAME"``: the total is
    max((ceil(T/s)-1)·s + (k-1)·d + 1 - T, 0), the left side its floor half."""
    span = (kernel_size - 1) * dilation + 1
    total = max((-(-length // stride) - 1) * stride + span - length, 0)
    return total // 2, total - total // 2


def conv1d_same(v, weight, bias, stride: int = 1, dilation: int = 1, groups: int = 1):
    """"SAME" 1-D conv of (B, C, T) with a (C_out, C_in/groups, k) weight."""
    lo, hi = same_padding(v.shape[-1], weight.shape[-1], stride, dilation)
    if lo != hi:
        v, lo = F.pad(v, (lo, hi)), 0
    return F.conv1d(v, weight, bias, stride, lo, dilation, groups)


def conv_same(x, weight, bias, stride: int = 1, dilation: int = 1, groups: int = 1):
    """``conv1d_same`` on (B, T, C)."""
    return conv1d_same(x.transpose(1, 2), weight, bias, stride, dilation, groups).transpose(1, 2)


def same_transpose_offset(kernel_size: int, stride: int) -> int:
    """Where ``lax.conv_transpose(padding="SAME")``'s T·stride outputs start
    in the full (unpadded) transposed convolution: kernel_size-1 minus the
    left pad lax uses."""
    pad_len = kernel_size + stride - 2
    pad_a = kernel_size - 1 if stride > kernel_size - 1 else math.ceil(pad_len / 2)
    return kernel_size - 1 - pad_a


def conv_transpose1d_same(v, weight, bias, stride: int):
    """flax ``ConvTranspose(strides=(stride,), padding="SAME")`` on (B, C, T)
    with a torch-layout (C_in, C_out, k) weight: exactly T·stride outputs."""
    n_out = v.shape[-1] * stride
    y = F.conv_transpose1d(v, weight, stride=stride)
    start = same_transpose_offset(weight.shape[-1], stride)
    if start + n_out > y.shape[-1]:
        y = F.pad(y, (0, start + n_out - y.shape[-1]))
    return y[..., start : start + n_out] + bias[None, :, None]


def conv_transpose_same(x, weight, bias, stride: int):
    """``conv_transpose1d_same`` on (B, T, C)."""
    return conv_transpose1d_same(x.transpose(1, 2), weight, bias, stride).transpose(1, 2)


def _weight_norm(w: torch.Tensor, scale: torch.Tensor, feature_dim: int = 0) -> torch.Tensor:
    dims = tuple(d for d in range(w.dim()) if d != feature_dim)
    shape = [1] * w.dim()
    shape[feature_dim] = -1
    return w * torch.rsqrt(w.square().sum(dim=dims, keepdim=True) + WN_EPS) * scale.reshape(shape)


class WNConv1d(nn.Module):
    """A weight-normed "SAME" 1-D conv on (B, C, T); ``weight`` is
    (C_out, C_in/groups, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels // groups, kernel_size))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded(self) -> torch.Tensor:
        return _weight_norm(self.weight, self.scale)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return conv1d_same(v, self.folded().to(v.dtype), self.bias.to(v.dtype),
                           self.stride, self.dilation, self.groups)


class WNConv2d(nn.Module):
    """A weight-normed (k, 1) conv on (B, C, T/p, p) with stride (s, 1) and
    the MPD's explicit ((k-1)/2, (k-1)/2) padding; ``weight`` is
    (C_out, C_in, k, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size, 1))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight, self.scale).to(x.dtype)
        k = self.weight.shape[2]
        return F.conv2d(x, w, self.bias.to(x.dtype), (self.stride, 1), ((k - 1) // 2, 0))


class WNConvTranspose1d(nn.Module):
    """A weight-normed transposed conv with flax's ``padding="SAME"``.
    ``weight`` is torch's (C_in, C_out, k) layout, i.e. the flax kernel with
    its taps reversed; weight norm is per output channel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels, kernel_size))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded(self) -> torch.Tensor:
        return _weight_norm(self.weight, self.scale, feature_dim=1)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d_same(v, self.folded().to(v.dtype), self.bias.to(v.dtype),
                                     self.stride)


class SpectralNormConv1d(nn.Module):
    """The JAX package's stateless ``SpectralNormConv``: the kernel divided by
    its largest singular value, from 8 power iterations on every call that
    start at ones/sqrt(n) over the flax kernel reshaped to (k·C_in/g, C_out).
    ``u`` and ``v`` carry no gradient; sigma = v·W·u does. The iteration runs
    in float32 whatever the conv's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def normalized(self) -> torch.Tensor:
        flat = self.weight.permute(2, 1, 0).reshape(-1, self.weight.shape[0])
        with torch.no_grad():
            f = flat.float()
            v = torch.ones(f.shape[0], device=f.device) / math.sqrt(f.shape[0])
            for _ in range(SN_POWER_ITERATIONS):
                u = f.T @ v
                u = u / (torch.linalg.vector_norm(u) + SN_EPS)
                v = f @ u
                v = v / (torch.linalg.vector_norm(v) + SN_EPS)
        sigma = v @ flat @ u
        return self.weight / (sigma + SN_EPS)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return conv1d_same(v, self.normalized().to(v.dtype), self.bias.to(v.dtype),
                           self.stride, 1, self.groups)


class ResBlock1(nn.Module):
    """MRF resblock "1" on (B, C, T): per dilation, leaky-relu → dilated conv
    → leaky-relu → conv, added to the input. ``convs`` alternate (dilated,
    d = 1)."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=dd)
            for d in self.dilations for dd in (d, 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for u in range(len(self.dilations)):
            y = self.convs[2 * u](F.leaky_relu(x, LRELU_SLOPE))
            y = self.convs[2 * u + 1](F.leaky_relu(y, LRELU_SLOPE))
            x = x + y
        return x


class ResBlock2(nn.Module):
    """MRF resblock "2" on (B, C, T): per dilation, leaky-relu → dilated
    conv, added to the input."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in self.dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


RESBLOCKS = {"1": ResBlock1, "2": ResBlock2}


class HiFiGANGenerator(nn.Module):
    def __init__(
        self,
        upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_initial_channel: int = 512,
        resblock: str = "1",
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
        istft_layer: bool = False,
        istft_n_fft: int = 16,
        istft_hop: int = 4,
        n_mels: int = 80,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if resblock not in RESBLOCKS:
            raise ValueError(f"Unknown HiFiGAN resblock {resblock!r}: expected '1' or '2'")
        self.upsample_rates = tuple(upsample_rates)
        self.resblock = resblock
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.istft_layer = istft_layer
        self.istft_n_fft = istft_n_fft
        self.istft_hop = istft_hop
        self.dtype = torch_dtype(compute_dtype)
        ch = upsample_initial_channel
        self.conv_pre = WNConv1d(n_mels, ch, 7)
        self.ups = nn.ModuleList()
        # resblocks[i * n_chains + r] is chain r of stage i.
        self.resblocks = nn.ModuleList()
        for rate, kernel in zip(self.upsample_rates, upsample_kernel_sizes):
            self.ups.append(WNConvTranspose1d(ch, ch // 2, kernel, rate))
            ch //= 2
            for k, dils in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(RESBLOCKS[resblock](ch, k, dils))
        head = 2 * (istft_n_fft // 2 + 1) if istft_layer else 1
        self.conv_post = WNConv1d(ch, head, 7)
        self._prepared = None

    @classmethod
    def from_config(cls, config: dict, compute_dtype: str = "float32") -> "HiFiGANGenerator":
        """Build from a HiFiGAN config dict (defaults filled in by
        ``everyvoice_tpu_torch.config.hifigan_config``). With the iSTFT head,
        its hop is what the upsampling leaves of the mel hop, its n_fft four
        hops."""
        m = config["model"]
        istft_hop, istft_n_fft = 4, 16
        if m["istft_layer"]:
            istft_hop = config["preprocessing"]["audio"]["fft_hop_size"] // math.prod(
                m["upsample_rates"])
            istft_n_fft = istft_hop * 4
        return cls(
            upsample_rates=m["upsample_rates"],
            upsample_kernel_sizes=m["upsample_kernel_sizes"],
            upsample_initial_channel=m["upsample_initial_channel"],
            resblock=m["resblock"],
            resblock_kernel_sizes=m["resblock_kernel_sizes"],
            resblock_dilation_sizes=m["resblock_dilation_sizes"],
            istft_layer=m["istft_layer"],
            istft_n_fft=istft_n_fft,
            istft_hop=istft_hop,
            n_mels=config["preprocessing"]["audio"]["n_mels"],
            compute_dtype=compute_dtype,
        )

    def _prepared_key(self) -> tuple:
        # An in-place update (an optimizer step, load_state_dict) bumps a
        # parameter's version, so folded weights never go stale.
        return (self.conv_pre.weight.device, tuple(p._version for p in self.parameters()))

    @torch.no_grad()
    def prepare(self) -> dict:
        """Fold weight norm and pack each MRF stage's convs for the kernel,
        in the compute dtype, on the parameters' device."""
        dt = self.dtype
        n_chains = len(self.resblock_kernel_sizes)
        stages = []
        for i, up in enumerate(self.ups):
            weights, biases = [], []
            for chain in self.resblocks[i * n_chains : (i + 1) * n_chains]:
                for conv in chain.convs:
                    # (C_out, C_in, k) → flax (k, C_in, C_out) → (k·C, C)
                    w = conv.folded().permute(2, 1, 0)
                    weights.append(w.reshape(-1, w.shape[-1]))
                    biases.append(conv.bias)
            stages.append((
                up.folded().to(dt), up.bias.to(dt), up.stride,
                *pack_mrf_weights(weights, biases, dt),
            ))
        self._prepared = {
            "key": self._prepared_key(),
            "pre": (self.conv_pre.folded().to(dt), self.conv_pre.bias.to(dt)),
            "stages": stages,
        }
        return self._prepared

    def _head(self, x: torch.Tensor, n_frames: int) -> torch.Tensor:
        """Post conv on float32 (B, C, T): tanh to a wav, or magnitude and
        phase through the inverse STFT to n_frames·prod(rates)·hop samples."""
        y = conv1d_same(x, self.conv_post.folded(), self.conv_post.bias)
        if not self.istft_layer:
            return torch.tanh(y[:, 0])
        n_bins = self.istft_n_fft // 2 + 1
        mag = torch.exp(torch.clamp(y[:, :n_bins], -10.0, 8.0))
        phase = math.pi * torch.sin(y[:, n_bins:])
        length = n_frames * math.prod(self.upsample_rates) * self.istft_hop
        return istft(mag * torch.cos(phase), mag * torch.sin(phase), self.istft_n_fft,
                     self.istft_n_fft, self.istft_hop, center=True, length=length)

    def train_forward(self, mel: torch.Tensor) -> torch.Tensor:
        """The forward through torch convs, differentiable in every
        parameter: the training step's, and resblock "2"'s inference."""
        dt = self.dtype
        n_chains = len(self.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2).to(dt))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for chain in self.resblocks[i * n_chains : (i + 1) * n_chains]:
                y = chain(x)
                acc = y if acc is None else acc + y
            x = acc / n_chains
        return self._head(F.leaky_relu(x, LRELU_SLOPE).float(), mel.shape[1])

    @torch.no_grad()
    @no_tf32()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if self.resblock != "1":
            return self.train_forward(mel)
        p = self._prepared
        if p is None or p["key"] != self._prepared_key():
            p = self.prepare()
        dt = self.dtype
        x = conv_same(mel.to(dt), *p["pre"])
        for up_w, up_b, stride, w_packed, b_packed in p["stages"]:
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = conv_transpose_same(x, up_w, up_b, stride).contiguous()
            x = mrf_stage(
                x, w_packed, b_packed,
                self.resblock_kernel_sizes, self.resblock_dilation_sizes, LRELU_SLOPE,
            )
        x = F.leaky_relu(x, LRELU_SLOPE).float()
        return self._head(x.transpose(1, 2), mel.shape[1])


class PeriodDiscriminator(nn.Module):
    """The wav (B, T), reflect-padded at its end to a multiple of the period
    and folded to (B, 1, T/p, p), through (5, 1) convs of stride 3."""

    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int, compute_dtype: str = "float32"):
        super().__init__()
        self.period = period
        self.dtype = torch_dtype(compute_dtype)
        convs, c_in = [], 1
        for c in self.CHANNELS:
            convs.append(WNConv2d(c_in, c, 5, stride=3))
            c_in = c
        convs.append(WNConv2d(c_in, c_in, 5))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(c_in, 1, 3)

    def forward(self, wav: torch.Tensor) -> tuple:
        b, t = wav.shape
        pad = (-t) % self.period
        x = wav[:, None]
        if pad:
            x = F.pad(x, (0, pad), mode="reflect" if t > 1 else "constant")
        x = x.reshape(b, 1, -1, self.period).to(self.dtype)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """Grouped strided "SAME" convs on the wav (B, 1, T); spectral norm on
    the raw-audio scale, weight norm on the pooled ones."""

    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))  # (C, k, stride, groups)

    def __init__(self, use_spectral_norm: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(compute_dtype)
        conv = SpectralNormConv1d if use_spectral_norm else WNConv1d
        convs, c_in = [], 1
        for c, k, stride, groups in self.SPECS:
            convs.append(conv(c_in, c, k, stride=stride, groups=groups))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(c_in, 1, 3)

    def forward(self, wav: torch.Tensor) -> tuple:
        x = wav[:, None].to(self.dtype)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.reshape(wav.shape[0], -1), feats


def avg_pool_same(wav: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(window 4, stride 2, "SAME")`` on (B, T): zero padding
    1 | 1 (even T) or 1 | 2 (odd T), every window divided by 4."""
    lo, hi = same_padding(wav.shape[-1], 4, 2)
    return F.avg_pool1d(F.pad(wav[:, None], (lo, hi)), 4, 2)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11), compute_dtype: str = "float32"):
        super().__init__()
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, compute_dtype) for p in periods)

    def forward(self, wav: torch.Tensor) -> tuple:
        scores, feats = [], []
        for disc in self.discriminators:
            s, f = disc(wav)
            scores.append(s)
            feats.append(f)
        return scores, feats


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, compute_dtype: str = "float32"):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(use_spectral_norm=i == 0, compute_dtype=compute_dtype)
            for i in range(n_scales))

    def forward(self, wav: torch.Tensor) -> tuple:
        scores, feats = [], []
        x = wav
        for i, disc in enumerate(self.discriminators):
            if i > 0:
                x = avg_pool_same(x)
            s, f = disc(x)
            scores.append(s)
            feats.append(f)
        return scores, feats


class HiFiGANDiscriminators(nn.Module):
    """The MPD and the MSD side by side: ``forward`` gives the MPD's scores
    and features, then the MSD's, as the JAX trainer concatenates them."""

    def __init__(self, periods=(2, 3, 5, 7, 11), n_scales: int = 3,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, compute_dtype)
        self.msd = MultiScaleDiscriminator(n_scales, compute_dtype)

    @classmethod
    def from_config(cls, config: dict, compute_dtype: str = "float32") -> "HiFiGANDiscriminators":
        m = config["model"]
        return cls(tuple(m["mpd_layers"]), m["msd_layers"], compute_dtype)

    def forward(self, wav: torch.Tensor) -> tuple:
        mpd_scores, mpd_feats = self.mpd(wav)
        msd_scores, msd_feats = self.msd(wav)
        return mpd_scores + msd_scores, mpd_feats + msd_feats

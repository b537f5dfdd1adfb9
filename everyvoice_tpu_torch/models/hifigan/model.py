"""HiFiGAN generator (resblock "1") inference in PyTorch (counterpart of
``HiFiGANGenerator`` in everyvoice_tpu/models/hifigan/model.py).

mel (B, T, n_mels) → pre-conv 7 → per upsample stage: leaky-relu →
transposed conv → MRF stage → leaky-relu → post-conv 7 → tanh → wav
(B, T·prod(rates)). Each MRF stage runs through
``everyvoice_tpu_torch.ops.mrf.mrf_stage``, the hand-written CUDA kernel on a
card. Weight norm is folded once per device and dtype, as flax's
``WeightNorm`` computes it: one scale per output feature, the norm over every
other axis. Resblock "2" and the iSTFT head are a later slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.ops.mrf import mrf_stage, pack_mrf_weights
from everyvoice_tpu_torch.utils.precision import no_tf32, torch_dtype

LRELU_SLOPE = 0.1
WN_EPS = 1e-12  # flax WeightNorm epsilon


class WNConv1d(nn.Module):
    """A weight-normed 1-D conv; ``weight`` is (C_out, C_in, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        nn.init.normal_(self.weight, 0.0, 0.01)
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded(self) -> torch.Tensor:
        w = self.weight
        inv = torch.rsqrt(w.square().sum(dim=(1, 2), keepdim=True) + WN_EPS)
        return w * inv * self.scale[:, None, None]


class WNConvTranspose1d(nn.Module):
    """A weight-normed transposed conv with flax's ``padding="SAME"``.
    ``weight`` is torch's (C_in, C_out, k) layout, i.e. the flax kernel with
    its taps reversed; weight norm is per output channel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        nn.init.normal_(self.weight, 0.0, 0.01)
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded(self) -> torch.Tensor:
        w = self.weight
        inv = torch.rsqrt(w.square().sum(dim=(0, 2), keepdim=True) + WN_EPS)
        return w * inv * self.scale[None, :, None]


def same_transpose_offset(kernel_size: int, stride: int) -> int:
    """Where ``lax.conv_transpose(padding="SAME")``'s T·stride outputs start
    in the full (unpadded) transposed convolution: kernel_size-1 minus the
    left pad lax uses."""
    pad_len = kernel_size + stride - 2
    pad_a = kernel_size - 1 if stride > kernel_size - 1 else math.ceil(pad_len / 2)
    return kernel_size - 1 - pad_a


def conv_transpose_same(x, weight, bias, stride: int) -> torch.Tensor:
    """flax ``ConvTranspose(strides=(stride,), padding="SAME")`` on (B, T, C)
    with a torch-layout (C_in, C_out, k) weight: exactly T·stride outputs."""
    k = weight.shape[-1]
    n_out = x.shape[1] * stride
    y = F.conv_transpose1d(x.transpose(1, 2), weight, stride=stride)
    start = same_transpose_offset(k, stride)
    if start + n_out > y.shape[-1]:
        y = F.pad(y, (0, start + n_out - y.shape[-1]))
    y = y[..., start : start + n_out] + bias[None, :, None]
    return y.transpose(1, 2)


def conv_same(x, weight, bias) -> torch.Tensor:
    """"SAME" 1-D conv of (B, T, C) with a (C_out, C_in, k) weight."""
    k = weight.shape[-1]
    v = F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
    return F.conv1d(v, weight, bias).transpose(1, 2)


class HiFiGANGenerator(nn.Module):
    def __init__(
        self,
        upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_initial_channel: int = 512,
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
        n_mels: int = 80,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.dtype = torch_dtype(compute_dtype)
        ch = upsample_initial_channel
        self.conv_pre = WNConv1d(n_mels, ch, 7)
        self.ups = nn.ModuleList()
        # resblocks[i * n_chains + r] is chain r of stage i; each holds
        # 2·len(dilations) convs in order (dilated, then d=1, per dilation).
        self.resblocks = nn.ModuleList()
        for rate, kernel in zip(self.upsample_rates, upsample_kernel_sizes):
            self.ups.append(WNConvTranspose1d(ch, ch // 2, kernel, rate))
            ch //= 2
            for k, dils in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(
                    nn.ModuleList(WNConv1d(ch, ch, k) for _ in range(2 * len(dils)))
                )
        self.conv_post = WNConv1d(ch, 1, 7)
        self._prepared = None

    @classmethod
    def from_config(cls, config: dict, compute_dtype: str = "float32") -> "HiFiGANGenerator":
        """Build from a HiFiGAN config dict (defaults filled in by
        ``everyvoice_tpu_torch.config.hifigan_config``)."""
        m = config["model"]
        if m["resblock"] != "1":
            raise NotImplementedError(
                f"HiFiGAN resblock {m['resblock']!r} is not ported yet; it comes "
                "with the port's vocoder-variants slice"
            )
        if m["istft_layer"]:
            raise NotImplementedError(
                "the iSTFTNet head is not ported yet; it comes with the port's "
                "vocoder-variants slice"
            )
        return cls(
            upsample_rates=m["upsample_rates"],
            upsample_kernel_sizes=m["upsample_kernel_sizes"],
            upsample_initial_channel=m["upsample_initial_channel"],
            resblock_kernel_sizes=m["resblock_kernel_sizes"],
            resblock_dilation_sizes=m["resblock_dilation_sizes"],
            n_mels=config["preprocessing"]["audio"]["n_mels"],
            compute_dtype=compute_dtype,
        )

    def load_state_dict(self, *args, **kwargs):
        self._prepared = None  # folded from the old weights
        return super().load_state_dict(*args, **kwargs)

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
                for conv in chain:
                    # (C_out, C_in, k) → flax (k, C_in, C_out) → (k·C, C)
                    w = conv.folded().permute(2, 1, 0)
                    weights.append(w.reshape(-1, w.shape[-1]))
                    biases.append(conv.bias)
            stages.append((
                up.folded().to(dt), up.bias.to(dt), up.stride,
                *pack_mrf_weights(weights, biases, dt),
            ))
        self._prepared = {
            "device": self.conv_pre.weight.device,
            "pre": (self.conv_pre.folded().to(dt), self.conv_pre.bias.to(dt)),
            "stages": stages,
            "post": (self.conv_post.folded(), self.conv_post.bias.detach()),
        }
        return self._prepared

    @torch.no_grad()
    @no_tf32()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        p = self._prepared
        if p is None or p["device"] != self.conv_pre.weight.device:
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
        return torch.tanh(conv_same(x, *p["post"]))[..., 0]

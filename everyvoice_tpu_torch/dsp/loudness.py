"""ITU-R BS.1770-4 integrated loudness (LKFS/LUFS) (counterpart of
everyvoice_tpu/dsp/loudness.py).

``integrated_loudness_host``, with which the preprocessor rejects clips
quieter than −36 LUFS, K-weights with the exact two-biquad cascade (scipy
``lfilter``), re-derived for the sample rate from the analogue prototypes.
``integrated_loudness``, which ``evaluate`` reports, K-weights a tensor on
its device with the cascade's impulse response truncated to a FIR. Both
gate alike (``gating_blocks``, ``gated_loudness``): 400 ms blocks at 75%
overlap, −70 LKFS absolute then −10 LU relative. ``batched_loudness``, the
preprocessor's device audio gate, does all of it on the device for a batch
of rows, in float32 as the JAX function does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from everyvoice_tpu_torch.utils.precision import no_tf32

K_WEIGHTING_TAPS = 4096


def _biquad_coeffs(sample_rate: float) -> tuple:
    """BS.1770-4 pre-filter + RLB high-pass coefficients, re-derived for the
    target sample rate from the analogue prototypes (as in pyloudnorm)."""
    # Stage 1: spherical-head high shelf
    db = 3.999843853973347
    f0 = 1681.974450955533
    Q = 0.7071752369554196
    K = np.tan(np.pi * f0 / sample_rate)
    Vh = np.power(10.0, db / 20.0)
    Vb = np.power(Vh, 0.4996667741545416)
    denom = 1.0 + K / Q + K * K
    b0 = (Vh + Vb * K / Q + K * K) / denom
    b1 = 2.0 * (K * K - Vh) / denom
    b2 = (Vh - Vb * K / Q + K * K) / denom
    a1 = 2.0 * (K * K - 1.0) / denom
    a2 = (1.0 - K / Q + K * K) / denom
    shelf = ([b0, b1, b2], [1.0, a1, a2])
    # Stage 2: RLB high-pass
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / sample_rate)
    denom = 1.0 + K / Q + K * K
    a1 = 2.0 * (K * K - 1.0) / denom
    a2 = (1.0 - K / Q + K * K) / denom
    hp = ([1.0, -2.0, 1.0], [1.0, a1, a2])
    return shelf, hp


def gating_blocks(n_samples: int, sample_rate: int) -> tuple:
    """The gating blocks of a clip of ``n_samples``: 400 ms at 75% overlap.
    Returns (block length, the padded length, the blocks' start samples); a
    clip shorter than one block is zero-padded to one."""
    block = int(round(0.400 * sample_rate))
    step = block // 4
    padded = max(n_samples, block)
    return block, padded, np.arange(1 + (padded - block) // step) * step


def gated_loudness(z_sum: np.ndarray) -> float:
    """Integrated loudness from the (n_blocks,) K-weighted mean squares of
    the gating blocks (summed over channels): the −70 LKFS absolute gate,
    then the −10 LU relative gate; −inf when every block is gated out."""
    loud_block = -0.691 + 10.0 * np.log10(np.maximum(z_sum, 1e-12))

    abs_mask = loud_block > -70.0
    if not abs_mask.any():
        return float("-inf")
    z_abs = z_sum[abs_mask].mean()
    gamma_rel = -0.691 + 10.0 * np.log10(max(z_abs, 1e-12)) - 10.0
    # The loudest block is at least the mean, 10 LU above the relative
    # gate, so the relative gate always keeps a block.
    z_rel = z_sum[abs_mask & (loud_block > gamma_rel)].mean()
    return float(-0.691 + 10.0 * np.log10(max(z_rel, 1e-12)))


def integrated_loudness_host(audio: np.ndarray, sample_rate: int) -> float:
    """BS.1770-4 integrated loudness of one (T,) or (C, T) clip, K-weighted
    by the exact biquad cascade in float64."""
    from scipy.signal import lfilter

    x = np.asarray(audio, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    (b1, a1), (b2, a2) = _biquad_coeffs(float(sample_rate))
    weighted = lfilter(b2, a2, lfilter(b1, a1, x, axis=-1), axis=-1)
    block, padded, starts = gating_blocks(weighted.shape[-1], sample_rate)
    weighted = np.pad(weighted, ((0, 0), (0, padded - weighted.shape[-1])))
    # Mean square per gating block from a cumulative sum of squares.
    csum = np.concatenate(
        [np.zeros((weighted.shape[0], 1)), np.cumsum(weighted**2, axis=-1)],
        axis=-1,
    )
    z = (csum[:, starts + block] - csum[:, starts]) / block  # (C, n_blocks)
    return gated_loudness(z.sum(axis=0))


@lru_cache(maxsize=8)
def _k_weighting_fir(sample_rate: int) -> np.ndarray:
    """The K-weighting biquad cascade's impulse response, truncated to
    ``K_WEIGHTING_TAPS``."""
    from scipy.signal import lfilter

    impulse = np.zeros(K_WEIGHTING_TAPS)
    impulse[0] = 1.0
    (b1, a1), (b2, a2) = _biquad_coeffs(float(sample_rate))
    return lfilter(b2, a2, lfilter(b1, a1, impulse)).astype(np.float32)


def integrated_loudness(audio: torch.Tensor, sample_rate: int) -> float:
    """BS.1770-4 integrated loudness of a (T,) or (C, T) clip on its device
    (counterpart of everyvoice_tpu/dsp/loudness.py::integrated_loudness):
    K-weighted by the truncated FIR as a causal float32 ``conv1d``, the block
    mean squares in float64; only the (n_blocks,) energies leave the device
    for the gates."""
    x = audio.reshape(-1, audio.shape[-1]).float()
    weighted = _k_weighted(x, sample_rate)
    block, padded, starts = gating_blocks(weighted.shape[-1], sample_rate)
    weighted = F.pad(weighted.double(), (0, padded - weighted.shape[-1]))
    csum = F.pad(torch.cumsum(weighted * weighted, dim=-1), (1, 0))
    starts = torch.from_numpy(starts).to(x.device)
    z = (csum[:, starts + block] - csum[:, starts]) / block  # (C, n_blocks)
    return gated_loudness(z.sum(dim=0).cpu().numpy())


def _k_weighted(x: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """(N, T) float32 rows through the truncated K-weighting FIR, causal."""
    fir = torch.from_numpy(_k_weighting_fir(sample_rate)).to(x.device).flip(0)
    with no_tf32():
        return F.conv1d(F.pad(x[:, None], (K_WEIGHTING_TAPS - 1, 0)), fir[None, None])[:, 0]


def batched_loudness(audio: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """BS.1770-4 integrated loudness of each row of a (B, 1, T) or (B, C, T)
    batch → (B,) on its device (counterpart of the JAX
    ``integrated_loudness`` on (B, C, T)): float32 throughout, over the
    whole row, padding included; both gates on the device; −inf for a row
    whose every block is under the absolute gate."""
    batch, channels, t = audio.shape
    weighted = _k_weighted(audio.reshape(-1, t).float(), sample_rate)
    block = int(round(0.400 * sample_rate))
    step = block // 4
    weighted = F.pad(weighted, (0, max(block - t, 0)))
    # Mean square of each 400 ms block, summed over channels: (B, n_blocks).
    z = F.avg_pool1d((weighted * weighted)[:, None], block, step)[:, 0]
    z_sum = z.reshape(batch, channels, -1).sum(dim=1)
    loud_block = -0.691 + 10.0 * torch.log10(torch.clamp(z_sum, min=1e-12))
    abs_mask = loud_block > -70.0
    abs_count = torch.clamp(abs_mask.sum(dim=-1), min=1)
    z_abs = torch.where(abs_mask, z_sum, 0.0).sum(dim=-1) / abs_count
    gamma_rel = -0.691 + 10.0 * torch.log10(torch.clamp(z_abs, min=1e-12)) - 10.0
    rel_mask = abs_mask & (loud_block > gamma_rel[:, None])
    rel_count = torch.clamp(rel_mask.sum(dim=-1), min=1)
    z_rel = torch.where(rel_mask, z_sum, 0.0).sum(dim=-1) / rel_count
    lufs = -0.691 + 10.0 * torch.log10(torch.clamp(z_rel, min=1e-12))
    return torch.where(abs_mask.any(dim=-1), lufs, -torch.inf)

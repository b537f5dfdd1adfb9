"""ITU-R BS.1770-4 integrated loudness (LKFS/LUFS) on the host (counterpart
of everyvoice_tpu/dsp/loudness.py::integrated_loudness_host).

The preprocessor rejects clips quieter than −36 LUFS with it. The
K-weighting pre-filter is the exact two-biquad cascade (scipy ``lfilter``),
re-derived for the sample rate from the analogue prototypes; gating uses
400 ms blocks at 75% overlap, −70 LKFS absolute then −10 LU relative.
"""

from __future__ import annotations

import numpy as np


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


def integrated_loudness_host(audio: np.ndarray, sample_rate: int) -> float:
    """BS.1770-4 integrated loudness of one (T,) or (C, T) clip; −inf when
    every block is gated out."""
    from scipy.signal import lfilter

    x = np.asarray(audio, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    (b1, a1), (b2, a2) = _biquad_coeffs(float(sample_rate))
    weighted = lfilter(b2, a2, lfilter(b1, a1, x, axis=-1), axis=-1)

    block = int(round(0.400 * sample_rate))
    step = block // 4  # 75% overlap
    t = weighted.shape[-1]
    if t < block:
        weighted = np.pad(weighted, ((0, 0), (0, block - t)))
        t = block
    n_blocks = 1 + (t - block) // step
    # Mean square per gating block from a cumulative sum of squares.
    csum = np.concatenate(
        [np.zeros((weighted.shape[0], 1)), np.cumsum(weighted**2, axis=-1)],
        axis=-1,
    )
    starts = np.arange(n_blocks) * step
    z = (csum[:, starts + block] - csum[:, starts]) / block  # (C, n_blocks)
    z_sum = z.sum(axis=0)  # (n_blocks,)
    loud_block = -0.691 + 10.0 * np.log10(np.maximum(z_sum, 1e-12))

    abs_mask = loud_block > -70.0
    if not abs_mask.any():
        return float("-inf")
    z_abs = z_sum[abs_mask].mean()
    gamma_rel = -0.691 + 10.0 * np.log10(max(z_abs, 1e-12)) - 10.0
    rel_mask = abs_mask & (loud_block > gamma_rel)
    if not rel_mask.any():
        return float("-inf")
    z_rel = z_sum[rel_mask].mean()
    return float(-0.691 + 10.0 * np.log10(max(z_rel, 1e-12)))

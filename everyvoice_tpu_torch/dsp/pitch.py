"""Batched fundamental-frequency (F0) estimation (counterpart of
everyvoice_tpu/dsp/pitch.py).

A batched normalized-difference (YIN/CMNDF) tracker over every frame of
every utterance at once: the difference function from an FFT
autocorrelation, cumulative-mean normalization, the first lag under an
absolute threshold (else the global minimum) refined by a parabola, a
voicing decision, then linear interpolation across unvoiced gaps with
constant extension at the edges. Everything stays float32, in the same
steps as the JAX version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F0_FLOOR = 71.0   # pyworld default f0_floor (Hz)
F0_CEIL = 800.0   # pyworld default f0_ceil (Hz)
CMNDF_THRESHOLD = 0.1
VOICING_THRESHOLD = 0.45
LOCAL_MIN_WINDOW = 8


def _difference_function(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """d(τ) for τ in [0, tau_max) for each frame of shape (..., W + tau_max)."""
    seg = frames.shape[-1]
    w = seg - tau_max
    csum = torch.cumsum(frames * frames, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    idx = torch.arange(tau_max, device=frames.device)
    e_tau = csum[..., idx + w] - csum[..., idx]  # energy of x[τ:τ+w]
    e_0 = (csum[..., w] - csum[..., 0])[..., None]
    # Cross term Σ_{j<w} x_j x_{j+τ} for every τ at once: a linear correlation
    # of the frame head against the whole segment, zero-padded to a power of
    # two above seg + 1 so nothing wraps around.
    n_fft = int(2 ** np.ceil(np.log2(seg + 1)))
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    head = torch.where(torch.arange(seg, device=frames.device) < w, frames, 0.0)
    spec_head = torch.fft.rfft(head, n=n_fft, dim=-1)
    cross = torch.fft.irfft(torch.conj(spec_head) * spec, n=n_fft, dim=-1)[..., :tau_max]
    return e_0 + e_tau - 2.0 * cross


def _cmndf(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference function."""
    tau = torch.arange(d.shape[-1], dtype=d.dtype, device=d.device)
    out = d * tau / torch.clamp(torch.cumsum(d, dim=-1), min=1e-9)
    out[..., 0] = 1.0
    return out


def _pick_lag(cmndf: torch.Tensor, tau_min: int, tau_max: int) -> tuple:
    """First lag under threshold (else global min), walked to the local
    minimum of the next 8 lags, with parabolic refinement."""
    n = cmndf.shape[-1]
    tau_idx = torch.arange(n, device=cmndf.device)
    valid = (tau_idx >= tau_min) & (tau_idx < tau_max - 1)
    masked = torch.where(valid, cmndf, torch.inf)
    under = masked < CMNDF_THRESHOLD
    any_under = under.any(dim=-1)
    # argmax of a 0/1 tensor is the first 1, as jnp.argmax of a bool mask.
    first_under = under.to(torch.int32).argmax(dim=-1)
    global_min = masked.argmin(dim=-1)
    base = torch.where(any_under, first_under, global_min)
    offs = torch.arange(LOCAL_MIN_WINDOW, device=cmndf.device)
    cand = torch.clamp(base[..., None] + offs, 0, n - 1)
    best_off = torch.gather(masked, -1, cand).argmin(dim=-1)
    tau_star = torch.gather(cand, -1, best_off[..., None])

    tm1 = torch.clamp(tau_star - 1, 0, n - 1)
    tp1 = torch.clamp(tau_star + 1, 0, n - 1)
    y0 = torch.gather(cmndf, -1, tm1)[..., 0]
    y1 = torch.gather(cmndf, -1, tau_star)[..., 0]
    y2 = torch.gather(cmndf, -1, tp1)[..., 0]
    denom = y0 - 2.0 * y1 + y2
    curved = denom.abs() > 1e-12
    shift = torch.where(curved, 0.5 * (y0 - y2) / torch.where(curved, denom, 1.0), 0.0)
    shift = torch.clamp(shift, -0.5, 0.5)
    return tau_star[..., 0].to(torch.float32) + shift, y1


def _interpolate_unvoiced(f0: torch.Tensor, voiced: torch.Tensor) -> torch.Tensor:
    """Linear interpolation across unvoiced gaps with constant extension
    past the first and last voiced frame. f0, voiced: (..., F)."""
    n = f0.shape[-1]
    idx = torch.arange(n, device=f0.device)
    prev = torch.cummax(torch.where(voiced, idx, -1), dim=-1).values
    nxt = torch.cummin(torch.where(voiced, idx, n).flip(-1), dim=-1).values.flip(-1)
    f_prev = torch.gather(f0, -1, torch.clamp(prev, 0, n - 1))
    f_next = torch.gather(f0, -1, torch.clamp(nxt, 0, n - 1))
    has_prev = prev >= 0
    has_next = nxt < n
    w_next = (idx - prev) / torch.clamp(nxt - prev, min=1)
    interp = f_prev * (1.0 - w_next) + f_next * w_next
    interp = torch.where(has_prev & has_next, interp, 0.0)
    interp = torch.where(has_prev & ~has_next, f_prev, interp)
    interp = torch.where(~has_prev & has_next, f_next, interp)
    out = torch.where(voiced, f0, interp)
    return torch.where(voiced.any(dim=-1, keepdim=True), out, 0.0)


def estimate_f0(
    audio: torch.Tensor,
    sample_rate: int,
    hop_length: int,
    interpolate: bool = True,
) -> torch.Tensor:
    """Batched F0 track for (..., T) float32 audio → (..., T//hop + 1) Hz,
    aligned with the center-padded spectrogram frames."""
    tau_min = max(2, int(sample_rate / F0_CEIL))
    tau_max = int(sample_rate / F0_FLOOR) + 2
    w = 2 * tau_max  # analysis span: two periods of the lowest pitch
    seg = w + tau_max

    batch_shape = audio.shape[:-1]
    t = audio.shape[-1]
    n_frames = t // hop_length + 1
    x = audio.reshape(-1, t)
    pad = seg // 2
    frames = F.pad(x, (pad, pad + seg)).unfold(-1, seg, hop_length)[:, :n_frames]
    frames = frames - frames.mean(dim=-1, keepdim=True)

    cm = _cmndf(_difference_function(frames, tau_max))
    refined_tau, dip = _pick_lag(cm, tau_min, tau_max)
    f0 = sample_rate / torch.clamp(refined_tau, min=1.0)
    energy = (frames * frames).mean(dim=-1)
    peak_energy = energy.max(dim=-1, keepdim=True).values
    voiced = (
        (dip < VOICING_THRESHOLD)
        & (f0 >= F0_FLOOR)
        & (f0 <= F0_CEIL)
        & (energy > 1e-6 * torch.clamp(peak_energy, min=1e-12))
    )
    f0 = torch.where(voiced, f0, 0.0)
    if interpolate:
        f0 = _interpolate_unvoiced(f0, voiced)
    return f0.reshape(*batch_shape, n_frames)

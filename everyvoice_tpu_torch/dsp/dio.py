"""Batched DIO + StoneMask-role F0 estimation (counterpart of
everyvoice_tpu/dsp/dio.py).

The algorithm family of pyworld's DIO, as fixed-shape tensor work over every
frame of every utterance at once, on the tensor's device:

- a bank of half-octave Nuttall low-pass filters in [F0_FLOOR, F0_CEIL],
  applied by one ``rfft`` of the signal, a bank multiply and one ``irfft``;
- per channel, four event families (rising and falling zero crossings of the
  filtered wave and of its first difference) give the interval that spans
  each frame centre, found with ``cummax``/``cummin`` over hop-sized blocks;
- the channel whose four estimates disperse least wins, and a dispersion
  above ``DISPERSION_THRESHOLD`` means unvoiced;
- refinement in StoneMask's role: windowed DFTs at the first harmonics of the
  rough estimate, the instantaneous frequency from the phase advance over two
  samples, the amplitude-weighted mean of IF_k / k, twice.

Nothing in the preprocessing path calls it: the production tracker is the
YIN tracker of ``dsp/pitch.py``, and DIO is its independent cross-check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from everyvoice_tpu_torch.dsp.pitch import F0_CEIL, F0_FLOOR, _interpolate_unvoiced

DISPERSION_THRESHOLD = 0.12
_REFINE_HARMONICS = 4
_REFINE_ITERS = 2


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) / max(n - 1, 1)
    return (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )


def _channel_boundaries(f0_floor: float, f0_ceil: float) -> np.ndarray:
    """Half-octave-spaced low-pass boundaries covering [floor, ceil]."""
    n = int(np.ceil(2.0 * np.log2(f0_ceil / f0_floor)))
    return f0_floor * 2.0 ** ((np.arange(n) + 1) / 2.0)


def _lowpass_bank(x: torch.Tensor, sr: int, boundaries: np.ndarray) -> torch.Tensor:
    """The Nuttall low-pass bank on (B, T) audio → (B, C, T), each filter's
    linear-phase delay undone so every channel stays aligned with the
    input."""
    t = x.shape[-1]
    lens = [int(sr / b * 4) // 2 * 2 for b in boundaries]
    n_fft = int(2 ** np.ceil(np.log2(t + max(lens))))
    responses = []
    for ln in lens:
        taps = _nuttall(ln)
        taps = taps / taps.sum()
        resp = np.fft.rfft(taps, n=n_fft)
        freqs = np.arange(resp.shape[0]) / n_fft
        responses.append(resp * np.exp(2j * np.pi * freqs * (ln - 1) / 2))
    bank = torch.from_numpy(np.stack(responses).astype(np.complex64)).to(x.device)
    spec = torch.fft.rfft(x, n=n_fft, dim=-1)  # (B, F)
    filtered = torch.fft.irfft(spec[:, None, :] * bank[None], n=n_fft, dim=-1)
    return filtered[..., :t]


def _event_interval_at(y: torch.Tensor, n_frames: int, hop: int, sr: int) -> tuple:
    """The period (seconds) that one event family gives at the frame centres
    i·hop: the sub-sample distance between the rising zero crossings of
    ``y`` (..., T) that bracket each centre. Returns (interval, valid), each
    (..., n_frames). Events are reduced per hop-sized block first (the last
    and the first in each), so the bracketing search runs over blocks."""
    t = y.shape[-1]
    a = y[..., :-1]
    b = y[..., 1:]
    mask = (a < 0) & (b >= 0)
    frac = torch.where(mask, a / torch.clamp(a - b, max=-1e-12), 0.0)
    pos = torch.arange(t - 1, dtype=torch.float32, device=y.device) + frac
    pad = n_frames * hop - (t - 1)
    blocks = y.shape[:-1] + (n_frames, hop)
    inf = math.inf
    last_b = F.pad(torch.where(mask, pos, -inf), (0, pad), value=-inf).reshape(blocks).amax(-1)
    first_b = F.pad(torch.where(mask, pos, inf), (0, pad), value=inf).reshape(blocks).amin(-1)
    prev = torch.cummax(last_b, dim=-1).values
    prev = torch.cat([torch.full_like(prev[..., :1], -inf), prev[..., :-1]], dim=-1)
    nxt = torch.cummin(first_b.flip(-1), dim=-1).values.flip(-1)
    valid = torch.isfinite(prev) & torch.isfinite(nxt)
    interval = torch.where(valid, nxt - prev, 0.0) / sr
    return interval, valid


def _dio_rough(x: torch.Tensor, sr: int, n_frames: int, hop: int) -> tuple:
    """Rough F0 and voicing from the candidate bank. x: (B, T)."""
    yl = _lowpass_bank(x, sr, _channel_boundaries(F0_FLOOR, F0_CEIL))  # (B, C, T)
    dl = torch.diff(yl, dim=-1, append=yl[..., -1:])
    freqs, valids = [], []
    for src in (yl, -yl, dl, -dl):
        interval, valid = _event_interval_at(src, n_frames, hop, sr)
        freqs.append(torch.where(valid, 1.0 / torch.clamp(interval, min=1e-9), 0.0))
        valids.append(valid)
    f = torch.stack(freqs, dim=-1)  # (B, C, F, 4)
    v = torch.stack(valids, dim=-1) & (f >= F0_FLOOR) & (f <= F0_CEIL)
    n_valid = v.sum(dim=-1)
    denom = torch.clamp(n_valid, min=1)
    mean = torch.where(n_valid > 0, torch.sum(f * v, dim=-1) / denom, 0.0)
    var = torch.sum(torch.where(v, (f - mean[..., None]) ** 2, 0.0), dim=-1)
    std = torch.sqrt(var / denom)
    dispersion = torch.where(n_valid >= 4, std / torch.clamp(mean, min=1e-9), math.inf)
    best = torch.argmin(dispersion, dim=1, keepdim=True)  # (B, 1, F)
    best_disp = torch.gather(dispersion, 1, best)[:, 0]
    f0 = torch.gather(mean, 1, best)[:, 0]
    voiced = (best_disp < DISPERSION_THRESHOLD) & (f0 >= F0_FLOOR) & (f0 <= F0_CEIL)
    return torch.where(voiced, f0, 0.0), voiced


def _refine_stonemask(x: torch.Tensor, f0: torch.Tensor, voiced: torch.Tensor, sr: int,
                      centers: np.ndarray) -> torch.Tensor:
    """Harmonic instantaneous-frequency refinement of each voiced frame:
    the DFT at harmonics k·f0 of a three-period Hann window, at two starts
    two samples apart; IF_k from the phase advance; the amplitude-weighted
    mean of IF_k / k; iterated so the comb re-centres on the estimate."""
    seg = int(3 * sr / F0_FLOOR) + 2  # the longest 3-period window
    hop = 2  # the phase baseline, samples
    half = seg // 2
    xp = F.pad(x, (half, half + hop + 1))
    idx = torch.from_numpy(centers[:, None] + np.arange(seg + hop)[None, :]).to(x.device)
    segs = xp[:, idx]  # (B, F, seg + hop)
    x0_in = segs[..., :seg].to(torch.complex64)
    x1_in = segs[..., hop : seg + hop].to(torch.complex64)
    ts = torch.arange(seg, device=x.device)
    k = torch.arange(1, _REFINE_HARMONICS + 1, dtype=torch.float32, device=x.device)

    def one_iter(f0_cur):
        span = torch.clamp(3.0 * sr / torch.clamp(f0_cur, min=F0_FLOOR), max=float(seg))
        win = torch.where(
            ts[None, None, :] < span[..., None],
            0.5 - 0.5 * torch.cos(2 * math.pi * ts[None, None, :]
                                  / torch.clamp(span[..., None] - 1, min=1.0)),
            0.0,
        )  # (B, F, seg)
        ang = (-2j * math.pi * (f0_cur[..., None, None] * k[None, None, :, None])
               * ts[None, None, None, :] / sr)
        basis = torch.exp(ang) * win[..., None, :]  # (B, F, K, seg)
        x0 = torch.einsum("bfs,bfks->bfk", x0_in, basis)
        x1 = torch.einsum("bfs,bfks->bfk", x1_in, basis)
        dphi = torch.angle(x1 * torch.conj(x0))
        inst = f0_cur[..., None] * k[None, None, :] + dphi * sr / (2 * math.pi * hop)
        w = torch.abs(x0)
        refined = torch.sum(w * (inst / k[None, None, :]), dim=-1) / torch.clamp(
            torch.sum(w, dim=-1), min=1e-9)
        ok = (refined > F0_FLOOR) & (refined < F0_CEIL) & (
            torch.abs(refined - f0_cur) < 0.2 * f0_cur)
        return torch.where(ok & voiced, refined, f0_cur)

    f0_ref = f0
    for _ in range(_REFINE_ITERS):
        f0_ref = one_iter(f0_ref)
    return torch.where(voiced, f0_ref, 0.0)


@torch.no_grad()
def estimate_f0_dio(audio: torch.Tensor, sample_rate: int, hop_length: int,
                    interpolate: bool = True) -> torch.Tensor:
    """Batched DIO + refinement F0 of (..., T) audio → (..., T // hop + 1)
    Hz, on the frame grid of ``dsp/pitch.py::estimate_f0`` (the
    centre-padded STFT's, so pitch rows align with mel rows); unvoiced
    frames are 0 unless ``interpolate`` fills them."""
    batch_shape = audio.shape[:-1]
    t = audio.shape[-1]
    n_frames = t // hop_length + 1
    x = audio.reshape(-1, t).to(torch.float32)
    x = x - x.mean(dim=-1, keepdim=True)
    centers = np.minimum(np.arange(n_frames) * hop_length, t - 1)
    f0, voiced = _dio_rough(x, sample_rate, n_frames, hop_length)
    f0 = _refine_stonemask(x, f0, voiced, sample_rate, centers)
    if interpolate:
        f0 = _interpolate_unvoiced(f0, voiced)
    return f0.reshape(batch_shape + (n_frames,))

"""Batched log-mel spectrogram: the CUDA kernels' wrapper and its plain version.

``log_mel`` computes what ``everyvoice_tpu/ops/mel_pallas.py::fused_log_mel``
computes: (B, S) float32 audio → reflect pad of n_fft/2 → frames → periodic
Hann window (centre-padded to n_fft) → real DFT → √(re²+im²+1e-9) → slaney
mel matmul → log(max(·, 1e-5)), as a (B, n_mels, S//hop + 1) float32
tensor. A CUDA tensor goes to one of two hand-written kernels in
``csrc/mel.cu``, one launch either way, chosen by n_fft alone: the FFT
kernel for a power of two from 64 to 2048 (the served 1024 among them), the
DFT-as-matrix-product kernel for any other n_fft (1000, say). A CPU tensor
goes to ``log_mel_reference``. Nothing falls back from a kernel to the plain
version, or from one kernel to the other.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from everyvoice_tpu_torch.dsp.spectral import (
    _rdft_basis,
    frame_signal,
    librosa_mel_basis,
    padded_window,
)
from everyvoice_tpu_torch.utils.precision import no_tf32

BIN_TILE = 64       # bins per tile of the DFT kernel (csrc/mel.cu kTB)
MAX_MELS = 128      # both kernels' limit, the DFT kernel's (kGroups * kMaxMelPerThread)
FFT_MIN, FFT_MAX = 64, 2048  # the FFT kernel's n_fft (csrc/mel.cu log_mel_fft_launch)
CLIP_VAL = 1e-5     # floor of the mel before the log (csrc/mel.cu kClipVal)


def _check(audio, n_fft, win_length, hop_length):
    if audio.dim() != 2:
        raise ValueError(f"log_mel takes audio of shape (B, S), got {tuple(audio.shape)}")
    if audio.dtype != torch.float32:
        raise TypeError(f"log_mel takes float32 audio, got {audio.dtype}")
    if not 0 < win_length <= n_fft:
        raise ValueError(f"win_length {win_length} must be in (0, n_fft={n_fft}]")
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if audio.shape[1] <= n_fft // 2:
        raise ValueError(
            f"log_mel reflect-pads by n_fft/2 = {n_fft // 2} samples and needs "
            f"a longer signal, got {audio.shape[1]}"
        )


def log_mel_reference(
    audio: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    win_length: int = 1024,
    hop_length: int = 256,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic in the
    same float32 type (matmuls with TF32 off)."""
    _check(audio, n_fft, win_length, hop_length)
    device = audio.device
    frames = frame_signal(audio, n_fft, hop_length)[:, : audio.shape[1] // hop_length + 1]
    frames = frames * torch.from_numpy(padded_window(win_length, n_fft)).to(device)
    cos_b, msin_b = _rdft_basis(n_fft)
    melw = librosa_mel_basis(sample_rate, n_fft, n_mels, f_min, f_max).T
    with no_tf32():
        real = frames @ torch.from_numpy(cos_b).to(device)
        imag = frames @ torch.from_numpy(msin_b).to(device)
        mag = torch.sqrt(real * real + imag * imag + 1e-9)
        mel = mag @ torch.from_numpy(np.ascontiguousarray(melw)).to(device)
    return torch.log(torch.clamp(mel, min=CLIP_VAL)).transpose(1, 2).contiguous()


def fft_route(n_fft: int) -> bool:
    """Whether ``log_mel`` takes n_fft through the FFT kernel (else the DFT
    kernel)."""
    return FFT_MIN <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0


def fft_twiddles(n_fft: int) -> np.ndarray:
    """The FFT kernel's (n_fft, 2) float32 twiddle table, cos then sin of
    each angle, computed in float64 and rounded once: for each radix-2 stage
    Ns = 1, 2, .., n_fft/4 of the n_fft/2-point complex FFT,
    exp(-2πi·k / 2Ns) for k < Ns at [Ns - 1 + k]; then the real-FFT split
    step's exp(-2πi·k / n_fft) for k = 0..n_fft/2 at [n_fft/2 - 1 + k]."""
    half = n_fft // 2
    stages = [np.arange(ns) / (2 * ns) for ns in (1 << np.arange(half.bit_length() - 1))]
    angle = -2.0 * np.pi * np.concatenate([*stages, np.arange(half + 1) / n_fft])
    return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


def mel_ranges(basis: np.ndarray) -> tuple:
    """((3, n_mels) int32 rows lo, hi, offset; compacted weights; n_used) for
    a (n_mels, n_bins) filterbank: filter m's weights are the basis's row m
    over bins [lo, hi), its first to last nonzero, stored from ``offset`` of
    the compacted weights; an all-zero filter gets lo = hi = 0. ``n_used``
    is one past the last bin any filter uses."""
    ranges = np.zeros((3, basis.shape[0]), np.int32)
    weights = []
    offset = 0
    for m, row in enumerate(basis):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        ranges[:, m] = lo, hi, offset
        weights.append(row[lo:hi])
        offset += hi - lo
    return ranges, np.concatenate(weights).astype(np.float32), int(ranges[1].max())


@lru_cache(maxsize=8)
def _fft_constants(sample_rate, n_fft, win_length, n_mels, f_min, f_max, device):
    """(window, twiddles, mel weights, mel ranges, n_used) of the FFT kernel
    on ``device``."""
    ranges, weights, n_used = mel_ranges(
        librosa_mel_basis(sample_rate, n_fft, n_mels, f_min, f_max)
    )
    consts = (padded_window(win_length, n_fft), fft_twiddles(n_fft), weights, ranges)
    return (*(torch.from_numpy(a).to(device) for a in consts), n_used)


@lru_cache(maxsize=8)
def _dft_constants(sample_rate, n_fft, win_length, n_mels, f_min, f_max, device):
    """(window, basis, melw) of the DFT kernel on ``device``: the bases
    as (n_tiles, n_fft, 2·64) tiles of cos then −sin, and the mel weights
    as (n_tiles·64, n_mels), both zero past the last bin."""
    cos_b, msin_b = _rdft_basis(n_fft)
    n_bins = cos_b.shape[1]
    n_tiles = -(-n_bins // BIN_TILE)
    basis = np.zeros((n_tiles, n_fft, 2 * BIN_TILE), np.float32)
    for t in range(n_tiles):
        cols = slice(t * BIN_TILE, min((t + 1) * BIN_TILE, n_bins))
        width = cols.stop - cols.start
        basis[t, :, :width] = cos_b[:, cols]
        basis[t, :, BIN_TILE : BIN_TILE + width] = msin_b[:, cols]
    melw = np.zeros((n_tiles * BIN_TILE, n_mels), np.float32)
    melw[:n_bins] = librosa_mel_basis(sample_rate, n_fft, n_mels, f_min, f_max).T
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (padded_window(win_length, n_fft), basis, melw)
    )


def log_mel(
    audio: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    win_length: int = 1024,
    hop_length: int = 256,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> torch.Tensor:
    """Log-mel of (B, S) float32 ``audio`` as (B, n_mels, S//hop + 1): the
    FFT or DFT kernel for a CUDA tensor (``fft_route``), the plain version
    for a CPU tensor. ``log_mel.launches`` counts the launches of either
    kernel, ``log_mel.fft_launches`` those of the FFT kernel."""
    _check(audio, n_fft, win_length, hop_length)
    if audio.device.type == "cpu":
        return log_mel_reference(
            audio, sample_rate, n_fft, win_length, hop_length, n_mels, f_min, f_max
        )
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel runs on cuda or cpu, not {audio.device}")
    if not 0 < n_mels <= MAX_MELS:
        raise ValueError(f"the log-mel kernel takes 1..{MAX_MELS} mels, got {n_mels}")
    if not audio.is_contiguous():
        raise ValueError("log_mel takes contiguous audio")
    if audio.shape[0] > 65535:
        raise ValueError(f"the log-mel kernel takes up to 65535 rows, got {audio.shape[0]}")

    from everyvoice_tpu_torch.ops import _build

    lib = _build.load("mel")
    batch, samples = audio.shape
    n_frames = samples // hop_length + 1
    out = torch.empty(batch, n_mels, n_frames, dtype=torch.float32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    key = (int(sample_rate), int(n_fft), int(win_length), int(n_mels),
           float(f_min), float(f_max), audio.device)
    fft = fft_route(n_fft)
    if fft:
        window, twiddle, weights, ranges, n_used = _fft_constants(*key)
        fn = lib.log_mel_fft_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = (twiddle.data_ptr(), weights.data_ptr(), ranges.data_ptr(), out.data_ptr(),
                batch, samples, n_frames, n_fft, hop_length, n_mels, weights.numel(), n_used)
    else:
        window, basis, melw = _dft_constants(*key)
        fn = lib.log_mel_dft_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        args = (basis.data_ptr(), melw.data_ptr(), out.data_ptr(), batch, samples,
                n_frames, n_fft, hop_length, basis.shape[0], n_mels)
    fn.restype = ctypes.c_int
    rc = fn(audio.data_ptr(), window.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(
            f"log_mel {'FFT' if fft else 'DFT'} kernel launch failed: CUDA error {rc}"
        )
    log_mel.launches += 1
    if fft:
        log_mel.fft_launches += 1
    return out


log_mel.launches = 0
log_mel.fft_launches = 0

"""Batched log-mel spectrogram: the CUDA kernel's wrapper and its plain version.

``log_mel`` computes what ``everyvoice_tpu/ops/mel_pallas.py::fused_log_mel``
computes: (B, S) float32 audio → reflect pad of n_fft/2 → frames → periodic
Hann window (centre-padded to n_fft) → real DFT against the cos and −sin
bases → √(re²+im²+1e-9) → slaney mel matmul → log(max(·, 1e-5)), as a
(B, n_mels, S//hop + 1) float32 tensor. A CUDA tensor goes to the
hand-written kernel in ``csrc/mel.cu`` (one launch); a CPU tensor goes to
``log_mel_reference``. Nothing falls back from the kernel to the plain
version.
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

BIN_TILE = 64       # bins per tile of the kernel (csrc/mel.cu kTB)
MAX_MELS = 128
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


@lru_cache(maxsize=8)
def _kernel_constants(sample_rate, n_fft, win_length, n_mels, f_min, f_max, device):
    """(window, basis, melw) on ``device`` in the kernel's layout: the bases
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
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``log_mel.launches`` counts the kernel's launches."""
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
    fn = lib.log_mel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    window, basis, melw = _kernel_constants(
        int(sample_rate), int(n_fft), int(win_length), int(n_mels),
        float(f_min), float(f_max), audio.device,
    )
    batch, samples = audio.shape
    n_frames = samples // hop_length + 1
    out = torch.empty(batch, n_mels, n_frames, dtype=torch.float32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = fn(
        audio.data_ptr(), window.data_ptr(), basis.data_ptr(), melw.data_ptr(),
        out.data_ptr(), batch, samples, n_frames, n_fft, hop_length,
        basis.shape[0], n_mels, stream,
    )
    if rc != 0:
        raise RuntimeError(f"log_mel kernel launch failed: CUDA error {rc}")
    log_mel.launches += 1
    return out


log_mel.launches = 0

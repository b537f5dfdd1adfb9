"""Batched spectral transforms: STFT, mel filterbanks, iSTFT, energy
(counterpart of everyvoice_tpu/dsp/spectral.py).

The window, the real-DFT bases and the mel filterbanks are built on the host
by the same numpy code as the JAX package's, so they are bit-identical to
its constants. The STFT is the same real DFT as a matrix product; float32
products run with TF32 off (``no_tf32``), as the reference's
``Precision.HIGHEST`` asks. Inputs are (..., samples) tensors and outputs
(..., n_bins_or_mels, frames), on the inputs' device.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from everyvoice_tpu_torch.utils.precision import no_tf32

# ---------------------------------------------------------------------------
# Window + DFT basis construction (host-side numpy, copied verbatim)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w[:win_length].astype(np.float32)


@lru_cache(maxsize=16)
def _rdft_basis(n_fft: int) -> tuple:
    """Real-DFT basis: cos (n_fft, n_bins) and -sin (n_fft, n_bins)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    return (
        np.cos(angle).astype(np.float32),
        (-np.sin(angle)).astype(np.float32),
    )


def hz_to_mel_slaney(freq):
    """Slaney-style mel scale: linear below 1 kHz, log above."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=16)
def librosa_mel_basis(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (n_mels, n_bins), as
    librosa.filters.mel(htk=False, norm='slaney') builds it."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(
        hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def htk_mel_basis(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """HTK-scale mel filterbank with slaney area-normalization (the basis of
    spec_type 'mel')."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asanyarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asanyarray(m, dtype=np.float64) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """The periodic Hann window, centre-padded with zeros to n_fft."""
    lpad = (n_fft - win_length) // 2
    return np.pad(hann_window(win_length), (lpad, n_fft - win_length - lpad))


@lru_cache(maxsize=32)
def _on_device(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)``, a host constant, copied to ``device`` once per
    (function, arguments, device); callers only read it."""
    return torch.from_numpy(np.ascontiguousarray(make(*args))).to(device)


def _rdft_part(n_fft: int, index: int, transpose: bool) -> np.ndarray:
    """The real-DFT basis's cos (0) or -sin (1) half, (n_fft, n_bins) or
    transposed."""
    part = _rdft_basis(n_fft)[index]
    return part.T if transpose else part


# ---------------------------------------------------------------------------
# Framing + STFT


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Reflect-pad (..., T) audio by n_fft/2 on each side and slice it into
    overlapping frames (..., n_frames, n_fft). Reflect padding mirrors
    without repeating the edge sample, as jnp.pad does; torch needs the pad
    shorter than the signal."""
    shape = audio.shape
    flat = F.pad(audio.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
    return flat.reshape(*shape[:-1], flat.shape[-1]).unfold(-1, n_fft, hop_length)


def stft_real_imag(
    audio: torch.Tensor, n_fft: int, win_length: int, hop_length: int
) -> tuple:
    """Centred STFT with the periodic Hann window, as the real DFT against
    the cos and -sin bases; returns (real, imag), each (..., n_bins,
    n_frames)."""
    device = audio.device
    window = _on_device(padded_window, (win_length, n_fft), device)
    frames = frame_signal(audio, n_fft, hop_length) * window
    with no_tf32():
        real = frames @ _on_device(_rdft_part, (n_fft, 0, False), device)
        imag = frames @ _on_device(_rdft_part, (n_fft, 1, False), device)
    return real.transpose(-1, -2), imag.transpose(-1, -2)


def stft_power(
    audio: torch.Tensor,
    n_fft: int,
    win_length: int,
    hop_length: int,
    power: float = 2.0,
) -> torch.Tensor:
    real, imag = stft_real_imag(audio, n_fft, win_length, hop_length)
    mag_sq = real * real + imag * imag
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(mag_sq + 1e-12)
    return torch.pow(mag_sq, power / 2.0)


def _istft_bin_weights(n_fft: int) -> np.ndarray:
    """Conjugate-symmetric expansion weights: bins 1..n-2 count twice."""
    weights = np.ones(n_fft // 2 + 1, dtype=np.float32) * 2.0
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    return weights


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int,
    win_length: int,
    hop_length: int,
    center: bool = True,
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT with Hann overlap-add and window-sum normalization.
    Inputs are (..., n_bins, n_frames); output is (..., samples). Needs
    hop | n_fft: each frame splits into K = n_fft/hop hop-sized chunks and
    the overlap-add is K shifted adds."""
    if n_fft % hop_length != 0:
        raise ValueError("iSTFT requires hop | n_fft")
    window = padded_window(win_length, n_fft)
    device = real.device
    weights_t = _on_device(_istft_bin_weights, (n_fft,), device)
    real_t = real.transpose(-1, -2) * weights_t  # (..., frames, bins)
    imag_t = imag.transpose(-1, -2) * weights_t
    with no_tf32():
        frames = (
            real_t @ _on_device(_rdft_part, (n_fft, 0, True), device)
            + imag_t @ _on_device(_rdft_part, (n_fft, 1, True), device)
        ) / n_fft
    frames = frames * _on_device(padded_window, (win_length, n_fft), device)
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft)

    k_overlap = n_fft // hop_length
    chunks = flat.reshape(-1, n_frames, k_overlap, hop_length)
    n_slots = n_frames + k_overlap - 1
    sig = torch.zeros(flat.shape[0], n_slots, hop_length, device=device)
    for j in range(k_overlap):
        sig[:, j : j + n_frames] += chunks[:, :, j]
    sig = sig.reshape(flat.shape[0], n_slots * hop_length)[:, :out_len]
    wsum = np.zeros(out_len, dtype=np.float32)
    w_sq = (window * window).astype(np.float32)
    for f in range(n_frames):
        wsum[f * hop_length : f * hop_length + n_fft] += w_sq
    sig = sig / torch.from_numpy(np.maximum(wsum, 1e-11)).to(device)
    if center:
        sig = sig[:, n_fft // 2 : out_len - n_fft // 2]
    if length is not None:
        if sig.shape[-1] < length:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
        else:
            sig = sig[:, :length]
    return sig.reshape(*batch_shape, sig.shape[-1])


# ---------------------------------------------------------------------------
# Dynamic range compression and the transform factory


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5):
    """log(clamp(x, clip_val) * C)."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0):
    return torch.exp(x) / C


def get_spectral_transform(
    spec_type: str,
    n_fft: int,
    win_length: int,
    hop_length: int,
    sample_rate: int | None = None,
    n_mels: int | None = None,
    f_min: float = 0,
    f_max: float = 8000,
):
    """The JAX package's transform factory: a callable mapping (..., T)
    audio to a spectrogram, or None for an unknown spec_type."""
    if spec_type in ("mel-librosa", "mel"):
        make_basis = librosa_mel_basis if spec_type == "mel-librosa" else htk_mel_basis
        basis_args = (sample_rate, n_fft, n_mels, f_min, f_max)

        def mel_transform(audio):
            power = stft_power(audio, n_fft, win_length, hop_length, power=2.0)
            if spec_type == "mel-librosa":
                power = torch.sqrt(power + 1e-9)
            with no_tf32():
                return _on_device(make_basis, basis_args, audio.device) @ power

        return mel_transform
    if spec_type == "linear":
        return partial(
            stft_power, n_fft=n_fft, win_length=win_length, hop_length=hop_length,
            power=2.0,
        )
    if spec_type == "raw":
        return partial(
            stft_real_imag, n_fft=n_fft, win_length=win_length, hop_length=hop_length,
        )
    if spec_type == "istft":
        return partial(
            istft, n_fft=n_fft, win_length=win_length, hop_length=hop_length
        )
    return None


def compute_energy(spec: torch.Tensor) -> torch.Tensor:
    """Frame energy = L2 norm over the frequency axis. spec: (..., n_bins,
    n_frames)."""
    return torch.sqrt(torch.sum(spec * spec, dim=-2))

"""Objective evaluation of synthesized audio, on a torch device
(counterpart of everyvoice_tpu/evaluation.py).

- ``si_sdr`` and ``stoi_proxy``: intrusive metrics against a reference wav
  of the same name (SI-SDR by its definition; the STOI proxy follows
  STOI's one-third-octave short-time correlation structure);
- ``signal_report``: duration, integrated loudness, clipping rate,
  silence ratio and spectral flatness, with no reference;
- ``try_squim_objective`` and ``try_squim_subjective`` return None: the
  TorchAudio-SQUIM models need torchaudio and weights that are downloaded,
  and neither is here (the JAX package's functions return None without
  them too).

The wavs are read on the host; resampling, the STFTs, K-weighting and every
reduction over samples or frames run on the device of the tensors they are
given. ``evaluate_directory`` evaluates a directory of wavs (or one wav)
into the JSON rows that ``everyvoice-tpu evaluate`` writes, on the CUDA card
unless ``device`` says otherwise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp import read_wav, spectral
from everyvoice_tpu_torch.dsp.loudness import integrated_loudness
from everyvoice_tpu_torch.dsp.resample import resample
from everyvoice_tpu_torch.utils.precision import no_tf32


def resample_to_16k(audio: torch.Tensor, sr: int) -> torch.Tensor:
    return audio if sr == 16000 else resample(audio, sr, 16000)


def si_sdr(estimate: torch.Tensor, reference: torch.Tensor) -> float:
    """Scale-invariant signal-to-distortion ratio (dB), in float64."""
    n = min(estimate.shape[-1], reference.shape[-1])
    est, ref = estimate[:n].double(), reference[:n].double()
    est = est - est.mean()
    ref = ref - ref.mean()
    alpha = (est @ ref) / torch.clamp(ref @ ref, min=1e-12)
    target = alpha * ref
    noise = est - target
    return float(10.0 * torch.log10(torch.clamp(target @ target, min=1e-12)
                                    / torch.clamp(noise @ noise, min=1e-12)))


def stft_power(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(n_bins, frames) power of the port's STFT (``dsp.spectral``: centred,
    reflect-padded, periodic Hann, float32)."""
    return spectral.stft_power(audio.float(), n_fft, n_fft, hop)


def _third_octave_bands(sr: int, n_fft: int, n_bands: int = 15, f_start: float = 150.0):
    cf = f_start * (2.0 ** (np.arange(n_bands) / 3.0))
    lo = cf / (2 ** (1 / 6))
    hi = cf * (2 ** (1 / 6))
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    bands = np.zeros((n_bands, len(freqs)), np.float32)
    for i in range(n_bands):
        bands[i, (freqs >= lo[i]) & (freqs < hi[i])] = 1.0
    return bands


@no_tf32()
def stoi_proxy(estimate: torch.Tensor, reference: torch.Tensor, sr: int) -> float:
    """Short-time objective intelligibility by STOI's structure: 10 kHz,
    one-third-octave bands, 384 ms segment correlations, every segment at
    once."""
    target_sr = 10000
    n = min(estimate.shape[-1], reference.shape[-1])
    est = resample(estimate[:n], sr, target_sr)
    ref = resample(reference[:n], sr, target_sr)
    n_fft, hop = 512, 256
    spec_e = torch.sqrt(stft_power(est, n_fft, hop) + 1e-12)
    spec_r = torch.sqrt(stft_power(ref, n_fft, hop) + 1e-12)
    bands = torch.from_numpy(_third_octave_bands(target_sr, n_fft)).to(est.device)
    be = torch.sqrt(bands @ (spec_e ** 2) + 1e-12)  # (bands, frames)
    br = torch.sqrt(bands @ (spec_r ** 2) + 1e-12)
    seg = min(30, be.shape[1])  # about 384 ms at 10 kHz, hop 256
    x = br.unfold(1, seg, 1)  # (bands, segments, seg)
    y = be.unfold(1, seg, 1)
    alpha = torch.sqrt((x ** 2).sum(-1, keepdim=True)
                       / torch.clamp((y ** 2).sum(-1, keepdim=True), min=1e-12))
    y_n = torch.minimum(alpha * y, x * (1 + 10 ** (15 / 20)))
    xm = x - x.mean(-1, keepdim=True)
    ym = y_n - y_n.mean(-1, keepdim=True)
    corrs = (xm * ym).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(xm, dim=-1) * torch.linalg.vector_norm(ym, dim=-1), min=1e-12)
    return float(corrs.mean())


def signal_report(audio: torch.Tensor, sr: int) -> dict:
    lufs = integrated_loudness(audio, sr)
    power = stft_power(audio, 1024, 256) + 1e-12
    flatness = float(torch.mean(torch.exp(torch.mean(torch.log(power), dim=0))
                                / torch.mean(power, dim=0)))
    n = audio.shape[-1]
    return {
        "duration_s": round(n / sr, 3),
        "loudness_lufs": round(lufs, 2) if np.isfinite(lufs) else None,
        "clipping_rate": int((audio.abs() > 0.999).sum()) / n,
        "silence_ratio": int((audio.abs() < 1e-4).sum()) / n,
        "spectral_flatness": round(flatness, 4),
    }


def try_squim_objective(audio_16k: torch.Tensor) -> Optional[dict]:
    """TorchAudio-SQUIM objective scores: None, as there are no weights."""
    return None


def try_squim_subjective(audio_16k: torch.Tensor, non_matching_references_16k: list
                         ) -> Optional[float]:
    """TorchAudio-SQUIM subjective MOS: None, as there are no weights."""
    return None


def _read_mono(path, device: torch.device) -> tuple:
    audio, sr = read_wav(path)
    return torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device).mean(0), sr


def calculate_objective_metrics_from_single_path(
    wav_path: Path | str,
    reference_path: Optional[Path | str] = None,
    non_matching_references_16k: Optional[list] = None,
    device=None,
) -> dict:
    device = resolve_device(device)
    mono, sr = _read_mono(wav_path, device)
    metrics = {"file": str(wav_path)}
    metrics.update(signal_report(mono, sr))
    est_mono = resample_to_16k(mono, sr)
    quality_metrics = False
    squim = try_squim_objective(est_mono)
    if squim is not None:
        metrics.update(squim)
        quality_metrics = True
    mos = try_squim_subjective(est_mono, non_matching_references_16k or [])
    if mos is not None:
        metrics["squim_mos"] = mos
        quality_metrics = True
    if reference_path is not None:
        ref_mono, ref_sr = _read_mono(reference_path, device)
        ref_mono = resample_to_16k(ref_mono, ref_sr)
        metrics["si_sdr"] = round(si_sdr(est_mono, ref_mono), 3)
        metrics["stoi"] = round(stoi_proxy(est_mono, ref_mono, 16000), 4)
        quality_metrics = True
    metrics["has_quality_metrics"] = quality_metrics
    return metrics


def load_non_matching_references(nmr_dir: Optional[Path | str], limit: int = 5,
                                 device=None) -> list:
    """Up to ``limit`` 16 kHz mono non-matching reference recordings from a
    directory of wavs, or one wav."""
    if nmr_dir is None:
        return []
    device = resolve_device(device)
    nmr_dir = Path(nmr_dir)
    paths = [nmr_dir] if nmr_dir.is_file() else sorted(nmr_dir.glob("**/*.wav"))
    return [resample_to_16k(*_read_mono(p, device)) for p in paths[:limit]]


def evaluate_directory(
    wav_dir: Path | str,
    reference_dir: Optional[Path | str] = None,
    non_matching_reference_dir: Optional[Path | str] = None,
    device=None,
) -> list:
    """One metrics row per wav under ``wav_dir`` (or for the one wav it
    names), with the intrusive metrics where ``reference_dir`` holds a wav
    of the same name."""
    device = resolve_device(device)
    wav_dir = Path(wav_dir)
    nmr = load_non_matching_references(non_matching_reference_dir, device=device)
    wavs = [wav_dir] if wav_dir.is_file() else sorted(wav_dir.glob("**/*.wav"))
    results = []
    for wav_path in wavs:
        ref = None
        if reference_dir is not None:
            candidate = Path(reference_dir) / wav_path.name
            ref = candidate if candidate.exists() else None
        results.append(calculate_objective_metrics_from_single_path(
            wav_path, ref, non_matching_references_16k=nmr, device=device))
    return results

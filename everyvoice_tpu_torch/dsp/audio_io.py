"""PCM WAV writing through the standard library's ``wave`` module, byte for
byte as everyvoice_tpu/dsp/audio_io.py::write_wav writes it.

16-bit samples are rounded as the JAX package's native writer
(``native/wav_io.c::wav_write_i16``) rounds them, which it uses whenever it
is built: in float32, half away from zero. (Its numpy fallback rounds half
to even instead; the two differ only where v·32767 ends in exactly .5.)
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def write_wav(path: Path | str, audio: np.ndarray, sample_rate: int, bit_depth: int = 16) -> None:
    """Write float audio in [-1, 1], (channels, samples) or (samples,), as
    PCM, clipped to [-1, 1]."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_channels, _ = audio.shape
    interleaved = np.clip(audio.T.reshape(-1), -1.0, 1.0)
    if bit_depth == 16:
        scaled = interleaved * np.float32(32767.0)
        half = np.where(scaled >= 0, np.float32(0.5), np.float32(-0.5))
        pcm = np.trunc(scaled + half).astype("<i2")
        sampwidth = 2
    elif bit_depth == 32:
        pcm = (interleaved * 2147483647.0).round().astype("<i4")
        sampwidth = 4
    else:
        raise ValueError(f"Unsupported target bit depth {bit_depth}")
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(n_channels)
        wf.setsampwidth(sampwidth)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())

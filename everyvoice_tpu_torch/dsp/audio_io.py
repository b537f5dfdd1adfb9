"""WAV reading and writing through the standard library's ``wave`` module
(counterpart of everyvoice_tpu/dsp/audio_io.py).

``read_wav`` is the JAX package's stdlib parser with its RIFF branch for IEEE
float files; the JAX package's native C codec decodes to the same values.
``write_wav`` writes PCM byte for byte as the JAX package's native writer;
``write_wav_bytes`` encodes in memory as the JAX package's function of that
name does (TensorBoard audio summaries).

16-bit samples are rounded as the JAX package's native writer
(``native/wav_io.c::wav_write_i16``) rounds them, which it uses whenever it
is built: in float32, half away from zero. (Its numpy fallback rounds half
to even instead; the two differ only where v·32767 ends in exactly .5.)
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

_PCM_SCALE = {16: 32768.0, 32: 2147483648.0}


def read_wav(path: Path | str) -> tuple:
    """Read a WAV file → (audio float32 (channels, samples), sample_rate):
    PCM 8/16/24/32-bit through ``wave``, IEEE float through the RIFF
    chunks."""
    path = str(path)
    try:
        with wave.open(path, "rb") as wf:
            n_channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            sr = wf.getframerate()
            raw = wf.readframes(wf.getnframes())
        if sampwidth == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif sampwidth == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif sampwidth == 3:
            as_bytes = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as_int = (
                as_bytes[:, 0].astype(np.int32)
                | (as_bytes[:, 1].astype(np.int32) << 8)
                | (as_bytes[:, 2].astype(np.int32) << 16)
            )
            as_int = np.where(as_int >= 2**23, as_int - 2**24, as_int)
            data = as_int.astype(np.float32) / 8388608.0
        elif sampwidth == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported sample width {sampwidth} in {path}")
    except wave.Error:
        # The wave module refuses IEEE-float files; parse the RIFF chunks.
        data, n_channels, sr = _read_riff_float(path)
    if n_channels > 1:
        data = data.reshape(-1, n_channels).T
    else:
        data = data.reshape(1, -1)
    return np.ascontiguousarray(data), sr


def _read_riff_float(path: str) -> tuple:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        chunk_id = blob[pos : pos + 4]
        size = struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
        body = blob[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt or data chunk")
    audio_format, n_channels, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 3 and bits == 64:
        samples = np.frombuffer(data, dtype="<f8").astype(np.float32)
    elif audio_format == 1:
        scale = _PCM_SCALE.get(bits)
        if scale is None:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
        dtype = "<i2" if bits == 16 else "<i4"
        samples = np.frombuffer(data, dtype=dtype).astype(np.float32) / scale
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    return samples, n_channels, sr


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


def write_wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """In-memory 16-bit PCM WAV of (samples,) float audio, rounded half to
    even as the JAX package's ``write_wav_bytes`` rounds."""
    import io

    audio = np.asarray(audio, np.float32).reshape(-1)
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()

"""Minimal TensorBoard event writer (copy of
everyvoice_tpu/train/tensorboard.py).

Writes scalar, audio and image summaries in the standard
``events.out.tfevents.*`` format (TFRecord framing with masked CRC32C plus
hand-encoded Event/Summary protos), so runs are viewable in stock
TensorBoard. Images are PNGs encoded here with ``zlib`` and ``struct``, not
PIL.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven


def _make_crc32c_table() -> list:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


try:  # C extension when present — audio/image events are hundreds of KB,
    # and a per-byte Python CRC loop would stall the train loop for
    # seconds at every validation media flush.
    import google_crc32c as _gcrc

    def crc32c(data: bytes) -> int:
        return _gcrc.value(data)

except ImportError:  # pragma: no cover - environment without the wheel
    _CRC_TABLE = _make_crc32c_table()

    def crc32c(data: bytes) -> int:
        crc = 0xFFFFFFFF
        table = _CRC_TABLE
        for byte in data:
            crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = int(crc32c(data)) & 0xFFFFFFFF
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Tiny protobuf wire-format encoder (only what Event/Summary need)


def _varint(value: int) -> bytes:
    out = b""
    value &= 0xFFFFFFFFFFFFFFFF
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out += bytes([bits | 0x80])
        else:
            out += bytes([bits])
            return out


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _string_field(field: int, value: str) -> bytes:
    return _bytes_field(field, value.encode("utf8"))


def encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag=1, simple_value=2 }
    summary_value = _string_field(1, tag) + _float_field(2, float(value))
    # Summary { value=1 repeated }
    summary = _bytes_field(1, summary_value)
    # Event { wall_time=1, step=2, summary=5 }
    return (
        _double_field(1, wall_time)
        + _int64_field(2, int(step))
        + _bytes_field(5, summary)
    )


def encode_file_version_event(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3 }
    return _double_field(1, wall_time) + _string_field(3, "brain.Event:2")


def _event(summary_value: bytes, step: int, wall_time: float) -> bytes:
    summary = _bytes_field(1, summary_value)
    return (
        _double_field(1, wall_time)
        + _int64_field(2, int(step))
        + _bytes_field(5, summary)
    )


def encode_audio_event(
    tag: str, audio: np.ndarray, sample_rate: int, step: int, wall_time: float
) -> bytes:
    """Summary.Value.audio (field 6): WAV-encoded mono float audio
    (the reference gets this via Lightning's TensorBoardLogger.add_audio)."""
    from everyvoice_tpu_torch.dsp.audio_io import write_wav_bytes

    wav_bytes = write_wav_bytes(np.asarray(audio, np.float32), sample_rate)
    # Summary.Audio { sample_rate=1 (float), num_channels=2, length_frames=3,
    #                 encoded_audio_string=4, content_type=5 }
    audio_proto = (
        _float_field(1, float(sample_rate))
        + _int64_field(2, 1)
        + _int64_field(3, len(audio))
        + _bytes_field(4, wav_bytes)
        + _string_field(5, "audio/wav")
    )
    value = _string_field(1, tag) + _bytes_field(6, audio_proto)
    return _event(value, step, wall_time)


def mel_to_image(mel: np.ndarray) -> np.ndarray:
    """(frames, n_mels) log-mel → (n_mels, frames, 3) uint8 heatmap
    (low=dark blue, high=yellow; the role of the reference's
    plot_spectrogram helper, utils/__init__.py:184)."""
    m = np.asarray(mel, np.float32).T[::-1]  # mels on y, low freq at bottom
    lo, hi = float(m.min()), float(m.max())
    norm = (m - lo) / (hi - lo + 1e-9)
    r = np.clip(3.0 * norm - 1.0, 0, 1)
    g = np.clip(2.0 * norm - 0.2, 0, 1) * norm
    b = np.clip(1.2 - 2.0 * np.abs(norm - 0.3), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """A (H, W, 3) uint8 image as an 8-bit RGB PNG: the signature, IHDR, one
    zlib-compressed IDAT of unfiltered scanlines, IEND."""
    image = np.ascontiguousarray(image, np.uint8)
    height, width = image.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_image_event(
    tag: str, image: np.ndarray, step: int, wall_time: float
) -> bytes:
    """Summary.Value.image (field 4): PNG-encoded (H, W, 3) uint8."""
    # Summary.Image { height=1, width=2, colorspace=3, encoded_image_string=4 }
    image_proto = (
        _int64_field(1, image.shape[0])
        + _int64_field(2, image.shape[1])
        + _int64_field(3, 3)
        + _bytes_field(4, encode_png(image))
    )
    value = _string_field(1, tag) + _bytes_field(4, image_proto)
    return _event(value, step, wall_time)


class SummaryWriter:
    """Append-only scalar event writer compatible with TensorBoard."""

    def __init__(self, log_dir: Path | str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        filename = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.0"
        )
        self.path = self.log_dir / filename
        self._file = open(self.path, "ab")
        self._write_record(encode_file_version_event(time.time()))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            encode_scalar_event(tag, value, step, time.time())
        )

    def add_scalars(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            if np.isscalar(value) or hasattr(value, "item"):
                self.add_scalar(tag, float(value), step)

    def add_audio(
        self, tag: str, audio: np.ndarray, sample_rate: int, step: int
    ) -> None:
        self._write_record(
            encode_audio_event(tag, audio, sample_rate, step, time.time())
        )

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._write_record(
            encode_image_event(tag, image, step, time.time())
        )

    def add_mel(self, tag: str, mel: np.ndarray, step: int) -> None:
        """Log a (frames, n_mels) spectrogram as a heatmap image."""
        self.add_image(tag, mel_to_image(mel), step)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

"""Preprocessing helpers: statistics scaler, counters, config lock
(counterpart of everyvoice_tpu/preprocessor/helpers.py)."""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np


class Scaler:
    """NaN-aware collector of mean/std/min/max used to z-score pitch and
    energy across the corpus."""

    def __init__(self):
        self._data = []
        self._array = None
        self.min = None
        self.max = None
        self.std = None
        self.mean = None
        self.norm_min = None
        self.norm_max = None

    def __len__(self):
        return len(self._data)

    @property
    def data(self):
        return self._data

    def append(self, value):
        self._data.append(np.asarray(value).reshape(-1))

    def clear_data(self):
        self.__init__()

    def normalize(self, data):
        return (data - self.mean) / self.std

    def denormalize(self, data):
        return (data * self.std) + self.mean

    def calculate_stats(self):
        if not len(self):
            return None
        if self._array is None:
            self._array = np.concatenate(self._data)
        finite = self._array[~np.isnan(self._array)]
        self.min = float(finite.min())
        self.max = float(finite.max())
        self.mean = float(np.nanmean(self._array))
        # ddof=1: the sample standard deviation.
        self.std = float(finite.std(ddof=1)) if finite.size > 1 else 1.0
        self.norm_max = float(self.normalize(self.max))
        self.norm_min = float(self.normalize(self.min))
        return {
            "sample_size": len(self),
            "norm_min": self.norm_min,
            "norm_max": self.norm_max,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "std": self.std,
        }


class Counters:
    """Counters for the preprocessing report (``summary.txt``); thread-safe,
    since the audio step increments them from a thread pool. "nans" stays 0:
    the F0 tracker interpolates unvoiced gaps, so no NaN reaches an
    artifact."""

    FIELDS = (
        "processed_files", "previously_processed_files", "duration", "nans",
        "audio_empty", "audio_too_short", "audio_too_long",
        "skipped_processes", "missing_files", "multichannel", "sox_error",
    )

    def __init__(self):
        self._counters = {f: 0.0 for f in self.FIELDS}
        self._lock = threading.Lock()

    def increment(self, name: str, amount=1):
        with self._lock:
            self._counters[name] += amount

    def value(self, name: str):
        return self._counters[name]

    def as_dict(self) -> dict:
        return dict(self._counters)


CONFIG_LOCK_NAME = ".config-lock"


def write_config_lock(save_dir: Path, config_summary: dict, status: str) -> None:
    """Write the read-only lock file that guards a save directory against a
    run with another configuration or a concurrent run."""
    lock_path = Path(save_dir) / CONFIG_LOCK_NAME
    if lock_path.exists():
        os.chmod(lock_path, 0o644)
    with open(lock_path, "w", encoding="utf8") as f:
        json.dump({"status": status, "config": config_summary}, f, indent=1)
    os.chmod(lock_path, 0o444)


def read_config_lock(save_dir: Path):
    lock_path = Path(save_dir) / CONFIG_LOCK_NAME
    if not lock_path.exists():
        return None
    with open(lock_path, encoding="utf8") as f:
        return json.load(f)

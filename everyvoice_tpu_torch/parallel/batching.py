"""Host-side batch shaping before a batch goes to the card (copy of
everyvoice_tpu/parallel/mesh.py:187-264)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def compress_for_transfer(batch: dict, keys: Sequence[str]) -> dict:
    """Cast the float32 arrays under ``keys`` to float16 on the host, halving
    their bytes to the device; the train step casts them back to float32.
    The rounding is part of the numbers the JAX package trains on."""
    out = dict(batch)
    for key in keys:
        value = out.get(key)
        if value is not None and getattr(value, "dtype", None) == np.float32:
            out[key] = value.astype(np.float16)
    return out


def stack_batches(group: list) -> dict:
    """Stack K same-shape host batches into one (K, batch, ...) batch, for K
    optimizer steps in a row from one transfer."""
    return {k: np.stack([g[k] for g in group]) for k in group[0]}


def pad_batch_for_eval(batch: dict, n_devices: int, batch_size: Optional[int] = None) -> tuple:
    """Pad an evaluation batch up to ``batch_size`` (or to the next device
    multiple) by repeating rows cyclically, and mark which rows are real in
    a ``row_weights`` (1 = real, 0 = pad) float32 array the losses mask pad
    rows out with. Returns (padded_batch, n_true_rows)."""
    first = next(v for v in batch.values() if isinstance(v, np.ndarray))
    b = first.shape[0]
    target = max(batch_size or 0, b, 1)
    if target % n_devices:
        target += n_devices - target % n_devices
    weights = np.zeros(target, np.float32)
    weights[:b] = 1.0
    if target == b:
        return {**batch, "row_weights": weights}, b
    reps = np.arange(target - b) % b
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.shape[:1] == (b,):
            out[key] = np.concatenate([value, value[reps]], axis=0)
        else:
            out[key] = value
    out["row_weights"] = weights
    return out, b


def pad_batch_to_devices(batch: dict, n_devices: int) -> dict:
    """Make the batch axis a multiple of ``n_devices`` by repeating rows
    cyclically (rows are masked by their lengths downstream)."""
    first = next(v for v in batch.values() if isinstance(v, np.ndarray))
    b = first.shape[0]
    remainder = b % n_devices
    if remainder == 0:
        return batch
    reps = np.arange(n_devices - remainder) % b
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.shape[:1] == (b,):
            out[key] = np.concatenate([value, value[reps]], axis=0)
        else:
            out[key] = value
    return out

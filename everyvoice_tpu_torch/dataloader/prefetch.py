"""Background batch prefetching (counterpart of
everyvoice_tpu/dataloader/prefetch.py).

Trainers wrap their batch iterators in ``prefetch``: a daemon thread
assembles upcoming batches (disk reads, padding, the copy to the card)
while the card computes. ``to_device`` copies a host batch through pinned
memory without blocking, so the copy overlaps the step before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Yield from ``iterator``, assembling up to ``size`` items ahead on a
    background thread. An exception on the thread re-raises here; a consumer
    that stops early (``break``) stops the thread too."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch's arrays as tensors on ``device``; other values pass
    through. To a card, each array goes through pinned memory with a
    non-blocking copy (the caching host allocator keeps the pinned block
    until the copy has run)."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            tensor = torch.from_numpy(value)
            if device.type == "cuda":
                tensor = tensor.pin_memory().to(device, non_blocking=True)
            out[key] = tensor
        else:
            out[key] = value
    return out

"""Fixed-size segment sampling for vocoder training (counterpart of
everyvoice_tpu/dsp/segments.py).

Functional like the JAX version: the random starts come from an explicit
``torch.Generator``, and a given start slices exactly as
``jax.lax.dynamic_slice_in_dim`` does, clamped so the window stays inside the
array. The batched sampler draws one start per row within the row's true
length and zeroes whatever the window takes past it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _random_start(high: int, generator: torch.Generator | None) -> int:
    """A start drawn uniformly from [0, high]."""
    return int(torch.randint(0, high + 1, (), generator=generator))


def get_segment(
    t: torch.Tensor,
    segment_size: int,
    generator: torch.Generator | None = None,
    start: int | None = None,
) -> tuple:
    """Slice a (C, T) tensor to (C, segment_size) from ``start`` (or a start
    drawn with ``generator``); a tensor shorter than the segment is
    zero-padded from 0. Returns (segment, start)."""
    t_len = t.shape[-1]
    if t_len < segment_size:
        return F.pad(t, (0, segment_size - t_len)), 0
    max_start = t_len - segment_size
    if start is None:
        if generator is None:
            raise ValueError("give a torch.Generator for a random segment")
        start = _random_start(max_start, generator)
    start = int(start)
    at = min(max(start, 0), max_start)  # dynamic_slice clamps its start
    return t[..., at : at + segment_size], start


def get_segments_batched(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    segment_size: int,
    generator: torch.Generator | None = None,
    axis: int = 1,
    starts: torch.Tensor | None = None,
) -> tuple:
    """One segment of each row of a padded (B, T, ...) batch, sliced along
    ``axis`` within the row's true length: ``starts`` given, or drawn from
    [0, max(length - segment_size, 0)] with ``generator``. Samples past a
    row's length are zeroed. Returns (segments, starts)."""
    b = batch.shape[0]
    t_len = batch.shape[axis]
    lengths = torch.as_tensor(lengths).to(torch.int64).cpu()
    if starts is None:
        if generator is None:
            raise ValueError("give a torch.Generator for random segments")
        starts = torch.tensor([
            _random_start(max(int(n) - segment_size, 0), generator) for n in lengths
        ], dtype=torch.int64)
    else:
        starts = torch.as_tensor(starts).to(torch.int64).cpu()
    rows = []
    shape = [1] * (batch.ndim - 1)
    shape[axis - 1] = segment_size
    steps = torch.arange(segment_size)
    for i in range(b):
        at = min(max(int(starts[i]), 0), t_len - segment_size)
        seg = batch[i].narrow(axis - 1, at, segment_size)
        valid = steps < max(int(lengths[i]) - int(starts[i]), 0)
        rows.append(seg * valid.reshape(shape).to(device=batch.device, dtype=seg.dtype))
    return torch.stack(rows), starts

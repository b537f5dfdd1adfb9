"""The collectives of a multi-device step: what XLA's SPMD partitioner
inserts into the JAX package's step, written out.

- ``data_parallel``/``mean_denominator``: the JAX step's masked means
  divide by counts over the global batch. Inside ``data_parallel(mesh)``
  the losses all-reduce their counts over the batch ranks and divide by the
  count's mean per rank, so each rank's loss is its share of the global
  loss scaled by the number of ranks: their mean, and the mean of their
  gradients, are the global batch's.
- ``copy_to_model_parallel``/``reduce_from_model_parallel``: Megatron's f
  and g around a tensor-parallel block (identity forward and all-reduce
  backward; all-reduce forward and identity backward).
- ``all_reduce_mean``: a bucketed mean of tensors over a group (the
  data-parallel gradient reduction); ``all_gather_dim`` and
  ``reduce_scatter_mean_dim``: a tensor's blocks along one dimension,
  gathered from or reduced onto the group's ranks (ZeRO-3's parameter
  gather and gradient reduce-scatter).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

BUCKET_ELEMENTS = 1 << 24  # 64 MiB of float32 a bucket

_batch = None  # (group, size) of the step in progress, inside data_parallel


def _dist():
    import torch.distributed as dist

    return dist


@contextmanager
def data_parallel(mesh):
    """Within the block the losses' denominators are the global batch's
    (over ``mesh``'s batch ranks); a None mesh, or one batch rank, changes
    nothing."""
    global _batch
    previous = _batch
    _batch = None if mesh is None or mesh.data_size == 1 else (mesh.batch_group, mesh.data_size)
    try:
        yield
    finally:
        _batch = previous


def mean_denominator(count: torch.Tensor, minimum=1) -> torch.Tensor:
    """The denominator of a masked mean whose numerator sums this rank's
    rows: ``max(count, minimum)`` on one process; inside ``data_parallel``
    the global count's ``max(total, minimum)`` over the number of batch
    ranks, so the ranks' mean of the quotients is the global masked mean."""
    if _batch is None:
        return torch.clamp(count, min=minimum)
    group, size = _batch
    total = count.detach().clone()
    _dist().all_reduce(total, group=group)
    return torch.clamp(total, min=minimum) / size


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _dist().all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        _dist().all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over ``group``."""
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group``, its gradient as it is."""
    return _ReduceFromModelParallel.apply(x, group)


def all_reduce_mean(tensors: list, group, size: int) -> list:
    """The mean over ``group``'s ``size`` ranks of each tensor, by buckets
    of one dtype flattened into one all-reduce each."""
    dist = _dist()
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for indices in by_dtype.values():
        bucket, filled = [], 0
        for n, i in enumerate(indices):
            bucket.append(i)
            filled += tensors[i].numel()
            if filled >= BUCKET_ELEMENTS or n == len(indices) - 1:
                flat = torch.cat([tensors[j].reshape(-1) for j in bucket])
                dist.all_reduce(flat, group=group)
                flat /= size
                offset = 0
                for j in bucket:
                    numel = tensors[j].numel()
                    out[j] = flat[offset:offset + numel].view_as(tensors[j])
                    offset += numel
                bucket, filled = [], 0
    return out


def all_gather_dim(shard: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The tensor whose ``size`` blocks along ``dim`` are the group's
    ranks' ``shard``s, in rank order."""
    local = shard.movedim(dim, 0).contiguous()
    out = torch.empty((size * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    _dist().all_gather_into_tensor(out, local, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_mean_dim(full: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the mean over ``group`` of
    ``full``."""
    whole = full.movedim(dim, 0).contiguous()
    out = torch.empty((whole.shape[0] // size,) + tuple(whole.shape[1:]),
                      dtype=whole.dtype, device=whole.device)
    _dist().reduce_scatter_tensor(out, whole, group=group)
    out /= size
    return out.movedim(0, dim).contiguous()


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    _dist().all_reduce(t, group=group)
    return t

"""Parameter layouts on the mesh: data parallel, ZeRO-3 (FSDP) and
Megatron tensor parallelism (counterpart of
everyvoice_tpu/parallel/sharding.py).

A layout is a dict of the sharded parameters' names to a spec in torch's
layout, one entry per dimension: None, ``MODEL_AXIS``, or the batch axes
(``DATA_AXIS``, or ``(NODE_AXIS, DATA_AXIS)`` on a multi-node mesh). A name
absent from it is replicated.

- ``param_shardings`` (``--strategy tp<k>``): the Conformer's feed-forward
  and attention blocks Megatron-style over the model axis, as the JAX
  package's ``FS2_PARAM_RULES``; ``apply_tensor_parallel`` cuts the
  modules' parameters to this rank's shard, and the modules run with local
  heads and all-reduced outputs.
- ``fsdp_shardings`` (``--strategy fsdp``): every parameter of at least
  16,384 elements split on its largest evenly-divisible dimension over the
  batch axes. ``Placement`` keeps this rank's shard of it and of its
  optimizer moments between steps, gathers the whole parameter for a step,
  and reduce-scatters its gradient (a ZeRO-3 at the step's edges, which
  sees the ``torch.autograd.grad`` dicts the trainers take).
- Anything else (``ddp``): replicated, gradients averaged over the batch
  axes.

Checkpoints always hold whole tensors: ``Placement.full`` gathers them.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

from everyvoice_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_reduce_mean,
    all_reduce_sum_,
    reduce_scatter_mean_dim,
)
from everyvoice_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, NODE_AXIS

FSDP_MIN_SIZE = 16_384

# (parameter-name regex, spec in torch's (out, in) layout), first match
# wins. q/k/v's out-features are head-major, so splitting their rows splits
# heads (flax's (dim, heads, head_dim) kernel over heads); the output
# projection and the feed-forward's second dense are row-parallel over
# their input features.
FS2_PARAM_RULES: list = [
    (r"(.*\.)?ff[12]\.fc1\.weight$", (MODEL_AXIS, None)),
    (r"(.*\.)?ff[12]\.fc1\.bias$", (MODEL_AXIS,)),
    (r"(.*\.)?ff[12]\.fc2\.weight$", (None, MODEL_AXIS)),
    (r"(.*\.)?attn\.(query|key|value)\.weight$", (MODEL_AXIS, None)),
    (r"(.*\.)?attn\.(query|key|value)\.bias$", (MODEL_AXIS,)),
    (r"(.*\.)?attn\.out\.weight$", (None, MODEL_AXIS)),
]


def _axis_size(axis, mesh) -> int:
    if axis == MODEL_AXIS:
        return mesh.model_size
    return mesh.data_size


def _spec_fits(spec: tuple, shape: tuple, mesh) -> bool:
    """Every sharded dimension divides its axes' size (otherwise the leaf
    stays replicated)."""
    if len(spec) > len(shape):
        return False
    return all(axis is None or shape[i] % _axis_size(axis, mesh) == 0
               for i, axis in enumerate(spec))


def param_shardings(model: torch.nn.Module, mesh) -> dict:
    """The tensor-parallel layout of ``model``'s parameters by
    ``FS2_PARAM_RULES``; empty on a model axis of one. An attention block
    whose heads do not divide the axis stays replicated."""
    if mesh is None or mesh.model_size == 1:
        return {}
    from everyvoice_tpu_torch.models.layers import MultiHeadAttention

    compiled = [(re.compile(pattern), spec) for pattern, spec in FS2_PARAM_RULES]
    heads = {f"{name}.": m.heads for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)}
    out = {}
    for name, p in model.named_parameters():
        for pattern, spec in compiled:
            if pattern.match(name):
                prefix = name.rsplit(".", 2)[0] + "."
                fits = _spec_fits(spec, tuple(p.shape), mesh) and (
                    prefix not in heads or heads[prefix] % mesh.model_size == 0)
                if fits:
                    out[name] = spec
                break
    return out


def fsdp_shardings(params: dict, mesh) -> dict:
    """The ZeRO-3 layout: each parameter of at least ``FSDP_MIN_SIZE``
    elements split over the batch axes (node×data) on its largest dimension
    that their size divides; smaller ones (biases, norm scales)
    replicated."""
    total = 1 if mesh is None else mesh.data_size
    if total == 1:
        return {}
    axes = (NODE_AXIS, DATA_AXIS) if NODE_AXIS in mesh.axis_names else DATA_AXIS
    out = {}
    for name, p in params.items():
        if p.numel() < FSDP_MIN_SIZE:
            continue
        candidates = [(d, i) for i, d in enumerate(p.shape) if d % total == 0]
        if candidates:
            _, idx = max(candidates)
            spec = [None] * p.dim()
            spec[idx] = axes
            out[name] = tuple(spec)
    return out


def apply_tensor_parallel(model: torch.nn.Module, layout: dict, mesh) -> None:
    """Cut each attention and feed-forward block that ``layout`` shards to
    this rank's shard of the model axis."""
    from everyvoice_tpu_torch.models.layers import FeedForwardModule, MultiHeadAttention

    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, MultiHeadAttention) and f"{prefix}query.weight" in layout:
            module.tensor_parallel(mesh.model_rank, mesh.model_size, mesh.model_group)
        elif isinstance(module, FeedForwardModule) and f"{prefix}fc1.weight" in layout:
            module.tensor_parallel(mesh.model_rank, mesh.model_size, mesh.model_group)


class Placement:
    """One network's trained parameters (``params``, by name) on ``mesh``
    under ``layout``: what the optimizer steps (``owned``: this rank's
    shards of FSDP leaves, the parameters themselves otherwise), the
    gradient reduction, the global norm, and whole tensors for checkpoints.
    Without a mesh every method is the identity, so one code path serves
    one device and many. Under FSDP the whole parameters exist only inside
    ``gathered(placement)``."""

    def __init__(self, params: dict, mesh=None, layout: Optional[dict] = None):
        self.params = params
        self.mesh = mesh
        self.shards: dict = {}  # name -> (dim, group, size, rank)
        self.full_shapes: dict = {}
        self.zero: dict = {}  # FSDP leaves: name -> this rank's shard
        for name, spec in (layout or {}).items():
            dim = next(i for i, axis in enumerate(spec) if axis is not None)
            p = params[name]
            if spec[dim] == MODEL_AXIS:  # the parameter is the local shard already
                group = (mesh.model_group, mesh.model_size, mesh.model_rank)
                shape = list(p.shape)
                shape[dim] *= mesh.model_size
            else:
                group = (mesh.batch_group, mesh.data_size, mesh.data_rank)
                shape = list(p.shape)
                per = shape[dim] // mesh.data_size
                self.zero[name] = p.detach().narrow(dim, mesh.data_rank * per, per).clone()
            self.shards[name] = (dim,) + group
            self.full_shapes[name] = torch.Size(shape)
        self.owned = {n: self.zero.get(n, p) for n, p in params.items()}
        self.release()

    # -- ZeRO-3 --------------------------------------------------------------
    @torch.no_grad()
    def gather(self) -> None:
        """Whole FSDP parameters from every rank's shard."""
        for name, shard in self.zero.items():
            dim, group, size, _ = self.shards[name]
            self.params[name].data = all_gather_dim(shard, dim, group, size)

    def release(self) -> None:
        """Free the whole FSDP parameters (and their gradients)."""
        for name in self.zero:
            p = self.params[name]
            p.grad = None
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # -- the step ----------------------------------------------------------
    def reduce_grads(self, grads: dict) -> dict:
        """Gradients in ``owned``'s shapes, averaged over the batch ranks:
        one bucketed all-reduce for the whole leaves, a reduce-scatter for
        each FSDP leaf (a missing gradient counts as zeros). With one batch
        rank nothing is reduced: ``grads`` as they are."""
        if self.mesh is None or self.mesh.data_size == 1:
            return grads
        mesh = self.mesh
        g = {n: grads[n] if grads.get(n) is not None else torch.zeros(
                 self.full_shapes[n] if n in self.zero else p.shape, dtype=p.dtype,
                 device=p.device)
             for n, p in self.params.items()}
        dense = [n for n in self.params if n not in self.zero]
        out = dict(zip(dense, all_reduce_mean([g[n] for n in dense], mesh.batch_group,
                                              mesh.data_size)))
        for name in self.zero:
            dim, group, size, _ = self.shards[name]
            out[name] = reduce_scatter_mean_dim(g[name], dim, group, size)
        return out

    def global_norm(self, norms: dict) -> torch.Tensor:
        """The global norm from each owned leaf's local norm: the sharded
        leaves' squares summed over their groups, each replicated leaf once."""
        replicated = [v for n, v in norms.items() if n not in self.shards]
        total = torch.stack(replicated).square().sum() if replicated else None
        by_group: dict = {}
        for name, (_, group, _, _) in self.shards.items():
            by_group.setdefault(id(group), (group, []))[1].append(norms[name])
        for group, values in by_group.values():
            part = all_reduce_sum_(torch.stack(values).square().sum(), group)
            total = part if total is None else total + part
        return torch.sqrt(total)

    @property
    def norm_fn(self):
        """``global_norm`` where a leaf is sharded, else None (the
        optimizer's own norm)."""
        return self.global_norm if self.shards else None

    # -- whole tensors -----------------------------------------------------
    def full(self, named: dict) -> dict:
        """``named`` (parameters, a state dict or moments) with each sharded
        entry that is not whole gathered from the ranks' shards."""
        out = dict(named)
        for name, (dim, group, size, _) in self.shards.items():
            if name in out and out[name].shape != self.full_shapes[name]:
                out[name] = all_gather_dim(out[name], dim, group, size)
        return out

    def local(self, named: dict) -> dict:
        """Whole tensors (a restored optimizer state's moments) cut to this
        rank's shards."""
        out = dict(named)
        for name, (dim, _, size, rank) in self.shards.items():
            if name in out and out[name].shape == self.full_shapes[name]:
                per = out[name].shape[dim] // size
                out[name] = out[name].narrow(dim, rank * per, per).contiguous()
        return out


@contextmanager
def gathered(*placements):
    """Each placement's whole parameters inside the block (FSDP)."""
    for placement in placements:
        placement.gather()
    try:
        yield
    finally:
        for placement in placements:
            placement.release()


def shard_params(params: dict, mesh, model: Optional[torch.nn.Module] = None,
                 fsdp: bool = False) -> Placement:
    """Place one network's parameters on the mesh: ZeRO-3 over the batch
    axes when ``fsdp``; else tensor-parallel by ``FS2_PARAM_RULES`` over
    the model axis where ``model`` is given and the axis is larger than one
    (its blocks cut in place, ``params`` re-read from it); replicated
    otherwise."""
    if mesh is None:
        return Placement(params)
    if fsdp:
        return Placement(params, mesh, fsdp_shardings(params, mesh))
    if model is None:
        return Placement(params, mesh)
    layout = param_shardings(model, mesh)
    apply_tensor_parallel(model, layout, mesh)
    current = dict(model.named_parameters())
    return Placement({n: current[n] for n in params}, mesh, layout)


def _map_moments(state: dict, fn) -> dict:
    """``state`` (an ``Optimizer``'s, or ``{group: state}``) with ``fn``
    applied to its moment dicts."""
    if "nu" in state:
        return {**state, **{k: fn(state[k]) for k in ("mu", "nu") if k in state}}
    return {k: _map_moments(v, fn) for k, v in state.items()}


def shard_opt_state_like(opt_state: dict, placement: Placement) -> dict:
    """An optimizer state of whole tensors (restored from a checkpoint) in
    the parameters' layouts."""
    return _map_moments(opt_state, placement.local)


def fresh_sharded_opt_state(optimizer, placement: Placement) -> dict:
    """A zero-initialised optimizer state in the parameters' layouts."""
    return optimizer.init(placement.owned)


def full_opt_state(opt_state: dict, placement: Placement) -> dict:
    """The optimizer state with whole moments, for a checkpoint (every rank
    joins the gathers)."""
    return _map_moments(opt_state, placement.full)


class Strategy(NamedTuple):
    """Resolved --strategy: model-parallel degree + FSDP flag."""

    model_parallel: int = 1
    fsdp: bool = False


def parse_strategy(strategy: str) -> Strategy:
    """The reference CLI's --strategy: 'ddp'/'auto'/'' data parallel;
    'tp<k>' or 'ddp_tp<k>' k-way tensor parallelism over the model axis;
    'fsdp' ZeRO-3 parameter and optimizer-state sharding over the batch
    axes. Anything else is an error."""
    if not strategy:
        return Strategy()
    text = strategy.strip().lower()
    if text in ("ddp", "auto"):
        return Strategy()
    if text == "fsdp":
        return Strategy(model_parallel=1, fsdp=True)
    match = re.fullmatch(r"(?:ddp_)?tp(\d+)", text)
    if match:
        return Strategy(model_parallel=max(int(match.group(1)), 1))
    raise ValueError(
        f"Unknown --strategy {strategy!r}; expected ddp, auto, fsdp, "
        "tp<k>, or ddp_tp<k>."
    )

"""The device mesh of a multi-device run (counterpart of
everyvoice_tpu/parallel/mesh.py).

One process drives one device. The processes form one ``torch.distributed``
group, NCCL on CUDA cards and gloo on the CPU, arranged as a
``DeviceMesh`` of shape (data, model), or (node, data, model) with
``--nodes``: the model axis innermost, so a tensor-parallel group is
adjacent ranks. The batch splits over the (node×)data ranks, each taking
its own rows of the global batch; the model axis holds tensor-parallel
shards (``sharding.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
NODE_AXIS = "node"

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT = timedelta(minutes=30)


def coordinator_address(address: Optional[str] = None) -> str:
    """``host:port`` of rank 0: ``address``, else
    ``EVERYVOICE_COORDINATOR_ADDRESS``, else ``MASTER_ADDR:MASTER_PORT``
    (127.0.0.1:12355 by default)."""
    return address or os.environ.get("EVERYVOICE_COORDINATOR_ADDRESS") or "{}:{}".format(
        os.environ.get("MASTER_ADDR", "127.0.0.1"), os.environ.get("MASTER_PORT", "12355"))


def node_rank_from_env(node_rank: Optional[int] = None) -> int:
    """This node's index: ``node_rank``, else ``EVERYVOICE_NODE_RANK``,
    else ``NODE_RANK``, else 0."""
    if node_rank is not None:
        return int(node_rank)
    return int(os.environ.get("EVERYVOICE_NODE_RANK", os.environ.get("NODE_RANK", "0")))


def launcher_rank() -> Optional[tuple]:
    """(rank, world size, local rank) where a launcher such as torchrun
    started this process (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
    else None."""
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                int(os.environ["LOCAL_RANK"]))
    return None


def init_distributed(device_type: str, rank: int = 0, world_size: int = 1,
                     local_rank: int = 0, address: Optional[str] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` (a group a
    launcher set up in the environment takes precedence) and return this
    rank's device: ``cuda:<local rank>`` or the CPU. The backend is NCCL for
    the card and gloo for the CPU; a group of one needs no coordinator, and
    a group this process joined before (a launcher's or the caller's) is
    used as it is."""
    import torch.distributed as dist

    backend = BACKENDS[device_type]
    joined = launcher_rank()
    if joined is not None:
        rank, world_size, local_rank = joined
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    if dist.is_initialized():
        return device
    if joined is not None:
        dist.init_process_group(backend, timeout=TIMEOUT)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address(address)}",
                                rank=rank, world_size=world_size, timeout=TIMEOUT)
    return device


def resolve_devices(accelerator: Optional[str] = None, devices="auto") -> list:
    """This node's devices for ``--accelerator``/``--devices``: 'cuda' (or
    None, the default) the visible cards, 'cpu' that many gloo ranks on the
    CPU (one for 'auto'). A card asked for where there is none is an error;
    nothing drops to the CPU."""
    kind = accelerator or "cuda"
    if kind not in BACKENDS:
        raise ValueError(f"Unsupported accelerator {accelerator!r}: expected cuda or cpu")
    count = None if devices in ("auto", None) else int(devices)
    if count is not None and count < 1:
        raise ValueError(f"--devices {devices}: expected a positive count")
    if kind == "cpu":
        return [torch.device("cpu")] * (count or 1)
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if present == 0:
        raise RuntimeError(
            "everyvoice_tpu_torch runs on a CUDA card by default and none is available "
            "(available platforms: cpu); pass device='cpu' to run on the CPU")
    if count is not None and count > present:
        raise RuntimeError(f"--devices {count} was requested but this host has {present} "
                           "CUDA card(s)")
    return [torch.device("cuda", i) for i in range(count or present)]


@dataclass
class Mesh:
    """This rank's view of the mesh: its device, the axes' names and sizes,
    and the process groups of the batch axes (node×data) and the model
    axis that its collectives run over."""

    device: torch.device
    axis_names: tuple
    shape: tuple
    rank: int
    device_mesh: object
    batch_group: object
    model_group: object
    backend: str = ""  # the group's: nccl or gloo
    owns_group: bool = False  # this process joined the group in setup_mesh

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    @property
    def model_size(self) -> int:
        return self.shape[-1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        """Ranks the batch splits over: node × data."""
        return self.world // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(device: torch.device, model_parallel: int = 1, nodes: int = 1) -> Mesh:
    """The (data, model) mesh, or (node, data, model) when ``nodes`` > 1,
    over the joined process group; ``device`` is this rank's. The data size
    is what the world leaves: world / (model_parallel · nodes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    per = model_parallel * max(nodes, 1)
    if world % per:
        raise ValueError(f"{world} ranks do not split into {max(nodes, 1)} node(s) × "
                         f"tensor-parallel groups of {model_parallel}")
    data = world // per
    if nodes > 1:
        names, shape = (NODE_AXIS, DATA_AXIS, MODEL_AXIS), (nodes, data, model_parallel)
    else:
        names, shape = (DATA_AXIS, MODEL_AXIS), (data, model_parallel)
    device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
    model_group = device_mesh.get_group(MODEL_AXIS)
    if nodes > 1:
        # the batch axes flattened: one group per model index, every rank
        # creating every group in the same order
        batch_group = None
        for m in range(model_parallel):
            group = dist.new_group(list(range(m, world, model_parallel)))
            if rank % model_parallel == m:
                batch_group = group
    else:
        batch_group = device_mesh.get_group(DATA_AXIS)
    return Mesh(device, names, shape, rank, device_mesh, batch_group, model_group,
                str(dist.get_backend()))


def setup_mesh(accelerator: Optional[str] = None, devices="auto", nodes: int = 1,
               model_parallel: int = 1, local_rank: int = 0, node_rank: Optional[int] = None,
               address: Optional[str] = None) -> Mesh:
    """Join the group as device ``local_rank`` of this node (``--devices``
    per node, as Lightning counts them) and build the training mesh."""
    import torch.distributed as dist

    per_node = len(resolve_devices(accelerator, devices))
    rank = node_rank_from_env(node_rank) * per_node + local_rank
    owns = not dist.is_initialized()
    device = init_distributed(accelerator or "cuda", rank, per_node * max(nodes, 1),
                              local_rank, address)
    mesh = make_mesh(device, model_parallel, nodes)
    mesh.owns_group = owns
    return mesh


def teardown(mesh: Optional[Mesh]) -> None:
    """Leave the process group where ``setup_mesh`` joined it. A trainer of
    a one-rank mesh calls no collective (one batch rank reduces nothing),
    so it goes on working after its group is left."""
    import torch.distributed as dist

    if mesh is not None and mesh.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def local_rows(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This rank's rows of a host batch (in place of the JAX package's
    ``shard_batch``; the trainers take them before stacking batches for
    ``--steps-per-execution``, in place of ``shard_stacked_batch``): arrays
    whose leading axis is the batch split it into data-size equal blocks
    and keep block ``data_rank``; the rest pass through. The batch's size
    must divide (``pad_batch_to_devices``)."""
    if mesh is None or mesh.data_size == 1:
        return batch
    first = next(v for v in batch.values() if isinstance(v, np.ndarray))
    b = first.shape[0]
    per = b // mesh.data_size
    lo = mesh.data_rank * per
    return {k: v[lo:lo + per] if isinstance(v, np.ndarray) and v.shape[:1] == (b,) else v
            for k, v in batch.items()}


"""One worker process per device of this node (the role of Lightning's DDP
launcher): ``launch(worker, args, ...)`` runs ``worker(local_rank,
coordinator, *args)`` in as many processes as ``--devices`` names, started
with ``spawn``, and returns when all have finished. A worker's failure
stops the others and raises here. Under a launcher that started the
process itself (torchrun: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and
for one device, the worker runs in this process.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch

from everyvoice_tpu_torch.parallel.mesh import coordinator_address, launcher_rank, resolve_devices


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run(local_rank: int, worker, coordinator: str, threads: int, args: tuple):
    if threads:
        torch.set_num_threads(threads)
    worker(local_rank, coordinator, *args)


def launch(worker, args: tuple = (), accelerator: Optional[str] = None, devices="auto",
           nodes: int = 1) -> None:
    """Run ``worker(local_rank, coordinator, *args)`` once per device of
    this node. ``coordinator`` is rank 0's ``host:port``: the
    environment's with ``nodes`` > 1 (``mesh.coordinator_address``), else a
    free localhost port. CPU ranks share the host's cores evenly."""
    joined = launcher_rank()
    if joined is not None:
        worker(joined[2], coordinator_address(), *args)
        return
    per_node = len(resolve_devices(accelerator, devices))
    if nodes > 1:
        coordinator = coordinator_address()
    else:
        coordinator = f"127.0.0.1:{free_port()}"
    if per_node == 1:
        worker(0, coordinator, *args)
        return
    threads = max(1, (os.cpu_count() or 1) // per_node) if accelerator == "cpu" else 0
    import torch.multiprocessing as mp

    mp.start_processes(_run, args=(worker, coordinator, threads, args), nprocs=per_node,
                       join=True, start_method="spawn")

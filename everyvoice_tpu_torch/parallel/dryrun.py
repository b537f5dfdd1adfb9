"""One FastSpeech2 training step on an n-rank dp×tp mesh (the port's twin of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``): a small
model (dim 64, one Conformer layer each side), tensor parallel over 2 ranks
when n is even, data parallel over the rest, a global batch of 2n rows.

    python -m everyvoice_tpu_torch.parallel.dryrun 4              # 4 cards
    python -m everyvoice_tpu_torch.parallel.dryrun 4 --accelerator cpu  # gloo
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

SMALL = {"encoder": {"layers": 1, "heads": 2, "input_dim": 64, "feedforward_dim": 128},
         "decoder": {"layers": 1, "heads": 2, "input_dim": 64, "feedforward_dim": 128},
         "variance_predictors": {k: {"n_layers": 1, "input_dim": 64}
                                 for k in ("pitch", "energy", "duration")},
         "max_length": 64}


def _batch(b: int, n_text: int = 16, n_frames: int = 64, n_mels: int = 80) -> dict:
    return {
        "text": np.random.default_rng(0).integers(2, 64, (b, n_text)).astype(np.int64),
        "text_lengths": np.full((b,), n_text, np.int64),
        "mel": np.random.default_rng(1).standard_normal((b, n_frames, n_mels)).astype(np.float32),
        "mel_lengths": np.full((b,), n_frames, np.int64),
        "pitch": np.zeros((b, n_frames), np.float32),
        "energy": np.zeros((b, n_frames), np.float32),
        "attn_prior": np.full((b, n_frames, n_text), 1.0 / n_text, np.float32),
        "speaker_id": np.zeros((b,), np.int64),
        "language_id": np.zeros((b,), np.int64),
    }


def _step(local_rank: int, coordinator: str, n_devices: int, accelerator: Optional[str]) -> None:
    import torch.distributed as dist

    from everyvoice_tpu_torch.config import fs2_config
    from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
    from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
    from everyvoice_tpu_torch.models.layers import set_dropout_generator
    from everyvoice_tpu_torch.parallel import (
        data_parallel,
        fresh_sharded_opt_state,
        local_rows,
        setup_mesh,
        shard_params,
        teardown,
    )
    from everyvoice_tpu_torch.train.loop import TrainerBase, init_fs2_parameters
    from everyvoice_tpu_torch.train.optim import build_optimizer

    model_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = setup_mesh(accelerator, n_devices, 1, model_parallel, local_rank, address=coordinator)
    try:
        model = FastSpeech2.from_config(fs2_config({"model": SMALL}), n_symbols=64)
        init_fs2_parameters(model, torch.Generator().manual_seed(0))
        model.to(mesh.device)
        # masks differ across the batch ranks and agree across a tensor-parallel group
        set_dropout_generator(model, torch.Generator(mesh.device).manual_seed(mesh.data_rank))
        placement = shard_params(dict(model.named_parameters()), mesh, model=model)
        optimizer = build_optimizer({"name": "adamw", "learning_rate": 1e-4, "eps": 1e-8,
                                     "weight_decay": 1e-4, "betas": [0.9, 0.999]})
        state = fresh_sharded_opt_state(optimizer, placement)
        rows = {k: torch.from_numpy(v).to(mesh.device)
                for k, v in local_rows(_batch(2 * n_devices), mesh).items()}
        kwargs = {k: rows[k] for k in ("mel", "mel_lengths", "pitch", "energy", "speaker_id",
                                       "language_id", "attn_prior")}
        model.train()
        with data_parallel(mesh):
            losses = compute_fs2_losses(model(rows["text"], rows["text_lengths"], **kwargs),
                                        rows, {})
            losses["total"].backward()
            grads = {n: p.grad for n, p in placement.params.items()}
            norm = TrainerBase._update(optimizer, placement, grads, state)
        total = losses["total"].detach().clone()
        dist.all_reduce(total, group=mesh.batch_group)
        total /= mesh.data_size
        if not (torch.isfinite(total) and torch.isfinite(norm)):
            raise RuntimeError(f"non-finite step: loss {float(total)}, grad norm {float(norm)}")
        if mesh.is_main:
            print(f"dryrun: {n_devices} ranks, mesh {dict(zip(mesh.axis_names, mesh.shape))} "
                  f"({mesh.backend}), {len(placement.shards)} tensor-parallel leaves, "
                  f"loss {float(total):.4f}, grad norm {float(norm):.4f}", flush=True)
    finally:
        teardown(mesh)


def dryrun_multichip(n_devices: int, accelerator: Optional[str] = None) -> None:
    """One sharded training step on ``n_devices`` ranks (cards by default,
    gloo ranks on the CPU with ``accelerator="cpu"``)."""
    from everyvoice_tpu_torch.parallel.launch import launch

    launch(_step, (n_devices, accelerator), accelerator, n_devices)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--accelerator", choices=("cuda", "cpu"), default=None)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.accelerator)


if __name__ == "__main__":
    main()

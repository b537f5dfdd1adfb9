"""Train FastSpeech2 from preprocessed artifacts: the port's counterpart of
``everyvoice-tpu train text-to-spec`` (everyvoice_tpu/cli.py:367-397),
without click.

    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec
    trainer = train_text_to_spec(config)  # a config dict; the CUDA card

The config is a FastSpeech2 config as a dict (the JAX package's YAML
config, loaded); ``config_args`` are ``key.path=value`` overrides, as the
CLI's ``-c``. It reads the training and validation filelists and
``<save_dir>/stats.json`` that preprocessing wrote, and checkpoints into
the logger's run directory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

from everyvoice_tpu_torch.config import apply_overrides, fs2_training_config
from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.text.lookups import lookuptables_from_data
from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
from everyvoice_tpu_torch.utils import resolve_filelist_loader


def text_to_spec_trainer(
    config: dict,
    config_args: Sequence[str] = (),
    gradient_clip_val: Optional[float] = None,
    compute_precision: str = "auto",
    device=None,
    mesh=None,
    fsdp: bool = False,
) -> FastSpeech2Trainer:
    """The trainer ``train_text_to_spec`` fits, on its datasets, before
    ``fit``."""
    device = resolve_device(device) if mesh is None else mesh.device
    config = fs2_training_config(apply_overrides(config, config_args))
    t = config["training"]
    load = resolve_filelist_loader(t["filelist_loader"])
    train_list = load(t["training_filelist"])
    val_list = load(t["validation_filelist"])
    lang2id, speaker2id = lookuptables_from_data((train_list, val_list))
    ds = FastSpeech2Dataset(train_list, config, lang2id, speaker2id)
    vds = FastSpeech2Dataset(val_list, config, lang2id, speaker2id,
                             text_processor=ds.text_processor)
    stats_path = Path(config["preprocessing"]["save_dir"]) / "stats.json"
    stats = json.loads(stats_path.read_text()) if stats_path.exists() else {}
    return FastSpeech2Trainer(
        config, ds, vds, lang2id, speaker2id, stats=stats,
        gradient_clip_val=gradient_clip_val, compute_dtype=compute_precision, device=device,
        mesh=mesh, fsdp=fsdp,
    )


def train_text_to_spec(
    config: dict,
    config_args: Sequence[str] = (),
    gradient_clip_val: Optional[float] = None,
    profile_steps: int = 0,
    steps_per_execution: int = 1,
    compute_precision: str = "auto",
    device=None,
    log_every: int = 10,
    mesh=None,
    fsdp: bool = False,
) -> FastSpeech2Trainer:
    """Train a FastSpeech2 model and return its trainer (checkpoints under
    ``trainer.ckpt_dir``). Runs on the CUDA card unless ``device`` names
    the CPU; raises without a card. On a ``mesh`` (``parallel.setup_mesh``)
    this process trains as one of its ranks, ``fsdp`` sharding the
    parameters and optimizer state."""
    trainer = text_to_spec_trainer(config, config_args, gradient_clip_val, compute_precision,
                                   device, mesh, fsdp)
    trainer.fit(log_every=log_every, profile_steps=profile_steps,
                steps_per_execution=steps_per_execution)
    return trainer

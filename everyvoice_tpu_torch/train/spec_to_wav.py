"""Train a HiFiGAN vocoder from preprocessed artifacts: the port's
counterpart of ``everyvoice-tpu train spec-to-wav``
(everyvoice_tpu/cli.py:400-424), without click.

    from everyvoice_tpu_torch.train.spec_to_wav import train_spec_to_wav
    trainer = train_spec_to_wav(config)  # a config dict; the CUDA card

The config is a HiFiGAN config as a dict (the JAX package's YAML config,
loaded); ``config_args`` are ``key.path=value`` overrides, as the CLI's
``-c``. It reads the training and validation filelists, the spectrograms
(``spec/``, or ``synthesized_spec/`` under ``training.finetune``) and the
audio that preprocessing wrote, and checkpoints into the logger's run
directory.
"""

from __future__ import annotations

from typing import Optional, Sequence

from everyvoice_tpu_torch.config import apply_overrides, hifigan_training_config
from everyvoice_tpu_torch.dataloader import HiFiGANDataset
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.train.loop import HiFiGANTrainer
from everyvoice_tpu_torch.utils import resolve_filelist_loader


def spec_to_wav_trainer(
    config: dict,
    config_args: Sequence[str] = (),
    gradient_clip_val: Optional[float] = None,
    compute_precision: str = "auto",
    device=None,
    mesh=None,
    fsdp: bool = False,
) -> HiFiGANTrainer:
    """The trainer ``train_spec_to_wav`` fits, on its datasets, before
    ``fit``."""
    device = resolve_device(device) if mesh is None else mesh.device
    config = hifigan_training_config(apply_overrides(config, config_args))
    t = config["training"]
    load = resolve_filelist_loader(t["filelist_loader"])
    ds = HiFiGANDataset(load(t["training_filelist"]), config, finetune=t["finetune"])
    vds = HiFiGANDataset(load(t["validation_filelist"]), config, finetune=t["finetune"])
    return HiFiGANTrainer(config, ds, vds, gradient_clip_val=gradient_clip_val,
                          compute_dtype=compute_precision, device=device, mesh=mesh, fsdp=fsdp)


def train_spec_to_wav(
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
) -> HiFiGANTrainer:
    """Train a HiFiGAN (or iSTFTNet) vocoder and return its trainer
    (checkpoints under ``trainer.ckpt_dir``). Runs on the CUDA card unless
    ``device`` names the CPU; raises without a card. On a ``mesh``
    (``parallel.setup_mesh``) this process trains as one of its ranks,
    ``fsdp`` sharding the parameters and optimizer state."""
    trainer = spec_to_wav_trainer(config, config_args, gradient_clip_val, compute_precision,
                                  device, mesh, fsdp)
    trainer.fit(log_every=log_every, profile_steps=profile_steps,
                steps_per_execution=steps_per_execution)
    return trainer

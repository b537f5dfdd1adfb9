"""Train StyleTTS2 from preprocessed artifacts: the port's counterpart of
``everyvoice-tpu train text-to-wav --mode first|second``
(everyvoice_tpu/cli.py:427-452), without click.

    from everyvoice_tpu_torch.train.text_to_wav import train_text_to_wav
    trainer = train_text_to_wav(config, mode="first")   # the CUDA card
    trainer = train_text_to_wav(config, mode="second")  # picks up stage 1

The config is a StyleTTS2 config as a dict (the JAX package's YAML config,
loaded); ``config_args`` are ``key.path=value`` overrides, as the CLI's
``-c``. It reads the training and validation filelists that preprocessing
wrote (the language table from both) and checkpoints into the logger's run
directory.
"""

from __future__ import annotations

from typing import Optional, Sequence

from everyvoice_tpu_torch.config import apply_overrides, styletts2_config
from everyvoice_tpu_torch.dataloader import StyleTTS2Dataset
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
from everyvoice_tpu_torch.text.lookups import lookuptables_from_data
from everyvoice_tpu_torch.utils import resolve_filelist_loader


def train_text_to_wav(
    config: dict,
    config_args: Sequence[str] = (),
    mode: str = "first",
    gradient_clip_val: Optional[float] = None,
    profile_steps: int = 0,
    steps_per_execution: int = 1,
    compute_precision: str = "auto",
    device=None,
    log_every: int = 10,
    mesh=None,
    fsdp: bool = False,
) -> StyleTTS2Trainer:
    """Train one StyleTTS2 stage and return its trainer (checkpoints under
    ``trainer.ckpt_dir``). Runs on the CUDA card unless ``device`` names
    the CPU; raises without a card. On a ``mesh`` (``parallel.setup_mesh``)
    this process trains as one of its ranks, ``fsdp`` sharding the
    parameters and optimizer state."""
    device = resolve_device(device) if mesh is None else mesh.device
    config = styletts2_config(apply_overrides(config, config_args))
    t = config["training"]
    load = resolve_filelist_loader(t["filelist_loader"])
    train_list = load(t["training_filelist"])
    val_list = load(t["validation_filelist"])
    lang2id, _ = lookuptables_from_data((train_list, val_list))
    ds = StyleTTS2Dataset(train_list, config)
    vds = StyleTTS2Dataset(val_list, config, text_processor=ds.text_processor)
    trainer = StyleTTS2Trainer(config, ds, vds, lang2id=lang2id, mode=mode,
                               gradient_clip_val=gradient_clip_val,
                               compute_dtype=compute_precision, device=device,
                               mesh=mesh, fsdp=fsdp)
    trainer.fit(log_every=log_every, profile_steps=profile_steps,
                steps_per_execution=steps_per_execution)
    return trainer

"""Checkpoint IO shared with the JAX package, FastSpeech2 training
(``loop.FastSpeech2Trainer``, ``text_to_spec.train_text_to_spec``) and
HiFiGAN training (``loop.HiFiGANTrainer``, ``spec_to_wav.train_spec_to_wav``)."""

from everyvoice_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_checkpoint_header,
    save_checkpoint,
)

"""Checkpoint IO shared with the JAX package."""

from everyvoice_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_checkpoint_header,
    save_checkpoint,
)

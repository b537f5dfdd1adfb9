"""Reading published weights without ``transformers``: ``to_numpy`` for a
state dict's values, and ``read_hf_state_dict`` for a HuggingFace model
directory's weights (``pytorch_model.bin``, else ``model.safetensors``).

``pytorch_model.bin`` loads with ``torch.load(weights_only=True)``, as
``transformers``' ``from_pretrained`` loads it: the file is a plain state
dict of tensors, and a pickle that carries anything else is refused rather
than run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else x)


def read_hf_state_dict(path) -> dict:
    """The state dict of a HuggingFace model directory: ``pytorch_model.bin``
    (tensors only) or else ``model.safetensors`` (numpy arrays)."""
    path = Path(path)
    if (path / "pytorch_model.bin").is_file():
        return torch.load(str(path / "pytorch_model.bin"), map_location="cpu", weights_only=True)
    if (path / "model.safetensors").is_file():
        from everyvoice_tpu_torch.utils.safetensors_lite import load_file

        return load_file(path / "model.safetensors")
    raise FileNotFoundError(f"{path} has neither pytorch_model.bin nor model.safetensors")

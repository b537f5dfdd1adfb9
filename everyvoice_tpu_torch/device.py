"""Device resolution for the port's entry points.

``device=None`` means the CUDA card. Without one the entry points raise: they
never drop to the CPU unless the caller asks for it (``device="cpu"``, as the
tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on; raises where CUDA is asked
    for (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "everyvoice_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev}: expected cuda or cpu")
    return dev

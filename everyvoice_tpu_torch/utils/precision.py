"""Compute-precision policy for serving (counterpart of
everyvoice_tpu/utils/precision.py).

Convolutions and matmuls may run in bfloat16 while parameters, norm
statistics and heads stay float32. 'auto' resolves to bfloat16 on a CUDA
device and to float32 on the CPU, so CPU runs keep exact reference numerics.
Float32 work on a card is full float32: the model forwards run under
``no_tf32``, since cuDNN convolutions default to TF32 otherwise.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block
    (and inside a function it decorates), so float32 work on a card keeps
    float32 precision in either compute dtype (norms and heads stay float32
    under bfloat16 too). The caller's flags come back afterwards."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def resolve_compute_dtype(requested: str = "auto", device=None) -> str:
    """Resolve an 'auto'/'float32'/'bfloat16' request to a concrete dtype
    name for computations on ``device``."""
    if requested != "auto":
        if requested not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unsupported compute dtype {requested!r}: expected 'auto', "
                "'float32', or 'bfloat16'"
            )
        return requested
    dev = torch.device("cuda" if device is None else device)
    return "bfloat16" if dev.type == "cuda" else "float32"


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]

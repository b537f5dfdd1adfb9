"""A reader of the ``.safetensors`` format on the standard library and
numpy, for a machine without the ``safetensors`` package (as
``msgpack_lite`` stands in for msgpack).

The format: an unsigned little-endian 64-bit header length, that many
bytes of a JSON header mapping each tensor's name to its ``dtype``,
``shape`` and ``data_offsets`` (begin, end) into the byte buffer that
follows, and an optional ``__metadata__`` entry of strings. ``load_file``
returns ``{name: numpy array}``; bfloat16 tensors come back as float32 (numpy
has no bfloat16), every other type as itself.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
          "U16": np.uint16, "U32": np.uint32, "U64": np.uint64}


def load_file(path) -> dict:
    """Every tensor of a ``.safetensors`` file, as numpy arrays."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n].decode("utf8"))
    buffer = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = buffer[begin:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        else:
            dtype = np.dtype(DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    return out

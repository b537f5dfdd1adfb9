"""EVTP checkpoints, read and written without flax or msgpack (counterpart
of everyvoice_tpu/train/checkpoint.py).

Layout: 4-byte magic 'EVTP' | 8-byte little-endian header length | JSON
header | msgpack body. The body is ``{"state_dict": tree}`` (plus
``"optimizer_states"`` for training checkpoints, in the layout of
``flax.serialization.to_state_dict`` of the optax state), each tree a nested
dict of numpy arrays in flax's ndarray extension encoding. Both packages
read each other's files. ``resume_mode`` is the JAX package's three-way
resume gate.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from everyvoice_tpu_torch.utils import msgpack_lite

MAGIC = b"EVTP"
FORMAT_VERSION = "1.0"


class InvalidConfiguration(Exception):
    """A configuration combination is invalid (the JAX package's
    ``everyvoice_tpu.exceptions.InvalidConfiguration``)."""


def _check_format_version(header: dict, path) -> None:
    """Refuse a checkpoint written by a newer major format; a missing version
    means the oldest format and is accepted."""
    version = str(header.get("model_info", {}).get("version", "0.0"))
    try:
        major = int(version.split(".")[0])
    except ValueError:
        raise ValueError(
            f"{path} declares an unparseable checkpoint version {version!r}"
        ) from None
    if major > 1:
        raise ValueError(
            f"{path} was saved by a newer everyvoice_tpu (checkpoint format "
            f"{version}); upgrade this installation to load it."
        )


def _read_header(f, path) -> dict:
    if f.read(4) != MAGIC:
        raise ValueError(f"{path} is not an everyvoice_tpu checkpoint")
    (header_len,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(header_len).decode("utf8"))
    _check_format_version(header, path)
    return header


def load_checkpoint_header(path: Path | str) -> dict:
    """Only the JSON header (no tensor IO)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def _unchunk(tree):
    """Undo flax's splitting of arrays above 1 GiB into chunk dicts."""
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_checkpoint(path: Path | str) -> dict:
    """Header dict plus 'state_dict' (and 'optimizer_states' if present)."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
        body = msgpack_lite.unpackb(f.read())
    out = dict(header)
    out.update(_unchunk(body))
    return out


def _numpy_tree(tree):
    """Keys sorted and leaves as numpy arrays, as the JAX package's writer
    leaves a tree (``jax.tree.map(np.asarray, ...)``), so both packages
    write the same bytes for the same parameters."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(tree[k]) for k in sorted(tree)}
    return np.asarray(tree)


def save_checkpoint(
    path: Path | str,
    model_name: str,
    config: dict,
    params: dict,
    step: int = 0,
    epoch: int = 0,
    opt_state: Optional[dict] = None,
    lang2id: Optional[dict] = None,
    speaker2id: Optional[dict] = None,
    stats: Optional[dict] = None,
) -> Path:
    """Write ``params`` (a nested dict of numpy arrays in the JAX package's
    layout), and ``opt_state`` (the optax state dict layout) if given, with a
    header the JAX package's ``load_checkpoint`` accepts."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "model_info": {"name": model_name, "version": FORMAT_VERSION},
        "hyper_parameters": {
            "config": config,
            "lang2id": lang2id or {},
            "speaker2id": speaker2id or {},
            "stats": stats or {},
        },
        "global_step": int(step),
        "epoch": int(epoch),
    }
    header_bytes = json.dumps(header, ensure_ascii=False).encode("utf8")
    body = {"state_dict": _numpy_tree(params)}
    if opt_state is not None:
        body["optimizer_states"] = _numpy_tree(opt_state)
    body = msgpack_lite.packb(body)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        f.write(body)
    tmp.replace(path)
    return path


def changed_config_values(old, new, prefix: str = "") -> list:
    """(path, old, new) triples where both configs define a key but disagree;
    keys or list items present on one side only are ignored, so a new
    config field never blocks a resume."""
    if isinstance(old, dict) and isinstance(new, dict):
        diffs = []
        for key in sorted(old.keys() & new.keys(), key=str):
            child = f"{prefix}.{key}" if prefix else str(key)
            diffs += changed_config_values(old[key], new[key], child)
        return diffs
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        diffs = []
        for i, (a, b) in enumerate(zip(old, new)):
            diffs += changed_config_values(a, b, f"{prefix}[{i}]")
        return diffs
    if old != new or type(old) is not type(new):
        return [(prefix, old, new)]
    return []


def resume_mode(old_config: dict, new_config: dict, model_name: str) -> str:
    """Three-way resume gate: a model-architecture difference raises
    ``InvalidConfiguration``; an optimizer difference gives
    ``"fresh_optimizer"`` (weights kept, optimizer and counters restarted);
    otherwise ``"full"`` (weights, optimizer and counters). StyleTTS2 skips
    the gate, since its two-stage recipe changes the config by design."""
    if model_name == "StyleTTS2Module":
        return "full"
    model_diff = changed_config_values(
        (old_config or {}).get("model", {}), (new_config or {}).get("model", {})
    )
    if model_diff:
        pretty = "\n".join(f"  {p}: {a!r} -> {b!r}" for p, a, b in model_diff)
        raise InvalidConfiguration(
            "The model architecture in your configuration differs from the "
            "one this checkpoint was trained with — fine-tuning across "
            "architectures is not supported. Fix the configuration or pick "
            f"a matching checkpoint. Changed values:\n{pretty}"
        )
    optimizer_diff = changed_config_values(
        (old_config or {}).get("training", {}).get("optimizer", {}),
        (new_config or {}).get("training", {}).get("optimizer", {}),
    )
    return "fresh_optimizer" if optimizer_diff else "full"

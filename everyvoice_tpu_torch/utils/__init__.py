"""Host-side string helpers copied from everyvoice_tpu/utils/__init__.py:
the text cleaners a checkpoint's text config names, and output-file naming."""

from __future__ import annotations

import hashlib
import importlib
import re
from unicodedata import normalize


def lower(text: str) -> str:
    return text.lower()


def nfc_normalize(text: str) -> str:
    return normalize("NFC", text)


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def strip_text(text: str) -> str:
    return text.strip()


CLEANERS = {
    f.__name__: f for f in (lower, nfc_normalize, collapse_whitespace, strip_text)
}


def resolve_cleaner(name: str):
    """Map a serialized cleaner name to the port's copy of that cleaner.

    The JAX package stores cleaners as dotted names
    (``"everyvoice_tpu.utils.collapse_whitespace"``; a bare name or an
    ``everyvoice.`` prefix means the same module). Those resolve here by
    name, never by importing the JAX package; a name in another module is
    imported as a user plugin."""
    if "." not in name:
        name = f"everyvoice_tpu.utils.{name}"
    module_name, _, function_name = name.rpartition(".")
    if module_name in ("everyvoice_tpu.utils", "everyvoice.utils"):
        if function_name not in CLEANERS:
            raise NotImplementedError(
                f"Cleaner {name!r} has no copy in everyvoice_tpu_torch.utils "
                f"(available: {sorted(CLEANERS)})"
            )
        return CLEANERS[function_name]
    if module_name.split(".")[0] in ("everyvoice_tpu", "everyvoice"):
        raise NotImplementedError(
            f"Cleaner {name!r} lives in the JAX package, which the port does "
            "not import"
        )
    return getattr(importlib.import_module(module_name), function_name)


def slugify(text: str, repl: str = "-", limit_to_n_characters: int | None = None) -> str:
    """Filesystem-safe version of a string."""
    slug = re.sub(r"[\\/:*?\"<>|\s]", repl, text)
    slug = re.sub(re.escape(repl) + r"{2,}", repl, slug)
    if limit_to_n_characters is not None:
        slug = slug[:limit_to_n_characters]
    return slug


def truncate_basename(basename: str, limit: int = 30) -> str:
    """Shorten long basenames, keeping them unique via a short hash suffix."""
    if len(basename) <= limit:
        return basename
    digest = hashlib.md5(basename.encode("utf8")).hexdigest()[:8]
    return f"{basename[: limit - 9]}-{digest}"

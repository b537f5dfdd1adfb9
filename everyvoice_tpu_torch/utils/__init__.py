"""Host-side helpers copied from everyvoice_tpu/utils/__init__.py: the text
cleaners a checkpoint's text config names, output-file naming, the
filelist readers and writer of preprocessing, and the logger's run
sub-directory name."""

from __future__ import annotations

import csv
import hashlib
import importlib
import os
import re
from itertools import islice
from pathlib import Path
from typing import Iterable
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


def _resolve_by_name(name: str, copies: dict, kind: str):
    """Map a serialized function name to the port's copy of that function.

    The JAX package stores functions as dotted names
    (``"everyvoice_tpu.utils.collapse_whitespace"``; a bare name or an
    ``everyvoice.`` prefix means the same module). Those resolve here by
    name, never by importing the JAX package; a name in another module is
    imported as a user plugin."""
    if "." not in name:
        name = f"everyvoice_tpu.utils.{name}"
    module_name, _, function_name = name.rpartition(".")
    if module_name in ("everyvoice_tpu.utils", "everyvoice.utils"):
        if function_name not in copies:
            raise NotImplementedError(
                f"{kind} {name!r} has no copy in everyvoice_tpu_torch.utils "
                f"(available: {sorted(copies)})"
            )
        return copies[function_name]
    if module_name.split(".")[0] in ("everyvoice_tpu", "everyvoice"):
        raise NotImplementedError(
            f"{kind} {name!r} lives in the JAX package, which the port does "
            "not import"
        )
    return getattr(importlib.import_module(module_name), function_name)


def resolve_cleaner(name: str):
    """The port's copy of the text cleaner a config names."""
    return _resolve_by_name(name, CLEANERS, "Cleaner")


def resolve_filelist_loader(name):
    """The port's copy of the filelist loader a dataset config names
    (``"everyvoice_tpu.utils.generic_psv_filelist_reader"`` by default); a
    callable is returned as it is."""
    if callable(name):
        return name
    return _resolve_by_name(name, FILELIST_LOADERS, "Filelist loader")


def get_current_time() -> str:
    """Timestamp used for logger sub-directories."""
    import time

    return str(int(time.time()))


def resolve_sub_dir_callable(name):
    """The port's copy of a logger config's ``sub_dir_callable``
    (``"everyvoice_tpu.utils.get_current_time"`` by default); a callable is
    returned as it is."""
    if callable(name):
        return name
    return _resolve_by_name(name, {"get_current_time": get_current_time}, "Sub-directory callable")


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


def n_times(n: int) -> str:
    if n == 1:
        return "once"
    if n == 2:
        return "twice"
    return f"{n} times"


# ---------------------------------------------------------------------------
# filelist IO: the same columns, order and escaping as the JAX package's

FILELIST_BASE_FIELDS = [
    "basename",
    "language",
    "speaker",
    "characters",
    "character_tokens",
    "phones",
    "phone_tokens",
]


def write_filelist(files: list, path: Path | str) -> None:
    """Write a psv filelist: the base fields first in their canonical order,
    then every other column of any row, sorted."""
    with open(path, "w", encoding="utf8", newline="") as f:
        if not files:
            print("", file=f)
            return
        found = sorted({key for row in files for key in row})
        fieldnames = [x for x in FILELIST_BASE_FIELDS if x in found] + [
            x for x in found if x not in FILELIST_BASE_FIELDS
        ]
        writer = csv.DictWriter(
            f,
            fieldnames=fieldnames,
            delimiter="|",
            quoting=csv.QUOTE_NONE,
            escapechar="\\",
            lineterminator="\n",
            restval="",
        )
        writer.writeheader()
        for row in files:
            writer.writerow(row)


def generic_xsv_filelist_reader(
    path: Path | str,
    delimiter: str = "|",
    quoting: int = csv.QUOTE_NONE,
    escapechar: str = "\\",
    fieldnames: list | None = None,
    file_has_header_line: bool = True,
    record_limit: int = 0,
) -> list:
    """Parse a delimited filelist into a list of row dicts, with the
    extension stripped from each basename."""
    if fieldnames is None and not file_has_header_line:
        raise ValueError("a filelist without a header line needs fieldnames")
    with open(path, "r", newline="", encoding="utf8") as f:
        lines: Iterable[str] = islice(f, record_limit) if record_limit else f
        reader = csv.DictReader(
            lines,
            fieldnames=fieldnames,
            delimiter=delimiter,
            quoting=quoting,
            escapechar=escapechar,
        )
        if fieldnames and file_has_header_line:
            next(reader, None)
        rows = []
        for row in reader:
            if "basename" in row and row["basename"] is not None:
                row["basename"] = os.path.splitext(row["basename"])[0]
            rows.append(row)
    return rows


def generic_psv_filelist_reader(path, **kwargs) -> list:
    return generic_xsv_filelist_reader(path, delimiter="|", **kwargs)


def generic_csv_filelist_reader(path, **kwargs) -> list:
    return generic_xsv_filelist_reader(path, delimiter=",", **kwargs)


FILELIST_LOADERS = {
    f.__name__: f
    for f in (
        generic_xsv_filelist_reader,
        generic_psv_filelist_reader,
        generic_csv_filelist_reader,
    )
}

"""Language and speaker lookup tables (copy of everyvoice_tpu/text/lookups.py)."""

from __future__ import annotations

from itertools import chain
from typing import Dict, Iterable, Sequence

LookupTable = Dict[str, int]


def lookuptables_from_data(data: Iterable[Sequence[dict]]) -> tuple:
    """Build (lang2id, speaker2id) from filelist rows, sorted for determinism."""
    rows = list(chain(*data))
    languages = set(d["language"] for d in rows if d.get("language") is not None)
    lang2id = {lang: i for i, lang in enumerate(sorted(languages))}
    speakers = set(d["speaker"] for d in rows if d.get("speaker") is not None)
    speaker2id = {spk: i for i, spk in enumerate(sorted(speakers))}
    return lang2id, speaker2id


def lookuptables_from_config(config: dict) -> tuple:
    """(lang2id, speaker2id) of a training config's two filelists."""
    from everyvoice_tpu_torch.utils import resolve_filelist_loader

    training = config["training"]
    load = resolve_filelist_loader(training["filelist_loader"])
    train = load(training["training_filelist"])
    val = load(training["validation_filelist"])
    return lookuptables_from_data((train, val))


def build_lookup(items: Sequence[dict], key: str) -> LookupTable:
    """Order-preserving unique lookup from a row key."""
    uniq = {item[key]: 1 for item in items}
    return {item: i for i, item in enumerate(uniq)}

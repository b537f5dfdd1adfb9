"""Symbol-mapping suggestions for pretrained models (a copy of
everyvoice_tpu/text/utils_heavy.py for the port: map user symbols onto a
frozen pretrained symbol table by minimizing phonological/orthographic
distance with an optimal assignment).

Distance tiers (reference utils_heavy.py:137-186):
1. articulatory feature distance between IPA segments (panphon-style —
   here via the port's text/ipa.py feature table),
2. Levenshtein distance between symbol strings,
3. Unicode-category tiers for non-IPA symbols.
The assignment is solved with scipy's linear_sum_assignment.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """
    >>> levenshtein('kitten', 'sitting')
    3
    """
    if len(a) < len(b):
        a, b = b, a
    previous = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        current = [i]
        for j, cb in enumerate(b, start=1):
            current.append(
                min(previous[j] + 1, current[j - 1] + 1,
                    previous[j - 1] + (ca != cb))
            )
        previous = current
    return previous[-1]


def feature_distance(sym_a: str, sym_b: str) -> Optional[float]:
    """Weighted articulatory feature distance between two IPA segments, or
    None when either is not parseable IPA."""
    from everyvoice_tpu_torch.text.ipa import segment_features

    fa = segment_features(sym_a)
    fb = segment_features(sym_b)
    if fa is None or fb is None:
        return None
    fa = np.asarray(fa)
    fb = np.asarray(fb)
    # Weight the major class features higher (syl/son/cons dominate identity).
    weights = np.ones(len(fa))
    weights[:3] = 4.0
    return float(np.sum(weights * np.abs(fa - fb)))


def unicode_table_distance(sym_a: str, sym_b: str) -> float:
    """Coarse distance from Unicode category/block similarity
    (reference utils_heavy.py:41-71)."""
    a0 = sym_a[0] if sym_a else " "
    b0 = sym_b[0] if sym_b else " "
    cat_a, cat_b = unicodedata.category(a0), unicodedata.category(b0)
    dist = 0.0
    if cat_a[0] != cat_b[0]:
        # Different major class (letter vs digit vs punctuation): far.
        dist += 10.0
    elif cat_a != cat_b:
        # Same major class, different subcategory (e.g. Lu vs Ll): near.
        dist += 5.0
    try:
        name_a = unicodedata.name(a0).split()[0]
        name_b = unicodedata.name(b0).split()[0]
        if name_a != name_b:
            dist += 2.0
    except ValueError:
        dist += 2.0
    # Codepoint proximity breaks ties inside a category: '1' is closer to
    # '2' than to '4', 'a' closer to 'b' than to 'z' (the reference ranks
    # by unicode-table adjacency the same way, utils_heavy.py:41-71).
    dist += min(abs(ord(a0) - ord(b0)) / 64.0, 1.0)
    return dist


def styletts2_symbol_distance(user_symbol: str, pretrained_symbol: str) -> float:
    """Tiered distance used to map user symbols into a frozen pretrained
    symbol table (reference utils_heavy.py:137-186)."""
    if user_symbol == pretrained_symbol:
        return 0.0
    fd = feature_distance(user_symbol, pretrained_symbol)
    if fd is not None:
        return 1.0 + fd  # exact matches stay strictly cheaper
    # Unnormalized edit distance: '1'→'22' (two edits) must rank farther
    # than '1'→'2' (one edit) even though both are "completely different".
    lev = levenshtein(user_symbol, pretrained_symbol)
    return 100.0 + 10.0 * lev + unicode_table_distance(
        user_symbol, pretrained_symbol
    )


_FORBIDDEN_COST = 1e9


def _optimal_assignment(
    user_symbols: List[str],
    candidates: List[str],
    forbidden=None,
) -> Dict[str, str]:
    """Rectangular 1:1 minimum-cost assignment; (symbol, candidate) pairs
    matching `forbidden` are never assigned (dropped from the result)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.zeros((len(user_symbols), len(candidates)))
    for i, us in enumerate(user_symbols):
        for j, ps in enumerate(candidates):
            if forbidden is not None and forbidden(us, ps):
                cost[i, j] = _FORBIDDEN_COST
            else:
                cost[i, j] = styletts2_symbol_distance(us, ps)
    rows, cols = linear_sum_assignment(cost)
    return {
        user_symbols[i]: candidates[j]
        for i, j in zip(rows, cols)
        if cost[i, j] < _FORBIDDEN_COST
    }


def find_optimal_mapping(
    user_symbols: List[str], pretrained_symbols: List[str]
) -> Dict[str, str]:
    """1:1 assignment of user symbols onto pretrained symbols minimizing the
    total tiered distance (reference utils_heavy.py:73-135)."""
    if len(user_symbols) > len(pretrained_symbols):
        raise ValueError(
            f"Cannot map {len(user_symbols)} user symbols onto only "
            f"{len(pretrained_symbols)} pretrained symbols."
        )
    return _optimal_assignment(user_symbols, pretrained_symbols)


def suggest_symbol_mapping(
    user_symbols: List[str],
    pretrained_symbols: List[str],
    reserved_targets: Optional[List[str]] = None,
) -> Dict[str, str]:
    """Suggest replacements only for symbols NOT already in the pretrained
    table; identical symbols map to themselves
    (reference utils_heavy.py:189-259).

    Guarantees (matching the reference's suggestion semantics):
      * one-to-one — two distinct symbols never share a target (they would
        collapse into the same frozen pretrained embedding),
      * digits are never given a stand-in (they are unexpanded numbers that
        need text normalization, not graphemes),
      * `reserved_targets` (e.g. symbols already doing punctuation duty)
        are never handed out,
      * a symbol is never mapped onto one of its own literal components
        ('k̟ʷ' → 'k' would make it indistinguishable from plain 'k').
    """
    pretrained_set = set(pretrained_symbols)
    reserved = set(reserved_targets or ())
    missing = [
        s for s in user_symbols
        if s not in pretrained_set and not s.isdigit()
    ]
    if not missing:
        return {}
    # Candidates: pretrained symbols not already claimed by exact matches
    # or reserved by the caller.
    used = (set(user_symbols) & pretrained_set) | reserved
    candidates = [s for s in pretrained_symbols if s not in used]
    if not candidates:
        return {}
    # Rectangular assignment pairs min(n_missing, n_candidates) symbols;
    # own-literal-component pairs are forbidden (left unmapped).
    return _optimal_assignment(
        missing, candidates, forbidden=lambda sym, cand: cand in sym
    )

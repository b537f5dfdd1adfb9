"""Data-driven rule-table grapheme-to-phoneme engines.

Copied from everyvoice_tpu/text/rule_g2p.py, which the port may not import;
tests/test_torch_g2p.py holds the copy to the original.

The reference seeds its G2P registry from the `g2p` library's JSON mapping
tables (reference everyvoice/text/phonemizer.py:20-28, ~20 languages). That
library is not available here, so this module provides the same
architecture natively: a longest-match-first, context-aware rule engine
driven by plain data tables, plus built-in tables for languages with
(mostly) regular orthographies. Users add further languages either by
registering a callable plugin (``TextConfig.g2p_engines``, identical to the
reference's plugin API) or by loading a JSON rule table with
``load_rules_from_json``.

Rule format: ``(graphemes, ipa, pre, post)``
- ``graphemes``: literal string matched in the lower-cased word,
- ``ipa``: replacement IPA string ("" deletes, e.g. silent letters),
- ``pre``: regex that must match the END of the preceding text (``\\A`` =
  word-initial), or None,
- ``post``: regex that must match the FOLLOWING text (``\\Z`` = word-final),
  or None.

At each position the first rule (longest grapheme first, then table order)
whose context matches is applied. Unmatched characters pass through so the
TextProcessor's missing-symbol accounting still sees them.

The built-in tables are broad-transcription approximations — documented as
such — aimed at the same fidelity class as the reference's rule mappings;
for production-quality lexical G2P, register a plugin.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

Rule = Tuple[str, str, Optional[str], Optional[str]]


class RuleG2P:
    """Longest-match-first contextual rewrite engine producing IPA tokens."""

    def __init__(self, rules: Sequence[Rule], name: str = "rule-g2p"):
        self.name = name
        # Sort by grapheme length (longest first), stable within a length so
        # table order breaks ties.
        indexed = list(enumerate(rules))
        indexed.sort(key=lambda pair: (-len(pair[1][0]), pair[0]))
        self._rules = [
            (
                graph,
                ipa,
                re.compile(pre + r"\Z") if pre else None,
                re.compile(post) if post else None,
            )
            for _, (graph, ipa, pre, post) in indexed
        ]

    def word_to_ipa(self, word: str) -> str:
        word = unicodedata.normalize("NFC", word.lower())
        out: List[str] = []
        i = 0
        while i < len(word):
            for graph, ipa, pre, post in self._rules:
                if not word.startswith(graph, i):
                    continue
                if pre is not None and not pre.search(word[:i]):
                    continue
                tail = word[i + len(graph):]
                if post is not None and not post.match(tail):
                    continue
                out.append(ipa)
                i += len(graph)
                break
            else:
                out.append(word[i])
                i += 1
        return "".join(out)

    def __call__(self, normalized_text: str) -> List[str]:
        from everyvoice_tpu_torch.text.ipa import tokenize_ipa

        tokens: List[str] = []
        for piece in re.split(r"(\W+)", normalized_text):
            if not piece:
                continue
            if re.match(r"^\w+$", piece, re.UNICODE):
                tokens.extend(tokenize_ipa(self.word_to_ipa(piece)))
            else:
                tokens.extend(piece)
        return tokens


def load_rules_from_json(path: Path | str) -> RuleG2P:
    """Load a user rule table: a JSON list of
    ``{"in": ..., "out": ..., "pre": ..., "post": ...}`` objects (the shape
    of the `g2p` library's mapping files, with optional contexts)."""
    data = json.loads(Path(path).read_text(encoding="utf8"))
    rules = [
        (entry["in"], entry.get("out", ""), entry.get("pre"), entry.get("post"))
        for entry in data
    ]
    return RuleG2P(rules, name=str(path))


_VOWEL = "[aeiouáéíóúàèìòùâêîôûäëïöüæœøyå]"
# French nasal context: the n/m nasalizes only when NOT followed by a
# vowel or another nasal (e.g. "bonne" keeps /n/, "bon" nasalizes).
_NOT_NASAL = "(?![nm" + _VOWEL[1:-1] + "])"

# ---------------------------------------------------------------------------
# Built-in tables (broad transcriptions).

SPANISH_RULES: List[Rule] = [
    ("ch", "t͡ʃ", None, None),
    ("ll", "ʝ", None, None),
    ("rr", "r", None, None),
    ("qu", "k", None, "[eéií]"),
    ("gü", "ɡw", None, "[eéií]"),
    ("gu", "ɡ", None, "[eéií]"),
    ("c", "θ", None, "[eéií]"),
    ("c", "k", None, None),
    ("g", "x", None, "[eéií]"),
    ("g", "ɡ", None, None),
    ("z", "θ", None, None),
    ("j", "x", None, None),
    ("ñ", "ɲ", None, None),
    ("h", "", None, None),
    ("v", "b", None, None),
    ("y", "i", None, r"\Z"),
    ("y", "ʝ", None, None),
    ("x", "ks", None, None),
    ("r", "r", r"\A", None),
    ("r", "r", "[nls]", None),
    ("r", "ɾ", None, None),
    ("á", "a", None, None), ("é", "e", None, None), ("í", "i", None, None),
    ("ó", "o", None, None), ("ú", "u", None, None), ("ü", "u", None, None),
]

ITALIAN_RULES: List[Rule] = [
    ("sch", "sk", None, None),
    ("sci", "ʃ", None, _VOWEL),
    ("sc", "ʃ", None, "[eèéi]"),
    ("ch", "k", None, None),
    ("gh", "ɡ", None, None),
    ("gli", "ʎ", None, _VOWEL),
    ("gli", "ʎi", None, None),
    ("gn", "ɲ", None, None),
    ("ci", "t͡ʃ", None, _VOWEL),
    ("c", "t͡ʃ", None, "[eèéi]"),
    ("c", "k", None, None),
    ("gi", "d͡ʒ", None, _VOWEL),
    ("g", "d͡ʒ", None, "[eèéi]"),
    ("g", "ɡ", None, None),
    ("z", "t͡s", None, None),
    ("h", "", None, None),
    ("qu", "kw", None, None),
    ("s", "z", _VOWEL, _VOWEL),
    ("è", "ɛ", None, None), ("é", "e", None, None),
    ("ò", "ɔ", None, None), ("ó", "o", None, None),
    ("à", "a", None, None), ("ì", "i", None, None), ("ù", "u", None, None),
]

FINNISH_RULES: List[Rule] = [
    ("ng", "ŋ", None, None),
    ("nk", "ŋk", None, None),
    ("y", "y", None, None),
    ("ä", "æ", None, None),
    ("ö", "ø", None, None),
    ("å", "o", None, None),
    ("v", "ʋ", None, None),
]

GERMAN_RULES: List[Rule] = [
    ("tsch", "t͡ʃ", None, None),
    ("sch", "ʃ", None, None),
    ("ch", "x", "[aou]", None),
    ("ch", "x", "au", None),
    ("ch", "ç", None, None),
    ("ck", "k", None, None),
    ("ph", "f", None, None),
    ("th", "t", None, None),
    ("qu", "kv", None, None),
    ("ei", "aɪ", None, None),
    ("ai", "aɪ", None, None),
    ("ie", "i", None, None),
    ("eu", "ɔʏ", None, None),
    ("äu", "ɔʏ", None, None),
    ("au", "aʊ", None, None),
    ("sp", "ʃp", r"\A", None),
    ("st", "ʃt", r"\A", None),
    ("ß", "s", None, None),
    ("ss", "s", None, None),
    ("s", "z", None, _VOWEL),
    ("v", "f", None, None),
    ("w", "v", None, None),
    ("z", "t͡s", None, None),
    ("ö", "ø", None, None),
    ("ü", "y", None, None),
    ("ä", "ɛ", None, None),
    ("er", "ɐ", None, r"\Z"),
    ("e", "ə", None, r"\Z"),
    ("h", "", _VOWEL, None),  # lengthening h is silent
    ("b", "p", None, r"\Z"),
    ("d", "t", None, r"\Z"),
    ("g", "k", None, r"\Z"),
]

FRENCH_RULES: List[Rule] = [
    ("eaux", "o", None, r"\Z"),
    ("eau", "o", None, None),
    ("aux", "o", None, r"\Z"),
    ("au", "o", None, None),
    ("ou", "u", None, None),
    ("oi", "wa", None, None),
    ("ille", "ij", None, r"\Z"),
    ("ain", "ɛ̃", None, _NOT_NASAL),
    ("ein", "ɛ̃", None, _NOT_NASAL),
    ("in", "ɛ̃", None, _NOT_NASAL),
    ("im", "ɛ̃", None, "[pb]"),
    ("an", "ɑ̃", None, _NOT_NASAL),
    ("am", "ɑ̃", None, "[pb]"),
    ("en", "ɑ̃", None, _NOT_NASAL),
    ("em", "ɑ̃", None, "[pb]"),
    ("on", "ɔ̃", None, _NOT_NASAL),
    ("om", "ɔ̃", None, "[pb]"),
    ("un", "œ̃", None, _NOT_NASAL),
    ("ai", "ɛ", None, None),
    ("ei", "ɛ", None, None),
    ("eu", "ø", None, None),
    ("œu", "ø", None, None),
    ("œ", "ø", None, None),
    ("ch", "ʃ", None, None),
    ("gn", "ɲ", None, None),
    ("qu", "k", None, None),
    ("ç", "s", None, None),
    ("j", "ʒ", None, None),
    ("g", "ʒ", None, "[eéèêiy]"),
    ("g", "ɡ", None, None),
    ("c", "s", None, "[eéèêiy]"),
    ("c", "k", None, None),
    ("ph", "f", None, None),
    ("é", "e", None, None),
    ("è", "ɛ", None, None), ("ê", "ɛ", None, None),
    ("â", "a", None, None), ("ô", "o", None, None),
    ("û", "y", None, None), ("î", "i", None, None),
    ("u", "y", None, None),
    ("ll", "l", None, None),
    ("nn", "n", None, None),
    ("mm", "m", None, None),
    ("tt", "t", None, None),
    ("pp", "p", None, None),
    ("ss", "s", None, None),
    ("rr", "ʁ", None, None),
    ("h", "", None, None),
    ("r", "ʁ", None, None),
    ("y", "i", None, None),
    ("s", "z", _VOWEL, _VOWEL),
    # Common silent finals (broad approximation).
    ("ps", "", None, r"\Z"),
    ("es", "", None, r"\Z"),
    ("e", "", None, r"\Z"),
    ("s", "", None, r"\Z"),
    ("t", "", None, r"\Z"),
    ("d", "", None, r"\Z"),
    ("x", "", None, r"\Z"),
    ("z", "", None, r"\Z"),
    ("p", "", None, r"\Z"),
]

BUILTIN_RULE_TABLES = {
    "spa": SPANISH_RULES,
    "ita": ITALIAN_RULES,
    "fin": FINNISH_RULES,
    "deu": GERMAN_RULES,
    "fra": FRENCH_RULES,
}


def _load_extra_tables():
    from everyvoice_tpu_torch.text.rule_g2p_tables import EXTRA_RULE_TABLES

    BUILTIN_RULE_TABLES.update(EXTRA_RULE_TABLES)


_load_extra_tables()


def make_rule_engine(lang_id: str) -> RuleG2P:
    return RuleG2P(BUILTIN_RULE_TABLES[lang_id], name=f"{lang_id}-rules")

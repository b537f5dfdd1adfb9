"""Additional built-in G2P rule tables.

Copied from everyvoice_tpu/text/rule_g2p_tables.py, which the port may not import;
tests/test_torch_g2p.py holds the copy to the original.

Together with the tables in ``rule_g2p.py`` these bring the built-in
language registry to ~24 languages — the same breadth class as the
reference's `g2p`-seeded registry (reference everyvoice/text/phonemizer.py:
20-28, ~20 arpabet-capable languages). All tables are broad-transcription
approximations for (mostly) regular orthographies; for lexical-quality G2P
register a plugin via ``TextConfig.g2p_engines``.

Rule format matches ``rule_g2p.Rule``: (graphemes, ipa, pre, post).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# Same shape as rule_g2p.Rule; defined locally to avoid a circular import
# (rule_g2p merges these tables at module init).
Rule = Tuple[str, str, Optional[str], Optional[str]]

_VOWEL = "[aeiouáéíóúàèìòùâêîôûäëïöüãõåæøœyı]"

TURKISH_RULES: List[Rule] = [
    ("c", "d͡ʒ", None, None),
    ("ç", "t͡ʃ", None, None),
    ("ş", "ʃ", None, None),
    ("ğ", "", None, None),  # yumuşak g: lengthens the preceding vowel
    ("ı", "ɯ", None, None),
    ("i", "i", None, None),
    ("ö", "ø", None, None),
    ("ü", "y", None, None),
    ("j", "ʒ", None, None),
    ("y", "j", None, None),
    ("v", "v", None, None),
    ("r", "ɾ", None, None),
    ("â", "a", None, None), ("î", "i", None, None), ("û", "u", None, None),
]

POLISH_RULES: List[Rule] = [
    ("dzi", "d͡ʑ", None, _VOWEL),
    ("dź", "d͡ʑ", None, None),
    ("dż", "d͡ʐ", None, None),
    ("dz", "d͡z", None, None),
    ("sz", "ʂ", None, None),
    ("cz", "t͡ʂ", None, None),
    ("rz", "ʐ", None, None),
    ("ch", "x", None, None),
    ("ci", "t͡ɕ", None, _VOWEL),
    ("si", "ɕ", None, _VOWEL),
    ("zi", "ʑ", None, _VOWEL),
    ("ni", "ɲ", None, _VOWEL),
    ("ż", "ʐ", None, None),
    ("ź", "ʑ", None, None),
    ("ś", "ɕ", None, None),
    ("ć", "t͡ɕ", None, None),
    ("ń", "ɲ", None, None),
    ("ł", "w", None, None),
    ("w", "v", None, None),
    ("h", "x", None, None),
    ("c", "t͡s", None, None),
    ("j", "j", None, None),
    ("y", "ɨ", None, None),
    ("ą", "ɔ̃", None, None),
    ("ę", "ɛ̃", None, None),
    ("ó", "u", None, None),
]

CZECH_RULES: List[Rule] = [
    ("ch", "x", None, None),
    ("č", "t͡ʃ", None, None),
    ("š", "ʃ", None, None),
    ("ž", "ʒ", None, None),
    ("ř", "r̝", None, None),
    ("ď", "ɟ", None, None),
    ("ť", "c", None, None),
    ("ň", "ɲ", None, None),
    ("c", "t͡s", None, None),
    ("j", "j", None, None),
    ("h", "ɦ", None, None),
    ("w", "v", None, None),
    ("y", "ɪ", None, None),
    ("ý", "iː", None, None),
    ("á", "aː", None, None), ("é", "ɛː", None, None), ("í", "iː", None, None),
    ("ó", "oː", None, None), ("ú", "uː", None, None), ("ů", "uː", None, None),
    ("ě", "jɛ", None, None),
    ("e", "ɛ", None, None),
]

CROATIAN_RULES: List[Rule] = [
    ("dž", "d͡ʒ", None, None),
    ("nj", "ɲ", None, None),
    ("lj", "ʎ", None, None),
    ("č", "t͡ʃ", None, None),
    ("ć", "t͡ɕ", None, None),
    ("đ", "d͡ʑ", None, None),
    ("š", "ʃ", None, None),
    ("ž", "ʒ", None, None),
    ("c", "t͡s", None, None),
    ("j", "j", None, None),
    ("r", "r", None, None),
]

ROMANIAN_RULES: List[Rule] = [
    ("che", "ke", None, None),
    ("chi", "ki", None, None),
    ("ghe", "ɡe", None, None),
    ("ghi", "ɡi", None, None),
    ("ce", "t͡ʃe", None, None),
    ("ci", "t͡ʃi", None, None),
    ("ge", "d͡ʒe", None, None),
    ("gi", "d͡ʒi", None, None),
    ("ă", "ə", None, None),
    ("â", "ɨ", None, None),
    ("î", "ɨ", None, None),
    ("ș", "ʃ", None, None),
    ("ş", "ʃ", None, None),
    ("ț", "t͡s", None, None),
    ("ţ", "t͡s", None, None),
    ("j", "ʒ", None, None),
    ("c", "k", None, None),
    ("g", "ɡ", None, None),
]

PORTUGUESE_RULES: List[Rule] = [
    ("nh", "ɲ", None, None),
    ("lh", "ʎ", None, None),
    ("ch", "ʃ", None, None),
    ("ss", "s", None, None),
    ("ção", "sɐ̃w", None, None),
    ("ão", "ɐ̃w", None, None),
    ("õe", "õj", None, None),
    ("qu", "k", None, "[eéêií]"),
    ("gu", "ɡ", None, "[eéêií]"),
    ("ç", "s", None, None),
    ("x", "ʃ", None, None),
    ("j", "ʒ", None, None),
    ("g", "ʒ", None, "[eéêií]"),
    ("g", "ɡ", None, None),
    ("c", "s", None, "[eéêií]"),
    ("c", "k", None, None),
    ("s", "z", _VOWEL, _VOWEL),
    ("o", "u", None, r"s?\Z"),
    ("á", "a", None, None), ("â", "ɐ", None, None), ("ã", "ɐ̃", None, None),
    ("é", "ɛ", None, None), ("ê", "e", None, None), ("í", "i", None, None),
    ("ó", "ɔ", None, None), ("ô", "o", None, None), ("õ", "õ", None, None),
    ("ú", "u", None, None),
]

CATALAN_RULES: List[Rule] = [
    ("ny", "ɲ", None, None),
    ("ix", "ʃ", "[aeouàèéòóú]", None),
    ("ll", "ʎ", None, None),
    ("tx", "t͡ʃ", None, None),
    ("ig", "t͡ʃ", _VOWEL, r"\Z"),
    ("qu", "k", None, "[eèéií]"),
    ("gu", "ɡ", None, "[eèéií]"),
    ("ç", "s", None, None),
    ("x", "ʃ", r"\A", None),
    ("x", "ʃ", "[i]", None),
    ("x", "ks", None, None),
    ("j", "ʒ", None, None),
    ("g", "ʒ", None, "[eèéi]"),
    ("g", "ɡ", None, None),
    ("c", "s", None, "[eèéií]"),
    ("c", "k", None, None),
    ("à", "a", None, None), ("è", "ɛ", None, None), ("é", "e", None, None),
    ("í", "i", None, None), ("ò", "ɔ", None, None), ("ó", "o", None, None),
    ("ú", "u", None, None), ("ï", "i", None, None),
]

HUNGARIAN_RULES: List[Rule] = [
    ("ssz", "sː", None, None),
    ("ccs", "t͡ʃː", None, None),
    ("zs", "ʒ", None, None),
    ("sz", "s", None, None),
    ("cs", "t͡ʃ", None, None),
    ("gy", "ɟ", None, None),
    ("ty", "c", None, None),
    ("ny", "ɲ", None, None),
    ("ly", "j", None, None),
    ("s", "ʃ", None, None),
    ("c", "t͡s", None, None),
    ("j", "j", None, None),
    ("a", "ɒ", None, None),
    ("á", "aː", None, None), ("é", "eː", None, None), ("í", "iː", None, None),
    ("ó", "oː", None, None), ("ö", "ø", None, None), ("ő", "øː", None, None),
    ("ú", "uː", None, None), ("ü", "y", None, None), ("ű", "yː", None, None),
]

INDONESIAN_RULES: List[Rule] = [
    ("ngg", "ŋɡ", None, None),
    ("ng", "ŋ", None, None),
    ("ny", "ɲ", None, None),
    ("sy", "ʃ", None, None),
    ("kh", "x", None, None),
    ("c", "t͡ʃ", None, None),
    ("j", "d͡ʒ", None, None),
    ("y", "j", None, None),
]

SWAHILI_RULES: List[Rule] = [
    ("ng'", "ŋ", None, None),
    ("ng", "ŋɡ", None, None),
    ("ch", "t͡ʃ", None, None),
    ("sh", "ʃ", None, None),
    ("ny", "ɲ", None, None),
    ("dh", "ð", None, None),
    ("th", "θ", None, None),
    ("gh", "ɣ", None, None),
    ("j", "d͡ʒ", None, None),
    ("y", "j", None, None),
]

DANISH_RULES: List[Rule] = [
    ("r", "ʁ", None, None),
    ("d", "ð", _VOWEL, r"\Z"),
    ("æ", "ɛ", None, None),
    ("ø", "ø", None, None),
    ("å", "ɔ", None, None),
    ("y", "y", None, None),
    ("j", "j", None, None),
]

SWEDISH_RULES: List[Rule] = [
    ("stj", "ɧ", None, None),
    ("skj", "ɧ", None, None),
    ("sj", "ɧ", None, None),
    ("tj", "ɕ", None, None),
    ("kj", "ɕ", None, None),
    ("sk", "ɧ", None, "[eiyäö]"),
    ("k", "ɕ", r"\A", "[eiyäö]"),
    ("g", "j", r"\A", "[eiyäö]"),
    ("å", "o", None, None),
    ("ä", "ɛ", None, None),
    ("ö", "ø", None, None),
    ("y", "y", None, None),
    ("j", "j", None, None),
]

ESTONIAN_RULES: List[Rule] = [
    ("õ", "ɤ", None, None),
    ("ä", "æ", None, None),
    ("ö", "ø", None, None),
    ("ü", "y", None, None),
    ("š", "ʃ", None, None),
    ("ž", "ʒ", None, None),
]

BASQUE_RULES: List[Rule] = [
    ("tx", "t͡ʃ", None, None),
    ("tz", "t͡s", None, None),
    ("ts", "t͡s", None, None),
    ("x", "ʃ", None, None),
    ("ñ", "ɲ", None, None),
    ("ll", "ʎ", None, None),
    ("rr", "r", None, None),
    ("r", "ɾ", None, None),
    ("j", "j", None, None),
    ("z", "s", None, None),
]

RUSSIAN_RULES: List[Rule] = [
    ("а", "a", None, None), ("б", "b", None, None), ("в", "v", None, None),
    ("г", "ɡ", None, None), ("д", "d", None, None), ("е", "je", None, None),
    ("ё", "jo", None, None), ("ж", "ʐ", None, None), ("з", "z", None, None),
    ("и", "i", None, None), ("й", "j", None, None), ("к", "k", None, None),
    ("л", "l", None, None), ("м", "m", None, None), ("н", "n", None, None),
    ("о", "o", None, None), ("п", "p", None, None), ("р", "r", None, None),
    ("с", "s", None, None), ("т", "t", None, None), ("у", "u", None, None),
    ("ф", "f", None, None), ("х", "x", None, None), ("ц", "t͡s", None, None),
    ("ч", "t͡ɕ", None, None), ("ш", "ʂ", None, None), ("щ", "ɕ", None, None),
    ("ъ", "", None, None), ("ы", "ɨ", None, None), ("ь", "", None, None),
    ("э", "ɛ", None, None), ("ю", "ju", None, None), ("я", "ja", None, None),
]

UKRAINIAN_RULES: List[Rule] = [
    ("а", "a", None, None), ("б", "b", None, None), ("в", "ʋ", None, None),
    ("г", "ɦ", None, None), ("ґ", "ɡ", None, None), ("д", "d", None, None),
    ("е", "ɛ", None, None), ("є", "jɛ", None, None), ("ж", "ʒ", None, None),
    ("з", "z", None, None), ("и", "ɪ", None, None), ("і", "i", None, None),
    ("ї", "ji", None, None), ("й", "j", None, None), ("к", "k", None, None),
    ("л", "l", None, None), ("м", "m", None, None), ("н", "n", None, None),
    ("о", "ɔ", None, None), ("п", "p", None, None), ("р", "r", None, None),
    ("с", "s", None, None), ("т", "t", None, None), ("у", "u", None, None),
    ("ф", "f", None, None), ("х", "x", None, None), ("ц", "t͡s", None, None),
    ("ч", "t͡ʃ", None, None), ("ш", "ʃ", None, None), ("щ", "ʃt͡ʃ", None, None),
    ("ь", "", None, None), ("ю", "ju", None, None), ("я", "ja", None, None),
]

GREEK_RULES: List[Rule] = [
    ("ου", "u", None, None), ("ού", "u", None, None),
    ("αι", "e", None, None), ("αί", "e", None, None),
    ("ει", "i", None, None), ("εί", "i", None, None),
    ("οι", "i", None, None), ("οί", "i", None, None),
    ("μπ", "b", None, None), ("ντ", "d", None, None),
    ("γγ", "ŋɡ", None, None), ("γκ", "ɡ", None, None),
    ("τσ", "t͡s", None, None), ("τζ", "d͡z", None, None),
    ("α", "a", None, None), ("ά", "a", None, None),
    ("β", "v", None, None), ("γ", "ɣ", None, None), ("δ", "ð", None, None),
    ("ε", "e", None, None), ("έ", "e", None, None), ("ζ", "z", None, None),
    ("η", "i", None, None), ("ή", "i", None, None), ("θ", "θ", None, None),
    ("ι", "i", None, None), ("ί", "i", None, None), ("κ", "k", None, None),
    ("λ", "l", None, None), ("μ", "m", None, None), ("ν", "n", None, None),
    ("ξ", "ks", None, None), ("ο", "o", None, None), ("ό", "o", None, None),
    ("π", "p", None, None), ("ρ", "r", None, None), ("σ", "s", None, None),
    ("ς", "s", None, None), ("τ", "t", None, None), ("υ", "i", None, None),
    ("ύ", "i", None, None), ("φ", "f", None, None), ("χ", "x", None, None),
    ("ψ", "ps", None, None), ("ω", "o", None, None), ("ώ", "o", None, None),
]

EXTRA_RULE_TABLES = {
    "tur": TURKISH_RULES,
    "pol": POLISH_RULES,
    "ces": CZECH_RULES,
    "hrv": CROATIAN_RULES,
    "ron": ROMANIAN_RULES,
    "por": PORTUGUESE_RULES,
    "cat": CATALAN_RULES,
    "hun": HUNGARIAN_RULES,
    "ind": INDONESIAN_RULES,
    "swa": SWAHILI_RULES,
    "dan": DANISH_RULES,
    "swe": SWEDISH_RULES,
    "est": ESTONIAN_RULES,
    "eus": BASQUE_RULES,
    "rus": RUSSIAN_RULES,
    "ukr": UKRAINIAN_RULES,
    "ell": GREEK_RULES,
}

EXTRA_LANGUAGE_NAMES = {
    "tur": "Turkish",
    "pol": "Polish",
    "ces": "Czech",
    "hrv": "Croatian",
    "ron": "Romanian",
    "por": "Portuguese",
    "cat": "Catalan",
    "hun": "Hungarian",
    "ind": "Indonesian",
    "swa": "Swahili",
    "dan": "Danish",
    "swe": "Swedish",
    "est": "Estonian",
    "eus": "Basque",
    "rus": "Russian",
    "ukr": "Ukrainian",
    "ell": "Greek (Modern)",
}

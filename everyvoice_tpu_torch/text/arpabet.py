"""ARPABET → IPA conversion (parity: everyvoice/text/arpabet.py:39-214).

Copied from everyvoice_tpu/text/arpabet.py, which the port may not import;
tests/test_torch_g2p.py holds the copy to the original.

Converts space-separated ARPABET tokens (upper- or lower-case, with optional
0/1/2 stress digits) into an IPA string. Stress digits become the IPA stress
marks ˈ (primary) / ˌ (secondary) placed *before* the vowel that carries them.
"""

from __future__ import annotations

import re

# The standard ARPABET phone set (CMUdict flavour).
ARPABET_VOWELS_TO_IPA = {
    "AA": "ɑ",
    "AE": "æ",
    "AH": "ʌ",
    "AO": "ɔ",
    "AW": "aʊ",
    "AX": "ə",
    "AXR": "ɚ",
    "AY": "aɪ",
    "EH": "ɛ",
    "ER": "ɝ",
    "EY": "eɪ",
    "IH": "ɪ",
    "IX": "ɨ",
    "IY": "i",
    "OW": "oʊ",
    "OY": "ɔɪ",
    "UH": "ʊ",
    "UW": "u",
    "UX": "ʉ",
}

ARPABET_CONSONANTS_TO_IPA = {
    "B": "b",
    "CH": "t͡ʃ",
    "D": "d",
    "DH": "ð",
    "DX": "ɾ",
    "EL": "l̩",
    "EM": "m̩",
    "EN": "n̩",
    "F": "f",
    "G": "ɡ",
    "HH": "h",
    "H": "h",
    "JH": "d͡ʒ",
    "K": "k",
    "L": "l",
    "M": "m",
    "N": "n",
    "NG": "ŋ",
    "NX": "ɾ̃",
    "P": "p",
    "Q": "ʔ",
    "R": "ɹ",
    "S": "s",
    "SH": "ʃ",
    "T": "t",
    "TH": "θ",
    "V": "v",
    "W": "w",
    "WH": "ʍ",
    "Y": "j",
    "Z": "z",
    "ZH": "ʒ",
}

ARPABET_TO_IPA = {**ARPABET_VOWELS_TO_IPA, **ARPABET_CONSONANTS_TO_IPA}

_TOKEN_RE = re.compile(r"^(?P<phone>[A-Za-z]+)(?P<stress>[0-2]?)$")
_STRESS_TO_IPA = {"1": "ˈ", "2": "ˌ"}


def convert_arpabet_token(token: str) -> str:
    """Convert a single ARPABET token; unknown tokens pass through unchanged.

    >>> convert_arpabet_token('HH')
    'h'
    >>> convert_arpabet_token('AY1')
    'ˈaɪ'
    """
    m = _TOKEN_RE.match(token)
    if m is None:
        return token
    phone = m["phone"].upper()
    ipa = ARPABET_TO_IPA.get(phone)
    if ipa is None:
        return token
    stress = _STRESS_TO_IPA.get(m["stress"], "")
    return stress + ipa


def arpabet_to_ipa(text: str) -> str:
    """Convert a space-separated ARPABET string into an IPA string.

    Spaces between phones of a word are removed; multiple spaces delimit
    words and are preserved as single spaces.

    >>> arpabet_to_ipa('HH AH0 L OW1')
    'hʌlˈoʊ'
    >>> arpabet_to_ipa('K AE1 T  S AE1 T')
    'kˈæt sˈæt'
    """
    words = re.split(r"\s{2,}", text.strip())
    out_words = []
    for word in words:
        out_words.append(
            "".join(convert_arpabet_token(tok) for tok in word.split())
        )
    return " ".join(out_words)


def arpabet_tokens_to_ipa_tokens(tokens: list) -> list:
    """Convert a list of ARPABET tokens to IPA phone tokens (stress marks as
    separate tokens, as the IPA tokenizer would produce them)."""
    from everyvoice_tpu_torch.text.ipa import tokenize_ipa

    return tokenize_ipa("".join(convert_arpabet_token(t) for t in tokens))

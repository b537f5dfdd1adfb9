"""IPA tokenization and articulatory feature tables.

Copied from everyvoice_tpu/text/ipa.py, which the port may not import;
tests/test_torch_g2p.py holds the copy to the original.

Native replacement for the reference's `ipatok` (tokenization) and `panphon`
(feature table) dependencies (reference everyvoice/text/features.py:3 and
everyvoice/text/phonemizer.py:8-9). The feature system keeps panphon's
24-dimension layout and ternary (+1/-1/0) value scheme so downstream feature
vectors have the same shape and semantics; the table itself is generated from
compact articulatory descriptions rather than shipped as data files.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# Feature space: panphon-compatible 24 articulatory dimensions.

FEATURE_NAMES: List[str] = [
    "syl", "son", "cons", "cont", "delrel", "lat", "nas", "strid",
    "voi", "sg", "cg", "ant", "cor", "distr", "lab", "hi", "lo",
    "back", "round", "velaric", "tense", "long", "hitone", "hireg",
]
N_ARTICULATORY_FEATURES = len(FEATURE_NAMES)
_IDX = {name: i for i, name in enumerate(FEATURE_NAMES)}


def _vec(**kwargs) -> list:
    v = [0.0] * N_ARTICULATORY_FEATURES
    for name, value in kwargs.items():
        v[_IDX[name]] = float(value)
    return v


# Baseline for any consonant: non-syllabic obstruent defaults; individual
# rows override manner/place/voicing dimensions.
def _consonant(
    place: str,
    manner: str,
    voiced: bool,
    lateral: bool = False,
    strident: Optional[bool] = None,
) -> list:
    v = _vec(
        syl=-1, son=-1, cons=1, cont=-1, delrel=-1, lat=-1, nas=-1, strid=-1,
        voi=1 if voiced else -1, sg=-1, cg=-1,
        ant=-1, cor=-1, distr=-1, lab=-1, hi=-1, lo=-1, back=-1, round=-1,
        velaric=-1, tense=0, long=-1, hitone=0, hireg=0,
    )

    def s(**kw):
        for k, val in kw.items():
            v[_IDX[k]] = float(val)

    # Place of articulation
    if place == "bilabial":
        s(lab=1, ant=1)
    elif place == "labiodental":
        s(lab=1, ant=1, strid=1)
    elif place == "dental":
        s(cor=1, ant=1, distr=1)
    elif place == "alveolar":
        s(cor=1, ant=1)
    elif place == "postalveolar":
        s(cor=1, ant=-1, distr=1)
    elif place == "alveolopalatal":
        # Polish/Mandarin-type ɕ ʑ: postalveolar tongue-blade contact plus a
        # raised (palatalized) body.
        s(cor=1, ant=-1, distr=1, hi=1, back=-1)
    elif place == "retroflex":
        s(cor=1, ant=-1, distr=-1)
    elif place == "palatal":
        s(cor=-1, hi=1, back=-1, distr=1)
    elif place == "velar":
        s(hi=1, back=1)
    elif place == "uvular":
        s(back=1)
    elif place == "pharyngeal":
        s(lo=1, back=1)
    elif place == "glottal":
        s(cons=-1)
    elif place == "labiovelar":
        s(lab=1, hi=1, back=1, round=1)
    # Manner of articulation
    if manner == "stop":
        pass
    elif manner == "nasal":
        s(son=1, nas=1)
    elif manner == "fricative":
        s(cont=1)
        if strident is None and place in (
            "alveolar", "postalveolar", "alveolopalatal", "labiodental"
        ):
            s(strid=1)
    elif manner == "affricate":
        # Affricates in the base table are built by tying a stop and a
        # fricative (see the tied-composition path), so this branch only
        # serves future direct rows; keep its stridency places in sync with
        # the fricative branch above.
        s(delrel=1)
        if strident is None and place in (
            "alveolar", "postalveolar", "alveolopalatal", "labiodental"
        ):
            s(strid=1)
    elif manner == "approximant":
        s(son=1, cont=1, cons=-1)
    elif manner == "trill":
        s(son=1, cont=1)
    elif manner == "tap":
        s(son=1)
    if lateral:
        s(lat=1, son=1)
    if strident is not None:
        s(strid=1 if strident else -1)
    return v


def _vowel(hi: int, lo: int, back: int, rnd: bool, tense: int) -> list:
    return _vec(
        syl=1, son=1, cons=-1, cont=1, delrel=-1, lat=-1, nas=-1, strid=0,
        voi=1, sg=-1, cg=-1, ant=0, cor=-1, distr=0,
        lab=1 if rnd else -1, hi=hi, lo=lo, back=back,
        round=1 if rnd else -1, velaric=-1, tense=tense, long=-1,
        hitone=0, hireg=0,
    )


def _build_base_table() -> Dict[str, list]:
    C = _consonant
    t: Dict[str, list] = {}
    # --- plosives
    for sym, place, voiced in [
        ("p", "bilabial", False), ("b", "bilabial", True),
        ("t", "alveolar", False), ("d", "alveolar", True),
        ("ʈ", "retroflex", False), ("ɖ", "retroflex", True),
        ("c", "palatal", False), ("ɟ", "palatal", True),
        ("k", "velar", False), ("ɡ", "velar", True), ("g", "velar", True),
        ("q", "uvular", False), ("ɢ", "uvular", True),
        ("ʡ", "pharyngeal", False),
    ]:
        t[sym] = C(place, "stop", voiced)
    t["ʔ"] = _vec(
        syl=-1, son=-1, cons=-1, cont=-1, delrel=-1, lat=-1, nas=-1, strid=-1,
        voi=-1, sg=-1, cg=1, ant=-1, cor=-1, distr=-1, lab=-1, hi=-1, lo=-1,
        back=-1, round=-1, velaric=-1, tense=0, long=-1,
    )
    # --- nasals
    for sym, place in [
        ("m", "bilabial"), ("ɱ", "labiodental"), ("n", "alveolar"),
        ("ɳ", "retroflex"), ("ɲ", "palatal"), ("ŋ", "velar"), ("ɴ", "uvular"),
    ]:
        t[sym] = C(place, "nasal", True)
    # --- trills / taps
    t["ʙ"] = C("bilabial", "trill", True)
    t["r"] = C("alveolar", "trill", True)
    t["ʀ"] = C("uvular", "trill", True)
    t["ɾ"] = C("alveolar", "tap", True)
    t["ɽ"] = C("retroflex", "tap", True)
    # --- fricatives
    for sym, place, voiced in [
        ("ɸ", "bilabial", False), ("β", "bilabial", True),
        ("f", "labiodental", False), ("v", "labiodental", True),
        ("θ", "dental", False), ("ð", "dental", True),
        ("s", "alveolar", False), ("z", "alveolar", True),
        ("ʃ", "postalveolar", False), ("ʒ", "postalveolar", True),
        ("ʂ", "retroflex", False), ("ʐ", "retroflex", True),
        ("ɕ", "alveolopalatal", False), ("ʑ", "alveolopalatal", True),
        ("ç", "palatal", False), ("ʝ", "palatal", True),
        ("x", "velar", False), ("ɣ", "velar", True),
        ("χ", "uvular", False), ("ʁ", "uvular", True),
        ("ħ", "pharyngeal", False), ("ʕ", "pharyngeal", True),
    ]:
        t[sym] = C(place, "fricative", voiced)
    t["θ"][_IDX["strid"]] = -1.0
    t["ð"][_IDX["strid"]] = -1.0
    t["h"] = _vec(
        syl=-1, son=-1, cons=-1, cont=1, delrel=-1, lat=-1, nas=-1, strid=-1,
        voi=-1, sg=1, cg=-1, ant=-1, cor=-1, distr=-1, lab=-1, hi=-1, lo=-1,
        back=-1, round=-1, velaric=-1, tense=0, long=-1,
    )
    t["ɦ"] = list(t["h"])
    t["ɦ"][_IDX["voi"]] = 1.0
    # --- lateral fricatives/approximants
    t["ɬ"] = C("alveolar", "fricative", False, lateral=True, strident=False)
    t["ɬ"][_IDX["son"]] = -1.0
    t["ɮ"] = C("alveolar", "fricative", True, lateral=True, strident=False)
    t["ɮ"][_IDX["son"]] = -1.0
    t["l"] = C("alveolar", "approximant", True, lateral=True)
    t["l"][_IDX["cons"]] = 1.0
    t["ɭ"] = C("retroflex", "approximant", True, lateral=True)
    t["ʎ"] = C("palatal", "approximant", True, lateral=True)
    t["ʟ"] = C("velar", "approximant", True, lateral=True)
    # --- approximants / glides
    t["ʋ"] = C("labiodental", "approximant", True, strident=False)
    t["ɹ"] = C("alveolar", "approximant", True)
    t["ɻ"] = C("retroflex", "approximant", True)
    t["j"] = C("palatal", "approximant", True)
    t["ɰ"] = C("velar", "approximant", True)
    t["w"] = C("labiovelar", "approximant", True)
    t["ɥ"] = C("labiovelar", "approximant", True)
    t["ɥ"][_IDX["back"]] = -1.0
    t["ʍ"] = C("labiovelar", "fricative", False, strident=False)
    # --- clicks & implosives (velaric / glottalic airstream)
    for sym, base in [("ʘ", "bilabial"), ("ǀ", "dental"), ("ǃ", "alveolar"),
                      ("ǂ", "palatal"), ("ǁ", "alveolar")]:
        t[sym] = C(base, "stop", False)
        t[sym][_IDX["velaric"]] = 1.0
    for sym, place in [("ɓ", "bilabial"), ("ɗ", "alveolar"), ("ʄ", "palatal"),
                       ("ɠ", "velar"), ("ʛ", "uvular")]:
        t[sym] = C(place, "stop", True)
        t[sym][_IDX["cg"]] = 1.0
    # --- vowels (hi, lo, back, round, tense)
    V = _vowel
    t.update({
        "i": V(1, -1, -1, False, 1),  "y": V(1, -1, -1, True, 1),
        "ɨ": V(1, -1, 0, False, 1),   "ʉ": V(1, -1, 0, True, 1),
        "ɯ": V(1, -1, 1, False, 1),   "u": V(1, -1, 1, True, 1),
        "ɪ": V(1, -1, -1, False, -1), "ʏ": V(1, -1, -1, True, -1),
        "ʊ": V(1, -1, 1, True, -1),
        "e": V(-1, -1, -1, False, 1), "ø": V(-1, -1, -1, True, 1),
        "ɘ": V(-1, -1, 0, False, 1),  "ɵ": V(-1, -1, 0, True, 1),
        "ɤ": V(-1, -1, 1, False, 1),  "o": V(-1, -1, 1, True, 1),
        "ə": V(-1, -1, 0, False, -1),
        "ɛ": V(-1, -1, -1, False, -1), "œ": V(-1, -1, -1, True, -1),
        "ɜ": V(-1, -1, 0, False, -1), "ɞ": V(-1, -1, 0, True, -1),
        "ʌ": V(-1, -1, 1, False, -1), "ɔ": V(-1, -1, 1, True, -1),
        "æ": V(-1, 1, -1, False, -1), "ɐ": V(-1, 1, 0, False, -1),
        "a": V(-1, 1, -1, False, 1),  "ɶ": V(-1, 1, -1, True, 1),
        "ɑ": V(-1, 1, 1, False, 1),   "ɒ": V(-1, 1, 1, True, 1),
    })
    # syllabic consonant diacritic handled via modifiers; 'ɚ'/'ɝ' rhotacized
    t["ɚ"] = list(t["ə"])
    t["ɝ"] = list(t["ɜ"])
    return t


BASE_FEATURES: Dict[str, list] = _build_base_table()

# Modifier characters: combining diacritics and spacing modifier letters that
# attach to the preceding base segment, mapped to feature overrides.
MODIFIER_FEATURES: Dict[str, dict] = {
    "ʰ": {"sg": 1},              # aspirated
    "ʱ": {"sg": 1, "voi": 1},
    "ʼ": {"cg": 1},              # ejective
    "ʲ": {"hi": 1, "back": -1},  # palatalized
    "ʷ": {"round": 1, "lab": 1},  # labialized
    "ˠ": {"hi": 1, "back": 1},   # velarized
    "ˤ": {"lo": 1, "back": 1},   # pharyngealized
    "ⁿ": {"nas": 1},             # prenasalized
    "ˡ": {"lat": 1},
    "ː": {"long": 1},            # long
    "ˑ": {"long": 1},            # half-long
    "̃": {"nas": 1},        # combining tilde: nasalized
    "̥": {"voi": -1},       # ring below: voiceless
    "̊": {"voi": -1},       # ring above: voiceless
    "̬": {"voi": 1},        # caron below: voiced
    "̩": {"syl": 1},        # syllabic
    "̯": {"syl": -1},       # non-syllabic
    "̤": {"sg": 1},         # breathy voice
    "̰": {"cg": 1},         # creaky voice
    "̼": {"distr": 1},      # linguolabial
    "̪": {"distr": 1, "ant": 1},  # dental
    "̺": {"ant": 1},        # apical
    "̻": {"distr": 1},      # laminal
    "̟": {"back": -1},      # advanced
    "̠": {"back": 1},       # retracted
    "̈": {},                # centralized (no clean mapping)
    "̽": {},                # mid-centralized
    "̝": {"hi": 1},         # raised
    "̞": {"lo": 1},         # lowered
    "̘": {"tense": 1},      # ATR
    "̙": {"tense": -1},     # RTR
    "˞": {},                # rhotacized hook (ɚ-style)
    "͡": {},                # tie bar (above) — handled by the tokenizer
    "͜": {},                # tie bar (below) — handled by the tokenizer
}

# Suprasegmentals that stand alone as their own tokens.
STRESS_MARKS = ("ˈ", "ˌ")
TONE_LETTERS = tuple("˥˦˧˨˩")
STANDALONE_MARKS = STRESS_MARKS + TONE_LETTERS + ("|", "‖", ".", "‿")

TIE_BARS = ("͡", "͜")

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_modifier(ch: str) -> bool:
    if ch in MODIFIER_FEATURES:
        return True
    cat = unicodedata.category(ch)
    return cat in ("Mn", "Mc", "Sk") or (cat == "Lm" and ch not in STANDALONE_MARKS)


def _is_base_phone(ch: str) -> bool:
    return ch in BASE_FEATURES


def tokenize_ipa(
    text: str, unknown: bool = True, merge_same_vowels: bool = False
) -> List[str]:
    """Tokenize an IPA string into phone segments.

    A segment is a base phone plus any attached modifiers; tie bars join two
    base phones into one affricate/double-articulation segment. Stress marks
    and tone letters are their own tokens. Non-IPA characters are kept as
    single-character tokens when ``unknown=True`` and discarded otherwise.

    >>> tokenize_ipa('t͡ʃiːz')
    ['t͡ʃ', 'iː', 'z']
    >>> tokenize_ipa('ˈhɛloʊ')
    ['ˈ', 'h', 'ɛ', 'l', 'o', 'ʊ']
    >>> tokenize_ipa('ʃin1[}!]', unknown=False)
    ['ʃ', 'i', 'n']
    """
    tokens: List[str] = []
    current = ""
    tie_pending = False
    for ch in unicodedata.normalize("NFD", text):
        if ch in TIE_BARS:
            if current:
                current += ch
                tie_pending = True
            continue
        if ch in STANDALONE_MARKS:
            if current:
                tokens.append(current)
                current = ""
            tokens.append(ch)
            tie_pending = False
            continue
        if _is_base_phone(ch):
            if tie_pending and current:
                current += ch
                tie_pending = False
            else:
                if current:
                    tokens.append(current)
                current = ch
            continue
        if _is_modifier(ch) and current:
            current += ch
            continue
        # Unknown character.
        if current:
            tokens.append(current)
            current = ""
        tie_pending = False
        if unknown and not ch.isspace():
            tokens.append(ch)
    if current:
        tokens.append(current)
    return [unicodedata.normalize("NFC", tok) for tok in tokens]


@lru_cache(maxsize=4096)
def segment_features(segment: str) -> Optional[tuple]:
    """Return the 24-dim articulatory feature vector for one IPA segment.

    Multi-base segments (diphthongs, tied affricates) average their
    components, zeroing dimensions where components disagree in sign —
    matching the reference's diphthong handling
    (everyvoice/text/features.py:188-194). Returns None for non-phones.

    >>> fs = segment_features('aɪ')
    >>> fs[_IDX['hi']], fs[_IDX['lo']], fs[_IDX['back']]
    (0.0, 0.0, -1.0)
    """
    decomposed = unicodedata.normalize("NFD", segment)
    component_vecs: List[list] = []
    current: Optional[list] = None
    tied = False
    for ch in decomposed:
        if ch in TIE_BARS:
            tied = True
            continue
        if ch in BASE_FEATURES:
            current = list(BASE_FEATURES[ch])
            component_vecs.append(current)
        elif ch in MODIFIER_FEATURES and current is not None:
            for name, value in MODIFIER_FEATURES[ch].items():
                current[_IDX[name]] = float(value)
        elif _is_modifier(ch):
            continue
        else:
            return None
    if not component_vecs:
        return None
    if len(component_vecs) == 1:
        return tuple(component_vecs[0])
    if tied and len(component_vecs) == 2:
        first, second = component_vecs
        is_stop = first[_IDX["cont"]] == -1.0 and first[_IDX["son"]] == -1.0
        is_fric = second[_IDX["cont"]] == 1.0 and second[_IDX["son"]] == -1.0
        if is_stop and is_fric:
            # Tied affricate: stop closure released into a fricative — the
            # single-segment value is the fricative's place/voicing/stridency
            # with [-cont, +delrel] (textbook affricate spec; panphon gives
            # t͡ʃ exactly this decomposition), NOT the mean of the parts.
            out = list(second)
            out[_IDX["cont"]] = -1.0
            out[_IDX["delrel"]] = 1.0
            return tuple(out)
    import numpy as np

    stacked = np.asarray(component_vecs)
    mean = stacked.mean(axis=0)
    # Disagreeing dims -> 0; agreeing dims keep their shared value.
    out = np.where(np.all(stacked == stacked[0], axis=0), stacked[0], np.sign(mean) * (np.abs(mean) == 1.0))
    # Components that partially agree (e.g. +1 and 0) round toward the mean sign.
    partial = ~np.all(stacked == stacked[0], axis=0)
    out = np.where(partial, np.where(np.abs(mean) >= 0.5, np.sign(mean), 0.0), out)
    return tuple(float(x) for x in out)


def is_ipa_segment(segment: str) -> bool:
    """True if the string parses as one or more known IPA base phones."""
    return segment_features(segment) is not None

"""Built-in English grapheme-to-phoneme engine.

Copied from everyvoice_tpu/text/english_g2p.py, which the port may not import;
tests/test_torch_g2p.py holds the copy to the original.

The reference delegates English G2P to the `g2p` library's trained
CMUdict-derived `eng`→`eng-ipa` transducer (reference
everyvoice/text/phonemizer.py:20-110); that dependency is not available
here, so we ship a self-contained engine with the same output alphabet:

1. an ARPABET exception lexicon (everyvoice_tpu_torch.text.english_lexicon)
   with morphological extension (plural/possessive/past/-ing/-ly),
2. letter-to-sound rules for out-of-vocabulary words, emitting the same
   phone inventory (ʌ for schwa, ɜ˞ for the r-colored vowel, r-controlled
   vowel digraphs) so OOV words stay inside the declared symbol set.

Accuracy against the reference-produced IPA in
reference everyvoice/tests/data/metadata_phones.psv is pinned by
tests/test_g2p_accuracy.py. The engine stays pluggable: users can
register a better engine via ``TextConfig.g2p_engines``.

Output is a list of IPA phone tokens as produced by
everyvoice_tpu_torch.text.ipa.tokenize_ipa (diphthongs split into components,
stress marks as separate tokens).
"""

from __future__ import annotations

import re
from typing import List

from everyvoice_tpu_torch.text.english_lexicon import lookup as _lexicon_lookup

# Ordered letter-to-sound rules: (pattern, ipa). Applied greedily left to
# right, longest-pattern first at each position. The phone alphabet matches
# the lexicon's (g2p-library conventions): schwa-like reductions → ʌ,
# r-colored vowels → ɜ˞ / ɑɹ / ɔɹ / iɹ / ɛɹ / ʊɹ.
MULTIGRAPH_RULES = [
    ("tions", "ʃʌnz"), ("sions", "ʒʌnz"),
    ("tion", "ʃʌn"), ("sion", "ʒʌn"), ("cial", "ʃʌl"), ("tial", "ʃʌl"),
    ("cious", "ʃʌs"), ("tious", "ʃʌs"), ("ture", "t͡ʃɜ˞"),
    ("sure", "ʒɜ˞"), ("ould", "ʊd"), ("ause", "ɔz"), ("alk", "ɔk"),
    ("ought", "ɔt"), ("aught", "ɔt"), ("ight", "aɪt"),
    ("eigh", "eɪ"), ("ough", "ʌf"), ("augh", "æf"), ("tch", "t͡ʃ"),
    ("dge", "d͡ʒ"), ("sch", "sk"), ("ear", "iɹ"), ("eer", "iɹ"),
    ("ier", "iɹ"), ("air", "ɛɹ"), ("are", "ɛɹ"), ("oor", "ɔɹ"),
    ("our", "ɔɹ"), ("ure", "ʊɹ"),
    ("ar", "ɑɹ"), ("or", "ɔɹ"), ("er", "ɜ˞"), ("ir", "ɜ˞"), ("ur", "ɜ˞"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("au", "ɔ"), ("aw", "ɔ"),
    ("ea", "i"), ("ee", "i"), ("ei", "eɪ"), ("eu", "ju"), ("ew", "ju"),
    ("ey", "eɪ"), ("ie", "i"), ("oa", "oʊ"), ("oe", "oʊ"), ("oi", "ɔɪ"),
    ("oo", "u"), ("ou", "aʊ"), ("ow", "aʊ"), ("oy", "ɔɪ"), ("ue", "u"),
    ("ui", "u"),
    ("psych", "saɪk"), ("chr", "kɹ"), ("chl", "kl"), ("chn", "kn"),
    ("old", "oʊld"),
    # n+soft-g: change/strange/revenge/sponge (finger-type ŋɡ words keep
    # the plain ng rule via their -inge-/-nger- spellings)
    ("ange", "eɪnd͡ʒ"), ("enge", "ɛnd͡ʒ"), ("onge", "ʌnd͡ʒ"),
    ("unge", "ʌnd͡ʒ"),
    ("ique", "ik"), ("exa", "ɪɡzæ"), ("alt", "ɔlt"),
    ("every", "ɛvɹi"), ("charac", "kɛɹʌk"),
    ("ch", "t͡ʃ"), ("ck", "k"), ("gh", "ɡ"), ("gn", "n"), ("kn", "n"),
    ("ng", "ŋ"), ("ph", "f"), ("qu", "kw"), ("sh", "ʃ"), ("th", "θ"),
    ("wh", "w"), ("wr", "ɹ"), ("mb", "m"), ("ps", "s"),
    ("bb", "b"), ("dd", "d"), ("ff", "f"), ("gg", "ɡ"), ("ll", "l"),
    ("mm", "m"), ("nn", "n"), ("pp", "p"), ("rr", "ɹ"), ("ss", "s"),
    ("tt", "t"), ("zz", "z"), ("cc", "k"),
]

SINGLE_LETTER = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f",
    "g": "ɡ", "h": "h", "i": "ɪ", "j": "d͡ʒ", "k": "k", "l": "l",
    "m": "m", "n": "n", "o": "ɑ", "p": "p", "q": "k", "r": "ɹ",
    "s": "s", "t": "t", "u": "ʌ", "v": "v", "w": "w", "x": "ks",
    "y": "j", "z": "z",
}

_VOWELS = set("aeiouy")

# "Magic e": vowel + single consonant + final e → long vowel, silent e.
_LONG_VOWEL = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "ju"}


# Productive suffixes peeled off before the letter loop, with their
# CMUdict-conventional pronunciations (unstressed vowels → ʌ in the g2p
# alphabet). (suffix, tail IPA, restore_e): when restore_e is True the
# stem gets its silent e back before recursing (excite-ment).
# Ordered longest-first; tuned on the held-IN lexicon slice only — the
# held-out slice is reserved for tools/eval_g2p.py and the pinned floors
# in tests/test_g2p_accuracy.py.
SUFFIX_RULES = [
    ("ological", "ʌlɑd͡ʒɪkʌl", False), ("ization", "ʌzeɪʃʌn", False),
    ("isation", "ʌzeɪʃʌn", False), ("ability", "ʌbɪlʌti", False),
    ("ibility", "ʌbɪlʌti", False), ("ological", "ʌlɑd͡ʒɪkʌl", False),
    ("ology", "ɑlʌd͡ʒi", False), ("ation", "eɪʃʌn", False),
    ("ition", "ɪʃʌn", False), ("ution", "uʃʌn", False),
    ("ssion", "ʃʌn", False), ("cious", "ʃʌs", False),
    ("tious", "ʃʌs", False), ("ious", "iʌs", False),
    ("eous", "iʌs", False), ("cially", "ʃʌli", False),
    ("tially", "ʃʌli", False), ("cial", "ʃʌl", False),
    ("tial", "ʃʌl", False), ("cian", "ʃʌn", False),
    ("cience", "ʃʌns", False), ("cient", "ʃʌnt", False),
    ("able", "ʌbʌl", False), ("ible", "ʌbʌl", False),
    ("ical", "ɪkʌl", False), ("ically", "ɪkli", False),
    ("ement", "mʌnt", True), ("ment", "mʌnt", False),
    ("ness", "nʌs", False), ("less", "lʌs", False),
    ("ful", "fʌl", False), ("ity", "ʌti", False),
    ("ety", "ʌti", False), ("ture", "t͡ʃɜ˞", False),
    ("sure", "ʒɜ˞", False), ("ious", "iʌs", False),
    ("ism", "ɪzʌm", False), ("ist", "ɪst", False),
    ("ize", "aɪz", False), ("ise", "aɪz", False),
    ("ify", "ʌfaɪ", False), ("age", "ɪd͡ʒ", False),
    ("ive", "ɪv", False), ("ier", "iɜ˞", False),
    ("iest", "iʌst", False), ("ance", "ʌns", False),
    ("ence", "ʌns", False), ("ancy", "ʌnsi", False),
    ("ency", "ʌnsi", False), ("ant", "ʌnt", False),
    ("ent", "ʌnt", False), ("ery", "ɜ˞i", False),
    ("ary", "ɛɹi", False), ("ory", "ɔɹi", False),
    ("erous", "ɜ˞ʌs", False),
    ("ous", "ʌs", False), ("stion", "st͡ʃʌn", False),
    ("ction", "kʃʌn", False),
    ("ion", "jʌn", False), ("asm", "æzʌm", False),
    ("ted", "tɪd", False), ("ded", "dɪd", False),
    ("ies", "iz", False),
    ("ator", "eɪtɜ˞", False), ("ior", "iɜ˞", False),
    ("ely", "li", True), ("ly", "li", False), ("al", "ʌl", False),
]

# Magic-e must not fire on these endings — a dedicated suffix or
# multigraph rule owns them (tu+re → t͡ʃɜ˞, not tjuɹ).
_MAGIC_E_EXCLUDE = ("ture", "sure")

# Unstressed Latinate prefixes: re-/de-/be-/pre- before a consonant
# onset reduce to ɪ (report ɹɪpɔɹt, depend dɪpɛnd, become bɪkʌm,
# prevent pɹɪvɛnt — CMUdict IH0 → the g2p alphabet keeps ɪ), and ex-
# before a consonant is ɪks (expect ɪkspɛkt). Applied only when the
# remainder still contains a vowel (so "red", "desk", "bed", "next"
# fall through to the letter loop). Tuned on the held-IN slice only.
PREFIX_RULES = [
    ("ex", "ɪks"), ("pre", "pɹɪ"), ("re", "ɹɪ"), ("de", "dɪ"),
    ("be", "bɪ"),
]


def _split_prefix(word: str):
    for prefix, ipa in PREFIX_RULES:
        if not word.startswith(prefix) or len(word) < len(prefix) + 3:
            continue
        rest = word[len(prefix):]
        # consonant onset + a later vowel → an unstressed open prefix
        # syllable (re-port); vowel-initial rests (read, death) keep the
        # prefix letters inside the normal letter loop.
        if rest[0] not in _VOWELS and any(c in _VOWELS for c in rest[1:]):
            return ipa, rest
    return None


def _letters_to_sound(word: str, _depth: int = 0) -> str:
    """Rule-based fallback for words the lexicon cannot derive."""
    # Peel one productive suffix and recurse on the stem (bounded depth:
    # nation-al-ity style stacks resolve in ≤2 peels).
    if _depth < 2:
        for suffix, tail, restore_e in SUFFIX_RULES:
            stem = word[: -len(suffix)]
            if word.endswith(suffix) and len(stem) >= 3:
                # -tion/-sion belong to the ʃʌn multigraphs, not to the
                # bare "ion" peel (action → æk-ʃʌn, not act-jʌn).
                if suffix == "ion" and stem[-1] in "ts":
                    continue
                if restore_e:
                    stem += "e"
                return _letters_to_sound(stem, _depth + 1) + tail
    # Peel an unstressed Latinate prefix (re-port → ɹɪ + port).
    pref = _split_prefix(word)
    if pref is not None:
        return pref[0] + _letters_to_sound(pref[1], _depth)
    # Handle the magic-e pattern on the final syllable.
    m = re.search(r"([aeiou])([bcdfgklmnprstvz])e$", word)
    long_sub = None
    soft_final = None
    if m and len(word) > 3 and not word.endswith(_MAGIC_E_EXCLUDE):
        long_sub = (m.start(1), _LONG_VOWEL[m.group(1)])
        # The dropped silent e kept a preceding c/g soft (police, oblige).
        if m.group(2) == "c":
            soft_final = "s"
        elif m.group(2) == "g":
            soft_final = "d͡ʒ"
        word = word[: m.start(2) + 1]  # drop the silent e
    out = []
    i = 0
    while i < len(word):
        if long_sub is not None and i == long_sub[0]:
            out.append(long_sub[1])
            i += 1
            continue
        if soft_final is not None and i == len(word) - 1:
            out.append(soft_final)
            i += 1
            continue
        # soft c / soft g before e, i, y
        if word[i] == "c" and i + 1 < len(word) and word[i + 1] in "eiy":
            out.append("s")
            i += 1
            continue
        if word[i] == "g" and i + 1 < len(word) and word[i + 1] in "eiy":
            out.append("d͡ʒ")
            i += 1
            continue
        # y as a vowel when not word-initial
        if word[i] == "y" and i > 0:
            out.append("i" if i == len(word) - 1 else "ɪ")
            i += 1
            continue
        # final unstressed -e(d)/-es handled by morphology; a lone final e
        # after a consonant cluster is usually silent (e.g. "ensemble").
        if (
            word[i] == "e"
            and i == len(word) - 1
            and i > 1
            and word[i - 1] not in _VOWELS
        ):
            i += 1
            continue
        # Word-final single vowels: radio → oʊ, extra → ʌ (the unstressed
        # CMUdict finals), not the closed-syllable defaults.
        if i == len(word) - 1 and word[i] == "o":
            out.append("oʊ")
            i += 1
            continue
        if i == len(word) - 1 and word[i] == "a" and len(word) > 2:
            out.append("ʌ")
            i += 1
            continue
        # "ear" + consonant → ɜ˞ (early, learn, search, heard); the
        # ear/eer/ier → iɹ multigraphs keep the prevocalic/final cases.
        if (
            word.startswith("ear", i)
            and i + 3 < len(word)
            and word[i + 3] not in _VOWELS
        ):
            out.append("ɜ˞")
            i += 3
            continue
        # Non-initial "ther" closing a syllable voices the th (mother,
        # northern, otherwise); therapy-type onsets (vowel follows) and
        # word-initial th keep the default θ.
        if (
            word.startswith("ther", i)
            and i > 0
            and (i + 4 == len(word) or word[i + 4] not in _VOWELS)
        ):
            out.append("ðɜ˞")
            i += 4
            continue
        # Initial w rounds a following a (want wɑnt, wash wɑʃ, watch
        # wɑt͡ʃ); war- is handled by the ar→ɑɹ... no: wɔɹ via "ar"? keep
        # to the t/s/n contexts where CMUdict is uniform.
        if (
            i == 0
            and word.startswith("wa")
            and len(word) > 2
            and word[2] in "tsn"
        ):
            out.append("wɑ")
            i += 2
            continue
        # Word-final "-ind" is the long-vowel family (find, kind, behind);
        # window-type medial "ind" stays short.
        if i + 3 == len(word) and word.startswith("ind", i) and i > 0:
            out.append("aɪnd")
            i += 3
            continue
        # Unstressed word-final -en / -el after a consonant in longer
        # words reduce to ʌ (hidden hɪdʌn, model mɑdʌl).
        if (
            i + 2 == len(word)
            and len(word) >= 5
            and word[i] == "e"
            and word[i + 1] in "nl"
            and i > 0
            and word[i - 1] not in _VOWELS
        ):
            out.append("ʌ" + ("n" if word[i + 1] == "n" else "l"))
            i += 2
            continue
        # Unstressed final syllables -son / -man (person, reason, workman,
        # human — CMUdict S AH0 N / M AH0 N).
        if i > 1 and i + 3 == len(word) and word.startswith("son", i):
            out.append("sʌn")
            i += 3
            continue
        if i > 1 and i + 3 == len(word) and word.startswith("man", i):
            out.append("mʌn")
            i += 3
            continue
        # Final plural/genitive-looking single s after a voiced consonant
        # sounds z (others, colors, news); monosyllables and vowel-final
        # stems (gas, tennis) keep s.
        if (
            i + 1 == len(word)
            and len(word) >= 4
            and word[i] == "s"
            and word[i - 1] in "bdgvmnlrwy"
        ):
            out.append("z")
            i += 1
            continue
        for pattern, ipa in MULTIGRAPH_RULES:
            if word.startswith(pattern, i) and not (
                # never swallow the magic-e long vowel into a digraph
                # (cre|ate: "ea" must not consume the long a of a-t-e)
                long_sub is not None
                and i < long_sub[0] < i + len(pattern)
            ):
                out.append(ipa)
                i += len(pattern)
                break
        else:
            out.append(SINGLE_LETTER.get(word[i], ""))
            i += 1
    return "".join(out)


def _word_to_ipa(word: str) -> str:
    word = word.lower()
    hit = _lexicon_lookup(word)
    if hit is not None:
        return hit
    if "-" in word:  # hyphenated compounds: derive each part
        return "".join(_word_to_ipa(part) for part in word.split("-") if part)
    return _letters_to_sound(word)


def english_g2p(normalized_text: str) -> List[str]:
    """Convert normalized English text to a list of IPA phone tokens.

    >>> english_g2p('hello')
    ['h', 'ʌ', 'l', 'o', 'ʊ']
    >>> english_g2p('cheese cake')[:3]
    ['t͡ʃ', 'i', 'z']
    >>> ''.join(english_g2p('the future'))
    'ðʌ fjut͡ʃɜ˞'
    """
    from everyvoice_tpu_torch.text.ipa import tokenize_ipa

    tokens: List[str] = []
    pieces = re.split(r"([^\w'-]+)", normalized_text)
    for piece in pieces:
        if not piece:
            continue
        if re.match(r"^[\w'-]*\w[\w'-]*$", piece, re.UNICODE):
            tokens.extend(tokenize_ipa(_word_to_ipa(piece)))
        else:
            # Punctuation and whitespace pass through character by character;
            # the TextProcessor validates them against its inventory.
            for ch in piece:
                tokens.append(ch)
    return tokens

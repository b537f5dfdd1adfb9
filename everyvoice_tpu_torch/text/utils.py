"""Grapheme guessing for ``check text-config`` (counterpart of
``guess_graphemes_in_text`` and ``guess_graphemes_in_text_lines`` in
everyvoice_tpu/text/utils.py, which use the ``regex`` module's ``\\X``).

``graphemes(text)`` splits text into extended grapheme clusters by the
rules of Unicode's UAX #29 with the standard library only: CR LF, controls,
Hangul syllable sequences, a base followed by its marks (``Mn``, ``Mc``,
``Me``), ZWJ and variation selectors, prepended concatenation marks, Indic
conjuncts (consonant, virama, consonant), emoji ZWJ sequences and flag
pairs. The grapheme properties that ``unicodedata`` lacks are tabled below
as code-point ranges; they are the values ``regex`` uses.

The wizard's helpers are here too: ``guess_ipa_phones_in_text(_lines)``, and
``is_sentence_final``, whose ``\\p{Sentence_Break=ST}|\\p{Sentence_Break=AT}``
(UAX #29's STerm and ATerm) is a table of code-point ranges generated once
from ``regex``, as the grapheme tables were.
"""

from __future__ import annotations

import unicodedata
from bisect import bisect_right


def _table(*ranges) -> tuple:
    starts = tuple(lo for lo, _ in ranges)
    return starts, tuple(ranges)


def _in(table: tuple, cp: int) -> bool:
    starts, ranges = table
    i = bisect_right(starts, cp) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


# Not a mark, yet extends the cluster: ZWNJ, halfwidth voiced marks, emoji
# skin-tone modifiers, tag characters.
_EXTEND = _table((0x200C, 0x200C), (0xFF9E, 0xFF9F), (0x1F3FB, 0x1F3FF), (0xE0020, 0xE007F))
_SPACING = _table((0x0E33, 0x0E33), (0x0EB3, 0x0EB3))
# Spacing marks that start a cluster of their own.
_MARK_OTHER = _table(
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D), (0x1083, 0x1083),
    (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61), (0x1A63, 0x1A64),
    (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D), (0x11720, 0x11721))
_PREPEND = _table(
    (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891), (0x08E2, 0x08E2),
    (0x0D4E, 0x0D4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
    (0x113D1, 0x113D1), (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A84, 0x11A89),
    (0x11D46, 0x11D46), (0x11F02, 0x11F02))
# Unassigned default-ignorable code points, which break like controls.
_CONTROL_UNASSIGNED = _table((0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000),
                             (0xE0002, 0xE001F), (0xE0080, 0xE00FF), (0xE01F0, 0xE0FFF))
# Indic conjuncts (InCB): linkers (viramas that join), the consonants they
# join, and the spacing marks that may sit between.
_LINKERS = frozenset((0x094D, 0x09CD, 0x0ACD, 0x0B4D, 0x0C4D, 0x0D4D, 0x1039, 0x17D2, 0x1A60,
                      0x1B44, 0x1BAB, 0xA9C0, 0xAAF6, 0x10A3F, 0x11133, 0x1193E, 0x11A47,
                      0x11A99, 0x11F42))
_CONSONANTS = _table(
    (0x0915, 0x0939), (0x0958, 0x095F), (0x0978, 0x097F), (0x0995, 0x09A8), (0x09AA, 0x09B0),
    (0x09B2, 0x09B2), (0x09B6, 0x09B9), (0x09DC, 0x09DD), (0x09DF, 0x09DF), (0x09F0, 0x09F1),
    (0x0A95, 0x0AA8), (0x0AAA, 0x0AB0), (0x0AB2, 0x0AB3), (0x0AB5, 0x0AB9), (0x0AF9, 0x0AF9),
    (0x0B15, 0x0B28), (0x0B2A, 0x0B30), (0x0B32, 0x0B33), (0x0B35, 0x0B39), (0x0B5C, 0x0B5D),
    (0x0B5F, 0x0B5F), (0x0B71, 0x0B71), (0x0C15, 0x0C28), (0x0C2A, 0x0C39), (0x0C58, 0x0C5A),
    (0x0D15, 0x0D3A), (0x1000, 0x102A), (0x103F, 0x103F), (0x1050, 0x1055), (0x105A, 0x105D),
    (0x1061, 0x1061), (0x1065, 0x1066), (0x106E, 0x1070), (0x1075, 0x107F), (0x1780, 0x17B3),
    (0x1A20, 0x1A54), (0x1B0B, 0x1B0C), (0x1B13, 0x1B33), (0x1B45, 0x1B4C), (0x1B83, 0x1BA0),
    (0x1BAE, 0x1BAF), (0x1BBB, 0x1BBD), (0xA989, 0xA98B), (0xA98F, 0xA9B2), (0xA9E0, 0xA9E4),
    (0xA9E7, 0xA9EF), (0xA9FA, 0xA9FE), (0xAAE0, 0xAAEA), (0x10A00, 0x10A00),
    (0x10A10, 0x10A13), (0x10A15, 0x10A17), (0x10A19, 0x10A35), (0x11103, 0x11126),
    (0x11144, 0x11144), (0x11147, 0x11147), (0x11900, 0x11906), (0x11909, 0x11909),
    (0x1190C, 0x11913), (0x11915, 0x11916), (0x11918, 0x1192F), (0x11A00, 0x11A00),
    (0x11A0B, 0x11A32), (0x11A50, 0x11A50), (0x11A5C, 0x11A7F), (0x11A80, 0x11A83),
    (0x11F04, 0x11F10), (0x11F12, 0x11F33))
_CONJUNCT_MC = _table(
    (0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57), (0x0BBE, 0x0BBE),
    (0x0BD7, 0x0BD7), (0x0CC0, 0x0CC0), (0x0CC2, 0x0CC2), (0x0CC7, 0x0CC8), (0x0CCA, 0x0CCB),
    (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
    (0x1715, 0x1715), (0x1734, 0x1734), (0x1B35, 0x1B35), (0x1B3B, 0x1B3B), (0x1B3D, 0x1B3D),
    (0x1B43, 0x1B44), (0x1BAA, 0x1BAA), (0x1BF2, 0x1BF3), (0x302E, 0x302F), (0xA953, 0xA953),
    (0xA9C0, 0xA9C0), (0x111C0, 0x111C0), (0x11235, 0x11235), (0x1133E, 0x1133E),
    (0x1134D, 0x1134D), (0x11357, 0x11357), (0x114B0, 0x114B0), (0x114BD, 0x114BD),
    (0x115AF, 0x115AF), (0x116B6, 0x116B6), (0x11930, 0x11930), (0x1193D, 0x1193D),
    (0x11F41, 0x11F41), (0x16FF0, 0x16FF1), (0x1D165, 0x1D166), (0x1D16D, 0x1D172))
_PICTOGRAPHIC = _table(
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
    (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
    (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x27BF),
    (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55),
    (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297), (0x3299, 0x3299),
    (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A),
    (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F),
    (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF),
    (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))

CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING, L, V, T, LV, LVT, OTHER = range(14)


def _class(cp: int) -> int:
    """The code point's Grapheme_Cluster_Break value."""
    if cp == 0x0D:
        return CR
    if cp == 0x0A:
        return LF
    if cp == 0x200D:
        return ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return T
    if 0xAC00 <= cp <= 0xD7A3:
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    if _in(_PREPEND, cp):
        return PREPEND
    if _in(_EXTEND, cp):
        return EXTEND
    if _in(_SPACING, cp):
        return SPACING
    category = unicodedata.category(chr(cp))
    if category in ("Mn", "Me"):
        return EXTEND
    if category == "Mc":
        return OTHER if _in(_MARK_OTHER, cp) else SPACING
    if category in ("Cc", "Cf", "Zl", "Zp") or (category == "Cn" and _in(_CONTROL_UNASSIGNED, cp)):
        return CONTROL
    return OTHER


def _conjunct_extend(cp: int, cls: int) -> bool:
    """InCB=Extend: a mark that may sit inside an Indic conjunct."""
    if cls == ZWJ:
        return True
    if cls == EXTEND:
        return cp != 0x200C and cp != 0x1171E
    return cls == SPACING and _in(_CONJUNCT_MC, cp)


def graphemes(text: str) -> list:
    """``text`` split into extended grapheme clusters, as
    ``regex.findall(r"\\X", text)`` splits it."""
    clusters: list = []
    prev = None
    emoji = 0      # 1: pictograph then extends, 2: ... then ZWJ
    ri_run = 0     # regional indicators in a row, ending at prev
    conjunct = 0   # 1: consonant (then extends), 2: ... then a linker
    for ch in text:
        cp = ord(ch)
        cls = _class(cp)
        if prev is None:
            joins = False
        elif prev == CR and cls == LF:
            joins = True
        elif prev in (CONTROL, CR, LF) or cls in (CONTROL, CR, LF):
            joins = False
        elif prev == L and cls in (L, V, LV, LVT):
            joins = True
        elif prev in (LV, V) and cls in (V, T):
            joins = True
        elif prev in (LVT, T) and cls == T:
            joins = True
        elif cls in (EXTEND, ZWJ, SPACING) or prev == PREPEND:
            joins = True
        elif conjunct == 2 and _in(_CONSONANTS, cp):
            joins = True
        elif emoji == 2 and _in(_PICTOGRAPHIC, cp):
            joins = True
        else:
            joins = prev == RI and cls == RI and ri_run % 2 == 1
        if joins:
            clusters[-1] += ch
        else:
            clusters.append(ch)
        if _in(_PICTOGRAPHIC, cp):
            emoji = 1
        elif emoji == 1 and cls == ZWJ:
            emoji = 2
        elif not (emoji == 1 and cls == EXTEND):
            emoji = 0
        ri_run = ri_run + 1 if cls == RI else 0
        if _in(_CONSONANTS, cp):
            conjunct = 1
        elif conjunct and cp in _LINKERS:
            conjunct = 2
        elif not (conjunct and _conjunct_extend(cp, cls)):
            conjunct = 0
        prev = cls
    return clusters


def guess_graphemes_in_text(text: str) -> set:
    """The set of grapheme clusters in ``text``.

    >>> sorted(guess_graphemes_in_text('g\\u0331an'))
    ['a', 'g̱', 'n']
    """
    return set(graphemes(text))


def guess_graphemes_in_text_lines(text_lines: list) -> set:
    """
    >>> example_data = [" කෝකටත් මං වෙනදා ", " ඇන්ජලීනා ජොලී කියන්නේ "]
    >>> sorted(guess_graphemes_in_text_lines(example_data))
    [' ', 'ඇ', 'ක', 'කි', 'කෝ', 'ජ', 'ජො', 'ට', 'ත්', 'දා', 'න', 'න්', 'නා', 'නේ', 'මං', 'ය', 'ලී', 'වෙ']
    """
    found: set = set()
    for line in text_lines:
        found.update(graphemes(line))
    return found


def guess_ipa_phones_in_text(text: str) -> set:
    """The IPA phones in ``text``, anything that is not IPA dropped.

    >>> sorted(guess_ipa_phones_in_text('ʃin1[}!]'))
    ['i', 'n', 'ʃ']
    """
    from everyvoice_tpu_torch.text.ipa import tokenize_ipa

    return set(tokenize_ipa(text, unknown=False))


def guess_ipa_phones_in_text_lines(text_lines: list) -> set:
    phones: set = set()
    for line in text_lines:
        phones.update(guess_ipa_phones_in_text(line))
    return phones


# Code points whose Sentence_Break is STerm or ATerm.
_SENTENCE_TERMINAL = _table(
    (0x0021, 0x0021), (0x002E, 0x002E), (0x003F, 0x003F), (0x0589, 0x0589), (0x061D, 0x061F),
    (0x06D4, 0x06D4), (0x0700, 0x0702), (0x07F9, 0x07F9), (0x0837, 0x0837), (0x0839, 0x0839),
    (0x083D, 0x083E), (0x0964, 0x0965), (0x104A, 0x104B), (0x1362, 0x1362), (0x1367, 0x1368),
    (0x166E, 0x166E), (0x1735, 0x1736), (0x17D4, 0x17D5), (0x1803, 0x1803), (0x1809, 0x1809),
    (0x1944, 0x1945), (0x1AA8, 0x1AAB), (0x1B4E, 0x1B4F), (0x1B5A, 0x1B5B), (0x1B5E, 0x1B5F),
    (0x1B7D, 0x1B7F), (0x1C3B, 0x1C3C), (0x1C7E, 0x1C7F), (0x2024, 0x2024), (0x203C, 0x203D),
    (0x2047, 0x2049), (0x2CF9, 0x2CFB), (0x2E2E, 0x2E2E), (0x2E3C, 0x2E3C), (0x2E53, 0x2E54),
    (0x3002, 0x3002), (0xA4FF, 0xA4FF), (0xA60E, 0xA60F), (0xA6F3, 0xA6F3), (0xA6F7, 0xA6F7),
    (0xA876, 0xA877), (0xA8CE, 0xA8CF), (0xA92F, 0xA92F), (0xA9C8, 0xA9C9), (0xAA5D, 0xAA5F),
    (0xAAF0, 0xAAF1), (0xABEB, 0xABEB), (0xFE12, 0xFE12), (0xFE15, 0xFE16), (0xFE52, 0xFE52),
    (0xFE56, 0xFE57), (0xFF01, 0xFF01), (0xFF0E, 0xFF0E), (0xFF1F, 0xFF1F), (0xFF61, 0xFF61),
    (0x10A56, 0x10A57), (0x10F55, 0x10F59), (0x10F86, 0x10F89), (0x11047, 0x11048),
    (0x110BE, 0x110C1), (0x11141, 0x11143), (0x111C5, 0x111C6), (0x111CD, 0x111CD),
    (0x111DE, 0x111DF), (0x11238, 0x11239), (0x1123B, 0x1123C), (0x112A9, 0x112A9),
    (0x113D4, 0x113D5), (0x1144B, 0x1144C), (0x115C2, 0x115C3), (0x115C9, 0x115D7),
    (0x11641, 0x11642), (0x1173C, 0x1173E), (0x11944, 0x11944), (0x11946, 0x11946),
    (0x11A42, 0x11A43), (0x11A9B, 0x11A9C), (0x11C41, 0x11C42), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F44), (0x16A6E, 0x16A6F), (0x16AF5, 0x16AF5), (0x16B37, 0x16B38),
    (0x16B44, 0x16B44), (0x16D6E, 0x16D6F), (0x16E98, 0x16E98), (0x1BC9F, 0x1BC9F),
    (0x1DA88, 0x1DA88),
)


def is_sentence_final(char: str) -> bool:
    """True if Unicode classifies the character as sentence-terminal.

    >>> is_sentence_final('!')
    True
    >>> is_sentence_final('¡')
    False
    """
    if len(char) != 1:
        raise ValueError("Input must be a character (string of length one).")
    return _in(_SENTENCE_TERMINAL, ord(char))

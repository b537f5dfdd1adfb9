"""The port's character-level text front end against the JAX package's:
the same ids from the same config, and the same chunks from chunk_text.
Exact equality (integer ids, strings)."""

import pytest

from everyvoice_tpu.config import TextConfig
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.text.textsplit import chunk_text as jax_chunk_text
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.text import TextProcessor, chunk_text

LONG = (
    "It is a long way to the sea; we walked, and walked, and then we stopped "
    "for a while by the river. Nobody there remembered who had built the mill, "
    "or why it stood so far from the village (some said 1820!), but everyone "
    "agreed: it was “beautiful”… Wasn't it? " * 3
)
TEXTS = [
    "Hello, World! How are YOU today?",
    "  Tabs\tand   spaces\n collapse  ",
    "Unknown symbols: ça, ß, &, 42 and ж drop out.",
    "Quotes «here», dashes — and * stars; [brackets] {braces}.",
    "é composed vs é precomposed",
    LONG,
]
CONFIGS = {
    "lowercase_letters": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
    "cased_with_cleaners": {
        "symbols": {"letters": list("abcdefghijklmnopqrstuvwxyzABCé")},
        "cleaners": [
            "everyvoice_tpu.utils.nfc_normalize", "everyvoice_tpu.utils.lower",
            "everyvoice_tpu.utils.collapse_whitespace", "everyvoice_tpu.utils.strip_text",
        ],
        "to_replace": {"&": " and ", "42": "forty two"},
    },
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def processors(request):
    jax_cfg = TextConfig(**CONFIGS[request.param])
    jtp = JaxTextProcessor(jax_cfg)
    # The port reads the dumped config a checkpoint header carries.
    ttp = TextProcessor(fs2_config({"text": jax_cfg.model_dump(mode="json")})["text"])
    return jtp, ttp


def test_symbol_table_matches(processors):
    jtp, ttp = processors
    assert ttp.symbols == jtp.symbols
    assert ttp.symbols[:2] == ["\x80", " "]


@pytest.mark.parametrize("text", TEXTS)
def test_ids_match(processors, text):
    jtp, ttp = processors
    want = jtp.encode_text(text, quiet=True)
    assert ttp.encode_text(text, quiet=True) == want
    assert ttp.token_sequence_to_text_sequence(want) == jtp.token_sequence_to_text_sequence(want)


def test_missing_symbols_are_counted_like_jax(processors):
    jtp, ttp = processors
    for text in TEXTS:
        jtp.encode_text(text, quiet=True)
        ttp.encode_text(text, quiet=True)
    assert ttp.missing_symbols == jtp.missing_symbols


@pytest.mark.parametrize("kwargs", [
    {}, {"desired_length": 5, "max_length": 20},
    {"desired_length": 30, "max_length": 60, "strong_boundaries": "!?", "weak_boundaries": ";"},
])
def test_chunk_text_matches(kwargs):
    for text in TEXTS + ["", "...", "no boundary at all " * 20]:
        assert chunk_text(text, **kwargs) == jax_chunk_text(text, **kwargs)


def test_phone_level_and_g2p_raise():
    """Phone level and G2P run as in the JAX package: the same id table at
    every level, the same ids through the ``eng`` engine, and the same
    ValueErrors where G2P cannot run (no engine for the language, or
    features asked for without G2P)."""
    jax_cfg = TextConfig(symbols={"ipa": ["h", "ʌ", "l", "o", "ʊ", "ɛ", "ə"]})
    jtp = JaxTextProcessor(jax_cfg)
    cfg = fs2_config({"text": jax_cfg.model_dump(mode="json")})["text"]
    assert TextProcessor(cfg, "phones").symbols == TextProcessor(cfg).symbols == jtp.symbols
    want = jtp.encode_text("hello", apply_g2p=True, lang_id="eng", quiet=True)
    assert want and TextProcessor(cfg).encode_text("hello", apply_g2p=True, lang_id="eng",
                                                    quiet=True) == want
    for kwargs in ({"apply_g2p": True, "lang_id": "xyz"},
                   {"encode_as_phonological_features": True, "lang_id": "eng"}):
        with pytest.raises(ValueError) as jax_error:
            jtp.encode_text("hello", **kwargs)
        with pytest.raises(ValueError) as port_error:
            TextProcessor(cfg, "phones").encode_text("hello", **kwargs)
        assert str(port_error.value) == str(jax_error.value)


def test_cleaners_resolve_by_name_without_the_jax_package():
    from everyvoice_tpu_torch.utils import lower, resolve_cleaner

    assert resolve_cleaner("everyvoice_tpu.utils.lower") is lower
    assert resolve_cleaner("everyvoice.utils.lower") is lower
    assert resolve_cleaner("lower") is lower
    with pytest.raises(NotImplementedError):
        resolve_cleaner("everyvoice_tpu.utils.original_hifigan_leaky_relu")


@pytest.mark.parametrize("text", TEXTS)
def test_get_missing_symbols_matches(processors, text):
    jtp, ttp = processors
    normalized = jtp.normalize_text(text)
    assert ttp.normalize_text(text) == normalized
    assert ttp.get_missing_symbols(normalized, quiet=True) == jtp.get_missing_symbols(
        normalized, quiet=True)


# Extended grapheme clusters: the port's standard-library segmenter against
# the regex module's \X, on the JAX docstrings and on seeded random text
# over scripts with marks, conjuncts, Hangul jamo, emoji and flags.
GRAPHEME_DOCS = ["g̱an", " කෝකටත් මං වෙනදා ", " ඇන්ජලීනා ජොලී කියන්නේ ",
                 "क्षत्रिय", "한국어 ᄒᆞᆫ글", "👨‍👩‍👧 🇨🇦🇫 👍🏽 ✌️", "a\r\nb؀c"]
GRAPHEME_POOLS = [
    "abcxyz \r\n\t", "".join(map(chr, range(0x300, 0x370))), "".join(map(chr, range(0xD80, 0xDF5))),
    "".join(map(chr, range(0x900, 0x980))), "".join(map(chr, range(0x980, 0xA00))),
    "".join(map(chr, range(0x1100, 0x1200))), "".join(map(chr, range(0xAC00, 0xAC40))),
    "‍‌️︎­؀", "".join(map(chr, range(0x1F600, 0x1F650))),
    "".join(map(chr, range(0x1F1E6, 0x1F200))), "".join(map(chr, range(0x1F3FB, 0x1F400))),
    "".join(map(chr, range(0x1000, 0x10A0))), "".join(map(chr, range(0xE00, 0xE80))),
]


def test_graphemes_match_regex_x():
    import random

    import regex

    from everyvoice_tpu.text.utils import guess_graphemes_in_text_lines as jax_lines
    from everyvoice_tpu_torch.text.utils import graphemes, guess_graphemes_in_text_lines

    rng = random.Random(0)
    texts = GRAPHEME_DOCS + [
        "".join(rng.choice(rng.choice(GRAPHEME_POOLS)) for _ in range(rng.randint(1, 12)))
        for _ in range(3000)]
    for text in texts:
        assert graphemes(text) == regex.findall(r"\X", text), repr(text)
    assert guess_graphemes_in_text_lines(GRAPHEME_DOCS) == jax_lines(GRAPHEME_DOCS)

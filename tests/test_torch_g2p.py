"""The port's copies of the JAX package's G2P and phonological-feature
modules (``everyvoice_tpu_torch/text/``) against the originals, on seeded
inputs. Everything is host code, so everything must agree exactly: tokens
token for token, ids as integers, and features bit for bit."""

import numpy as np
import pytest

from everyvoice_tpu.config import TextConfig
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.text import arpabet as jax_arpabet
from everyvoice_tpu.text import ipa as jax_ipa
from everyvoice_tpu.text import phonemizer as jax_phonemizer
from everyvoice_tpu.text.features import PhonologicalFeatureCalculator as JaxCalculator
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.text import arpabet, ipa, phonemizer
from everyvoice_tpu_torch.text.english_lexicon import ARPABET_LEXICON
from everyvoice_tpu_torch.text.features import PhonologicalFeatureCalculator
from everyvoice_tpu_torch.text.rule_g2p import BUILTIN_RULE_TABLES

SENTENCES = [
    "Hello, world! How are you today?",
    "The quick brown fox jumps over the lazy dog near my big red house and sings.",
    "Printing, in the only sense with which we are at present concerned; differs.",
    "Don't re-enter the “well-known” zyxwv qrstu — ok…",
]


def _port_text(jax_cfg: TextConfig) -> dict:
    """The text section the port reads from a checkpoint for ``jax_cfg``."""
    return fs2_config({"text": jax_cfg.model_dump(mode="json")})["text"]


def _words(rng, alphabet: list, n: int, low: int = 2, high: int = 10) -> list:
    return ["".join(rng.choice(alphabet, size=int(rng.integers(low, high + 1))))
            for _ in range(n)]


def _engine_inputs(lang: str) -> list:
    rng = np.random.default_rng(sum(map(ord, lang)))
    if lang == "eng":
        oov = _words(rng, list("abcdefghijklmnopqrstuvwxyz") + ["'", "-"], 500, 3, 12)
        return sorted(ARPABET_LEXICON) + oov + SENTENCES
    if lang == "und":
        alphabet = sorted(ipa.BASE_FEATURES) + list("abcdefghijklmnopqrstuvwxyzABC ,.!")
    else:
        alphabet = sorted({ch for graphemes, *_ in BUILTIN_RULE_TABLES[lang] for ch in graphemes})
    return _words(rng, alphabet, 200)


@pytest.mark.parametrize("lang", sorted(phonemizer.BUILTIN_G2P_LANGUAGES))
def test_engines_match_token_for_token(lang):
    assert set(jax_phonemizer.AVAILABLE_G2P_ENGINES) >= phonemizer.BUILTIN_G2P_LANGUAGES
    port = phonemizer.get_g2p_engine(lang)
    jax = jax_phonemizer._BUILTIN_FACTORIES[lang]()  # the built-in, never a test's plugin
    words = _engine_inputs(lang)
    got = [port(w) for w in words]
    want = [jax(w) for w in words]
    mismatched = [(w, g, x) for w, g, x in zip(words, got, want) if g != x]
    assert not mismatched, mismatched[:5]
    assert sum(map(len, got)) > len(words)  # the engine produced phones


def test_arpabet_to_ipa_matches_for_every_symbol_and_stress():
    symbols = sorted(jax_arpabet.ARPABET_TO_IPA)
    assert symbols == sorted(arpabet.ARPABET_TO_IPA)
    tokens = [f"{s}{stress}" for s in symbols for stress in ("", "0", "1", "2")]
    tokens += [t.lower() for t in tokens] + ["XX1", "?", "AH3"]
    for token in tokens:
        assert arpabet.convert_arpabet_token(token) == jax_arpabet.convert_arpabet_token(token)
        assert arpabet.arpabet_to_ipa(token) == jax_arpabet.arpabet_to_ipa(token)
    phrase = "  ".join(" ".join(tokens[i : i + 5]) for i in range(0, len(tokens), 5))
    assert arpabet.arpabet_to_ipa(phrase) == jax_arpabet.arpabet_to_ipa(phrase)
    assert (arpabet.arpabet_tokens_to_ipa_tokens(tokens)
            == jax_arpabet.arpabet_tokens_to_ipa_tokens(tokens))


def _segments() -> list:
    """Every base phone alone, with every modifier, and tied to the next."""
    bases = sorted(jax_ipa.BASE_FEATURES)
    assert bases == sorted(ipa.BASE_FEATURES)
    mods = sorted(jax_ipa.MODIFIER_FEATURES)
    out = list(bases) + [b + m for b in bases for m in mods]
    out += [a + "͡" + b for a, b in zip(bases, bases[1:] + bases[:1])]
    out += [a + b for a, b in zip(bases, bases[3:])]  # untied pairs (diphthongs)
    return out + list(jax_ipa.STANDALONE_MARKS) + ["x1", "", "[PAD]"]


def test_segment_features_and_tokenize_ipa_match_over_the_table():
    segments = _segments()
    for seg in segments:
        assert ipa.segment_features(seg) == jax_ipa.segment_features(seg), seg
    text = " ".join(segments) + " ʃin1[}!] t͡ʃiːz ˈhɛloʊ"
    for unknown in (True, False):
        for merge in (False, True):
            assert (ipa.tokenize_ipa(text, unknown=unknown, merge_same_vowels=merge)
                    == jax_ipa.tokenize_ipa(text, unknown=unknown, merge_same_vowels=merge))


def test_phonological_features_are_bit_equal():
    cfg = TextConfig()
    tokens = _segments() + [" ", "<SIL>", "<EXCL>", "<QINT>", "<PERIOD>", "<COMMA>",
                            "<EPS>", "<PAREN>", "<QUOTE>", "<HYPHEN>", "<COLON>", "<SEMICOL>",
                            "[UNK]", "[CLS]", "[SEP]", "[MASK]", "ˈ", "ˌ", "?", "zz"]
    want = JaxCalculator(cfg).get_features(tokens)
    got = PhonologicalFeatureCalculator(_port_text(cfg)).get_features(tokens)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(tokens), 43)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PhonologicalFeatureCalculator(_port_text(cfg)).get_features([]),
                                  JaxCalculator(cfg).get_features([]))


@pytest.fixture(scope="module")
def phone_processors():
    """Both TextProcessors over an inventory of letters and of the phones the
    ``eng`` engine gives for SENTENCES, minus a few (so some are dropped)."""
    engine = jax_phonemizer._BUILTIN_FACTORIES["eng"]()
    phones = sorted({t for s in SENTENCES for t in engine(s.lower()) if t.strip()}
                    - {"ŋ", "ʒ", ",", "!", "?", ";", ".", "—", "…", "“", "”", "'", "-"})
    cfg = TextConfig(
        symbols={"letters": list("abcdefghijklmnopqrstuvwxyz"), "eng_phones": phones},
        cleaners=["everyvoice_tpu.utils.lower", "everyvoice_tpu.utils.collapse_whitespace"],
    )
    return JaxTextProcessor(cfg), TextProcessor(_port_text(cfg), "phones")


@pytest.mark.parametrize("text", SENTENCES)
def test_text_processor_phone_ids_and_features_are_bit_equal(phone_processors, text):
    jtp, ttp = phone_processors
    assert ttp.symbols == jtp.symbols
    for kwargs in ({}, {"normalize_punctuation": True}):
        want = jtp.encode_text(text, apply_g2p=True, lang_id="eng", quiet=True, **kwargs)
        assert ttp.encode_text(text, apply_g2p=True, lang_id="eng", quiet=True, **kwargs) == want
        assert ttp.decode_tokens(want) == jtp.decode_tokens(want)
    want = jtp.encode_text(text, apply_g2p=True, encode_as_phonological_features=True,
                           lang_id="eng", quiet=True)
    got = ttp.encode_text(text, apply_g2p=True, encode_as_phonological_features=True,
                          lang_id="eng", quiet=True)
    assert got.shape == want.shape and got.shape[1] == 43
    np.testing.assert_array_equal(got, want)
    tokens = jtp.tokens_for(text, lang_id="eng", apply_g2p=True, quiet=True)
    assert ttp.tokens_for(text, lang_id="eng", apply_g2p=True, quiet=True) == tokens
    np.testing.assert_array_equal(ttp.calculate_phonological_features(tokens),
                                  jtp.calculate_phonological_features(tokens))
    assert ttp.missing_symbols == jtp.missing_symbols


@pytest.fixture
def registries():
    """Both registries restored after a test registers plugins."""
    saved = (dict(jax_phonemizer.AVAILABLE_G2P_ENGINES), dict(phonemizer.AVAILABLE_G2P_ENGINES))
    yield
    for registry, old in zip((jax_phonemizer.AVAILABLE_G2P_ENGINES,
                              phonemizer.AVAILABLE_G2P_ENGINES), saved):
        registry.clear()
        registry.update(old)


def test_g2p_engine_plugin_registers_through_the_text_config(registries):
    raw = {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")},
           "g2p_engines": {"tst": "tests.g2p_engines.valid_g2p"}}
    jtp = JaxTextProcessor(TextConfig(**raw))
    ttp = TextProcessor(_port_text(TextConfig(**raw)), "phones")
    from tests.g2p_engines import valid_g2p

    assert phonemizer.AVAILABLE_G2P_ENGINES["tst"] is valid_g2p
    want = jtp.encode_text("hello there", apply_g2p=True, lang_id="tst", quiet=True)
    assert ttp.encode_text("hello there", apply_g2p=True, lang_id="tst", quiet=True) == want
    for name, error in (("wrong_sig_g2p", AssertionError), ("not_a_list", AssertionError),
                        ("multiple_arguments", AssertionError)):
        with pytest.raises(error):
            TextProcessor({**ttp.config, "g2p_engines": {"bad": f"tests.g2p_engines.{name}"}})
    with pytest.raises(ValueError, match="Invalid G2P engine module"):
        TextProcessor({**ttp.config, "g2p_engines": {"bad": "no.such.module.fn"}})

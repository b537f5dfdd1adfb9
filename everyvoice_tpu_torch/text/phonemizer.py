"""G2P engine registry: ISO language ids → grapheme-to-phoneme callables
(``Callable[[str], list[str]]``), created lazily and wrapped in a per-word
cache (counterpart of everyvoice_tpu/text/phonemizer.py, with the text
config's plugin loader, ``load_custom_g2p_engine``, copied in).

Built-ins: ``eng`` (the lexicon and letter-to-sound engine of
``english_g2p``), ``und`` (IPA-looking characters of the lower-cased text)
and the 22 rule-table languages of ``rule_g2p``. A text config's
``g2p_engines`` plugins override them; ``register_g2p_engines`` adds them,
as the JAX package's ``TextConfig`` validator does when a config is built.
"""

from __future__ import annotations

import importlib
import inspect
import logging
import typing
from typing import Callable, Dict, List, Union

from everyvoice_tpu_torch.text.rule_g2p_tables import EXTRA_LANGUAGE_NAMES

logger = logging.getLogger(__name__)

G2PCallable = Callable[[str], List[str]]

# Marker for engines known how to build but not instantiated yet.
DEFERRED_ENGINE = "DEFERRED"


class CachingG2PEngine:
    """Wraps a G2P callable with a per-word cache; words are split on
    whitespace and joined by single space tokens."""

    def __init__(self, engine: G2PCallable):
        self._engine = engine
        self._cache: Dict[str, tuple] = {}

    def process_one_token(self, input_text: str) -> List[str]:
        cached = self._cache.get(input_text)
        if cached is None:
            cached = tuple(self._engine(input_text))
            self._cache[input_text] = cached
        return list(cached)

    def __call__(self, normalized_input_text: str) -> List[str]:
        output: List[str] = []
        for i, word in enumerate(normalized_input_text.split()):
            if i > 0:
                output.append(" ")
            output.extend(self.process_one_token(word))
        return output


def _make_eng_engine() -> CachingG2PEngine:
    from everyvoice_tpu_torch.text.english_g2p import english_g2p

    return CachingG2PEngine(english_g2p)


def _make_und_engine() -> CachingG2PEngine:
    """Language-independent fallback: keep characters that look like IPA."""
    from everyvoice_tpu_torch.text.ipa import tokenize_ipa

    def und_g2p(text: str) -> List[str]:
        return tokenize_ipa(text.lower(), unknown=True)

    return CachingG2PEngine(und_g2p)


def _make_rule_engine(lang_id: str) -> Callable[[], CachingG2PEngine]:
    def factory() -> CachingG2PEngine:
        from everyvoice_tpu_torch.text.rule_g2p import make_rule_engine

        return CachingG2PEngine(make_rule_engine(lang_id))

    return factory


RULE_LANGUAGES = (
    "spa", "ita", "fin", "deu", "fra",
    "tur", "pol", "ces", "hrv", "ron", "por", "cat", "hun", "ind", "swa",
    "dan", "swe", "est", "eus", "rus", "ukr", "ell",
)

_BUILTIN_FACTORIES: Dict[str, Callable[[], CachingG2PEngine]] = {
    "eng": _make_eng_engine,
    "und": _make_und_engine,
    **{lang: _make_rule_engine(lang) for lang in RULE_LANGUAGES},
}

BUILTIN_G2P_LANGUAGES = frozenset(_BUILTIN_FACTORIES)
# lang id -> engine instance, DEFERRED marker, or user plugin callable.
AVAILABLE_G2P_ENGINES: Dict[str, Union[G2PCallable, str]] = {
    lang: DEFERRED_ENGINE for lang in _BUILTIN_FACTORIES
}


# Display names for the wizard's language picker.
G2P_LANGUAGE_NAMES: Dict[str, str] = {
    "eng": "English", "und": "Undetermined", "spa": "Spanish", "ita": "Italian",
    "fin": "Finnish", "deu": "German", "fra": "French", **EXTRA_LANGUAGE_NAMES,
}


def get_g2p_engine(lang_id: str) -> G2PCallable:
    """The G2P engine for a language, built at its first use."""
    if lang_id not in AVAILABLE_G2P_ENGINES:
        raise NotImplementedError(
            f"Sorry, we don't have a grapheme-to-phoneme engine available for "
            f"{lang_id}. Please follow the docs to implement one yourself, or "
            "register a plugin via the text config's g2p_engines field."
        )
    engine = AVAILABLE_G2P_ENGINES[lang_id]
    if engine == DEFERRED_ENGINE:
        logger.info(f"Initializing G2P engine for {lang_id}; this only happens once.")
        engine = _BUILTIN_FACTORIES[lang_id]()
        AVAILABLE_G2P_ENGINES[lang_id] = engine
    assert callable(engine), f"G2P engine for {lang_id} is not callable"
    return engine


def validate_g2p_engine_signature(g2p_func):
    """A G2P plugin must be ``Callable[[str], List[str]]``."""
    sig = inspect.signature(g2p_func)
    assert len(sig.parameters) == 1, "G2P engine's signature should take a single argument"
    first = list(sig.parameters)[0]
    assert sig.parameters[first].annotation is str, "G2P Engine's signature should take a string"
    assert sig.return_annotation in (
        list[str],
        typing.List[str],  # noqa: UP006 — accepted for backwards compatibility
    ), "G2P Engine's signature should return a list of strings"
    return g2p_func


def load_custom_g2p_engine(lang_id: str, qualified_name: str):
    """The plugin ``module.function`` named for ``lang_id``, its signature
    checked."""
    module_name, _, function_name = qualified_name.rpartition(".")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError:
        message = f"Invalid G2P engine module `{module_name}` for `{lang_id}`"
        logger.error(message)
        raise ValueError(message) from None
    return validate_g2p_engine_signature(getattr(module, function_name))


def register_g2p_engines(g2p_engines: dict) -> None:
    """Register a text config's ``g2p_engines`` plugins (lang id → dotted
    path), overriding any engine already registered for the language."""
    for lang_id, name in g2p_engines.items():
        g2p_func = load_custom_g2p_engine(lang_id, name)
        if lang_id in AVAILABLE_G2P_ENGINES:
            logger.warning(f"Overriding g2p for `{lang_id}` with user plugin `{name}`")
        AVAILABLE_G2P_ENGINES[lang_id] = g2p_func

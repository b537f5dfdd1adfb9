"""Text processing: normalization → tokenization or G2P → ids or
phonological features (counterpart of everyvoice_tpu/text/text_processor.py,
with the helpers of ``text/utils.py`` and the text config's validators
copied in).

The id layout matches the JAX package: the pad symbol ``\\x80`` is id 0 and
space is id 1; the remaining declared symbols (including the internal
punctuation tokens and raw punctuation characters) are sorted longest-first,
then lexicographically. The table covers the whole declared inventory
whatever ``target_text_representation_level`` is, so datasets and serving
agree on ids. Phones come from a declared ``phones`` column or from the
language's G2P engine (``text/phonemizer.py``); the text config's
``g2p_engines`` plugins are registered when a ``TextProcessor`` is built, as
the JAX package registers them when its ``TextConfig`` is built.
"""

from __future__ import annotations

import logging
import re
from collections import Counter
from typing import Optional

import numpy as np

from everyvoice_tpu_torch.config import PUNCTUATION
from everyvoice_tpu_torch.text.features import (
    DEFAULT_PUNCTUATION_HASH,
    PhonologicalFeatureCalculator,
)
from everyvoice_tpu_torch.text.phonemizer import (
    AVAILABLE_G2P_ENGINES,
    get_g2p_engine,
    register_g2p_engines,
)
from everyvoice_tpu_torch.utils import resolve_cleaner

logger = logging.getLogger(__name__)

PAD_SYMBOL = "\x80"
# Token strings in filelists are joined with "/"; a "/" inside a token is
# written as "<SLASH>".
CHARACTER_JOINER = "/"
JOINER_SUBSTITUTION = "<SLASH>"


class OutOfVocabularySymbolError(Exception):
    pass


def symbol_sorter(symbols: list, hardcoded_initial_symbols: list) -> list:
    """Pinned symbols first, then longest first, then lexicographic."""
    return hardcoded_initial_symbols + sorted(symbols, key=lambda s: (-len(s), s))


def normalize_text_helper(text: str, to_replace: dict, cleaners: list) -> str:
    """Replace rules first, then cleaner functions."""
    for pattern, replacement in to_replace.items():
        text = re.sub(pattern, replacement, text)
    for cleaner in cleaners:
        text = cleaner(text)
    return text


def get_label_from_symbol_key(key: str) -> Optional[str]:
    """The dataset label of a ``<label>_phones``/``<label>_characters`` key."""
    last = key.rfind("_")
    if last >= 1 and key[last + 1 :] in ("phones", "characters"):
        return key[:last]
    return None


class TextProcessor:
    """Normalizes, tokenizes (or G2Ps) and encodes text for a text config
    dict (the ``text`` section of a checkpoint's config, defaults filled
    in). ``target_text_representation_level`` is recorded for callers; the
    id table does not depend on it."""

    def __init__(self, text_config: dict, target_text_representation_level: str = "characters"):
        self.target_text_representation_level = target_text_representation_level
        self.phonological_feature_calculator: Optional[PhonologicalFeatureCalculator] = None
        register_g2p_engines(text_config["g2p_engines"])
        self.config = text_config
        self.cleaners = [resolve_cleaner(c) for c in text_config["cleaners"]]
        self.language_cleaners = {
            k: [resolve_cleaner(c) for c in v]
            for k, v in text_config["language_cleaners"].items()
        }
        self.dataset_cleaners = {
            k: [resolve_cleaner(c) for c in v]
            for k, v in text_config["dataset_cleaners"].items()
        }
        # The config validator sorts global rules longest key first.
        self.to_replace = dict(
            sorted(text_config["to_replace"].items(), key=lambda kv: len(kv[0]), reverse=True)
        )
        self.missing_symbols: Counter = Counter()

        symbols_cfg = text_config["symbols"]
        punctuation = {
            name: list(symbols_cfg.get("punctuation", {}).get(name, default))
            for name, default in PUNCTUATION.items()
        }
        self.punctuation_to_internal_id = {
            symbol: DEFAULT_PUNCTUATION_HASH[name]
            for name, symbols in punctuation.items()
            for symbol in symbols
        }
        self.punctuation_characters = list(self.punctuation_to_internal_id)

        declared: set = set()
        for key, values in symbols_cfg.items():
            if key == "punctuation" or not isinstance(values, list):
                continue
            if key != "silence":
                # The config validator normalizes declared symbols with the
                # cleaners that apply to them, dropping empties.
                label = get_label_from_symbol_key(key)
                values = [
                    normalize_text_helper(
                        v, self.get_to_replace(dataset_label=label),
                        self.get_cleaners(dataset_label=label),
                    )
                    for v in values
                ]
            declared |= {v for v in values if v}
        # Every declared symbol but punctuation, as the JAX config's
        # ``all_except_punctuation``.
        self.declared_symbols = frozenset(declared)
        declared |= set(DEFAULT_PUNCTUATION_HASH.values())
        declared |= set(self.punctuation_characters)
        initial = [PAD_SYMBOL, " "]
        self.symbols = symbol_sorter(sorted(declared - set(initial)), initial)
        self._symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self._id_to_symbol = dict(enumerate(self.symbols))

        vocabulary = "|".join(
            re.escape(x) for x in self.symbols + self.punctuation_characters
        )
        self._tokenizer = re.compile(vocabulary)
        self._missing_finder = re.compile(f"(?:{vocabulary})+")

    def get_cleaners(self, lang_id: Optional[str] = None, dataset_label: Optional[str] = None):
        """Precedence: dataset > language > global."""
        if dataset_label is not None and dataset_label in self.dataset_cleaners:
            return self.dataset_cleaners[dataset_label]
        if lang_id is not None and lang_id in self.language_cleaners:
            return self.language_cleaners[lang_id]
        return self.cleaners

    def get_to_replace(self, lang_id: Optional[str] = None, dataset_label: Optional[str] = None):
        if dataset_label is not None and dataset_label in self.config["dataset_to_replace"]:
            return self.config["dataset_to_replace"][dataset_label]
        if lang_id is not None and lang_id in self.config["language_to_replace"]:
            return self.config["language_to_replace"][lang_id]
        return self.to_replace

    def normalize_text(
        self, text: str, lang_id: Optional[str] = None, dataset_label: Optional[str] = None
    ) -> str:
        """Replace rules, then cleaners, of the dataset, else the language,
        else the global config."""
        return normalize_text_helper(
            text,
            self.get_to_replace(lang_id=lang_id, dataset_label=dataset_label),
            self.get_cleaners(lang_id=lang_id, dataset_label=dataset_label),
        )

    def apply_tokenization(self, normalized_text: str, quiet: bool = False,
                           find_missing: bool = True) -> list:
        """Greedy longest-match tokenization over the declared inventory;
        undeclared runs are dropped (and counted, with ``find_missing``)."""
        if find_missing:
            self.get_missing_symbols(normalized_text, quiet=quiet)
        return self._tokenizer.findall(normalized_text)

    def get_missing_symbols(self, normalized_text: str, quiet: bool = False) -> list:
        """The runs of undeclared symbols in already-normalized text, each
        counted in ``missing_symbols`` (and logged unless ``quiet``)."""
        missing = [gap for gap in self._missing_finder.split(normalized_text) if gap]
        for gap in missing:
            if not quiet:
                logger.warning(
                    f"Dropping '{gap}' from '{normalized_text}': it is missing "
                    "from the symbol inventory in your text config."
                )
            self.missing_symbols[gap] += 1
        return missing

    def apply_punctuation_rules(self, tokenized_text: list) -> list:
        """Punctuation characters → their internal class tokens."""
        return [self.punctuation_to_internal_id.get(t, t) for t in tokenized_text]

    def calculate_phonological_features(self, phone_tokens: list,
                                         apply_punctuation_rules: bool = True) -> np.ndarray:
        """(len(phone_tokens), 43) float32 phonological features."""
        if self.phonological_feature_calculator is None:
            self.phonological_feature_calculator = PhonologicalFeatureCalculator(
                self.config, DEFAULT_PUNCTUATION_HASH)
        if apply_punctuation_rules:
            phone_tokens = self.apply_punctuation_rules(phone_tokens)
        return self.phonological_feature_calculator.get_features(phone_tokens)

    @staticmethod
    def _run_g2p(normalized_text: str, lang_id: str) -> list:
        """The registered engine's tokens; anything but a list raises."""
        tokens = None
        try:
            tokens = get_g2p_engine(lang_id)(normalized_text)
        except Exception:
            pass
        assert isinstance(tokens, list), (
            f"The g2p engine for {lang_id} produced {type(tokens)} but must "
            "produce a list of tokenized phones."
        )
        return tokens

    def apply_g2p_and_tokenization(self, normalized_text: str, lang_id: str,
                                   find_missing: bool = True, quiet: bool = False) -> list:
        """G2P, then the tokens the inventory declares; the rest are dropped
        and counted."""
        known = self._symbol_to_id.keys() | set(self.punctuation_characters)
        kept = []
        for token in self._run_g2p(normalized_text, lang_id):
            if token in known:
                kept.append(token)
                continue
            self.missing_symbols[token] += 1
            if find_missing and not quiet:
                logger.warning(
                    f"Dropping '{token}' from '{normalized_text}': it is "
                    "missing from the symbol inventory in your text config."
                )
        return kept

    def tokens_for(
        self,
        text: str,
        *,
        lang_id: Optional[str] = None,
        apply_g2p: bool = False,
        normalize: bool = True,
        normalize_punctuation: bool = False,
        quiet: bool = False,
        find_missing: bool = True,
        dataset_label: Optional[str] = None,
    ) -> list:
        """The token sequence of ``text``: normalization, then G2P (when
        asked for and a language is given) or inventory tokenization, then
        optionally the punctuation classes."""
        if normalize:
            text = self.normalize_text(text, lang_id=lang_id, dataset_label=dataset_label)
        if apply_g2p and lang_id is not None:
            tokens = self.apply_g2p_and_tokenization(text, lang_id, quiet=quiet,
                                                     find_missing=find_missing)
        else:
            tokens = self.apply_tokenization(text, quiet=quiet, find_missing=find_missing)
        return self.apply_punctuation_rules(tokens) if normalize_punctuation else tokens

    def encode_text(
        self,
        text: str,
        normalize_text: bool = True,
        apply_g2p: bool = False,
        normalize_punctuation: bool = False,
        encode_as_phonological_features: bool = False,
        lang_id: Optional[str] = None,
        quiet: bool = False,
        find_missing: bool = True,
        dataset_label: Optional[str] = None,
    ):
        """normalize → (G2P | tokenize) → ids, or (N, 43) phonological
        features with ``encode_as_phonological_features``."""
        if encode_as_phonological_features and not apply_g2p:
            raise ValueError(
                "Phonological-feature encoding needs phone tokens, which only "
                "exist after G2P runs — pass apply_g2p=True together with "
                "encode_as_phonological_features=True."
            )
        if apply_g2p and (lang_id is None or lang_id not in AVAILABLE_G2P_ENGINES):
            raise ValueError(
                f"No G2P engine is registered for language '{lang_id}', so "
                "apply_g2p cannot run. Register one in your text config's "
                "g2p_engines map or pick a supported language."
            )
        tokens = self.tokens_for(
            text, lang_id=lang_id, apply_g2p=apply_g2p, normalize=normalize_text,
            normalize_punctuation=normalize_punctuation, quiet=quiet,
            find_missing=find_missing, dataset_label=dataset_label,
        )
        if encode_as_phonological_features:
            return self.calculate_phonological_features(tokens, apply_punctuation_rules=False)
        return self.encode_string_tokens(tokens)

    def encode_string_tokens(self, sequence: list) -> list:
        encoded = []
        for token in sequence:
            try:
                encoded.append(self._symbol_to_id[token])
            except KeyError as e:
                raise OutOfVocabularySymbolError(
                    f"Sequence {sequence} contains item '{token}'"
                ) from e
        return encoded

    def encode_escaped_string_sequence(
        self,
        string_of_tokens: str,
        split_character: str = CHARACTER_JOINER,
        joiner_substitution: str = JOINER_SUBSTITUTION,
    ) -> list:
        """Ids of a joined token string (a filelist's ``character_tokens``),
        empty pieces dropped."""
        if not split_character:
            raise ValueError("An escaped string sequence needs a character to split on")
        tokens = self.split_tokens(string_of_tokens, split_character, joiner_substitution)
        return self.encode_string_tokens([token for token in tokens if token])

    def token_sequence_to_text_sequence(self, sequence: list) -> list:
        return [self._id_to_symbol[i] for i in sequence]

    def decode_tokens(self, sequence: list, join_character: Optional[str] = CHARACTER_JOINER,
                      joiner_substitution: Optional[str] = JOINER_SUBSTITUTION):
        """Ids back to a joined token string, or to the token list when
        ``join_character`` is None."""
        symbols = self.token_sequence_to_text_sequence(sequence)
        if join_character is None:
            return symbols
        return join_character.join(s.replace(join_character, joiner_substitution) for s in symbols)

    @staticmethod
    def split_tokens(
        joined_sequence: str,
        join_character: str = CHARACTER_JOINER,
        joiner_substitution: str = JOINER_SUBSTITUTION,
    ) -> list:
        """The tokens of a joined token string (a filelist's
        ``character_tokens`` or ``phone_tokens``)."""
        return [
            piece.replace(joiner_substitution, join_character)
            for piece in joined_sequence.split(join_character)
        ]

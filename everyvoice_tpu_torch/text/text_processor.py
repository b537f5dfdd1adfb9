"""Character-level text processing: normalization → tokenization → ids
(counterpart of everyvoice_tpu/text/text_processor.py, with the helpers of
``text/utils.py`` and the text config's validators copied in).

The id layout matches the JAX package: the pad symbol ``\\x80`` is id 0 and
space is id 1; the remaining declared symbols (including the internal
punctuation tokens and raw punctuation characters) are sorted longest-first,
then lexicographically. Phone-level text (G2P) and phonological features
are a later slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import re
from collections import Counter
from typing import Optional

from everyvoice_tpu_torch.config import PUNCTUATION
from everyvoice_tpu_torch.utils import resolve_cleaner

logger = logging.getLogger(__name__)

PAD_SYMBOL = "\x80"
# Token strings in filelists are joined with "/"; a "/" inside a token is
# written as "<SLASH>".
CHARACTER_JOINER = "/"
JOINER_SUBSTITUTION = "<SLASH>"
DEFAULT_PUNCTUATION_HASH = {
    "exclamations": "<EXCL>",
    "ellipses": "<EPS>",
    "question_symbols": "<QINT>",
    "quotemarks": "<QUOTE>",
    "periods": "<PERIOD>",
    "commas": "<COMMA>",
    "colons": "<COLON>",
    "semi_colons": "<SEMICOL>",
    "hyphens": "<HYPHEN>",
    "parentheses": "<PAREN>",
}
LATER_SLICE = (
    "phone-level text (G2P) and phonological features are not ported yet; "
    "they come with the port's text front-end slice"
)


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
    """Normalizes, tokenizes and encodes characters for a text config dict
    (the ``text`` section of a checkpoint's config, defaults filled in)."""

    def __init__(self, text_config: dict, target_text_representation_level: str = "characters"):
        if target_text_representation_level != "characters":
            raise NotImplementedError(
                f"target_text_representation_level="
                f"{target_text_representation_level!r}: {LATER_SLICE}"
            )
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

    def apply_tokenization(self, normalized_text: str, quiet: bool = False) -> list:
        """Greedy longest-match tokenization over the declared inventory;
        undeclared runs are dropped and counted."""
        for gap in self._missing_finder.split(normalized_text):
            if not gap:
                continue
            if not quiet:
                logger.warning(
                    f"Dropping '{gap}' from '{normalized_text}': it is missing "
                    "from the symbol inventory in your text config."
                )
            self.missing_symbols[gap] += 1
        return self._tokenizer.findall(normalized_text)

    def encode_text(
        self,
        text: str,
        apply_g2p: bool = False,
        lang_id: Optional[str] = None,
        quiet: bool = False,
    ) -> list:
        """normalize → tokenize → ids."""
        if apply_g2p:
            raise NotImplementedError(f"apply_g2p=True: {LATER_SLICE}")
        tokens = self.apply_tokenization(self.normalize_text(text, lang_id), quiet)
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

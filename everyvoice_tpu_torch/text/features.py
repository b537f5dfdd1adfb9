"""Phonological feature vectors (counterpart of
everyvoice_tpu/text/features.py, reading the text config as a dict).

Each token maps to a 43-dimensional multi-hot vector: 24 articulatory
features (+1/-1/0, panphon-compatible layout, see ``text/ipa.py``), 2 stress
one-hots, 12 punctuation/space/silence one-hots and 5 special-token
one-hots.
"""

from __future__ import annotations

import logging

import numpy as np

from everyvoice_tpu_torch.text.ipa import (
    N_ARTICULATORY_FEATURES,
    SPECIAL_TOKENS,
    segment_features,
)

logger = logging.getLogger(__name__)

N_STRESS_FEATURES = 2
N_PUNCTUATION_FEATURES = 12
N_SPECIAL_FEATURES = 5
N_PHONOLOGICAL_FEATURES = (
    N_ARTICULATORY_FEATURES + N_STRESS_FEATURES + N_PUNCTUATION_FEATURES + N_SPECIAL_FEATURES
)  # = 43

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


class PhonologicalFeatureCalculator:
    """(N, 43) float32 features of a token list, for a text config dict
    (the ``text`` section, defaults filled in)."""

    def __init__(self, text_config: dict, punctuation_hash: dict = DEFAULT_PUNCTUATION_HASH):
        self.config = text_config
        self.punctuation_hash = punctuation_hash
        self.silence = set(text_config["symbols"].get("silence", []))
        # The 12 punctuation one-hot slots: space first, silence last.
        self._punct_slot = {
            " ": 0,
            punctuation_hash["question_symbols"]: 1,
            punctuation_hash["periods"]: 2,
            punctuation_hash["colons"]: 3,
            punctuation_hash["semi_colons"]: 4,
            punctuation_hash["commas"]: 5,
            punctuation_hash["hyphens"]: 6,
            punctuation_hash["quotemarks"]: 7,
            punctuation_hash["parentheses"]: 8,
            punctuation_hash["ellipses"]: 9,
            punctuation_hash["exclamations"]: 10,
        }

    def get_punctuation_features(self, tokens: list) -> np.ndarray:
        """12-dim one-hot of space/punctuation class/silence per token."""
        out = np.zeros((len(tokens), N_PUNCTUATION_FEATURES), dtype=np.float32)
        for i, tok in enumerate(tokens):
            slot = self._punct_slot.get(tok)
            if slot is not None:
                out[i, slot] = 1.0
            elif tok in self.silence:
                out[i, 11] = 1.0
        return out

    def get_stress_features(self, tokens: list) -> np.ndarray:
        """2-dim one-hot of primary/secondary stress."""
        out = np.zeros((len(tokens), N_STRESS_FEATURES), dtype=np.float32)
        for i, tok in enumerate(tokens):
            if tok == "ˈ":
                out[i, 0] = 1.0
            elif tok == "ˌ":
                out[i, 1] = 1.0
        return out

    def get_special_token_features(self, tokens: list) -> np.ndarray:
        """5-dim one-hot for [PAD]/[UNK]/[CLS]/[SEP]/[MASK]."""
        out = np.zeros((len(tokens), N_SPECIAL_FEATURES), dtype=np.float32)
        for i, tok in enumerate(tokens):
            if tok in SPECIAL_TOKENS:
                out[i, SPECIAL_TOKENS.index(tok)] = 1.0
        return out

    def token_to_segmental_features(self, token: str) -> np.ndarray:
        """24-dim articulatory features; zeros for a token that is no phone."""
        feats = segment_features(token)
        if feats is None:
            if (token not in self._punct_slot and token not in SPECIAL_TOKENS
                    and token not in self.silence and token not in ("ˈ", "ˌ")):
                logger.debug(f"No phonological features found for token '{token}'; using zeros.")
            return np.zeros(N_ARTICULATORY_FEATURES, dtype=np.float32)
        return np.asarray(feats, dtype=np.float32)

    def get_features(self, tokens: list) -> np.ndarray:
        """All feature blocks side by side: (len(tokens), 43) float32."""
        if not tokens:
            return np.zeros((0, N_PHONOLOGICAL_FEATURES), dtype=np.float32)
        segmental = np.stack([self.token_to_segmental_features(t) for t in tokens])
        return np.concatenate(
            [segmental, self.get_stress_features(tokens), self.get_punctuation_features(tokens),
             self.get_special_token_features(tokens)],
            axis=1,
        ).astype(np.float32)

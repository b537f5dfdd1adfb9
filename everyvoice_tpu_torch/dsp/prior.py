"""Beta-binomial text↔mel alignment priors (counterpart of
everyvoice_tpu/dsp/prior.py, host numpy and scipy).

The prior P(text position | mel frame) is computed in closed form from
log-gamma functions over the whole (mel × text) grid. A cache of priors at
rounded sizes, resized bilinearly to each target, keeps repeated shapes
cheap.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.special import gammaln


def _log_beta(a, b):
    return gammaln(a) + gammaln(b) - gammaln(a + b)


@functools.lru_cache(maxsize=256)
def beta_binomial_prior_distribution(
    phoneme_count: int, mel_count: int, scaling: float = 1.0
) -> np.ndarray:
    """(mel_count, phoneme_count) matrix whose row i is the BetaBinomial
    pmf over text positions with a = scaling·i, b = scaling·(M+1−i)."""
    P = phoneme_count
    M = mel_count
    k = np.arange(P, dtype=np.float64)[None, :]  # text positions 0..P-1
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    a = scaling * i
    b = scaling * (M + 1 - i)
    n = P  # betabinom(P, ...) has support 0..P; the pmf is taken at 0..P-1
    log_pmf = (
        gammaln(n + 1)
        - gammaln(k + 1)
        - gammaln(n - k + 1)
        + _log_beta(k + a, n - k + b)
        - _log_beta(a, b)
    )
    return np.exp(log_pmf).astype(np.float32)


class BetaBinomialInterpolator:
    """Caches priors at rounded sizes and bilinearly resizes to the target."""

    def __init__(self, round_mel_len_to: int = 100, round_text_len_to: int = 20):
        self.round_mel_len_to = round_mel_len_to
        self.round_text_len_to = round_text_len_to

    @staticmethod
    def round(val: int, to: int) -> int:
        return max(1, int(np.round((val + 1) / to))) * to

    def __call__(self, w: int, h: int) -> np.ndarray:
        """w = mel length, h = text length → (w, h) prior."""
        from scipy import ndimage

        bw = self.round(w, to=self.round_mel_len_to)
        bh = self.round(h, to=self.round_text_len_to)
        # The pmf's support runs over the mel axis (phoneme_count=bw) with
        # one row per text position, then is transposed to (mel, text).
        base = beta_binomial_prior_distribution(bw, bh).T
        ret = ndimage.zoom(base, zoom=(w / bw, h / bh), order=1)
        if ret.shape != (w, h):
            raise RuntimeError(f"prior resized to {ret.shape}, wanted {(w, h)}")
        return ret.astype(np.float32)

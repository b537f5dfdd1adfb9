"""Polyphase sinc resampling on the host (counterpart of
everyvoice_tpu/dsp/resample.py::resample_host).

The Kaiser-windowed sinc kernel is built with the JAX package's numpy code,
so it is bit-identical to the kernel of its device ``resample``; scipy's
``upfirdn`` applies it to one clip at a time.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np


@lru_cache(maxsize=32)
def _sinc_kernel(
    up: int, down: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
    beta: float = 14.769656459379492,
) -> np.ndarray:
    """Kaiser-windowed sinc anti-aliasing/interpolation kernel for a rational
    rate change, designed at the intermediate rate ``orig·up``, with its
    cutoff at ``rolloff · min(orig, new)/2`` Hz."""
    f_c = rolloff / (2.0 * max(up, down))
    half_width = int(np.ceil(lowpass_filter_width / (2.0 * f_c)))
    t = np.arange(-half_width, half_width + 1, dtype=np.float64)
    sinc = 2.0 * f_c * np.sinc(2.0 * f_c * t)
    window_arg = t / half_width
    window = np.i0(beta * np.sqrt(np.clip(1 - window_arg**2, 0, None))) / np.i0(beta)
    return (sinc * window).astype(np.float32)


def resample_host(
    audio: np.ndarray, orig_freq: int, new_freq: int,
    lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> np.ndarray:
    """Resample (..., T) audio from orig_freq to new_freq; the output has
    ceil(T · new / orig) samples."""
    if orig_freq == new_freq:
        return np.asarray(audio)
    from scipy.signal import upfirdn

    g = gcd(int(orig_freq), int(new_freq))
    up = new_freq // g
    down = orig_freq // g
    kernel = _sinc_kernel(up, down, lowpass_filter_width, rolloff) * up
    half = (len(kernel) - 1) // 2
    x = np.asarray(audio, dtype=np.float32)
    out_len = -(-x.shape[-1] * up // down)  # ceil
    # upfirdn(h, x, up, 1) is the full correlation of the zero-stuffed
    # signal; sampling it at n*down + half centres the symmetric kernel.
    y = upfirdn(kernel, x, up=up, down=1, axis=-1)
    y = y[..., half : half + out_len * down : down]
    if y.shape[-1] < out_len:  # upfirdn trims trailing flush samples
        pad = [(0, 0)] * (y.ndim - 1) + [(0, out_len - y.shape[-1])]
        y = np.pad(y, pad)
    return y[..., :out_len].astype(np.float32)

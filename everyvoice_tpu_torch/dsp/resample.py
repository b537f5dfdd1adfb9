"""Polyphase sinc resampling (counterpart of everyvoice_tpu/dsp/resample.py).

The Kaiser-windowed sinc kernel is built with the JAX package's numpy code,
so it is bit-identical to the kernel of its device ``resample``.
``resample_host`` applies it with scipy's ``upfirdn`` to one clip at a time;
``resample`` applies it to tensors on their device as one strided
``conv1d``.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from everyvoice_tpu_torch.utils.precision import no_tf32


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
    # The full correlation of the zero-stuffed signal, sampled at
    # n*down + half, centres the symmetric kernel. upfirdn samples at
    # n*down: delaying the kernel by ``lead`` zeros brings half + lead to a
    # multiple of down, and upfirdn computes only the samples it keeps.
    lead = (-half) % down
    y = upfirdn(np.concatenate([np.zeros(lead, kernel.dtype), kernel]), x, up=up, down=down,
                axis=-1)
    start = (half + lead) // down
    y = y[..., start : start + out_len]
    if y.shape[-1] < out_len:  # upfirdn trims trailing flush samples
        pad = [(0, 0)] * (y.ndim - 1) + [(0, out_len - y.shape[-1])]
        y = np.pad(y, pad)
    return y[..., :out_len].astype(np.float32)


@lru_cache(maxsize=32)
def _polyphase_weight(up: int, down: int, lowpass_filter_width: int, rolloff: float) -> tuple:
    """The sinc kernel split into ``up`` phases, (up, K) float32, and the
    left padding P they assume.

    Output n = q·up + s is sum_k W[s, k] · x[q·down + k - P], with
    W[s, k] = h[(k - P)·up - s·down + half]: the taps of the zero-stuffed
    correlation that meet a nonzero input sample."""
    h = _sinc_kernel(up, down, lowpass_filter_width, rolloff) * up
    half = (len(h) - 1) // 2
    lead = half // up
    taps = ((up - 1) * down + half) // up + lead + 1
    index = (np.arange(taps)[None, :] - lead) * up - np.arange(up)[:, None] * down + half
    valid = (index >= 0) & (index < len(h))
    weight = np.where(valid, h[np.clip(index, 0, len(h) - 1)], 0.0).astype(np.float32)
    return weight, lead


def resample(
    audio: torch.Tensor, orig_freq: int, new_freq: int,
    lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample (..., T) float32 audio from orig_freq to new_freq on its
    device; the output has ceil(T · new / orig) samples. One ``conv1d`` of
    stride ``down`` whose ``up`` output channels are the output phases."""
    if orig_freq == new_freq:
        return audio
    g = gcd(int(orig_freq), int(new_freq))
    up = new_freq // g
    down = orig_freq // g
    weight, lead = _polyphase_weight(up, down, lowpass_filter_width, rolloff)
    t_in = audio.shape[-1]
    out_len = -(-t_in * up // down)  # ceil
    frames = -(-out_len // up)
    right = max(0, (frames - 1) * down + weight.shape[1] - lead - t_in)
    x = F.pad(audio.reshape(-1, 1, t_in).float(), (lead, right))
    with no_tf32():
        y = F.conv1d(x, torch.from_numpy(weight).to(x.device)[:, None, :], stride=down)
    y = y[..., :frames].transpose(1, 2).reshape(x.shape[0], frames * up)[:, :out_len]
    return y.reshape(*audio.shape[:-1], out_len)

"""The supported sox-style audio effects on numpy arrays (counterpart of
everyvoice_tpu/dsp/sox.py::apply_sox_effects on its host path).

Effect specs keep the sox command-line list-of-lists format, e.g.
``[["channels", "1"], ["gain", "-3"]]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from everyvoice_tpu_torch.dsp.resample import resample_host

SUPPORTED_EFFECTS = (
    "channels", "rate", "gain", "norm", "vol", "remix", "trim", "reverse",
)


class UnsupportedSoxEffect(ValueError):
    pass


def apply_sox_effects(
    audio: np.ndarray, sample_rate: int, effects: Sequence[Sequence]
) -> tuple:
    """Apply a chain of effect specs to (channels, samples) audio; returns
    (audio, sample_rate), since ``rate`` changes the latter."""
    for effect in effects or ():
        if not effect:
            continue
        name, *args = [str(a) for a in effect]
        if name == "channels":
            n = int(args[0])
            if n == 1 and audio.shape[0] > 1:
                audio = np.mean(audio, axis=0, keepdims=True)
            elif n > 1 and audio.shape[0] == 1:
                audio = np.tile(audio, (n, 1))
            elif n != audio.shape[0]:
                raise UnsupportedSoxEffect(
                    f"channels {audio.shape[0]}→{n} is not supported"
                )
        elif name == "remix":
            audio = audio[np.asarray([int(a) - 1 for a in args])]
        elif name == "rate":
            new_sr = int(float(args[-1]))
            audio = resample_host(audio, sample_rate, new_sr)
            sample_rate = new_sr
        elif name == "gain":
            audio = audio * (10.0 ** (float(args[-1]) / 20.0))
        elif name == "norm":
            target_db = float(args[0]) if args else 0.0
            peak = np.max(np.abs(audio))
            audio = audio * (10.0 ** (target_db / 20.0) / np.maximum(peak, 1e-9))
        elif name == "vol":
            audio = audio * float(args[0])
        elif name == "trim":
            start = int(float(args[0]) * sample_rate)
            if len(args) > 1:
                audio = audio[:, start : start + int(float(args[1]) * sample_rate)]
            else:
                audio = audio[:, start:]
        elif name == "reverse":
            audio = audio[:, ::-1]
        else:
            raise UnsupportedSoxEffect(
                f"sox effect '{name}' is not implemented; "
                f"supported: {SUPPORTED_EFFECTS}"
            )
    return audio, sample_rate

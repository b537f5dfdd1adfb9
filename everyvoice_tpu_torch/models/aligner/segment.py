"""Long-audio CTC segmentation (counterpart of
everyvoice_tpu/models/aligner/segment.py): ``segment align`` aligns each
line of a transcript against a long recording and writes a TextGrid of
sentence intervals; ``segment extract`` cuts a TextGrid's intervals into
wavs and a filelist.

The forced alignment is numpy on the host, in float64, with the JAX
package's trellis and tie order. The acoustic model is a locally staged
wav2vec2-CTC directory scored on the card (``wav2vec2.py``), or any
callable that maps 16 kHz audio to per-frame label log-probabilities. (The
JAX package's ``EVERYVOICE_SEGMENT_TORCH`` branch runs ``transformers``'
own model; this package reads the same directory without it, so it has no
such branch.)
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.audio_io import read_wav, write_wav
from everyvoice_tpu_torch.dsp.resample import resample
from everyvoice_tpu_torch.utils import write_filelist

logger = logging.getLogger(__name__)

NEG_INF = -1e9
SAMPLE_RATE = 16000
NORMALIZE_EPS = 1e-7


def ctc_forced_alignment(
    log_probs: np.ndarray,  # (T, V) per-frame log-probabilities
    targets: Sequence[int],  # label ids (no blanks)
    blank_id: int = 0,
) -> list:
    """Viterbi forced alignment through the standard CTC graph
    (blank-interleaved targets, self-loops + skips). Returns a list of
    (label_index, start_frame, end_frame) spans for each target label."""
    t_max, _ = log_probs.shape
    ext = []
    for label in targets:
        ext += [blank_id, int(label)]
    ext.append(blank_id)
    s_max = len(ext)

    # Vectorized over the state axis: each time step is one numpy pass.
    ext_arr = np.asarray(ext, np.int64)
    emit = log_probs[:, ext_arr].astype(np.float64)  # (T, S)
    skip_ok = np.zeros(s_max, bool)
    if s_max > 2:
        skip_ok[2:] = (ext_arr[2:] != blank_id) & (ext_arr[2:] != ext_arr[:-2])

    scores = np.full(s_max, NEG_INF, np.float64)
    scores[: min(2, s_max)] = emit[0, : min(2, s_max)]
    backptr = np.zeros((t_max, s_max), np.int8)
    state_idx = np.arange(s_max)
    for t in range(1, t_max):
        stay = scores
        advance = np.concatenate(([NEG_INF], scores[:-1]))
        skip = np.where(
            skip_ok, np.concatenate(([NEG_INF, NEG_INF], scores[:-2])), NEG_INF
        ) if s_max > 2 else np.full(s_max, NEG_INF)
        candidates = np.stack((stay, advance, skip))
        # argmax takes the first maximum, so ties prefer stay > advance >
        # skip — matching a strict-greater sequential comparison.
        move = candidates.argmax(axis=0)
        scores = candidates[move, state_idx] + emit[t]
        backptr[t] = move

    # Backtrace from the better of the last two states.
    s = s_max - 1
    if s_max > 1 and scores[s_max - 2] > scores[s_max - 1]:
        s = s_max - 2
    path = np.zeros(t_max, np.int32)
    for t in range(t_max - 1, -1, -1):
        path[t] = s
        if t > 0:
            s -= int(backptr[t, s])

    spans = []
    for i in range(len(targets)):
        state = 2 * i + 1  # the non-blank state for target i
        frames = np.nonzero(path == state)[0]
        if len(frames):
            spans.append((i, int(frames[0]), int(frames[-1]) + 1))
        else:
            # Label got squeezed out; give it a zero-length span at the
            # previous label's end.
            prev_end = spans[-1][2] if spans else 0
            spans.append((i, prev_end, prev_end))
    return spans


def segments_to_textgrid(
    segments: list,  # (text, start_s, end_s)
    total_duration: float,
    tier_name: str = "sentences",
) -> str:
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {total_duration:.6f}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        f'        name = "{tier_name}"',
        "        xmin = 0",
        f"        xmax = {total_duration:.6f}",
        f"        intervals: size = {len(segments)}",
    ]
    for i, (text, start, end) in enumerate(segments, start=1):
        escaped = str(text).replace('"', '""')
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {start:.6f}",
            f"            xmax = {end:.6f}",
            f'            text = "{escaped}"',
        ]
    return "\n".join(lines) + "\n"


def normalize_utterance(audio_16k: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance over the whole utterance, in float32 numpy,
    as ``Wav2Vec2FeatureExtractor(do_normalize=True)`` and the JAX package
    normalize it."""
    return (audio_16k - audio_16k.mean()) / np.sqrt(audio_16k.var() + NORMALIZE_EPS)


def load_wav2vec2_logprob_fn(model_path: Optional[str] = None, device=None) -> tuple:
    """Build a (log_prob_fn, vocab) pair from a locally staged wav2vec2-CTC
    checkpoint directory (``model_path``, else ``EVERYVOICE_WAV2VEC2_PATH``),
    scored on ``device`` (the card by default). Raises with guidance when no
    model is given."""
    from everyvoice_tpu_torch.models.aligner.wav2vec2 import (
        load_wav2vec2_ctc,
        windowed_log_probs,
    )

    device = resolve_device(device)
    model_path = model_path or os.environ.get("EVERYVOICE_WAV2VEC2_PATH")
    if model_path is None:
        raise RuntimeError(
            "CTC segmentation needs a wav2vec2 acoustic model. This "
            "environment has no network egress, so pass a local checkpoint "
            "directory via --acoustic-model or EVERYVOICE_WAV2VEC2_PATH."
        )
    model, vocab, do_normalize = load_wav2vec2_ctc(model_path, device=device)

    def log_prob_fn(audio_16k: np.ndarray) -> np.ndarray:
        if do_normalize:
            audio_16k = normalize_utterance(audio_16k)
        return windowed_log_probs(model, audio_16k)

    return log_prob_fn, vocab


def read_transcript(path: Path | str) -> list:
    return [line.strip() for line in Path(path).read_text(encoding="utf8").splitlines()
            if line.strip()]


def line_targets(lines: Sequence[str], vocab: dict) -> tuple:
    """(targets, line_bounds): one target sequence of every line's
    upper-cased characters that ``vocab`` has, with the word separator
    ``|`` (where the vocabulary has one) after each line, and each line's
    (start, end) range in it."""
    sep = vocab.get("|", None)
    targets = []
    line_bounds = []
    for line in lines:
        chars = [vocab[ch] for ch in line.upper() if ch in vocab]
        start = len(targets)
        targets.extend(chars)
        line_bounds.append((start, len(targets)))
        if sep is not None:
            targets.append(sep)
    return targets, line_bounds


def align_long_audio(
    audio_path: Path | str,
    transcript_path: Path | str,
    output_path: Path | str,
    acoustic_model: Optional[str] = None,
    log_prob_fn: Optional[Callable] = None,
    vocab: Optional[dict] = None,
    device=None,
) -> list:
    """Align each transcript line against the audio; write a TextGrid of
    sentence segments and return them. The mono mix is resampled to 16 kHz
    on ``device`` (the card by default), where the acoustic model scores it."""
    device = resolve_device(device)
    if log_prob_fn is None:
        log_prob_fn, vocab = load_wav2vec2_logprob_fn(acoustic_model, device=device)
    audio, sr = read_wav(audio_path)
    mono = audio.mean(axis=0)
    audio_16k = resample(torch.from_numpy(mono).to(device), sr, SAMPLE_RATE).cpu().numpy()
    duration = len(mono) / sr
    lines = read_transcript(transcript_path)
    log_probs = log_prob_fn(audio_16k)
    frame_dur = duration / len(log_probs)

    targets, line_bounds = line_targets(lines, vocab)
    spans = ctc_forced_alignment(log_probs, targets)
    segments = []
    for line, (lo, hi) in zip(lines, line_bounds):
        if hi <= lo:
            continue
        start_f = spans[lo][1]
        end_f = spans[hi - 1][2]
        segments.append((line, start_f * frame_dur, end_f * frame_dur))
    Path(output_path).write_text(segments_to_textgrid(segments, duration), encoding="utf8")
    logger.info(f"Aligned {len(segments)} segments into {output_path}")
    return segments


TEXTGRID_INTERVAL = re.compile(
    r"xmin\s*=\s*([0-9.eE+-]+)\s*\n\s*xmax\s*=\s*([0-9.eE+-]+)"
    r"\s*\n\s*text\s*=\s*\"((?:[^\"]|\"\")*)\""
)


def parse_textgrid(path: Path | str) -> list:
    """Read interval (text, start_s, end_s) triples back out of a TextGrid
    (the inverse of `segments_to_textgrid`; accepts any Praat short/long
    IntervalTier written in the long text format). Empty-text intervals are
    skipped, matching the reference extractor's behavior."""
    content = Path(path).read_text(encoding="utf8")
    segments = []
    for match in TEXTGRID_INTERVAL.finditer(content):
        start, end = float(match.group(1)), float(match.group(2))
        text = match.group(3).replace('""', '"')
        if text.strip():
            segments.append((text, start, end))
    return segments


def extract_segments(
    audio_path: Path | str,
    segments: list,
    output_dir: Path | str,
    prefix: str = "segment",
) -> list:
    """Cut aligned segments into individual wav files + a metadata filelist."""
    audio, sr = read_wav(audio_path)
    mono = audio.mean(axis=0)
    output_dir = Path(output_dir)
    (output_dir / "wavs").mkdir(parents=True, exist_ok=True)
    rows = []
    for i, (text, start, end) in enumerate(segments):
        basename = f"{prefix}-{i:05d}"
        clip = mono[int(start * sr) : int(end * sr)]
        write_wav(output_dir / "wavs" / f"{basename}.wav", clip, sr)
        rows.append({"basename": basename, "characters": text})
    write_filelist(rows, output_dir / "metadata.psv")
    return rows

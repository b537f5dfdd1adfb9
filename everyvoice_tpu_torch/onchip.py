"""What the on-card check (``chip_smoke.py``) and the serving profile
(``python -m everyvoice_tpu_torch.profile_serving``) share: the card's name
and power limit, the requests they send, seeded full-width checkpoints to
serve them from, a seeded wav corpus to preprocess, and the vocoder training
configs on that corpus (HiFiGAN V1 at its default full width, and the
iSTFTNet variant).

The checkpoints hold random FastSpeech2 and HiFiGAN V1 weights at the
default widths, drawn from a ``torch.Generator``, with the duration head's
bias calibrated so that a 128-token text fills about 960 of the 1000 frames
(as ``bench.py`` calibrates the JAX package's serving benchmark). They are
written as EVTP files in the JAX package's parameter layout
(``torch_to_flax``), so loading them exercises the same path as a trained
checkpoint.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import numpy as np
import torch

from everyvoice_tpu_torch.config import fs2_config, hifigan_config
from everyvoice_tpu_torch.convert import torch_to_flax
from everyvoice_tpu_torch.dsp.audio_io import write_wav
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts represented in the "
    "exhibition.",
    "Hello!",
    "It is a long way to the sea; we walked, and walked, and then we stopped "
    "for a while by the river, where the old mill still turns slowly in the "
    "wind. Nobody there remembered who had built it, or why it stood so far "
    "from the village, but everyone agreed that it was beautiful.",
    "Are you coming with us tomorrow morning?",
    "Numbers such as one, two and three are spelled out here.",
    "A short one.",
    "She sells sea shells by the sea shore, and the shells she sells are "
    "surely seashells.",
]
# Requests of 1, 4 and 16 texts; the longer texts are chunked.
REQUESTS = (TEXTS[:1], TEXTS[:4], (TEXTS * 2)[:16])
FILL_FRAMES = 960.0
PROBE_TOKENS = 128


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def seeded_init_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Random weights from ``gen``: lecun-normal matrices and kernels, zero
    biases, unit norm scales and weight-norm scales."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.copy_(torch.zeros_like(p) if name.endswith("bias") else torch.ones_like(p))
            else:
                fan_in = p.numel() // p.shape[0]
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)


def write_seeded_checkpoints(out_dir: Path, gen: torch.Generator, device) -> tuple:
    """(fs2_path, vocoder_path): full-width FastSpeech2 and HiFiGAN V1 EVTP
    checkpoints of seeded weights; ``device`` runs the duration calibration."""
    contact = {"contact_name": "Seeded Weights", "contact_email": "seeded@example.org"}
    letters = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    fs2_raw = {"contact": contact, "model": {}, "text": {"symbols": {"letters": letters}}}
    cfg = fs2_config(fs2_raw)
    n_symbols = len(TextProcessor(cfg["text"]).symbols)
    fs2 = FastSpeech2.from_config(cfg, n_symbols=n_symbols)
    seeded_init_(fs2, gen)
    fs2 = fs2.to(device).eval()
    probe = torch.randint(2, n_symbols, (16, PROBE_TOKENS), generator=gen).to(device)
    lengths = torch.full((16,), PROBE_TOKENS, device=device)
    with torch.no_grad():
        measured = fs2(probe, lengths)["log_duration_prediction"].mean().item()
        fs2.duration_predictor.head.bias += float(np.log1p(FILL_FRAMES / PROBE_TOKENS)) - measured
    fs2_path = save_checkpoint(out_dir / "fs2.ckpt", "FastSpeech2", fs2_raw,
                               torch_to_flax(fs2.state_dict(), fs2))

    voc_raw = {"contact": contact, "model": {}}
    voc = HiFiGANGenerator.from_config(hifigan_config(voc_raw))
    seeded_init_(voc, gen)
    voc_path = save_checkpoint(out_dir / "hifigan.ckpt", "HiFiGANGenerator", voc_raw,
                               torch_to_flax(voc.state_dict(), voc))
    return fs2_path, voc_path


CORPUS_WORDS = (
    "the quick brown fox jumps over a lazy dog near my big red house and sings"
).split()


def write_corpus(root: Path, n_utts: int, seed: int = 0, sr: int = 22050) -> tuple:
    """(filelist path, wav directory, audio seconds) of a seeded corpus of
    ``n_utts`` 16-bit utterances of 3–10 s: a noise-modulated tone gliding
    around 110 Hz, loud enough to pass the −36 LUFS gate, with eight words of
    text each. The filelist's columns are basename|characters|speaker|language,
    the ones the audio step keeps."""
    rng = np.random.default_rng(seed)
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rows = ["basename|characters|speaker|language"]
    total_seconds = 0.0
    for i in range(n_utts):
        seconds = float(rng.uniform(3.0, 10.0))
        t = np.arange(int(seconds * sr)) / sr
        total_seconds += t.size / sr
        f0 = 110.0 * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * t + i))
        tone = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / sr)
        noise = 0.05 * rng.standard_normal(t.size)
        envelope = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 1.3 * t))
        write_wav(wav_dir / f"utt{i:05d}.wav", ((tone + noise) * envelope).astype(np.float32), sr)
        text = " ".join(CORPUS_WORDS[j] for j in rng.integers(0, len(CORPUS_WORDS), 8))
        rows.append(f"utt{i:05d}|{text}|default|default")
    filelist = root / "filelist.psv"
    filelist.write_text("\n".join(rows) + "\n", encoding="utf8")
    return filelist, wav_dir, total_seconds


CONTACT = {"contact_name": "Chip Smoke", "contact_email": "smoke@example.org"}
# The iSTFTNet variant the vocoder recipes train: two upsampling stages of 8
# and an inverse STFT of hop 4 (n_fft 16) for the rest of the 256-sample hop.
ISTFT_MODEL = {"istft_layer": True, "upsample_rates": [8, 8], "upsample_kernel_sizes": [16, 16],
               "upsample_initial_channel": 512}


def vocoder_config(corpus: dict, logs: Path, version: str, model: dict | None = None,
                   **training) -> dict:
    """A HiFiGAN training config on a preprocessed corpus (``corpus`` holds
    its ``preprocessing`` section): the default V1 model unless ``model``
    says otherwise, the default AdamW, batch 16 and 8192-sample segments,
    the corpus's split filelists, checkpoints under ``logs``."""
    save = Path(corpus["preprocessing"]["save_dir"])
    return {
        "contact": CONTACT,
        "model": model or {},
        "preprocessing": corpus["preprocessing"],
        "training": {
            "batch_size": 16,
            "training_filelist": str(save / "training_filelist.psv"),
            "validation_filelist": str(save / "validation_filelist.psv"),
            "logger": {"save_dir": str(logs), "name": "vocoder", "version": version},
            **training,
        },
    }

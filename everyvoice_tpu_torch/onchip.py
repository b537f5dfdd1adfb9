"""What the on-card check (``chip_smoke.py``) and the serving profile
(``python -m everyvoice_tpu_torch.profile_serving``) share: the card's name
and power limit, the requests they send, seeded full-width checkpoints to
serve them from (FastSpeech2 + HiFiGAN V1, and StyleTTS2 with or without
the multilingual PL-BERT), a seeded wav corpus to preprocess, the vocoder
training configs on that corpus (HiFiGAN V1 at its default full width, and
the iSTFTNet variant), a project of config files over a corpus, laid out as
the JAX package's wizard lays one out, and a StyleTTS2 training project on
it with an out-of-domain text file.

``write_wav2vec2_ctc`` writes a seeded wav2vec2-CTC model directory in the
HuggingFace layout (``config.json``, ``vocab.json`` with
facebook/wav2vec2-base-960h's 32 characters, ``preprocessor_config.json``,
``tokenizer_config.json`` and ``pytorch_model.bin``), wav2vec2-base's
geometry by default, for the aligner's ``segment align``;
``write_long_recording`` a seeded long stereo recording and its transcript.

``write_pretrained_components`` writes StyleTTS2's four pretrained
components as seeded files in their published formats and, by default, at
their published geometries: the JDC pitch network's ``bst.t7``, the ASR
aligner's ``epoch_00080.pth`` with its ``config.yml``, the multilingual
PL-BERT's ``step_1100000.t7`` with its ``config.yml``, and a HuggingFace
``wavlm-base-plus`` directory (``config.json``, ``pytorch_model.bin``: 94 M
parameters, 0.38 GB in float32). The repository holds no pretrained
weights and the card's machine has no network, so these stand in for the
downloads ``fetch-pretrained`` would stage: they drive the same loaders,
converters and training path, and a run on them says nothing of the
published weights' quality. ``write_styletts2_pretrained_project`` gives a
StyleTTS2 project the ``-c`` overrides that point at them, as
``fetch-pretrained`` prints them.

The checkpoints hold random FastSpeech2 and HiFiGAN V1 weights at the
default widths, drawn from a ``torch.Generator``, with the duration head's
bias calibrated so that a 128-token text fills about 960 of the 1000 frames
(as ``bench.py`` calibrates the JAX package's serving benchmark). They are
written as EVTP files in the JAX package's parameter layout
(``torch_to_flax``), so loading them exercises the same path as a trained
checkpoint.
"""

from __future__ import annotations

import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from everyvoice_tpu_torch.config import fs2_config, hifigan_config, styletts2_config
from everyvoice_tpu_torch.convert import torch_to_flax
from everyvoice_tpu_torch.dsp.audio_io import write_wav
from everyvoice_tpu_torch.models.aligner.wav2vec2 import WAV2VEC2_BASE, hf_config
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.models.styletts2.asr import ASR_GEOMETRY
from everyvoice_tpu_torch.models.styletts2.jdc import JDC_BINS, JDC_CHANNELS, JDC_LSTM_HIDDEN
from everyvoice_tpu_torch.models.styletts2.plbert import MULTILINGUAL_PLBERT, PLBERT_CONFIG_NAMES
from everyvoice_tpu_torch.models.styletts2.slm import BASE_PLUS
from everyvoice_tpu_torch.utils import yaml_lite
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint
from everyvoice_tpu_torch.utils import (
    generic_psv_filelist_reader,
    load_config_file,
    write_config_file,
    write_filelist,
)

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


# StyleTTS2's seeded duration head: logits peaked at 5 frames a symbol
# (about 58 ms at 22,050 Hz and hop 256), so the request texts of up to 150
# symbols fit the 800 frames and the longest one is cut, as in the JAX
# package.
ST2_DURATION_PEAK = 5


def write_styletts2_checkpoint(out_dir: Path, gen: torch.Generator, plbert: bool = False) -> Path:
    """A full-width StyleTTS2 EVTP checkpoint of seeded weights (the JAX
    package's default model section, ``max_len`` 800), in the JAX layout,
    with the ``pretrained_components`` header serving reads; with
    ``plbert``, the multilingual PL-BERT geometry (768 wide, 12 layers),
    its vocabulary covering the text processor's symbols. Snake alphas are
    ones; the duration bias peaks at ``ST2_DURATION_PEAK`` frames, and the
    iSTFT head's magnitude is lowered so that the wavs are audio-sized."""
    letters = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    raw = {"contact": {"contact_name": "Seeded Weights", "contact_email": "seeded@example.org"},
           "model": {}, "text": {"symbols": {"letters": letters}}}
    config = styletts2_config(raw)
    n_symbols = len(TextProcessor(config["text"]).symbols)
    geometry = (dict(MULTILINGUAL_PLBERT, vocab_size=max(MULTILINGUAL_PLBERT["vocab_size"],
                                                          n_symbols))
                if plbert else None)
    model = StyleTTS2.from_config(config, n_symbols=n_symbols, plbert_geometry=geometry)
    seeded_init_(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".alpha" in name:
                p.fill_(1.0)
        classes = torch.arange(model.max_dur, dtype=torch.float32)
        model.predictor.duration.bias.copy_(-0.5 * (classes - ST2_DURATION_PEAK) ** 2)
        n_bins = model.decoder.n_fft // 2 + 1
        model.decoder.conv_post.bias[:n_bins] = -6.0
        model.decoder.conv_post.scale.mul_(0.2)
    name = "styletts2-plbert.ckpt" if plbert else "styletts2.ckpt"
    return save_checkpoint(
        Path(out_dir) / name, "StyleTTS2Module", raw,
        {"generator": torch_to_flax(model.state_dict(), model)}, lang2id={"default": 0},
        extra={"pretrained_components": {"plbert": geometry, "asr": None}})


CORPUS_WORDS = (
    "the quick brown fox jumps over a lazy dog near my big red house and sings"
).split()


def write_corpus(root: Path, n_utts: int, seed: int = 0, sr: int = 22050,
                 language: str = "default", n_quiet: int = 0, n_stereo: int = 0) -> tuple:
    """(filelist path, wav directory, audio seconds) of a seeded corpus of
    ``n_utts`` 16-bit utterances of 3–10 s: a noise-modulated tone gliding
    around 110 Hz, loud enough to pass the −36 LUFS gate, with eight words of
    text each, all in ``language`` (a language with a G2P engine, such as
    ``eng``, gets phones from it). Then ``n_quiet`` utterances of the same
    kind 50 dB down (below the gate; named ``quietNNNNN``) and ``n_stereo``
    two-channel ones (``stereoNNNNN``: the tone left, the noise right). The
    filelist's columns are basename|characters|speaker|language, the ones
    the audio step keeps."""
    rng = np.random.default_rng(seed)
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rows = ["basename|characters|speaker|language"]
    total_seconds = 0.0
    kinds = ["utt"] * n_utts + ["quiet"] * n_quiet + ["stereo"] * n_stereo

    def write(i: int, kind: str, n: int, noise: np.ndarray) -> None:
        t = np.arange(n) / sr
        f0 = 110.0 * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * t + i))
        tone = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / sr)
        envelope = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 1.3 * t))
        if kind == "stereo":
            audio = np.stack([tone * envelope, 4 * noise * envelope])
        else:
            audio = (tone + noise) * envelope * (10 ** (-50 / 20) if kind == "quiet" else 1.0)
        write_wav(wav_dir / f"{kind}{i:05d}.wav", audio.astype(np.float32), sr)

    # The draws in order, the signals and writes on threads (numpy releases
    # the GIL for whole-array work).
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        futures = []
        for i, kind in enumerate(kinds):
            n = int(float(rng.uniform(3.0, 10.0)) * sr)
            total_seconds += n / sr
            futures.append(pool.submit(write, i, kind, n, 0.05 * rng.standard_normal(n)))
            text = " ".join(CORPUS_WORDS[j] for j in rng.integers(0, len(CORPUS_WORDS), 8))
            rows.append(f"{kind}{i:05d}|{text}|default|{language}")
        for future in futures:
            future.result()
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


# The wizard's config file stems (everyvoice_tpu/wizard/steps.py:17-23).
CONFIG_STEMS = {
    "text": "everyvoice-shared-text",
    "data": "everyvoice-shared-data",
    "text-to-spec": "everyvoice-text-to-spec",
    "spec-to-wav": "everyvoice-spec-to-wav",
    "text-to-wav": "everyvoice-text-to-wav",
}


def write_project(root: Path, filelist: Path, wav_dir: Path, name: str = "cli-project",
                  label: str = "seeded", symbols: dict | None = None, contact: dict = CONTACT,
                  fmt: str = "yaml") -> Path:
    """A project over one dataset, written as the wizard's
    ``write_config_package`` writes it: ``<root>/<name>/config/`` holds the
    shared text and data configs and one config per model, joined by
    ``path_to_*_config_file``; the dataset's filelist is copied into the
    project; every path inside the project is relative to ``config/``
    (``../preprocessed``), one outside it stays as given. ``symbols`` maps
    a kind (``characters``, ``phones``) to its symbol list. Returns the
    config directory."""
    suffix = ".json" if fmt == "json" else ".yaml"
    files = {key: f"{stem}{suffix}" for key, stem in CONFIG_STEMS.items()}
    out_root = Path(root) / name
    config_dir = out_root / "config"
    config_dir.mkdir(parents=True, exist_ok=True)
    (out_root / "preprocessed").mkdir(exist_ok=True)
    (out_root / "logs_and_checkpoints").mkdir(exist_ok=True)

    def portable(path: Path) -> str:
        path = Path(path)
        resolved = (path if path.is_absolute() else Path.cwd() / path).resolve()
        if path.is_absolute() and not resolved.is_relative_to(out_root.resolve()):
            return str(path)
        return os.path.relpath(resolved, config_dir.resolve())

    rows = generic_psv_filelist_reader(filelist)
    speakers = {row.get("speaker") or "default" for row in rows}
    languages = {row.get("language") or "und" for row in rows}
    text_config = {}
    if symbols:
        text_config["symbols"] = {f"{label}_{kind}": list(v) for kind, v in symbols.items() if v}
    write_config_file(config_dir / files["text"], text_config)
    project_filelist = out_root / f"{label}-filelist.psv"
    write_filelist(rows, project_filelist)
    write_config_file(config_dir / files["data"], {
        "dataset": name,
        "save_dir": portable(out_root / "preprocessed"),
        "source_data": [{"label": label, "permissions_obtained": True,
                         "data_dir": portable(wav_dir), "filelist": portable(project_filelist)}],
    })
    preprocessed = out_root / "preprocessed"
    training = {
        "training_filelist": portable(preprocessed / "training_filelist.psv"),
        "validation_filelist": portable(preprocessed / "validation_filelist.psv"),
        "logger": {"save_dir": portable(out_root / "logs_and_checkpoints")},
    }
    model = {"multilingual": len(languages) > 1, "multispeaker": len(speakers) > 1}
    for kind in ("text-to-spec", "spec-to-wav", "text-to-wav"):
        config = {"contact": dict(contact), "path_to_preprocessing_config_file": files["data"]}
        if kind != "spec-to-wav":
            config["path_to_text_config_file"] = files["text"]
            config["model"] = dict(model)
        config["training"] = dict(training)
        write_config_file(config_dir / files[kind], config)
    return config_dir


def write_styletts2_project(root: Path, n_utts: int, seed: int = 0, name: str = "st2-project",
                            **training) -> Path:
    """A StyleTTS2 training project over a seeded corpus of ``n_utts``
    utterances (``write_corpus``), as ``write_project`` lays it out, its
    text-to-wav config given an out-of-domain source (a plain-text file of
    ``TEXTS``, one sentence a line, for the ``default`` language) and the
    ``training`` fields given (epochs, phases, ``max_steps``). Returns the
    path of ``everyvoice-text-to-wav.yaml``."""
    root = Path(root)
    filelist, wavs, _ = write_corpus(root / "corpus", n_utts, seed=seed)
    config_dir = write_project(root, filelist, wavs, name=name,
                               symbols={"characters": list("abcdefghijklmnopqrstuvwxyz")})
    ood = root / "ood.txt"
    ood.write_text("\n".join(TEXTS) + "\n", encoding="utf8")
    path = config_dir / f"{CONFIG_STEMS['text-to-wav']}.yaml"
    config = load_config_file(path)
    config["training"].update(training)
    config["training"]["ood_raw_data"] = {"default": {"local_path": str(ood.resolve())}}
    write_config_file(path, config)
    return path


# ---------------------------------------------------------------------------
# StyleTTS2's pretrained components, seeded, in their published formats


def _weight(gen: torch.Generator, *shape, fan_in: int | None = None, std: float | None = None):
    """N(0, 1/fan_in) (the second axis onward's size by default), or
    N(0, std²)."""
    scale = std if std is not None else (fan_in or int(np.prod(shape[1:]))) ** -0.5
    return torch.randn(shape, generator=gen) * scale


def _norm(prefix: str, n: int, stats: bool = False, gen=None) -> dict:
    out = {f"{prefix}.weight": torch.ones(n), f"{prefix}.bias": torch.zeros(n)}
    if stats:  # a batch norm's running statistics, not trivial
        out[f"{prefix}.running_mean"] = 0.1 * torch.randn(n, generator=gen)
        out[f"{prefix}.running_var"] = 1.0 + 0.2 * torch.rand(n, generator=gen)
    return out


def published_jdc_state(gen: torch.Generator, channels=JDC_CHANNELS,
                        lstm_hidden: int = JDC_LSTM_HIDDEN) -> dict:
    """A JDCNet state dict under the published keys (the classifier path:
    ``conv_block``, ``res_block1..3``, ``pool_block``,
    ``bilstm_classifier``, ``classifier``)."""
    c0, c1, c2, c3 = channels
    state = {"conv_block.0.weight": _weight(gen, c0, 1, 3, 3),
             **_norm("conv_block.1", c0, True, gen),
             "conv_block.3.weight": _weight(gen, c0, c0, 3, 3)}
    for i, (cin, cout) in enumerate(((c0, c1), (c1, c2), (c2, c3)), 1):
        p = f"res_block{i}"
        state.update({**_norm(f"{p}.pre_conv.0", cin, True, gen),
                      f"{p}.conv.0.weight": _weight(gen, cout, cin, 3, 3),
                      **_norm(f"{p}.conv.1", cout, True, gen),
                      f"{p}.conv.3.weight": _weight(gen, cout, cout, 3, 3),
                      f"{p}.conv1by1.weight": _weight(gen, cout, cin, 1, 1)})
    state.update(_norm("pool_block.0", c3, True, gen))
    feat, h = c3 * JDC_BINS, lstm_hidden
    for suffix in ("", "_reverse"):
        lstm = f"bilstm_classifier.{{}}_l0{suffix}"
        state.update({lstm.format("weight_ih"): _weight(gen, 4 * h, feat),
                      lstm.format("weight_hh"): _weight(gen, 4 * h, h),
                      lstm.format("bias_ih"): torch.zeros(4 * h),
                      lstm.format("bias_hh"): torch.zeros(4 * h)})
    state.update({"classifier.weight": _weight(gen, 1, 2 * h, std=10.0),
                  "classifier.bias": torch.full((1,), 100.0)})  # F0 of 100-250 Hz
    return state


def published_asr_state(gen: torch.Generator, geometry: dict = ASR_GEOMETRY) -> dict:
    """An ASRCNN state dict under the published aligner's keys."""
    hid, n_token = geometry["hidden_dim"], geometry["n_token"]
    emb, h = geometry["token_embedding_dim"], geometry["hidden_dim"] // 2
    state = {"init_cnn.conv.weight": _weight(gen, hid, geometry["input_dim"] // 2, 7),
             "init_cnn.conv.bias": torch.zeros(hid),
             "projection.conv.weight": _weight(gen, h, hid, 1), "projection.conv.bias": torch.zeros(h),
             "ctc_linear.0.linear_layer.weight": _weight(gen, hid, h),
             "ctc_linear.0.linear_layer.bias": torch.zeros(hid),
             "ctc_linear.2.linear_layer.weight": _weight(gen, n_token, hid),
             "ctc_linear.2.linear_layer.bias": torch.zeros(n_token)}
    for i in range(geometry["n_layers"]):
        for j in range(3):
            inner = f"cnns.{i}.0.blocks.{j}"
            state.update({f"{inner}.0.conv.weight": _weight(gen, hid, hid, 3),
                          f"{inner}.0.conv.bias": torch.zeros(hid), **_norm(f"{inner}.2", hid),
                          f"{inner}.4.conv.weight": _weight(gen, hid, hid, 3),
                          f"{inner}.4.conv.bias": torch.zeros(hid)})
        state.update(_norm(f"cnns.{i}.1", hid))
    a = "asr_s2s.attention_layer"
    state.update({
        "asr_s2s.embedding.weight": _weight(gen, n_token, emb, std=0.1),
        "asr_s2s.decoder_rnn.weight_ih": _weight(gen, 4 * h, emb + h),
        "asr_s2s.decoder_rnn.weight_hh": _weight(gen, 4 * h, h),
        "asr_s2s.decoder_rnn.bias_ih": torch.zeros(4 * h),
        "asr_s2s.decoder_rnn.bias_hh": torch.zeros(4 * h),
        f"{a}.query_layer.linear_layer.weight": _weight(gen, h, h),
        f"{a}.memory_layer.linear_layer.weight": _weight(gen, h, h),
        f"{a}.v.linear_layer.weight": _weight(gen, 1, h),
        f"{a}.location_layer.location_conv.conv.weight": _weight(gen, 32, 2, 63),
        f"{a}.location_layer.location_dense.linear_layer.weight": _weight(gen, h, 32),
        "asr_s2s.project_to_hidden.0.linear_layer.weight": _weight(gen, h, 2 * h),
        "asr_s2s.project_to_hidden.0.linear_layer.bias": torch.zeros(h),
        "asr_s2s.project_to_n_symbols.weight": _weight(gen, n_token, h),
        "asr_s2s.project_to_n_symbols.bias": torch.zeros(n_token),
    })
    return state


def published_albert_state(gen: torch.Generator, geometry: dict = MULTILINGUAL_PLBERT) -> dict:
    """A ``transformers.AlbertModel`` state dict (one shared layer)."""
    hid, emb = geometry["hidden_size"], geometry["embedding_size"]
    inter = geometry["intermediate_size"]
    state = {"embeddings.word_embeddings.weight": _weight(gen, geometry["vocab_size"], emb, std=0.02),
             "embeddings.position_embeddings.weight":
                 _weight(gen, geometry["max_position_embeddings"], emb, std=0.02),
             "embeddings.token_type_embeddings.weight": _weight(gen, 2, emb, std=0.02),
             **_norm("embeddings.LayerNorm", emb),
             "encoder.embedding_hidden_mapping_in.weight": _weight(gen, hid, emb),
             "encoder.embedding_hidden_mapping_in.bias": torch.zeros(hid)}
    lp = "encoder.albert_layer_groups.0.albert_layers.0"
    for name, (o, i) in {"attention.query": (hid, hid), "attention.key": (hid, hid),
                         "attention.value": (hid, hid), "attention.dense": (hid, hid),
                         "ffn": (inter, hid), "ffn_output": (hid, inter)}.items():
        state.update({f"{lp}.{name}.weight": _weight(gen, o, i), f"{lp}.{name}.bias": torch.zeros(o)})
    for name in ("attention.LayerNorm", "full_layer_layer_norm"):
        state.update(_norm(f"{lp}.{name}", hid))
    return state


def published_wavlm_state(gen: torch.Generator, geometry: dict = BASE_PLUS) -> dict:
    """A ``transformers.WavLMModel`` state dict, its positional conv's
    weight norm under the ``parametrizations`` keys."""
    hid, heads = geometry["hidden_size"], geometry["num_heads"]
    conv_dim, inter = list(geometry["conv_dim"]), geometry["intermediate_size"]
    state = {}
    for i, (ch, k) in enumerate(zip(conv_dim, geometry["conv_kernel"])):
        cin = 1 if i == 0 else conv_dim[i - 1]
        state[f"feature_extractor.conv_layers.{i}.conv.weight"] = _weight(gen, ch, cin, k)
    state.update(_norm("feature_extractor.conv_layers.0.layer_norm", conv_dim[0]))
    state.update(_norm("feature_projection.layer_norm", conv_dim[-1]))
    state.update({"feature_projection.projection.weight": _weight(gen, hid, conv_dim[-1]),
                  "feature_projection.projection.bias": torch.zeros(hid)})
    kp, groups = geometry["num_conv_pos_embeddings"], geometry["num_conv_pos_embedding_groups"]
    v = _weight(gen, hid, hid // groups, kp)
    pc = "encoder.pos_conv_embed.conv"
    state.update({f"{pc}.parametrizations.weight.original0":
                      torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True)),
                  f"{pc}.parametrizations.weight.original1": v, f"{pc}.bias": torch.zeros(hid)})
    state.update(_norm("encoder.layer_norm", hid))
    state["encoder.layers.0.attention.rel_attn_embed.weight"] = _weight(
        gen, geometry["num_buckets"], heads, std=0.02)
    for i in range(geometry["num_layers"]):
        pre = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state.update({f"{pre}.attention.{name}.weight": _weight(gen, hid, hid),
                          f"{pre}.attention.{name}.bias": torch.zeros(hid)})
        state.update({f"{pre}.attention.gru_rel_pos_linear.weight": _weight(gen, 8, hid // heads),
                      f"{pre}.attention.gru_rel_pos_linear.bias": torch.zeros(8),
                      f"{pre}.attention.gru_rel_pos_const": torch.ones(1, heads, 1, 1),
                      **_norm(f"{pre}.layer_norm", hid),
                      f"{pre}.feed_forward.intermediate_dense.weight": _weight(gen, inter, hid),
                      f"{pre}.feed_forward.intermediate_dense.bias": torch.zeros(inter),
                      f"{pre}.feed_forward.output_dense.weight": _weight(gen, hid, inter),
                      f"{pre}.feed_forward.output_dense.bias": torch.zeros(hid),
                      **_norm(f"{pre}.final_layer_norm", hid)})
    return state


# facebook/wav2vec2-base-960h's vocabulary: the specials, the word
# separator, then the letters by frequency.
BASE_960H_VOCAB = ("<pad>", "<s>", "</s>", "<unk>", "|", *"ETAONIHSRDLUMWCFGYPBVK'XJQZ")


def published_wav2vec2_state(gen: torch.Generator, geometry: dict = WAV2VEC2_BASE) -> dict:
    """A ``transformers.Wav2Vec2ForCTC`` state dict of ``geometry``
    (``Wav2Vec2CTC``'s argument names), its positional conv's weight norm
    under the ``parametrizations`` keys."""
    hid, inter = geometry["hidden_size"], geometry["intermediate_size"]
    conv_dim, layer_norms = list(geometry["conv_dim"]), geometry["feat_extract_norm"] == "layer"
    fe = "wav2vec2.feature_extractor.conv_layers"
    state = {}
    for i, (ch, k) in enumerate(zip(conv_dim, geometry["conv_kernel"])):
        state[f"{fe}.{i}.conv.weight"] = _weight(gen, ch, 1 if i == 0 else conv_dim[i - 1], k)
        if geometry["conv_bias"]:
            state[f"{fe}.{i}.conv.bias"] = torch.zeros(ch)
        if layer_norms or i == 0:
            state.update(_norm(f"{fe}.{i}.layer_norm", ch))
    state.update(_norm("wav2vec2.feature_projection.layer_norm", conv_dim[-1]))
    state.update({"wav2vec2.feature_projection.projection.weight": _weight(gen, hid, conv_dim[-1]),
                  "wav2vec2.feature_projection.projection.bias": torch.zeros(hid),
                  "wav2vec2.masked_spec_embed": torch.rand(hid, generator=gen)})
    kp, groups = geometry["num_conv_pos_embeddings"], geometry["num_conv_pos_embedding_groups"]
    v = _weight(gen, hid, hid // groups, kp)
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    state.update({f"{pc}.parametrizations.weight.original0":
                      torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True)),
                  f"{pc}.parametrizations.weight.original1": v, f"{pc}.bias": torch.zeros(hid)})
    state.update(_norm("wav2vec2.encoder.layer_norm", hid))
    for i in range(geometry["num_layers"]):
        pre = f"wav2vec2.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state.update({f"{pre}.attention.{name}.weight": _weight(gen, hid, hid),
                          f"{pre}.attention.{name}.bias": torch.zeros(hid)})
        state.update({**_norm(f"{pre}.layer_norm", hid),
                      f"{pre}.feed_forward.intermediate_dense.weight": _weight(gen, inter, hid),
                      f"{pre}.feed_forward.intermediate_dense.bias": torch.zeros(inter),
                      f"{pre}.feed_forward.output_dense.weight": _weight(gen, hid, inter),
                      f"{pre}.feed_forward.output_dense.bias": torch.zeros(hid),
                      **_norm(f"{pre}.final_layer_norm", hid)})
    state.update({"lm_head.weight": _weight(gen, geometry["vocab_size"], hid),
                  "lm_head.bias": torch.zeros(geometry["vocab_size"])})
    return state


def write_wav2vec2_ctc(out_dir: Path, gen: torch.Generator,
                       geometry: dict = WAV2VEC2_BASE) -> Path:
    """A seeded wav2vec2-CTC model directory in the HuggingFace layout that
    ``transformers.Wav2Vec2ForCTC``/``Wav2Vec2Processor.from_pretrained`` and
    ``load_wav2vec2_ctc`` read, with facebook/wav2vec2-base-960h's
    vocabulary (``BASE_960H_VOCAB``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    geometry = dict(geometry, vocab_size=len(BASE_960H_VOCAB))
    files = {
        "config.json": hf_config(geometry),
        "vocab.json": {token: i for i, token in enumerate(BASE_960H_VOCAB)},
        "preprocessor_config.json": {
            "do_normalize": True, "feature_extractor_type": "Wav2Vec2FeatureExtractor",
            "feature_size": 1, "padding_side": "right", "padding_value": 0.0,
            "return_attention_mask": False, "sampling_rate": 16000},
        "tokenizer_config.json": {
            "tokenizer_class": "Wav2Vec2CTCTokenizer", "unk_token": "<unk>", "bos_token": "<s>",
            "eos_token": "</s>", "pad_token": "<pad>", "word_delimiter_token": "|",
            "do_lower_case": False},
    }
    for name, content in files.items():
        (out_dir / name).write_text(json.dumps(content, indent=1), encoding="utf8")
    torch.save(published_wav2vec2_state(gen, geometry), out_dir / "pytorch_model.bin")
    return out_dir


def write_long_recording(root: Path, n_lines: int, seconds: float, seed: int = 0) -> tuple:
    """(wav path, transcript path): a seeded stereo recording of about
    ``seconds`` at 22,050 Hz (voiced tones of varying pitch with pauses, two
    channels slightly apart) and a transcript of ``n_lines`` lines of
    ``CORPUS_WORDS``."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    sr = 22050
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110.0 + 60.0 * np.sin(2 * np.pi * 0.23 * t)
    voiced = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / sr) * (np.sin(2 * np.pi * 0.5 * t) > -0.3)
    left = voiced + 0.01 * rng.standard_normal(n)
    right = 0.9 * voiced + 0.01 * rng.standard_normal(n)
    wav = root / "long.wav"
    write_wav(wav, np.stack([left, right]).astype(np.float32), sr)
    lines = [" ".join(rng.choice(CORPUS_WORDS, size=int(rng.integers(4, 10))))
             for _ in range(n_lines)]
    transcript = root / "transcript.txt"
    transcript.write_text("\n".join(lines) + "\n", encoding="utf8")
    return wav, transcript


def write_pretrained_components(root: Path, gen: torch.Generator, jdc: dict | None = None,
                                asr: dict = ASR_GEOMETRY, plbert: dict = MULTILINGUAL_PLBERT,
                                wavlm: dict = BASE_PLUS) -> dict:
    """Seeded pretrained components under ``root``, in the published
    formats (``jdc`` the ``published_jdc_state`` options; the other three
    their geometries). Returns their paths: ``f0``, ``asr``,
    ``asr_config``, ``plbert``, ``plbert_config`` and ``wavlm`` (a
    directory)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {"f0": root / "bst.t7", "asr": root / "asr" / "epoch_00080.pth",
             "asr_config": root / "asr" / "config.yml",
             "plbert": root / "plbert" / "step_1100000.t7",
             "plbert_config": root / "plbert" / "config.yml", "wavlm": root / "wavlm-base-plus"}
    for key in ("asr", "plbert", "wavlm"):
        (paths[key] if key == "wavlm" else paths[key].parent).mkdir(parents=True, exist_ok=True)
    torch.save({"net": published_jdc_state(gen, **(jdc or {}))}, paths["f0"])
    torch.save({"model": published_asr_state(gen, asr)}, paths["asr"])
    paths["asr_config"].write_text(yaml_lite.dump({"model_params": dict(asr)}), encoding="utf8")
    albert = published_albert_state(gen, plbert)
    torch.save({"net": {f"module.encoder.{k}": v for k, v in albert.items()}}, paths["plbert"])
    names = {ours: theirs for theirs, ours in PLBERT_CONFIG_NAMES.items()}
    paths["plbert_config"].write_text(yaml_lite.dump(
        {"model_params": {names[k]: v for k, v in plbert.items()}}), encoding="utf8")
    hf = {"model_type": "wavlm", "hidden_size": wavlm["hidden_size"],
          "num_hidden_layers": wavlm["num_layers"], "num_attention_heads": wavlm["num_heads"],
          "intermediate_size": wavlm["intermediate_size"], "conv_dim": list(wavlm["conv_dim"]),
          "conv_kernel": list(wavlm["conv_kernel"]), "conv_stride": list(wavlm["conv_stride"]),
          "num_buckets": wavlm["num_buckets"], "max_bucket_distance": wavlm["max_distance"],
          "num_conv_pos_embeddings": wavlm["num_conv_pos_embeddings"],
          "num_conv_pos_embedding_groups": wavlm["num_conv_pos_embedding_groups"],
          "feat_extract_norm": "group", "conv_bias": False, "do_stable_layer_norm": False}
    (paths["wavlm"] / "config.json").write_text(json.dumps(hf, indent=1), encoding="utf8")
    torch.save(published_wavlm_state(gen, wavlm), paths["wavlm"] / "pytorch_model.bin")
    return paths


def pretrained_overrides(paths: dict) -> list:
    """The ``-c`` overrides that point a text-to-wav config at
    ``write_pretrained_components``' files, as ``fetch-pretrained`` prints
    them."""
    return [f"pretrained.f0.local_path={paths['f0']}",
            f"pretrained.asr.local_checkpoint={paths['asr']}",
            f"pretrained.asr.local_config={paths['asr_config']}",
            f"pretrained.plbert.local_checkpoint={paths['plbert']}",
            f"pretrained.plbert.local_config={paths['plbert_config']}",
            f"model.slm.model={paths['wavlm']}"]


def write_styletts2_pretrained_project(root: Path, n_utts: int, gen: torch.Generator,
                                       seed: int = 0, **training) -> tuple:
    """A StyleTTS2 project (``write_styletts2_project``, with its
    out-of-domain text) and seeded pretrained components at their published
    geometries under ``root/pretrained`` (``write_pretrained_components``).
    Returns (config path, the ``-c`` overrides, the components' paths)."""
    root = Path(root)
    config_path = write_styletts2_project(root, n_utts, seed=seed, **training)
    paths = write_pretrained_components(root / "pretrained", gen)
    return config_path, pretrained_overrides(paths), paths

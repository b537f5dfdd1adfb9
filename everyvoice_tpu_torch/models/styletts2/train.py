"""StyleTTS2's two-stage trainer on one device (counterpart of
everyvoice_tpu/models/styletts2/train.py).

Two regimes, chosen by what is on disk, as the JAX trainer chooses: with
no pretrained file, the in-framework stand-ins (the conv context encoder
in place of PL-BERT, the FastSpeech2 alignment encoder as the TMA
(text-mel) aligner, and the preprocessor's F0); with the files that
``pretrained.*`` names (``load_pretrained_components``), the published
recipe's components: PL-BERT as the text-context encoder, fine-tuned at
``bert_lr``; the ASR aligner as the TMA aligner, fine-tuned at ``ft_lr``,
its attention the alignment from epoch 0 and its decoder's seq2seq loss
the ``s2s`` term; and the frozen JDC network's F0 as the F0 targets. A
configured path that does not exist warns and leaves the stand-in. In
stage 2, where ``model.slm.model`` names a WavLM on disk, SLM-adversarial
training joins: the frozen WavLM (in the step's compute dtype, its
features float32) encodes the 16 kHz resampled wavs, a head in the
discriminators' tree scores them, and from ``joint_epoch`` the generator
also decodes out-of-domain texts (the preprocessor's ``ood/`` bank) for the
SLM to judge.

Stage 1 (``mode="first"``) trains the generator stack against the MPD and
MSD: mel, duration (cross-entropy and L1), F0 and energy losses, the
adversarial and feature-matching losses on a random clip of
``decoder_segment_frames`` an utterance, and from ``tma_epoch`` on the TMA
losses, the aligner's Viterbi durations replacing the teacher's. Stage 2
(``mode="second"``) starts from stage 1's checkpoint, keeps the TMA on and
adds the style diffusion (EDM) and style reconstruction losses, weighted in
from ``diff_epoch``.

A step is the JAX package's, in its order: one set of clip starts for both
updates; the alignment targets once, without gradient, on the parameters
before any update; the discriminators' loss and update on a decode of
their own; then the generator's loss, on a second decode with its own
noise and dropout, against the updated discriminators, and its update.
Every random draw comes from a ``torch.Generator``: the clip starts, both
decodes' source noise, the diffusion's σ and noise, the ASR decoder's masks
and the out-of-domain texts and their decodes' noise from one seeded like
the JAX trainer's (17), the dropout masks from one seeded with the crc32
of the logger name. ``draw_step`` makes a step's draws; a caller (a test)
may hand ``train_step`` its own. Each network has its own ``optax.adamw``
with optax's defaults (weight decay 1e-4), after a global-norm clip when
``gradient_clip_val`` is given; with PL-BERT or the ASR aligner staged the
generator's is ``optax.multi_transform`` over the ``base``, ``bert`` and
``ft`` groups (``GroupedAdamW``). Checkpoints hold both optimizer states in
the optax layout, so either package resumes the other's.
"""

from __future__ import annotations

import logging
import math
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, fields
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from everyvoice_tpu_torch.convert import flax_to_torch, hifigan_tree, torch_to_flax
from everyvoice_tpu_torch.dataloader.prefetch import prefetch, to_device
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.resample import resample
from everyvoice_tpu_torch.dsp.spectral import dynamic_range_compression, get_spectral_transform
from everyvoice_tpu_torch.models.fs2 import alignment
from everyvoice_tpu_torch.models.hifigan.loss import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANDiscriminators
from everyvoice_tpu_torch.models.layers import Dropout, lengths_to_mask, set_dropout_generator
from everyvoice_tpu_torch.models.styletts2.asr import dct_matrix, draw_asr_masks, load_asr_params
from everyvoice_tpu_torch.models.styletts2.jdc import jdc_f0, load_jdc_params
from everyvoice_tpu_torch.models.styletts2.layers import SIGMA_FREQS, AdaINResBlock1
from everyvoice_tpu_torch.models.styletts2.loss import (
    asr_s2s_loss,
    diffusion_edm_loss,
    duration_ce_loss,
    duration_l1_loss,
    f0_loss,
    norm_loss,
    style_reconstruction_loss,
)
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.models.styletts2.plbert import load_plbert_params
from everyvoice_tpu_torch.models.styletts2.slm import (
    SLMDiscriminator,
    load_wavlm_params,
    slm_discriminator_loss,
    slm_generator_loss,
    stack_hidden_states,
    wavlm_from_flax,
)
from everyvoice_tpu_torch.parallel import (
    data_parallel,
    fresh_sharded_opt_state,
    full_opt_state,
    mean_denominator,
    pad_batch_for_eval,
    shard_opt_state_like,
    shard_params,
)
from everyvoice_tpu_torch.parallel.sharding import Placement, gathered
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
from everyvoice_tpu_torch.train.loop import (
    LECUN_TRUNCATED_STD,
    TrainerBase,
    _host_floats,
    _truncated_normal,
    init_hifigan_parameters,
)
from everyvoice_tpu_torch.train.optim import build_optimizer, global_norm_of
from everyvoice_tpu_torch.utils import generic_psv_filelist_reader
from everyvoice_tpu_torch.utils.precision import no_tf32, resolve_compute_dtype, torch_dtype

logger = logging.getLogger(__name__)

STAGE_CHECKPOINTS = {"first": "stage-1-last.ckpt", "second": "stage-2-last.ckpt"}
STEP_SEED = 17  # the JAX trainer's training_rng(17)
VALIDATION_BATCHES = 8
STYLE_NOISE_SIGMA = 0.1  # the style reconstruction's denoise of the joint style


def adamw_config(lr: float) -> dict:
    """``optax.adamw(lr)`` with optax's defaults, as an optimizer section
    of ``train/optim.py``."""
    return {"name": "adamw", "learning_rate": lr, "betas": [0.9, 0.999], "eps": 1e-8,
            "weight_decay": 1e-4}


# Generator parameter groups of the pretrained components (the flax tree's
# top-level module names, which the JAX trainer labels): PL-BERT at
# ``bert_lr``, the ASR aligner at ``ft_lr``, the rest ``base`` at ``lr``.
PRETRAINED_GROUPS = {"plbert_encoder": "bert", "text_aligner": "ft"}
OOD_BANK_SIZE = 512


def _present(path, what: str) -> bool:
    """Whether a configured pretrained path is on disk; a configured path
    that is not warns, and the stand-in trains instead."""
    if path is None:
        return False
    if Path(path).exists():
        return True
    logger.warning(f"pretrained.{what} is set to {path} but no such file exists — using the "
                   "trainable in-framework stand-in. Stage it with `everyvoice-tpu "
                   "fetch-pretrained text-to-wav` on a machine with network access.")
    return False


def _existing(path):
    return path if path and Path(path).exists() else None


def load_pretrained_components(config: dict, project_symbols) -> dict:
    """The staged pretrained components of ``config["pretrained"]``:
    ``plbert`` and ``asr`` as (geometry, flax tree) to graft into the
    generator, their symbol tables remapped onto ``project_symbols`` from
    ``pretrained_symbols``; ``jdc`` as the frozen ``JDCNet``. A component
    whose path is unset or absent is None."""
    pre = config["pretrained"]
    symbols = list(pre["pretrained_symbols"])
    out = {"plbert": None, "asr": None, "jdc": None}
    if _present(pre["f0"]["local_path"], "f0.local_path"):
        out["jdc"] = load_jdc_params(pre["f0"]["local_path"])[0]
        logger.info(f"Loaded the pretrained JDC F0 network from {pre['f0']['local_path']} "
                    "(frozen; the F0 targets come from it).")
    plbert = pre["plbert"]
    if _present(plbert["local_checkpoint"], "plbert.local_checkpoint"):
        out["plbert"] = load_plbert_params(plbert["local_checkpoint"],
                                           _existing(plbert["local_config"]),
                                           list(project_symbols), symbols)
        logger.info(f"Loaded pretrained PL-BERT from {plbert['local_checkpoint']} (fine-tuned "
                    f"at bert_lr={config['training']['optimizer']['bert_lr']}).")
    asr = pre["asr"]
    if _present(asr["local_checkpoint"], "asr.local_checkpoint"):
        out["asr"] = load_asr_params(asr["local_checkpoint"], _existing(asr["local_config"]),
                                     list(project_symbols), symbols)
        logger.info(f"Loaded the pretrained ASR aligner from {asr['local_checkpoint']} "
                    f"(fine-tuned at ft_lr={config['training']['optimizer']['ft_lr']}).")
    return out


class GroupedAdamW:
    """``optax.multi_transform`` of ``optax.adamw``s over named parameter
    groups (``rates``: group → learning rate), after one global-norm clip of
    all the gradients when ``gradient_clip_val`` is given. A parameter's
    group is its top module's in ``PRETRAINED_GROUPS``, else ``base``, for
    the update and the checkpoint layout alike. Its state is
    ``{group: Optimizer state}``; ``to_optax`` writes multi_transform's
    layout, each group's moments over the whole tree with the other groups'
    leaves masked (``{}``)."""

    def __init__(self, rates: dict, gradient_clip_val=None):
        self.groups = {g: build_optimizer(adamw_config(lr)) for g, lr in rates.items()}
        self.clip = gradient_clip_val if gradient_clip_val and gradient_clip_val > 0 else None

    def _split(self, named: dict) -> dict:
        out = {g: {} for g in self.groups}
        for n, v in named.items():
            out[self.group_of(n)][n] = v
        return out

    def init(self, params: dict) -> dict:
        return {g: self.groups[g].init(p) for g, p in self._split(params).items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict, global_norm=None) -> torch.Tensor:
        g = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(p)
             for n, p in params.items()}
        norm = global_norm_of(list(g), list(g.values()), global_norm)
        if self.clip is not None:
            factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            g = dict(zip(g, torch._foreach_mul(list(g.values()), factor)))
        split_grads = self._split(g)
        for group, p in self._split(params).items():
            if p:
                self.groups[group].step(p, split_grads[group], state[group])
            else:  # optax counts a group's updates whether or not it has leaves
                state[group]["count"] += 1
        return norm

    @staticmethod
    def group_of(name: str) -> str:
        """The group of a parameter's dotted name or of a top module."""
        return PRETRAINED_GROUPS.get(name.split(".")[0], "base")

    def to_optax(self, state: dict, to_flax) -> dict:
        """``to_flax`` maps a dict of named tensors (every parameter) to the
        flax tree."""
        def masked(tree, group):
            def empty(node):
                return {k: empty(v) for k, v in node.items()} if isinstance(node, dict) else {}
            return {"params": {k: v if self.group_of(k) == group else empty(v)
                               for k, v in tree["params"].items()}}

        inner = {}
        full = {n: torch.zeros_like(v) for s in state.values() for n, v in s["mu"].items()}
        for group, opt in self.groups.items():
            tree = opt.to_optax(
                state[group], lambda named, f=full: to_flax({**f, **named}))
            adam = tree["0"]
            adam["mu"], adam["nu"] = masked(adam["mu"], group), masked(adam["nu"], group)
            inner[group] = {"inner_state": tree}
        tree = {"inner_states": inner}
        return {"0": {}, "1": tree} if self.clip is not None else tree

    def from_optax(self, tree: dict, from_flax) -> dict:
        """Inverse of ``to_optax``; ``from_flax`` maps a whole flax tree to
        the named tensors of every parameter."""
        inner = (tree["1"] if self.clip is not None else tree)["inner_states"]
        merged = {}
        for moment in ("mu", "nu"):
            params = {}
            for module in inner["base"]["inner_state"]["0"][moment]["params"]:
                group = self.group_of(module)
                params[module] = inner[group]["inner_state"]["0"][moment]["params"][module]
            merged[moment] = self._split(from_flax({"params": params}))
        return {g: {"count": int(np.asarray(inner[g]["inner_state"]["0"]["count"])),
                    "schedule_count": 0, "mu": merged["mu"][g], "nu": merged["nu"][g]}
                for g in self.groups}


@dataclass
class StepDraws:
    """A step's random draws: the clip start of each row (None when the
    whole ``max_len`` is decoded), each decode's (B, samples) source noise,
    and the diffusion's (B,) log-σ draw and (B, 2·style) noises, all
    standard normal but the starts. With the ASR aligner, its decoder's
    masks for the generator's aligner pass (``asr.draw_asr_masks``); with
    an out-of-domain bank, each loss's (B,) picks from it and its decode's
    source noise."""

    segment_starts: Optional[torch.Tensor]
    disc_noise: torch.Tensor
    gen_noise: torch.Tensor
    log_sigma: torch.Tensor
    diffusion_noise: torch.Tensor
    style_noise: torch.Tensor
    asr_unk: Optional[torch.Tensor] = None
    asr_keep: Optional[torch.Tensor] = None
    ood_index_disc: Optional[torch.Tensor] = None
    ood_index_gen: Optional[torch.Tensor] = None
    ood_noise_disc: Optional[torch.Tensor] = None
    ood_noise_gen: Optional[torch.Tensor] = None

    def to(self, device) -> "StepDraws":
        return StepDraws(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device) for f in fields(self)})

    def rows(self, start: int, count: int) -> "StepDraws":
        """The draws of rows ``start`` to ``start + count`` of the batch
        (the ASR keep mask is (N+1, B, hidden))."""
        def cut(name, value):
            if value is None:
                return None
            if name == "asr_keep":
                return value[:, start:start + count]
            return value[start:start + count]
        return StepDraws(**{f.name: cut(f.name, getattr(self, f.name)) for f in fields(self)})


@contextmanager
def deterministic(module: nn.Module):
    """``module``'s dropout off inside the block (the JAX package's
    ``deterministic=True``); the rest keeps its mode, since cuDNN's LSTM
    backward needs training mode."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    was = [m.training for m in drops]
    for m in drops:
        m.training = False
    try:
        yield
    finally:
        for m, mode in zip(drops, was):
            m.training = mode


def _orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """flax's orthogonal initialiser for an (n, n) kernel."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def init_styletts2_parameters(model: StyleTTS2, gen: torch.Generator) -> None:
    """flax's default initialisers for the generator stack, drawn from the
    host generator ``gen``: weight-normed convs as HiFiGAN's, Dense and Conv
    kernels lecun-normal, zero biases, unit norm scales and snake alphas,
    embeddings N(0, 1/features), and each LSTM gate's input kernel
    lecun-normal and hidden kernel orthogonal (flax's
    ``OptimizedLSTMCell``)."""
    init_hifigan_parameters(model, gen)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            std = 1.0 / math.sqrt(m.weight[0].numel()) / LECUN_TRUNCATED_STD
            m.weight.copy_(_truncated_normal(m.weight.shape, std, gen))
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(m.weight.shape[1]))
        elif isinstance(m, nn.LSTM):
            hidden, n_in = m.hidden_size, m.input_size
            std = 1.0 / math.sqrt(n_in) / LECUN_TRUNCATED_STD
            m.weight_ih_l0.copy_(_truncated_normal((4 * hidden, n_in), std, gen))
            m.weight_hh_l0.copy_(torch.cat([_orthogonal(hidden, gen).T for _ in range(4)]))
            m.bias_ih_l0.zero_()
            m.bias_hh_l0.zero_()
        elif isinstance(m, AdaINResBlock1):
            for alpha in (*m.alpha1, *m.alpha2):
                alpha.fill_(1.0)


class StyleTTS2Trainer(TrainerBase):
    """Trains StyleTTS2 stage ``mode`` ("first" or "second") on ``dataset``
    (a ``StyleTTS2Dataset``), validating on ``val_dataset``, on ``device``
    (the CUDA card unless the caller names the CPU). The LSTMs' input
    biases stay zero (flax's LSTM cell has none), so they are not
    trained. ``jdc`` and ``wavlm`` are the frozen pretrained networks (None
    when not staged); the SLM head is ``discriminators.slm``. On a ``mesh``
    the trained networks are replicated (data parallel; a tensor-parallel
    strategy's model-axis ranks compute the same rows, as the JAX trainer's
    do) or, with ``fsdp``, sharded; the frozen ones are replicated. Each
    rank draws the global batch's ``StepDraws`` and keeps its rows."""

    model_name = "StyleTTS2Module"

    def __init__(self, config: dict, dataset, val_dataset, lang2id: Optional[dict] = None,
                 run_dir: Optional[Path] = None, mode: str = "first",
                 gradient_clip_val: Optional[float] = None, compute_dtype: str = "auto",
                 device=None, mesh=None, fsdp: bool = False):
        if mode not in STAGE_CHECKPOINTS:
            raise ValueError(f"mode must be 'first' or 'second', not {mode!r}")
        # before the components and the run directory
        device = resolve_device(device) if mesh is None else mesh.device
        self.last_checkpoint_name = STAGE_CHECKPOINTS[mode]
        super().__init__(config, run_dir=run_dir, device=device, mesh=mesh, fsdp=fsdp)
        self.mode = mode
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.lang2id = lang2id or {}
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        m = config["model"]
        components = load_pretrained_components(config, dataset.text_processor.symbols)
        self.plbert_geometry, self._plbert_pretrained = components["plbert"] or (None, None)
        self.asr_geometry, self._asr_pretrained = components["asr"] or (None, None)
        self.jdc = components["jdc"].to(self.device) if components["jdc"] is not None else None
        # SLM-adversarial training: stage 2, with a WavLM on disk. The
        # frozen WavLM runs in the compute dtype (its features float32).
        self.wavlm = None
        if mode == "second" and Path(m["slm"]["model"]).exists():
            geometry, tree = load_wavlm_params(m["slm"]["model"])
            self.wavlm = wavlm_from_flax(geometry, tree).to(
                self.device, torch_dtype(self.compute_dtype))
            logger.info(f"SLM-adversarial training enabled (WavLM from {m['slm']['model']})")
        with torch.device("meta"):  # no draw from the global RNG
            model = StyleTTS2.from_config(config, n_symbols=dataset.n_symbols,
                                          n_langs=max(len(self.lang2id), 1),
                                          plbert_geometry=self.plbert_geometry,
                                          asr_geometry=self.asr_geometry,
                                          compute_dtype=self.compute_dtype)
            discriminators = HiFiGANDiscriminators(tuple(m["decoder"]["mpd_layers"]),
                                                   m["decoder"]["msd_layers"], self.compute_dtype)
            if self.wavlm is not None:
                discriminators.slm = SLMDiscriminator(
                    (self.wavlm.num_layers + 1) * self.wavlm.hidden_size,
                    m["slm"]["initial_channel"])
        self.model = model.to_empty(device=self.device)
        self.discriminators = discriminators.to_empty(device=self.device)
        with torch.no_grad():  # a buffer, so to_empty left it unset
            self.model.denoiser.freqs.copy_(torch.from_numpy(SIGMA_FREQS))
            if self.asr_geometry is not None:
                self.model.text_aligner.dct.copy_(torch.from_numpy(
                    dct_matrix(self.asr_geometry["input_dim"] // 2, self.asr_geometry["input_dim"])))
        for name, p in self.model.named_parameters():
            if name.endswith("bias_ih_l0"):
                p.requires_grad_(False)
        self.gen_params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        self.disc_params = dict(self.discriminators.named_parameters())
        self.gen_placement = Placement(self.gen_params)  # laid out on the mesh by place()
        self.disc_placement = Placement(self.disc_params)
        opt = self.training_config["optimizer"]
        if self.plbert_geometry is not None or self.asr_geometry is not None:
            # the model has these modules only where their component is staged
            self.gen_opt = GroupedAdamW({"base": opt["lr"], "bert": opt["bert_lr"],
                                         "ft": opt["ft_lr"]}, gradient_clip_val)
        else:
            self.gen_opt = build_optimizer(adamw_config(opt["lr"]),
                                           gradient_clip_val=gradient_clip_val)
        self.disc_opt = build_optimizer(adamw_config(opt["lr"]),
                                        gradient_clip_val=gradient_clip_val)
        self.ood_bank = self.load_ood_bank() if self.wavlm is not None else None
        self.losses_cfg = self.training_config["losses"]
        a = config["preprocessing"]["audio"]
        self.mel_fn = get_spectral_transform(
            a["spec_type"], a["n_fft"], a["fft_window_size"], a["fft_hop_size"],
            a["output_sampling_rate"], a["n_mels"], a["f_min"], a["f_max"])
        self.hop_samples = a["fft_hop_size"] * (a["output_sampling_rate"] // a["input_sampling_rate"])
        name = self.training_config["logger"]["name"]
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            self._rank_seed(zlib.crc32(name.encode("utf8"))))
        set_dropout_generator(self.model, self.dropout_generator)
        self.step_generator = torch.Generator(self.device).manual_seed(STEP_SEED)
        self.gen_opt_state: Optional[dict] = None
        self.disc_opt_state: Optional[dict] = None
        self.grad_norm: Optional[torch.Tensor] = None
        self.disc_grad_norm: Optional[torch.Tensor] = None
        self._validation_noise: Optional[torch.Tensor] = None

    # -- phases ---------------------------------------------------------
    def phase_weights(self, epoch: int) -> tuple:
        """(tma_on, diff_on, joint_on) for ``epoch``: stage 1 phases the
        TMA in at ``tma_epoch``; stage 2 keeps it on and phases the
        diffusion in at ``diff_epoch`` and the SLM's out-of-domain terms at
        ``joint_epoch``."""
        losses = self.losses_cfg
        if self.mode == "first":
            return float(epoch >= losses["tma_epoch"]), 0.0, 0.0
        return 1.0, float(epoch >= losses["diff_epoch"]), float(epoch >= losses["joint_epoch"])

    def tma_active(self, epoch: int) -> bool:
        return self.mode == "second" or epoch >= self.losses_cfg["tma_epoch"]

    def ood_active(self, epoch: int) -> bool:
        """Whether ``epoch``'s steps decode out-of-domain texts for the SLM
        (stage 2 from ``joint_epoch``, with a bank and a WavLM)."""
        return (self.ood_bank is not None and self.mode == "second"
                and epoch >= self.losses_cfg["joint_epoch"])

    # -- the out-of-domain bank and the SLM ------------------------------------
    def load_ood_bank(self) -> Optional[dict]:
        """The preprocessed out-of-domain sentences (``{save_dir}/ood/
        <lang>.psv``, written by ``preprocess ... -s ood``) as a token bank
        on the device: ``tokens`` (S, max text length) zero-padded and
        ``lengths`` (S,), at most 512 sentences of at least
        ``OOD_min_length`` characters (all of them where none is that
        long). None where there are none."""
        ood_dir = Path(self.config["preprocessing"]["save_dir"]) / "ood"
        files = sorted(ood_dir.glob("*.psv")) if ood_dir.is_dir() else []
        if not files:
            logger.warning("SLM-adversarial training is on but no OOD sentences were found — "
                           "run `preprocess text-to-wav <config> -s ood` to stage them; "
                           "continuing with the in-domain SLM loss only.")
            return None
        tp, level = self.dataset.text_processor, self.dataset.level
        max_len = self.dataset.max_text_len
        min_chars = self.training_config.get("OOD_min_length") or 0
        rows = [(path.stem, row.get("text") or row.get("characters") or "")
                for path in files for row in generic_psv_filelist_reader(path)]
        rows = [r for r in rows if r[1].strip()]
        long_enough = [r for r in rows if len(r[1]) >= min_chars]
        if rows and not long_enough:
            logger.warning(f"All {len(rows)} OOD sentences are shorter than "
                           f"OOD_min_length={min_chars}; using them anyway.")
            long_enough = rows
        tokens, lengths = [], []
        for lang, text in long_enough:
            try:
                ids = tp.encode_text(text, apply_g2p=(level == "phones"),
                                     lang_id=lang if level == "phones" else None, quiet=True)
            except Exception:
                ids = tp.encode_text(text, quiet=True)
            if not ids:
                continue
            ids = list(ids)[:max_len]
            lengths.append(len(ids))
            tokens.append(ids + [0] * (max_len - len(ids)))
            if len(tokens) >= OOD_BANK_SIZE:
                break
        if not tokens:
            return None
        logger.info(f"SLM-adversarial OOD bank: {len(tokens)} sentences")
        return {"tokens": torch.tensor(tokens, dtype=torch.long, device=self.device),
                "lengths": torch.tensor(lengths, dtype=torch.long, device=self.device)}

    def slm_features(self, wav: torch.Tensor) -> torch.Tensor:
        """WavLM's stacked hidden states (B, T, (layers+1)·hidden), float32,
        of output-rate wavs resampled to ``model.slm.sr``; the gradient
        flows to the wavs, never into WavLM's frozen parameters."""
        a = self.config["preprocessing"]["audio"]
        wav16 = resample(wav, a["output_sampling_rate"], self.config["model"]["slm"]["sr"])
        dtype = next(self.wavlm.parameters()).dtype
        return stack_hidden_states(self.wavlm(wav16.to(dtype))).float()

    def synthesize_ood(self, batch: dict, index: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Decode the bank's texts ``index`` (B,) end to end (predicted
        durations and F0, styles from the batch's mels), the leading clip
        of ``segment_frames`` where the model decodes clips."""
        starts = (torch.zeros(index.shape[0], dtype=torch.long, device=index.device)
                  if self.model.segment_frames is not None else None)
        return self.model(self.ood_bank["tokens"][index], self.ood_bank["lengths"][index],
                          batch["mel"], batch["mel_lengths"], None, None, noise,
                          segment_starts=starts)["wav"]

    def target_f0_frames(self, batch: dict) -> torch.Tensor:
        """Frame F0 targets: the frozen JDC network's on the mel (zero past
        each row's frames) where it is staged, else the batch's."""
        if self.jdc is None:
            return batch["f0_frames"]
        with torch.no_grad():
            f0 = jdc_f0(self.jdc, batch["mel"])
        valid = lengths_to_mask(batch["mel_lengths"], batch["mel"].shape[1])
        return f0 * valid.to(f0.dtype)

    def teacher_f0(self, batch: dict) -> tuple:
        """Frame F0 (``target_f0_frames``) and token F0 over the batch's
        durations: the JDC's frames re-averaged where it is staged, else the
        batch's own token F0."""
        f0_frames = self.target_f0_frames(batch)
        f0_tokens = (alignment.phone_average_by_durations(f0_frames, batch["durations"])
                     if self.jdc is not None else batch["f0_tokens"])
        return f0_frames, f0_tokens

    # -- the step --------------------------------------------------------
    def draw_step(self, batch: dict, generator: Optional[torch.Generator] = None) -> StepDraws:
        """This step's draws from ``generator`` (the step generator by
        default), on the batch's device: a clip start an utterance, uniform
        over the starts that keep the clip inside its frames (0 for a
        shorter one), then both decodes' source noise and the diffusion's
        draws. On a mesh they are drawn for the global batch (its
        ``global_mel_lengths``) and this rank keeps its rows."""
        g = generator if generator is not None else self.step_generator
        device = batch["mel"].device
        lengths = batch.get("global_mel_lengths", batch["mel_lengths"])
        b = lengths.shape[0]
        seg = self.model.segment_frames
        starts = None
        if seg is not None:
            span = torch.clamp(lengths.long() - seg, min=0) + 1
            u = torch.rand(b, generator=g, device=device)
            starts = torch.minimum((u * span).long(), span - 1)
        n = (seg or self.model.max_frames) * self.model.hop
        style = 2 * self.model.style_dim

        def normal(*shape):
            return torch.randn(shape, generator=g, device=device)

        draws = StepDraws(starts, normal(b, n), normal(b, n), normal(b), normal(b, style),
                          normal(b, style))
        if self.asr_geometry is not None:
            draws.asr_unk, draws.asr_keep = draw_asr_masks(
                b, batch["text"].shape[1], self.asr_geometry["hidden_dim"] // 2, g, device)
        if self.ood_bank is not None:
            size = self.ood_bank["tokens"].shape[0]
            draws.ood_index_disc = torch.randint(size, (b,), generator=g, device=device)
            draws.ood_index_gen = torch.randint(size, (b,), generator=g, device=device)
            draws.ood_noise_disc, draws.ood_noise_gen = normal(b, n), normal(b, n)
        local = batch["mel"].shape[0]
        return draws if local == b else draws.rows(self.data_rank * local, local)

    def alignment_targets(self, batch: dict, tma_active: bool) -> dict:
        """Durations, frame F0 (``target_f0_frames``) and token F0/energy
        targets, once a step and without gradient: the batch's durations
        before the TMA phase (the token F0 re-averaged over them where the
        JDC gives the F0); from it on, or from epoch 0 with the ASR aligner
        staged, the Viterbi path of the aligner's attention (dropout off,
        the parameters before the step's updates), with F0 and energy
        re-averaged over that path."""
        if not (tma_active or self.asr_geometry is not None):
            f0_frames, f0_tokens = self.teacher_f0(batch)
            return {"f0_frames": f0_frames, "durations": batch["durations"],
                    "f0_tokens": f0_tokens, "energy_tokens": batch["energy_tokens"]}
        f0_frames = self.target_f0_frames(batch)
        with torch.no_grad(), deterministic(self.model):
            _, logprob, _ = self.model.align_text_mel(batch["text"], batch["text_lengths"],
                                                      batch["mel"], batch["mel_lengths"],
                                                      batch.get("language_id"))
        hard = alignment.viterbi_alignment(logprob, batch["text_lengths"], batch["mel_lengths"])
        return {"f0_frames": f0_frames, "durations": alignment.durations_from_hard_attention(hard),
                "f0_tokens": alignment.phone_average(f0_frames, hard),
                "energy_tokens": alignment.phone_average(batch["energy_frames"], hard)}

    def decode(self, batch: dict, targets: dict, noise: torch.Tensor) -> dict:
        """The training forward on the targets' durations and F0, decoding
        each row's clip."""
        return self.model(batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"],
                          targets["durations"], targets["f0_frames"], noise,
                          segment_starts=targets["segment_starts"],
                          language_id=batch.get("language_id"))

    def real_clip(self, audio: torch.Tensor, starts, n_samples: int) -> torch.Tensor:
        """Each row's recorded audio under its decoded clip."""
        if starts is None:
            return audio[:, :n_samples]
        begin = torch.clamp(starts.long() * self.hop_samples, 0, audio.shape[1] - n_samples)
        index = begin[:, None] + torch.arange(n_samples, device=audio.device)
        return torch.gather(audio, 1, index)

    def _log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        return dynamic_range_compression(self.mel_fn(wav))

    def discriminator_grads(self, batch: dict, targets: dict, draws: StepDraws,
                            joint_on: float = 0.0, ood_active: bool = False) -> tuple:
        """(metrics, gradients by parameter name) of the discriminators on
        the real clips and a decode of their own (its own noise and
        dropout); with the SLM, its head's LSGAN loss on WavLM's features of
        the same real and fake clips (``disc/slm``), and while
        ``ood_active`` on the real clips against an out-of-domain decode,
        weighted by ``joint_on`` (``disc/slm_ood``). ``disc/total`` is the
        sum the gradients are of."""
        with torch.no_grad():
            fake = self.decode(batch, targets, draws.disc_noise)["wav"]
        real = self.real_clip(batch["audio"], targets["segment_starts"], fake.shape[1])
        real_scores, _ = self.discriminators(real)
        fake_scores, _ = self.discriminators(fake)
        loss = discriminator_loss(real_scores, fake_scores)
        metrics = {}
        if self.wavlm is not None:
            head = self.discriminators.slm
            with torch.no_grad():
                feats_real, feats_fake = self.slm_features(real), self.slm_features(fake)
            metrics["disc/slm"] = slm_discriminator_loss(head(feats_real), head(feats_fake))
            loss = loss + metrics["disc/slm"]
            if ood_active:
                with torch.no_grad():
                    feats_ood = self.slm_features(self.synthesize_ood(
                        batch, draws.ood_index_disc, draws.ood_noise_disc))
                metrics["disc/slm_ood"] = slm_discriminator_loss(head(feats_real),
                                                                 head(feats_ood))
                loss = loss + joint_on * metrics["disc/slm_ood"]
        metrics["disc/total"] = loss
        grads = torch.autograd.grad(loss, list(self.disc_params.values()))
        return metrics, dict(zip(self.disc_params, grads))

    def generator_grads(self, batch: dict, targets: dict, draws: StepDraws, diff_on: float,
                        tma_active: bool, joint_on: float = 0.0,
                        ood_active: bool = False) -> tuple:
        """(losses, gradients of their total by parameter name): with the
        TMA on, the aligner again (with dropout, and the ASR decoder's
        draws) for the ``s2s`` loss (the ASR decoder's seq2seq
        cross-entropy, or the stand-in's forward-sum) and the binarization
        (``mono``) loss; the mel, duration, F0 and energy losses and the
        adversarial and feature-matching losses against the current
        discriminators on a second decode; in stage 2 the diffusion and
        style reconstruction losses on the detached joint style, weighted by
        ``diff_on``; with the SLM its generator loss on that decode
        (``slm``) and, while ``ood_active``, on an out-of-domain decode
        (``slm_ood``, weighted by ``joint_on``), the gradient flowing
        through the frozen WavLM to the wavs."""
        lc = self.losses_cfg
        text_lengths, mel_lengths = batch["text_lengths"], batch["mel_lengths"]
        src_mask = lengths_to_mask(text_lengths, batch["text"].shape[1])
        zero = torch.zeros((), device=self.device)
        losses = {"s2s": zero, "mono": zero}
        if tma_active:
            asr_draws = None if draws.asr_unk is None else (draws.asr_unk, draws.asr_keep)
            attn_soft, attn_logprob, aux = self.model.align_text_mel(
                batch["text"], text_lengths, batch["mel"], mel_lengths, batch.get("language_id"),
                asr_draws=asr_draws)
            hard = alignment.viterbi_alignment(attn_logprob, text_lengths, mel_lengths)
            if "s2s_logits" in aux:
                losses["s2s"] = asr_s2s_loss(aux["s2s_logits"], batch["text"], src_mask)
            else:
                losses["s2s"] = alignment.forward_sum_loss(attn_logprob, text_lengths, mel_lengths)
            losses["mono"] = alignment.binarization_loss(attn_soft, hard)
        out = self.decode(batch, targets, draws.gen_noise)
        fake = out["wav"]
        real = self.real_clip(batch["audio"], targets["segment_starts"], fake.shape[1])
        with torch.no_grad():
            mel_real = self._log_mel(real)
            _, real_feats = self.discriminators(real)
        durations = targets["durations"]
        losses["mel"] = torch.mean(torch.abs(self._log_mel(fake) - mel_real))
        losses["ce"] = duration_ce_loss(out["duration_logits"], durations, src_mask,
                                        self.model.max_dur)
        losses["dur"] = duration_l1_loss(out["duration_logits"], durations, src_mask)
        losses["f0"] = f0_loss(out["f0_prediction"], targets["f0_tokens"], src_mask)
        losses["norm"] = norm_loss(out["energy_prediction"], targets["energy_tokens"], src_mask)
        fake_scores, fake_feats = self.discriminators(fake)
        losses["gen"] = generator_adversarial_loss(fake_scores)
        losses["fm"] = feature_matching_loss(real_feats, fake_feats)
        total = (lc["lambda_mel"] * losses["mel"] + lc["lambda_ce"] * losses["ce"]
                 + lc["lambda_dur"] * losses["dur"] + lc["lambda_f0"] * losses["f0"]
                 + lc["lambda_norm"] * losses["norm"]
                 + lc["lambda_gen"] * (losses["gen"] + losses["fm"])
                 + lc["lambda_s2s"] * losses["s2s"] + lc["lambda_mono"] * losses["mono"])
        if self.mode == "second":
            joint = torch.cat([out["acoustic_style"], out["prosodic_style"]], dim=-1)
            clean = joint.detach()
            with deterministic(self.model):
                text_emb = self.model.text_context_embedding(batch["text"], src_mask)
            sigma_data = self.config["model"]["diffusion"]["dist"]["sigma_data"]
            losses["diff"] = diffusion_edm_loss(self.model.denoise_style, draws.log_sigma,
                                                draws.diffusion_noise, clean, text_emb, sigma_data)
            sigma = torch.full((joint.shape[0],), STYLE_NOISE_SIGMA, device=self.device)
            denoised = self.model.denoise_style(clean + STYLE_NOISE_SIGMA * draws.style_noise,
                                                sigma, text_emb)
            losses["sty"] = style_reconstruction_loss(denoised, joint)
            total = total + diff_on * (lc["lambda_diff"] * losses["diff"]
                                       + lc["lambda_sty"] * losses["sty"])
        if self.wavlm is not None:
            head = self.discriminators.slm
            losses["slm"] = slm_generator_loss(head(self.slm_features(fake)))
            total = total + lc["lambda_slm"] * losses["slm"]
            if ood_active:
                ood = self.synthesize_ood(batch, draws.ood_index_gen, draws.ood_noise_gen)
                losses["slm_ood"] = slm_generator_loss(head(self.slm_features(ood)))
                total = total + joint_on * lc["lambda_slm"] * losses["slm_ood"]
        losses["total"] = total
        grads = torch.autograd.grad(total, list(self.gen_params.values()), allow_unused=True)
        return losses, dict(zip(self.gen_params, grads))

    def train_step(self, batch: dict, draws: Optional[StepDraws] = None,
                   epoch: Optional[int] = None) -> dict:
        """One step on a device batch at ``epoch``'s phase (the trainer's
        epoch by default), from ``draws`` (``draw_step``'s by default);
        returns the (detached) losses, each computed before the update it
        drives."""
        epoch = self.epoch if epoch is None else epoch
        tma, ood = self.tma_active(epoch), self.ood_active(epoch)
        _, diff_on, joint_on = self.phase_weights(epoch)
        self.model.train()
        self.discriminators.train()
        with no_tf32(), data_parallel(self.mesh), gathered(self.gen_placement,
                                                           self.disc_placement):
            draws = draws if draws is not None else self.draw_step(batch)
            targets = self.alignment_targets(batch, tma)
            targets["segment_starts"] = draws.segment_starts
            d_metrics, d_grads = self.discriminator_grads(batch, targets, draws, joint_on, ood)
            self.disc_grad_norm = self._update(self.disc_opt, self.disc_placement, d_grads,
                                               self.disc_opt_state)
            self.disc_placement.gather()  # the generator's loss sees the update
            losses, g_grads = self.generator_grads(batch, targets, draws, diff_on, tma,
                                                   joint_on, ood)
            self.grad_norm = self._update(self.gen_opt, self.gen_placement, g_grads,
                                          self.gen_opt_state)
        return {**{k: v.detach() for k, v in d_metrics.items()},
                **{f"gen/{k}": v.detach() for k, v in losses.items()}}

    # -- validation -----------------------------------------------------
    def validation_noise(self, b: int) -> torch.Tensor:
        """The decoder's source noise in validation: one fixed draw of a
        CPU generator seeded with 0 (the JAX package's deterministic decode
        uses one fixed draw of its own)."""
        n = self.model.max_frames * self.model.hop
        if self._validation_noise is None or self._validation_noise.shape[0] != b:
            self._validation_noise = torch.randn(
                (b, n), generator=torch.Generator().manual_seed(0)).to(self.device)
        return self._validation_noise

    def val_losses(self, batch: dict) -> dict:
        """Held-out losses of one device batch: the deterministic forward
        on the teacher durations and F0, decoded over all ``max_len``
        frames; pad rows (``row_weights`` 0) count nowhere."""
        with torch.no_grad(), no_tf32(), deterministic(self.model):
            f0_frames, f0_tokens = self.teacher_f0(batch)
            noise = self._rank_block(self.validation_noise(batch["mel"].shape[0] * self.data_size))
            out = self.model(batch["text"], batch["text_lengths"], batch["mel"],
                             batch["mel_lengths"], batch["durations"], f0_frames, noise)
            fake = out["wav"]
            diff = torch.abs(self._log_mel(fake) - self._log_mel(batch["audio"][:, : fake.shape[1]]))
            src_mask = lengths_to_mask(batch["text_lengths"], batch["text"].shape[1])
            weights = batch.get("row_weights")
            if weights is not None:
                src_mask = src_mask & (weights > 0.5)[:, None]
                mel = torch.sum(diff.mean(dim=(1, 2)) * weights) / mean_denominator(weights.sum(),
                                                                                    1.0)
            else:
                mel = diff.mean()
            durations = batch["durations"]
            losses = {
                "mel": mel,
                "ce": duration_ce_loss(out["duration_logits"], durations, src_mask,
                                       self.model.max_dur),
                "dur": duration_l1_loss(out["duration_logits"], durations, src_mask),
                "f0": f0_loss(out["f0_prediction"], f0_tokens, src_mask),
                "norm": norm_loss(out["energy_prediction"], batch["energy_tokens"], src_mask),
            }
            lc = self.losses_cfg
            losses["total"] = (lc["lambda_mel"] * losses["mel"] + lc["lambda_ce"] * losses["ce"]
                               + lc["lambda_dur"] * losses["dur"] + lc["lambda_f0"] * losses["f0"]
                               + lc["lambda_norm"] * losses["norm"])
        return losses

    def validate(self) -> dict:
        """Mean validation losses over real rows, from at most 8 batches of
        ``batch_size`` (at least the device count; the last padded up with
        0-weighted rows), each split over the batch ranks."""
        totals: dict = {}
        rows = 0
        batch_size = max(self.training_config["batch_size"], self.n_devices, 1)
        with gathered(self.gen_placement), data_parallel(self.mesh):
            for count, batch in enumerate(self.val_dataset.batches(batch_size, shuffle=False)):
                if count >= VALIDATION_BATCHES:
                    break
                batch.pop("basenames", None)
                batch, n_true = pad_batch_for_eval(batch, self.n_devices, batch_size)
                losses = self.val_losses(to_device(self._local_rows(batch), self.device))
                for k, v in _host_floats(self._global_mean(losses)).items():
                    totals[k] = totals.get(k, 0.0) + v * n_true
                rows += n_true
        return {f"validation/{k}": v / rows for k, v in totals.items()} if rows else {}

    # -- parameters and checkpoints ---------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """flax-like initial parameters for both networks, drawn on the host
        from one generator seeded with ``seed`` and copied to the device,
        then the staged PL-BERT and ASR aligner grafted over theirs."""
        gen = torch.Generator().manual_seed(seed)
        init_styletts2_parameters(self.model, gen)
        init_hifigan_parameters(self.discriminators, gen)
        if self.wavlm is not None:
            with torch.no_grad():
                for conv in self.discriminators.slm.children():
                    std = 1.0 / math.sqrt(conv.weight[0].numel()) / LECUN_TRUNCATED_STD
                    conv.weight.copy_(_truncated_normal(conv.weight.shape, std, gen))
                    conv.bias.zero_()
        if self._plbert_pretrained is not None:
            self.graft_pretrained("plbert_encoder", self._plbert_pretrained, "PL-BERT")
        if self._asr_pretrained is not None:
            self.graft_pretrained("text_aligner", {"params": self._asr_pretrained},
                                  "the ASR aligner")

    def graft_pretrained(self, name: str, tree: dict, what: str) -> None:
        """Load a converted pretrained flax tree into the generator's
        ``name`` submodule, checking that its structure and every shape are
        the submodule's (a mismatch means the staged checkpoint's geometry
        disagrees with the config's model)."""
        module = getattr(self.model, name, None)
        if module is None:
            raise ValueError(f"Model has no '{name}' subtree to graft {what} into — the module "
                             "was built without it.")
        try:
            state, _ = flax_to_torch(tree, module)
        except (KeyError, ValueError) as e:
            raise ValueError(f"The converted {what} parameter tree does not match the model's "
                             f"'{name}' structure — check the staged checkpoint and its "
                             f"config.yml ({e}).") from None
        for key, value in module.state_dict().items():
            if key in state and tuple(state[key].shape) != tuple(value.shape):
                raise ValueError(f"Shape mismatch grafting {what}: expected "
                                 f"{tuple(value.shape)}, checkpoint has {tuple(state[key].shape)}.")
        module.load_state_dict(state)

    def load_params(self, tree: dict) -> None:
        """Parameters from a checkpoint tree of either package: its
        ``generator`` and ``discriminators`` subtrees, each where present (a
        discriminators tree without the SLM head's ``slm``, as stage 1
        writes, leaves the head as it is)."""
        for key, module in (("generator", self.model), ("discriminators", self.discriminators)):
            if key in tree:
                module.load_state_dict(flax_to_torch(tree[key], module)[0])

    def _gen_to_flax(self, named: dict) -> dict:
        """Named tensors of the trained parameters (moments) → the
        generator's flax tree; the untrained LSTM input biases count as 0."""
        full = {n: named[n] if n in named else torch.zeros_like(v)
                for n, v in self.model.state_dict().items()}
        return torch_to_flax(full, self.model)

    def _from_flax_for(self, module: nn.Module, names):
        def convert(tree: dict) -> dict:
            state, _ = flax_to_torch(tree, module)
            return {n: state[n].to(self.device) for n in names}
        return convert

    def host_state(self) -> tuple:
        """(params tree, optimizer tree) on the host, in the JAX layouts:
        ``{"generator": ..., "discriminators": {"mpd": ..., "msd": ...}}``
        and ``{"gen": ..., "disc": ...}``, whole tensors gathered from every
        rank; (None, None) off rank 0."""
        with gathered(self.gen_placement, self.disc_placement):
            gen_state, disc_state = self.model.state_dict(), self.discriminators.state_dict()
        gen_opt = full_opt_state(self.gen_opt_state, self.gen_placement)
        disc_opt = full_opt_state(self.disc_opt_state, self.disc_placement)
        if not self.is_main:
            return None, None
        params = hifigan_tree(gen_state, disc_state, self.model, self.discriminators)
        return params, {
            "gen": self.gen_opt.to_optax(gen_opt, self._gen_to_flax),
            "disc": self.disc_opt.to_optax(disc_opt,
                                           partial(torch_to_flax, model=self.discriminators)),
        }

    def place(self) -> None:
        """Lay both trained networks' (loaded) parameters out on the mesh:
        replicated, or FSDP shards."""
        self.gen_placement = shard_params(self.gen_params, self.mesh, fsdp=self.fsdp)
        self.disc_placement = shard_params(self.disc_params, self.mesh, fsdp=self.fsdp)

    def _local_rows(self, host_batch: dict) -> dict:
        """This rank's rows, with the global batch's mel lengths, which the
        global draws need."""
        local = super()._local_rows(host_batch)
        if local is not host_batch:
            local["global_mel_lengths"] = host_batch["mel_lengths"]
        return local

    def checkpoint_extra(self) -> dict:
        """The header's stage tag and the pretrained components' geometries
        (None for a stand-in), which serving rebuilds the module from."""
        return {"stage": self.mode, "pretrained_components": {"plbert": self.plbert_geometry,
                                                              "asr": self.asr_geometry}}

    def resolve_first_stage_path(self, configured) -> Optional[Path]:
        """The stage-1 checkpoint stage 2 starts from: ``configured`` as
        given, then under this run's directory, then in every sibling run
        of the experiment (newest first); the siblings of the run directory
        itself where it lies outside the logger's layout."""
        configured = Path(configured)
        candidates = [configured]
        if not configured.is_absolute():
            candidates.append(self.run_dir / configured)
            lc = self.training_config["logger"]
            version_dir = Path(lc["save_dir"]) / lc["name"] / lc["version"]
            try:
                self.run_dir.resolve().relative_to(version_dir.resolve())
            except (ValueError, OSError):
                version_dir = self.run_dir.parent
            siblings = [p for p in version_dir.glob(f"*/{configured.as_posix()}") if p.is_file()]
            candidates += sorted(siblings, key=lambda p: p.stat().st_mtime, reverse=True)
        return next((c for c in candidates if c.is_file()), None)

    # -- the loop ---------------------------------------------------------
    def _epoch_batches(self):
        return self.dataset.batches(self.training_config["batch_size"], shuffle=True,
                                    seed=self.epoch, drop_last=True)

    def _dispatch(self, n_steps: int, batch: dict) -> dict:
        return self._run_steps(n_steps, batch, self.train_step)

    def fit(self, max_steps: Optional[int] = None, log_every: int = 10,
            profile_steps: int = 0, steps_per_execution: int = 1) -> StyleTTS2:
        """Train this stage: ``epochs_1st`` or ``epochs_2nd`` epochs (or
        ``max_steps``), validating and checkpointing (``stage-N-last.ckpt``
        and the best by ``validation/total``) after each, and once more at
        the end unless the last epoch's checkpoint is of this very step. A
        ``finetune_checkpoint`` resumes; otherwise stage 2 starts from
        stage 1's checkpoint (``resolve_first_stage_path``)."""
        t = self.training_config
        max_steps = max_steps if max_steps is not None else t["max_steps"]
        max_epochs = t["epochs_1st"] if self.mode == "first" else t["epochs_2nd"]
        if next(self.dataset.batches(t["batch_size"], shuffle=False), None) is None:
            raise RuntimeError("The training dataset is empty — no usable items survived "
                               "filtering (check filelists and preprocessed artifacts).")
        self.init_params()
        tree, opt_tree = self.load_finetune_checkpoint()
        if tree is not None:
            self.load_params(tree)
        elif self.mode == "second":
            first_stage = self.resolve_first_stage_path(t["first_stage_path"])
            if first_stage is not None:
                self.load_params(load_checkpoint(first_stage)["state_dict"])
                logger.info(f"Loaded stage-1 checkpoint from {first_stage}")
            else:
                logger.warning(f"Stage-1 checkpoint {t['first_stage_path']} not found; "
                               "training stage 2 from scratch.")
        opt_tree = opt_tree or {}
        restored = {key: None if opt_tree.get(key) is None
                    else opt.from_optax(opt_tree[key], self._from_flax_for(module, params))
                    for key, opt, module, params in (
                        ("gen", self.gen_opt, self.model, self.gen_params),
                        ("disc", self.disc_opt, self.discriminators, self.disc_params))}
        self.place()
        self.gen_opt_state, self.disc_opt_state = (
            fresh_sharded_opt_state(opt, placement) if restored[key] is None
            else shard_opt_state_like(restored[key], placement)
            for key, opt, placement in (("gen", self.gen_opt, self.gen_placement),
                                        ("disc", self.disc_opt, self.disc_placement)))
        spe = max(int(steps_per_execution), 1)
        stop = False
        dispatches = 0
        checkpointed_at = -1
        losses: dict = {}
        val: dict = {}
        while not stop and self.epoch < max_epochs:
            steps_at_epoch_start = self.global_step
            for n_steps, batch in prefetch(self._device_batches(spe)):
                if dispatches == 1 and profile_steps:
                    self.start_profile(profile_steps)
                losses = self._dispatch(n_steps, batch)
                dispatches += 1
                prev_step = self.global_step
                self.global_step += n_steps
                self.tick_profile()
                if self.global_step // log_every > prev_step // log_every:
                    self.log_metrics({f"training/{k}": v
                                      for k, v in self._global_mean(losses).items()},
                                     self.global_step)
                if self.global_step >= max_steps:
                    stop = True
                    break
            if self.global_step == steps_at_epoch_start and not stop:
                raise RuntimeError("Epoch produced no training batches — the dataset is "
                                   "empty (check filelists and preprocessed artifacts).")
            self.epoch += 1
            losses = self._global_mean(losses)
            val = self.validate()
            if val:
                self.log_metrics(val, self.global_step)
            self.maybe_checkpoint(self._monitored(val, losses), *self.host_state())
            checkpointed_at = self.global_step
        if checkpointed_at != self.global_step:
            self.maybe_checkpoint(self._monitored(val, losses), *self.host_state())
        self.wait_for_checkpoints()
        return self.model

    @staticmethod
    def _monitored(val: dict, losses: dict) -> float:
        if "validation/total" in val:
            return float(val["validation/total"])
        return float(losses["gen/total"]) if losses else float("inf")

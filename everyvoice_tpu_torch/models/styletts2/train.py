"""StyleTTS2's two-stage trainer on one device (counterpart of
everyvoice_tpu/models/styletts2/train.py), for a project that trains with
the in-framework stand-ins: the conv context encoder in place of PL-BERT,
the FastSpeech2 alignment encoder as the TMA (text-mel) aligner, and the
preprocessor's F0. The pretrained components and SLM-adversarial training
are not ported yet: the trainer refuses a config whose pretrained files
exist (``refuse_pretrained``).

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
decodes' source noise and the diffusion's σ and noise from one seeded like
the JAX trainer's (17), the dropout masks from one seeded with the crc32
of the logger name. ``draw_step`` makes a step's draws; a caller (a test)
may hand ``train_step`` its own. Each network has its own ``optax.adamw``
with optax's defaults (weight decay 1e-4), after a global-norm clip when
``gradient_clip_val`` is given; checkpoints hold both optimizer states in
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

import torch
from torch import nn

from everyvoice_tpu_torch.convert import flax_to_torch, hifigan_tree, torch_to_flax
from everyvoice_tpu_torch.dataloader.prefetch import prefetch, to_device
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.spectral import dynamic_range_compression, get_spectral_transform
from everyvoice_tpu_torch.models.fs2 import alignment
from everyvoice_tpu_torch.models.hifigan.loss import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANDiscriminators
from everyvoice_tpu_torch.models.layers import Dropout, lengths_to_mask, set_dropout_generator
from everyvoice_tpu_torch.models.styletts2.layers import SIGMA_FREQS, AdaINResBlock1
from everyvoice_tpu_torch.models.styletts2.loss import (
    diffusion_edm_loss,
    duration_ce_loss,
    duration_l1_loss,
    f0_loss,
    norm_loss,
    style_reconstruction_loss,
)
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.parallel import pad_batch_for_eval
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
from everyvoice_tpu_torch.train.loop import (
    LECUN_TRUNCATED_STD,
    TrainerBase,
    _host_floats,
    _truncated_normal,
    init_hifigan_parameters,
)
from everyvoice_tpu_torch.train.optim import build_optimizer
from everyvoice_tpu_torch.utils.precision import no_tf32, resolve_compute_dtype

logger = logging.getLogger(__name__)

PRETRAINED_ITEM = "ROADMAP.md, queue 1, 'StyleTTS2's pretrained components'"
STAGE_CHECKPOINTS = {"first": "stage-1-last.ckpt", "second": "stage-2-last.ckpt"}
STEP_SEED = 17  # the JAX trainer's training_rng(17)
VALIDATION_BATCHES = 8
STYLE_NOISE_SIGMA = 0.1  # the style reconstruction's denoise of the joint style


def adamw_config(lr: float) -> dict:
    """``optax.adamw(lr)`` with optax's defaults, as an optimizer section
    of ``train/optim.py``."""
    return {"name": "adamw", "learning_rate": lr, "betas": [0.9, 0.999], "eps": 1e-8,
            "weight_decay": 1e-4}


def pretrained_files(config: dict, mode: str) -> list:
    """(what, path) of each pretrained file the JAX trainer would load:
    ``pretrained.*``'s paths that exist, and in stage 2 ``model.slm.model``
    where it exists on disk. A configured path that does not exist is
    skipped with a warning, as the JAX trainer uses the stand-in then."""
    pre = config["pretrained"]
    found = []
    for what, path in (("pretrained.f0.local_path", pre["f0"]["local_path"]),
                       ("pretrained.plbert.local_checkpoint", pre["plbert"]["local_checkpoint"]),
                       ("pretrained.asr.local_checkpoint", pre["asr"]["local_checkpoint"])):
        if path is None:
            continue
        if Path(path).exists():
            found.append((what, path))
        else:
            logger.warning(f"{what} is set to {path} but no such file exists — using the "
                           "trainable in-framework stand-in.")
    slm = config["model"]["slm"]["model"]
    if mode == "second" and Path(slm).exists():
        found.append(("model.slm.model (SLM-adversarial training)", slm))
    return found


def refuse_pretrained(config: dict, mode: str) -> None:
    """Raise where the config asks for a pretrained component: the port
    never trains without one that the JAX trainer would load."""
    found = pretrained_files(config, mode)
    if found:
        names = ", ".join(f"{what} = {path}" for what, path in found)
        raise NotImplementedError(
            f"StyleTTS2 training with pretrained components ({names}) is not ported yet; "
            f"see {PRETRAINED_ITEM}. Unset them to train with the in-framework stand-ins.")


@dataclass
class StepDraws:
    """A step's random draws: the clip start of each row (None when the
    whole ``max_len`` is decoded), each decode's (B, samples) source noise,
    and the diffusion's (B,) log-σ draw and (B, 2·style) noises, all
    standard normal but the starts."""

    segment_starts: Optional[torch.Tensor]
    disc_noise: torch.Tensor
    gen_noise: torch.Tensor
    log_sigma: torch.Tensor
    diffusion_noise: torch.Tensor
    style_noise: torch.Tensor

    def to(self, device) -> "StepDraws":
        return StepDraws(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device) for f in fields(self)})


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
        elif isinstance(m, nn.LayerNorm):
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
    trained."""

    model_name = "StyleTTS2Module"

    def __init__(self, config: dict, dataset, val_dataset, lang2id: Optional[dict] = None,
                 run_dir: Optional[Path] = None, mode: str = "first",
                 gradient_clip_val: Optional[float] = None, compute_dtype: str = "auto",
                 device=None):
        if mode not in STAGE_CHECKPOINTS:
            raise ValueError(f"mode must be 'first' or 'second', not {mode!r}")
        device = resolve_device(device)  # before the refusal and the run directory
        refuse_pretrained(config, mode)
        self.last_checkpoint_name = STAGE_CHECKPOINTS[mode]
        super().__init__(config, run_dir=run_dir, device=device)
        self.mode = mode
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.lang2id = lang2id or {}
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        m = config["model"]
        with torch.device("meta"):  # no draw from the global RNG
            model = StyleTTS2.from_config(config, n_symbols=dataset.n_symbols,
                                          n_langs=max(len(self.lang2id), 1),
                                          compute_dtype=self.compute_dtype)
            discriminators = HiFiGANDiscriminators(tuple(m["decoder"]["mpd_layers"]),
                                                   m["decoder"]["msd_layers"], self.compute_dtype)
        self.model = model.to_empty(device=self.device)
        self.discriminators = discriminators.to_empty(device=self.device)
        with torch.no_grad():  # a buffer, so to_empty left it unset
            self.model.denoiser.freqs.copy_(torch.from_numpy(SIGMA_FREQS))
        for name, p in self.model.named_parameters():
            if name.endswith("bias_ih_l0"):
                p.requires_grad_(False)
        self.gen_params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        self.disc_params = dict(self.discriminators.named_parameters())
        lr = self.training_config["optimizer"]["lr"]
        self.gen_opt = build_optimizer(adamw_config(lr), gradient_clip_val=gradient_clip_val)
        self.disc_opt = build_optimizer(adamw_config(lr), gradient_clip_val=gradient_clip_val)
        self.losses_cfg = self.training_config["losses"]
        a = config["preprocessing"]["audio"]
        self.mel_fn = get_spectral_transform(
            a["spec_type"], a["n_fft"], a["fft_window_size"], a["fft_hop_size"],
            a["output_sampling_rate"], a["n_mels"], a["f_min"], a["f_max"])
        self.hop_samples = a["fft_hop_size"] * (a["output_sampling_rate"] // a["input_sampling_rate"])
        name = self.training_config["logger"]["name"]
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            zlib.crc32(name.encode("utf8")))
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
        diffusion in at ``diff_epoch`` (and the SLM's OOD training, not
        ported, at ``joint_epoch``)."""
        losses = self.losses_cfg
        if self.mode == "first":
            return float(epoch >= losses["tma_epoch"]), 0.0, 0.0
        return 1.0, float(epoch >= losses["diff_epoch"]), float(epoch >= losses["joint_epoch"])

    def tma_active(self, epoch: int) -> bool:
        return self.mode == "second" or epoch >= self.losses_cfg["tma_epoch"]

    # -- the step --------------------------------------------------------
    def draw_step(self, batch: dict, generator: Optional[torch.Generator] = None) -> StepDraws:
        """This step's draws from ``generator`` (the step generator by
        default), on the batch's device: a clip start an utterance, uniform
        over the starts that keep the clip inside its frames (0 for a
        shorter one), then both decodes' source noise and the diffusion's
        draws."""
        g = generator if generator is not None else self.step_generator
        device = batch["mel"].device
        b = batch["mel"].shape[0]
        seg = self.model.segment_frames
        starts = None
        if seg is not None:
            span = torch.clamp(batch["mel_lengths"].long() - seg, min=0) + 1
            u = torch.rand(b, generator=g, device=device)
            starts = torch.minimum((u * span).long(), span - 1)
        n = (seg or self.model.max_frames) * self.model.hop
        style = 2 * self.model.style_dim

        def normal(*shape):
            return torch.randn(shape, generator=g, device=device)

        return StepDraws(starts, normal(b, n), normal(b, n), normal(b), normal(b, style),
                         normal(b, style))

    def alignment_targets(self, batch: dict, tma_active: bool) -> dict:
        """Durations and token F0/energy targets, once a step and without
        gradient: the batch's before the TMA phase; after it, the Viterbi
        path of the aligner's attention (dropout off, the parameters
        before the step's updates), with F0 and energy re-averaged over that
        path."""
        targets = {"f0_frames": batch["f0_frames"]}
        if not tma_active:
            return {**targets, "durations": batch["durations"], "f0_tokens": batch["f0_tokens"],
                    "energy_tokens": batch["energy_tokens"]}
        with torch.no_grad(), deterministic(self.model):
            _, logprob = self.model.align_text_mel(batch["text"], batch["text_lengths"],
                                                   batch["mel"], batch["mel_lengths"],
                                                   batch.get("language_id"))
        hard = alignment.viterbi_alignment(logprob, batch["text_lengths"], batch["mel_lengths"])
        return {**targets, "durations": alignment.durations_from_hard_attention(hard),
                "f0_tokens": alignment.phone_average(batch["f0_frames"], hard),
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

    def discriminator_grads(self, batch: dict, targets: dict, noise: torch.Tensor) -> tuple:
        """(loss, gradients by parameter name) of the discriminators on the
        real clips and a decode of their own (its own noise and dropout)."""
        with torch.no_grad():
            fake = self.decode(batch, targets, noise)["wav"]
        real = self.real_clip(batch["audio"], targets["segment_starts"], fake.shape[1])
        real_scores, _ = self.discriminators(real)
        fake_scores, _ = self.discriminators(fake)
        loss = discriminator_loss(real_scores, fake_scores)
        grads = torch.autograd.grad(loss, list(self.disc_params.values()))
        return loss, dict(zip(self.disc_params, grads))

    def generator_grads(self, batch: dict, targets: dict, draws: StepDraws, diff_on: float,
                        tma_active: bool) -> tuple:
        """(losses, gradients of their total by parameter name): with the
        TMA on, the aligner again (with dropout) for the forward-sum
        (``s2s``) and binarization (``mono``) losses; the mel, duration, F0
        and energy losses and the adversarial and feature-matching losses
        against the current discriminators on a second decode; in stage 2
        the diffusion and style reconstruction losses on the detached joint
        style, weighted by ``diff_on``."""
        lc = self.losses_cfg
        text_lengths, mel_lengths = batch["text_lengths"], batch["mel_lengths"]
        src_mask = lengths_to_mask(text_lengths, batch["text"].shape[1])
        zero = torch.zeros((), device=self.device)
        losses = {"s2s": zero, "mono": zero}
        if tma_active:
            attn_soft, attn_logprob = self.model.align_text_mel(
                batch["text"], text_lengths, batch["mel"], mel_lengths, batch.get("language_id"))
            hard = alignment.viterbi_alignment(attn_logprob, text_lengths, mel_lengths)
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
        tma = self.tma_active(epoch)
        _, diff_on, _ = self.phase_weights(epoch)
        self.model.train()
        self.discriminators.train()
        with no_tf32():
            draws = draws if draws is not None else self.draw_step(batch)
            targets = self.alignment_targets(batch, tma)
            targets["segment_starts"] = draws.segment_starts
            d_loss, d_grads = self.discriminator_grads(batch, targets, draws.disc_noise)
            self.disc_grad_norm = self.disc_opt.step(self.disc_params, d_grads,
                                                     self.disc_opt_state)
            losses, g_grads = self.generator_grads(batch, targets, draws, diff_on, tma)
            self.grad_norm = self.gen_opt.step(self.gen_params, g_grads, self.gen_opt_state)
        return {"disc/total": d_loss.detach(),
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
            out = self.model(batch["text"], batch["text_lengths"], batch["mel"],
                             batch["mel_lengths"], batch["durations"], batch["f0_frames"],
                             self.validation_noise(batch["mel"].shape[0]))
            fake = out["wav"]
            diff = torch.abs(self._log_mel(fake) - self._log_mel(batch["audio"][:, : fake.shape[1]]))
            src_mask = lengths_to_mask(batch["text_lengths"], batch["text"].shape[1])
            weights = batch.get("row_weights")
            if weights is not None:
                src_mask = src_mask & (weights > 0.5)[:, None]
                mel = torch.sum(diff.mean(dim=(1, 2)) * weights) / torch.clamp(weights.sum(), min=1.0)
            else:
                mel = diff.mean()
            durations = batch["durations"]
            losses = {
                "mel": mel,
                "ce": duration_ce_loss(out["duration_logits"], durations, src_mask,
                                       self.model.max_dur),
                "dur": duration_l1_loss(out["duration_logits"], durations, src_mask),
                "f0": f0_loss(out["f0_prediction"], batch["f0_tokens"], src_mask),
                "norm": norm_loss(out["energy_prediction"], batch["energy_tokens"], src_mask),
            }
            lc = self.losses_cfg
            losses["total"] = (lc["lambda_mel"] * losses["mel"] + lc["lambda_ce"] * losses["ce"]
                               + lc["lambda_dur"] * losses["dur"] + lc["lambda_f0"] * losses["f0"]
                               + lc["lambda_norm"] * losses["norm"])
        return losses

    def validate(self) -> dict:
        """Mean validation losses over real rows, from at most 8 batches of
        ``batch_size`` (the last padded up with 0-weighted rows)."""
        totals: dict = {}
        rows = 0
        batch_size = max(self.training_config["batch_size"], 1)
        for count, batch in enumerate(self.val_dataset.batches(batch_size, shuffle=False)):
            if count >= VALIDATION_BATCHES:
                break
            batch.pop("basenames", None)
            batch, n_true = pad_batch_for_eval(batch, 1, batch_size)
            for k, v in _host_floats(self.val_losses(to_device(batch, self.device))).items():
                totals[k] = totals.get(k, 0.0) + v * n_true
            rows += n_true
        return {f"validation/{k}": v / rows for k, v in totals.items()} if rows else {}

    # -- parameters and checkpoints ---------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """flax-like initial parameters for both networks, drawn on the host
        from one generator seeded with ``seed`` and copied to the device."""
        gen = torch.Generator().manual_seed(seed)
        init_styletts2_parameters(self.model, gen)
        init_hifigan_parameters(self.discriminators, gen)

    def load_params(self, tree: dict) -> None:
        """Parameters from a checkpoint tree of either package: its
        ``generator`` and ``discriminators`` subtrees, each where present."""
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
        and ``{"gen": ..., "disc": ...}``."""
        params = hifigan_tree(self.model.state_dict(), self.discriminators.state_dict(),
                              self.model, self.discriminators)
        return params, {
            "gen": self.gen_opt.to_optax(self.gen_opt_state, self._gen_to_flax),
            "disc": self.disc_opt.to_optax(self.disc_opt_state,
                                           partial(torch_to_flax, model=self.discriminators)),
        }

    def checkpoint_extra(self) -> dict:
        """The header's stage tag and pretrained-component geometry (none:
        the stand-ins), which serving rebuilds the module from."""
        return {"stage": self.mode, "pretrained_components": {"plbert": None, "asr": None}}

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
        self.gen_opt_state = (
            self.gen_opt.init(self.gen_params) if opt_tree.get("gen") is None
            else self.gen_opt.from_optax(opt_tree["gen"],
                                         self._from_flax_for(self.model, self.gen_params)))
        self.disc_opt_state = (
            self.disc_opt.init(self.disc_params) if opt_tree.get("disc") is None
            else self.disc_opt.from_optax(opt_tree["disc"],
                                          self._from_flax_for(self.discriminators,
                                                              self.disc_params)))
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
                    self.log_metrics({f"training/{k}": v for k, v in losses.items()},
                                     self.global_step)
                if self.global_step >= max_steps:
                    stop = True
                    break
            if self.global_step == steps_at_epoch_start and not stop:
                raise RuntimeError("Epoch produced no training batches — the dataset is "
                                   "empty (check filelists and preprocessed artifacts).")
            self.epoch += 1
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

"""FastSpeech2 and HiFiGAN training on one device (counterpart of
everyvoice_tpu/train/loop.py: ``TrainerBase``, ``FastSpeech2Trainer`` and
``HiFiGANTrainer``).

The run directory is ``<save_dir>/<name>/<version>/<sub_dir>`` with
``hparams.yaml``, ``metrics.jsonl``, a TensorBoard event file and
``checkpoints/`` (``last.ckpt`` plus the ``save_top_k_ckpts`` best by
validation loss, written on a background thread). Checkpoints carry the
parameters and the optimizer state in the JAX package's layouts, so either
package resumes from the other's files, through the same three-way gate
(``resume_mode``).

Parameters, losses and optimizer state are float32; the model's convs and
matmuls run in the compute dtype ('auto': bfloat16 on a card, float32 on the
CPU), and float32 work runs with TF32 off. Each batch's ``mel`` (and
FastSpeech2's ``attn_prior``) is rounded to float16 on the host, as the JAX
package rounds it for the transfer. Dropout masks come from a
``torch.Generator`` seeded with the crc32 of the logger name; parameters are
initialised from one seeded with 0.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import zlib
from functools import partial
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from everyvoice_tpu_torch.config import model_checkpoint_dump
from everyvoice_tpu_torch.convert import flax_to_torch, hifigan_tree, torch_to_flax
from everyvoice_tpu_torch.dataloader import imbalanced_sample_weights
from everyvoice_tpu_torch.dataloader.prefetch import prefetch, to_device
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.spectral import dynamic_range_compression, get_spectral_transform
from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.loss import (
    FEATURE_MATCHING_WEIGHT,
    MEL_LOSS_WEIGHT,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    mel_l1_loss,
)
from everyvoice_tpu_torch.models.hifigan.model import (
    HiFiGANDiscriminators,
    HiFiGANGenerator,
    SpectralNormConv1d,
    WNConv1d,
    WNConv2d,
    WNConvTranspose1d,
)
from everyvoice_tpu_torch.models.layers import set_dropout_generator
from everyvoice_tpu_torch.parallel import (
    compress_for_transfer,
    pad_batch_for_eval,
    pad_batch_to_devices,
    stack_batches,
)
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, resume_mode, save_checkpoint
from everyvoice_tpu_torch.train.optim import build_optimizer, learning_rate_at
from everyvoice_tpu_torch.train.tensorboard import SummaryWriter
from everyvoice_tpu_torch.utils import resolve_sub_dir_callable
from everyvoice_tpu_torch.utils.precision import no_tf32, resolve_compute_dtype

logger = logging.getLogger(__name__)



def _resolve_val_interval(value, steps_per_epoch: int) -> int:
    """Validation cadence in optimizer steps: an int is every N steps, a
    float <= 1.0 a fraction of an epoch, None 500.

    >>> _resolve_val_interval(0.25, 1000)
    250
    """
    if value is None:
        return 500
    if isinstance(value, float) and value <= 1.0:
        return max(1, int(value * max(steps_per_epoch, 1)))
    return max(1, int(value))


def _decompress(batch: dict) -> dict:
    """Undo ``compress_for_transfer`` on the device (float16 → float32)."""
    return {k: v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.float16 else v
            for k, v in batch.items()}


def _yaml_value(value) -> str:
    """A JSON-typed value in YAML flow style, read back by ``yaml.safe_load``
    as the same value (floats keep a '.', which YAML 1.1 needs)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exponent = text.partition("e")
        return text if "." in mantissa else f"{mantissa}.0{e}{exponent}"
    if isinstance(value, str):
        return json.dumps(value, ensure_ascii=False)
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_yaml_value(str(k))}: {_yaml_value(v)}"
                               for k, v in value.items()) + "}"
    return "[" + ", ".join(_yaml_value(v) for v in value) + "]"


def to_yaml(data: dict) -> str:
    """``data`` as a YAML document (the card's machine has no PyYAML)."""
    return "".join(f"{_yaml_value(str(k))}: {_yaml_value(v)}\n" for k, v in data.items())


def _host_floats(values: dict) -> dict:
    """Tensor values as Python floats, in one device-to-host copy."""
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in values.items() if not isinstance(v, torch.Tensor)}
    if keys:
        host = torch.stack([values[k].detach().float().reshape(()) for k in keys]).tolist()
        out.update(zip(keys, host))
    return out


LECUN_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's truncated normal in [-2, 2] standard deviations, by the
    inverse CDF of a uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    return (std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


@torch.no_grad()
def init_fs2_parameters(model: FastSpeech2, gen: torch.Generator) -> None:
    """flax's default initialisers, drawn from the host generator ``gen``
    and copied onto the model's device: Dense and Conv kernels lecun-normal
    (truncated, std 1/sqrt(fan_in)/0.8796), zero biases, unit norm scales,
    embeddings N(0, 1/features), and the duration head's bias at 1.6 (about
    4 frames a token)."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            fan_in = module.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / LECUN_TRUNCATED_STD
            module.weight.copy_(_truncated_normal(module.weight.shape, std, gen))
            module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            std = 1.0 / math.sqrt(module.weight.shape[1])
            module.weight.copy_(std * torch.randn(module.weight.shape, generator=gen))
    model.duration_predictor.head.bias.fill_(1.6)


@torch.no_grad()
def init_hifigan_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """flax's default initialisers for HiFiGAN's generator or
    discriminators, drawn from the host generator ``gen``: conv and
    transposed-conv kernels lecun-normal over their flax fan-in, zero biases,
    unit weight-norm scales."""
    for m in module.modules():
        if isinstance(m, WNConvTranspose1d):  # flax kernel (k, C_in, C_out)
            fan_in = m.weight.shape[0] * m.weight.shape[2]
        elif isinstance(m, (WNConv1d, WNConv2d, SpectralNormConv1d)):
            fan_in = m.weight[0].numel()
        else:
            continue
        std = 1.0 / math.sqrt(fan_in) / LECUN_TRUNCATED_STD
        m.weight.copy_(_truncated_normal(m.weight.shape, std, gen))
        m.bias.zero_()
        if hasattr(m, "scale"):
            m.scale.fill_(1.0)


class TrainerBase:
    model_name = "Base"
    last_checkpoint_name = "last.ckpt"

    def __init__(self, config: dict, run_dir: Optional[Path] = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.training_config = config["training"]
        if run_dir is None:
            lc = self.training_config["logger"]
            sub_dir = resolve_sub_dir_callable(lc["sub_dir_callable"])()
            run_dir = Path(lc["save_dir"]) / lc["name"] / lc["version"] / sub_dir
        self.run_dir = Path(run_dir)
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.global_step = 0
        self.epoch = 0
        self.resumed: Optional[str] = None  # the resume gate's mode, when resuming
        self._topk: list = []  # (metric_value, path), best first
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self._profiler = None
        self._profile_remaining = 0
        self.save_hparams()
        self.tb_writer = SummaryWriter(self.run_dir)

    # -- bookkeeping -----------------------------------------------------
    def save_hparams(self) -> None:
        (self.run_dir / "hparams.yaml").write_text(
            to_yaml(model_checkpoint_dump(self.config)), encoding="utf8")

    def log_metrics(self, metrics: dict, step: int) -> None:
        values = _host_floats(metrics)
        record = {"step": step, "epoch": self.epoch, "time": time.time(), **values}
        with open(self.metrics_path, "a", encoding="utf8") as f:
            f.write(json.dumps(record) + "\n")
        self.tb_writer.add_scalars(values, step)
        self.tb_writer.flush()

    def maybe_checkpoint(self, metric_value: float, params: dict, opt_state: dict) -> None:
        """Write ``last.ckpt``, and a tagged checkpoint if ``metric_value``
        ranks among the ``save_top_k_ckpts`` best; host trees in."""
        keep = self.training_config["save_top_k_ckpts"]
        self._save(self.ckpt_dir / self.last_checkpoint_name, params, opt_state)
        if keep <= 0:
            return
        if len(self._topk) >= keep and metric_value >= self._topk[-1][0]:
            return  # would be evicted at once
        tagged = self.ckpt_dir / (
            f"epoch={self.epoch}-step={self.global_step}-loss={metric_value:.4f}.ckpt")
        self._save(tagged, params, opt_state)
        self._topk.append((metric_value, tagged))
        self._topk.sort(key=lambda pair: pair[0])
        while len(self._topk) > keep:
            # Written by an earlier writer, which _save joined: it exists.
            _, worst = self._topk.pop()
            worst.unlink(missing_ok=True)

    def _save(self, path: Path, params: dict, opt_state: dict) -> None:
        """Serialize and write on one background thread, after the previous
        write, so training goes on meanwhile. A failed write raises at the
        next save or wait."""
        step, epoch = self.global_step, self.epoch

        def write():
            try:
                save_checkpoint(
                    path, self.model_name, model_checkpoint_dump(self.config), params,
                    step=step, epoch=epoch, opt_state=opt_state,
                    lang2id=getattr(self, "lang2id", None),
                    speaker2id=getattr(self, "speaker2id", None),
                    stats=getattr(self, "stats", None),
                )
            except BaseException as e:  # raised again on the training thread
                self._ckpt_error = e

        self.wait_for_checkpoints()
        self._ckpt_thread = threading.Thread(target=write, daemon=False)
        self._ckpt_thread.start()

    def wait_for_checkpoints(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        if self._ckpt_error is not None:
            error, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError("writing a checkpoint failed") from error

    # -- profiling -------------------------------------------------------
    def start_profile(self, profile_steps: int) -> None:
        """Trace the next ``profile_steps`` train steps with torch.profiler
        into ``<run_dir>/profile/trace.json`` (Chrome trace format)."""
        if profile_steps <= 0:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.__enter__()
        self._profile_remaining = profile_steps

    def tick_profile(self) -> None:
        if self._profile_remaining > 0:
            self._profile_remaining -= 1
            if self._profile_remaining == 0:
                self._profiler.__exit__(None, None, None)
                (self.run_dir / "profile").mkdir(exist_ok=True)
                self._profiler.export_chrome_trace(str(self.run_dir / "profile" / "trace.json"))
                logger.info(f"Wrote profiler trace to {self.run_dir}/profile")
                self._profiler = None

    # -- the loop --------------------------------------------------------
    # A trainer defines ``_epoch_batches()`` (this epoch's host batches),
    # ``_dispatch(n_steps, batch)`` (that many optimizer steps on a device
    # batch, stacked when more than one; the last step's losses),
    # ``_learning_rate()``, ``validate()`` and ``host_state()`` ((params
    # tree, optimizer tree) on the host, in the JAX layouts).
    compressed: tuple = ()  # float32 batch entries rounded to float16 for the transfer

    @staticmethod
    def _run_steps(n_steps: int, batch: dict, step) -> dict:
        if n_steps == 1:
            return step(batch)
        for k in range(n_steps):  # the last step's losses are logged
            losses = step({key: v[k] for key, v in batch.items()})
        return losses

    def _device_batches(self, spe: int):
        """(n_steps, device batch) pairs: single batches, or ``spe`` stacked
        into one (spe, batch, ...) transfer; an epoch's leftovers go
        singly."""
        group: list = []
        for host_batch in self._epoch_batches():
            host_batch.pop("basenames", None)
            host_batch = compress_for_transfer(pad_batch_to_devices(host_batch, 1), self.compressed)
            if spe <= 1:
                yield 1, to_device(host_batch, self.device)
                continue
            group.append(host_batch)
            if len(group) == spe:
                yield spe, to_device(stack_batches(group), self.device)
                group = []
        for host_batch in group:
            yield 1, to_device(host_batch, self.device)

    def _train_loop(self, max_steps: int, log_every: int, profile_steps: int,
                    steps_per_execution: int) -> None:
        """Epochs of dispatches until ``max_steps`` or ``max_epochs``:
        training metrics every ``log_every`` steps, validation and a
        checkpoint every ``val_check_interval``, and a final one unless the
        last validation wrote this very step."""
        t = self.training_config
        spe = max(int(steps_per_execution), 1)
        val_interval = _resolve_val_interval(
            t["val_check_interval"], len(self.dataset.items) // max(t["batch_size"], 1))
        stop = False
        dispatches = 0
        last_val_step = -1
        while not stop and self.epoch < t["max_epochs"]:
            steps_at_epoch_start = self.global_step
            for n_steps, batch in prefetch(self._device_batches(spe)):
                # From the second dispatch (the first warms up), counted in
                # dispatches so stacked and resumed runs trigger it too.
                if dispatches == 1 and profile_steps:
                    self.start_profile(profile_steps)
                losses = self._dispatch(n_steps, batch)
                dispatches += 1
                prev_step = self.global_step
                self.global_step += n_steps
                self.tick_profile()
                if self.global_step // log_every > prev_step // log_every:
                    metrics = {f"training/{k}": v for k, v in losses.items()}
                    metrics["training/lr"] = self._learning_rate()
                    self.log_metrics(metrics, self.global_step)
                if self.global_step // val_interval > prev_step // val_interval:
                    val = self.validate()
                    last_val_step = self.global_step
                    self.log_metrics({f"validation/{k}": v for k, v in val.items()},
                                     self.global_step)
                    self.maybe_checkpoint(val["total"], *self.host_state())
                if self.global_step >= max_steps:
                    stop = True
                    break
            if self.global_step == steps_at_epoch_start and not stop:
                raise RuntimeError("Epoch produced no training batches — the dataset is "
                                   "empty (check filelists and preprocessed artifacts).")
            self.epoch += 1
        if last_val_step != self.global_step:
            val = self.validate()
            self.maybe_checkpoint(val["total"], *self.host_state())
        self.wait_for_checkpoints()

    def load_finetune_checkpoint(self) -> tuple:
        """(params tree, optimizer tree or None) from
        ``training.finetune_checkpoint``, or (None, None) without one. An
        architecture difference raises; an optimizer difference keeps the
        weights and restarts the optimizer and counters; otherwise the
        weights, optimizer state and step/epoch all resume."""
        path = self.training_config["finetune_checkpoint"]
        if path is None:
            return None, None
        ckpt = load_checkpoint(path)
        if ckpt["model_info"]["name"] != self.model_name:
            raise ValueError(f"Checkpoint is a {ckpt['model_info']['name']}; expected "
                             f"{self.model_name}")
        old_config = ckpt.get("hyper_parameters", {}).get("config", {})
        self.resumed = resume_mode(old_config, model_checkpoint_dump(self.config),
                                   self.model_name)
        if self.resumed == "fresh_optimizer":
            logger.warning(
                f"Optimizer hyperparameters changed since '{path}' — keeping the "
                "checkpoint weights but restarting the optimizer, so training logs "
                "will start again from step 0/epoch 0.")
            return ckpt["state_dict"], None
        self.global_step = ckpt.get("global_step", 0)
        self.epoch = ckpt.get("epoch", 0)
        return ckpt["state_dict"], ckpt.get("optimizer_states")


class FastSpeech2Trainer(TrainerBase):
    """Trains FastSpeech2 on ``dataset`` (a ``FastSpeech2Dataset``),
    validating on ``val_dataset``, on ``device`` (the CUDA card unless the
    caller names the CPU)."""

    model_name = "FastSpeech2"
    compressed = ("mel", "attn_prior")

    def __init__(self, config: dict, dataset, val_dataset, lang2id: dict, speaker2id: dict,
                 stats: Optional[dict] = None, run_dir: Optional[Path] = None,
                 gradient_clip_val: Optional[float] = None, compute_dtype: str = "auto",
                 device=None):
        super().__init__(config, run_dir=run_dir, device=device)
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.lang2id = lang2id
        self.speaker2id = speaker2id
        self.stats = stats or {}
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        with torch.device("meta"):  # no draw from the global RNG
            model = FastSpeech2.from_config(
                config, n_symbols=len(dataset.text_processor.symbols),
                n_speakers=max(len(speaker2id), 1), n_langs=max(len(lang2id), 1),
                compute_dtype=self.compute_dtype,
            )
        self.model = model.to_empty(device=self.device)
        self.params = dict(self.model.named_parameters())
        self.optimizer = build_optimizer(self.training_config["optimizer"], self.model.dim,
                                         gradient_clip_val)
        name = self.training_config["logger"]["name"]
        # crc32, not hash(): str.__hash__ is salted per process.
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            zlib.crc32(name.encode("utf8")))
        set_dropout_generator(self.model, self.dropout_generator)
        self.opt_state: Optional[dict] = None
        self.grad_norm: Optional[torch.Tensor] = None
        self._vocoder = None  # (generator, sample rate), loaded at first use

    # -- steps ------------------------------------------------------------
    def _loss_weights(self) -> dict:
        t = self.training_config
        return {k: t[f"{k}_loss_weight"]
                for k in ("mel", "postnet", "pitch", "energy", "duration", "attn_ctc", "attn_bin")}

    @staticmethod
    def _model_kwargs(batch: dict) -> dict:
        kwargs = {k: batch[k] for k in ("mel", "mel_lengths", "pitch", "energy",
                                        "speaker_id", "language_id")}
        for key in ("attn_prior", "durations"):
            if key in batch:
                kwargs[key] = batch[key]
        return kwargs

    def losses(self, batch: dict, bin_ramp: float) -> dict:
        """The loss dict of one device batch (float16 entries decompressed)
        in the model's current mode."""
        batch = _decompress(batch)
        out = self.model(batch["text"], batch["text_lengths"], **self._model_kwargs(batch))
        return compute_fs2_losses(
            out, batch, self._loss_weights(),
            mel_loss_kind=self.config["model"]["mel_loss"],
            learn_alignment=self.config["model"]["learn_alignment"],
            bin_loss_ramp=bin_ramp,
        )

    def train_step(self, batch: dict, bin_ramp: float) -> dict:
        """One optimizer step on a device batch; returns its (detached)
        losses, computed before the update."""
        self.model.train()
        with no_tf32():
            losses = self.losses(batch, bin_ramp)
            for p in self.params.values():
                p.grad = None
            losses["total"].backward()
            grads = {n: p.grad for n, p in self.params.items()}
            self.grad_norm = self.optimizer.step(self.params, grads, self.opt_state)
        return {k: v.detach() for k, v in losses.items()}

    def init_params(self, seed: int = 0) -> None:
        """flax-like initial parameters, drawn on the host from a generator
        seeded with ``seed`` and copied to the device."""
        init_fs2_parameters(self.model, torch.Generator().manual_seed(seed))

    def load_params(self, tree: dict) -> None:
        """Parameters from a flax tree (a checkpoint's ``state_dict``)."""
        state, absent = flax_to_torch(tree, self.model)
        if absent:
            logger.warning(f"The checkpoint has no alignment encoder ({len(absent)} "
                           "parameters); it trains from its initial weights")
        self.model.load_state_dict(state)

    def _to_flax(self, named: dict) -> dict:
        return torch_to_flax(named, self.model)

    def _from_flax(self, tree: dict) -> dict:
        state, _ = flax_to_torch(tree, self.model)
        return {n: v.to(self.device) for n, v in state.items()}

    def host_state(self) -> tuple:
        """(params tree, optimizer tree) on the host, in the JAX layouts."""
        return (self._to_flax(self.model.state_dict()),
                self.optimizer.to_optax(self.opt_state, self._to_flax))

    def _epoch_batches(self):
        t = self.training_config
        weights = None
        if t["use_weighted_sampler"]:
            weights = imbalanced_sample_weights(
                [f'{it.get("language")}/{it.get("speaker")}' for it in self.dataset.items])
        return self.dataset.batches(t["batch_size"], shuffle=True, seed=self.epoch,
                                    drop_last=True, weights=weights)

    def _dispatch(self, n_steps: int, batch: dict) -> dict:
        ramp = min(1.0, (self.epoch + 1) / max(self.training_config["attn_bin_loss_warmup_epochs"], 1))
        return self._run_steps(n_steps, batch, lambda b: self.train_step(b, ramp))

    def _learning_rate(self) -> float:
        return learning_rate_at(self.training_config["optimizer"], self.global_step, self.model.dim)

    def fit(self, max_steps: Optional[int] = None, log_every: int = 10,
            profile_steps: int = 0, steps_per_execution: int = 1) -> FastSpeech2:
        self.init_params()
        tree, opt_tree = self.load_finetune_checkpoint()
        if tree is not None:
            self.load_params(tree)
        self.opt_state = (self.optimizer.init(self.params) if opt_tree is None
                          else self.optimizer.from_optax(opt_tree, self._from_flax))
        self._train_loop(max_steps if max_steps is not None else self.training_config["max_steps"],
                         log_every, profile_steps, steps_per_execution)
        return self.model

    @torch.no_grad()
    def validate(self) -> dict:
        """Mean validation losses over real rows: batches of ``batch_size``,
        the last padded up to it with 0-weighted rows."""
        self.model.eval()
        totals: dict = {}
        rows = 0
        batch_size = max(self.training_config["batch_size"], 1)
        for batch in self.val_dataset.batches(batch_size, shuffle=False):
            batch.pop("basenames", None)
            batch, n_true = pad_batch_for_eval(batch, 1, batch_size)
            batch = to_device(compress_for_transfer(batch, self.compressed), self.device)
            with no_tf32():
                losses = _host_floats(self.losses(batch, 1.0))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + v * n_true
            rows += n_true
        self.log_validation_media()
        return {k: v / max(rows, 1) for k, v in totals.items()}

    @torch.no_grad()
    def log_validation_media(self) -> None:
        """The first validation item's predicted and target mels as images,
        and, with ``training.vocoder_path``, its predicted audio through the
        port's HiFiGAN generator (``mrf_stage`` on a card)."""
        try:
            batch = next(self.val_dataset.batches(1, shuffle=False))
        except StopIteration:
            return
        batch.pop("basenames", None)
        self.model.eval()
        device_batch = to_device(batch, self.device)
        out = self.model(device_batch["text"], device_batch["text_lengths"],
                         **self._model_kwargs(device_batch))
        pred = out.get("postnet_mel", out["mel"])
        n_frames = int(batch["mel_lengths"][0])
        step = self.global_step
        self.tb_writer.add_mel("validation/mel_predicted", pred[0].cpu().numpy()[:n_frames], step)
        self.tb_writer.add_mel("validation/mel_target", batch["mel"][0][:n_frames], step)
        vocoder = self._maybe_vocoder()
        if vocoder is not None:
            generator, sample_rate = vocoder
            wav = generator(pred[:1]).float().cpu().numpy()[0]
            a = self.config["preprocessing"]["audio"]
            hop = a["fft_hop_size"] * max(a["output_sampling_rate"] // a["input_sampling_rate"], 1)
            self.tb_writer.add_audio("validation/audio_predicted", wav[: n_frames * hop],
                                     sample_rate, step)
        self.tb_writer.flush()

    def _maybe_vocoder(self):
        path = self.training_config["vocoder_path"]
        if self._vocoder is None and path:
            from everyvoice_tpu_torch.models.fs2.synthesize import load_vocoder_from_checkpoint

            generator, vconfig = load_vocoder_from_checkpoint(path, "auto", self.device)
            self._vocoder = (generator, vconfig["preprocessing"]["audio"]["output_sampling_rate"])
        return self._vocoder


class HiFiGANTrainer(TrainerBase):
    """Trains the HiFiGAN generator against the MPD and MSD on ``dataset``
    (a ``HiFiGANDataset``), validating on ``val_dataset``, on ``device``
    (the CUDA card unless the caller names the CPU).

    A step is the JAX package's: the discriminator step on the generator's
    output (detached), then the generator step (mel L1 · 45, and after
    ``generator_warmup_steps`` the adversarial and feature-matching losses)
    against the updated discriminators, each network with its own optimizer.
    The generator runs once a step; gradients are taken with
    ``torch.autograd.grad`` over one network's parameters, so neither step
    touches the other's. During the warmup the discriminator update is
    skipped whole (no decay, clip or count), and its loss is still logged.
    Validation runs the inference forward, so ``mrf_stage`` runs there."""

    model_name = "HiFiGAN"
    compressed = ("mel",)

    def __init__(self, config: dict, dataset, val_dataset, run_dir: Optional[Path] = None,
                 gradient_clip_val: Optional[float] = None, compute_dtype: str = "auto",
                 device=None):
        super().__init__(config, run_dir=run_dir, device=device)
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        with torch.device("meta"):  # no draw from the global RNG
            generator = HiFiGANGenerator.from_config(config, self.compute_dtype)
            discriminators = HiFiGANDiscriminators.from_config(config, self.compute_dtype)
        self.generator = generator.to_empty(device=self.device)
        self.discriminators = discriminators.to_empty(device=self.device)
        self.gen_params = dict(self.generator.named_parameters())
        self.disc_params = dict(self.discriminators.named_parameters())
        t = self.training_config
        self.gen_opt = build_optimizer(t["optimizer"], gradient_clip_val=gradient_clip_val)
        self.disc_opt = build_optimizer(t["optimizer"], gradient_clip_val=gradient_clip_val)
        self.gan_type = t["gan_type"]
        self.wgan_clip = t["wgan_clip_value"]
        a = config["preprocessing"]["audio"]
        self.segment_size = a["vocoder_segment_size"]
        # The loss's mel at the output rate's hop.
        hop = a["fft_hop_size"] * (a["output_sampling_rate"] // a["input_sampling_rate"])
        self.mel_fn = get_spectral_transform(
            a["spec_type"], a["n_fft"], a["fft_window_size"], hop, a["output_sampling_rate"],
            a["n_mels"], a["f_min"], a["f_max"])
        self.gen_opt_state: Optional[dict] = None
        self.disc_opt_state: Optional[dict] = None
        self.grad_norm: Optional[torch.Tensor] = None
        self.disc_grad_norm: Optional[torch.Tensor] = None

    # -- steps ------------------------------------------------------------
    def _log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        return dynamic_range_compression(self.mel_fn(wav))

    def discriminator_grads(self, audio: torch.Tensor, fake: torch.Tensor, gan_on: bool) -> tuple:
        """(discriminator loss, its gradients by parameter name, or None
        during the warmup, when the loss is only logged)."""
        with torch.set_grad_enabled(gan_on):
            real_scores, _ = self.discriminators(audio)
            fake_scores, _ = self.discriminators(fake.detach())
            loss = discriminator_loss(real_scores, fake_scores, self.gan_type)
        if not gan_on:
            return loss, None
        grads = torch.autograd.grad(loss, list(self.disc_params.values()))
        return loss, dict(zip(self.disc_params, grads))

    def update_discriminators(self, grads: dict) -> None:
        self.disc_grad_norm = self.disc_opt.step(self.disc_params, grads, self.disc_opt_state)
        if self.gan_type == "wgan":  # every leaf, weight-norm scales and biases too
            with torch.no_grad():
                params = list(self.disc_params.values())
                torch._foreach_clamp_min_(params, -self.wgan_clip)
                torch._foreach_clamp_max_(params, self.wgan_clip)

    def generator_grads(self, audio: torch.Tensor, fake: torch.Tensor, gan_on: bool) -> tuple:
        """(generator losses, gradients of their total by parameter name):
        the mel L1 of the log-mels, and the adversarial and feature-matching
        losses against the current discriminators (during the warmup only
        logged; the real audio's features and mel carry no gradient)."""
        with torch.no_grad():
            mel_real = self._log_mel(audio)
            _, real_feats = self.discriminators(audio)
        loss_mel = mel_l1_loss(mel_real, self._log_mel(fake))
        with torch.set_grad_enabled(gan_on):
            fake_scores, fake_feats = self.discriminators(fake if gan_on else fake.detach())
            loss_adv = generator_adversarial_loss(fake_scores, self.gan_type)
            loss_fm = feature_matching_loss(real_feats, fake_feats)
        total = MEL_LOSS_WEIGHT * loss_mel + float(gan_on) * (
            loss_adv + FEATURE_MATCHING_WEIGHT * loss_fm)
        grads = torch.autograd.grad(total, list(self.gen_params.values()))
        losses = {"gen/mel": loss_mel, "gen/adv": loss_adv, "gen/fm": loss_fm, "gen/total": total}
        return losses, dict(zip(self.gen_params, grads))

    def update_generator(self, grads: dict) -> None:
        self.grad_norm = self.gen_opt.step(self.gen_params, grads, self.gen_opt_state)

    def train_step(self, batch: dict, gan_on: bool) -> dict:
        """One GAN step on a device batch; returns its (detached) losses,
        each computed before the update it drives."""
        batch = _decompress(batch)
        audio = batch["audio"]
        with no_tf32():
            fake = self.generator.train_forward(batch["mel"])
            d_loss, d_grads = self.discriminator_grads(audio, fake, gan_on)
            if gan_on:
                self.update_discriminators(d_grads)
            losses, g_grads = self.generator_grads(audio, fake, gan_on)
            self.update_generator(g_grads)
        return {k: v.detach() for k, v in {"disc/total": d_loss, **losses}.items()}

    def init_params(self, seed: int = 0) -> None:
        """flax-like initial parameters for both networks, drawn on the host
        from one generator seeded with ``seed`` and copied to the device."""
        gen = torch.Generator().manual_seed(seed)
        init_hifigan_parameters(self.generator, gen)
        init_hifigan_parameters(self.discriminators, gen)

    def load_params(self, tree: dict) -> None:
        """Parameters from the JAX trainer's checkpoint tree: its
        ``generator`` and ``discriminators`` subtrees, each where present."""
        for key, module in (("generator", self.generator), ("discriminators", self.discriminators)):
            if key in tree:
                module.load_state_dict(flax_to_torch(tree[key], module)[0])

    def _from_flax_for(self, module: nn.Module):
        """A map of ``module``'s flax tree to named tensors on the device."""
        def convert(tree: dict) -> dict:
            state, _ = flax_to_torch(tree, module)
            return {n: v.to(self.device) for n, v in state.items()}
        return convert

    def host_state(self) -> tuple:
        params = hifigan_tree(self.generator.state_dict(), self.discriminators.state_dict(),
                              self.generator, self.discriminators)
        return params, {
            "gen": self.gen_opt.to_optax(self.gen_opt_state,
                                         partial(torch_to_flax, model=self.generator)),
            "disc": self.disc_opt.to_optax(self.disc_opt_state,
                                           partial(torch_to_flax, model=self.discriminators)),
        }

    def _epoch_batches(self):
        return self.dataset.segment_batches(self.training_config["batch_size"], self.segment_size,
                                            shuffle=True, seed=self.epoch, drop_last=True)

    def _dispatch(self, n_steps: int, batch: dict) -> dict:
        gan_on = self.global_step >= self.training_config["generator_warmup_steps"]
        return self._run_steps(n_steps, batch, lambda b: self.train_step(b, gan_on))

    def _learning_rate(self) -> float:
        return learning_rate_at(self.training_config["optimizer"], self.global_step)

    def fit(self, max_steps: Optional[int] = None, log_every: int = 10,
            profile_steps: int = 0, steps_per_execution: int = 1) -> HiFiGANGenerator:
        self.init_params()
        tree, opt_tree = self.load_finetune_checkpoint()
        if tree is not None:
            self.load_params(tree)
        opt_tree = opt_tree or {}
        self.gen_opt_state = (
            self.gen_opt.init(self.gen_params) if opt_tree.get("gen") is None
            else self.gen_opt.from_optax(opt_tree["gen"], self._from_flax_for(self.generator)))
        self.disc_opt_state = (
            self.disc_opt.init(self.disc_params) if opt_tree.get("disc") is None
            else self.disc_opt.from_optax(opt_tree["disc"], self._from_flax_for(self.discriminators)))
        self._train_loop(max_steps if max_steps is not None else self.training_config["max_steps"],
                         log_every, profile_steps, steps_per_execution)
        return self.generator

    @torch.no_grad()
    def validate(self) -> dict:
        """The mean mel L1 over real rows of the validation segments (each
        from frame 0), through the generator's inference forward, in
        batches of ``batch_size``, the last padded up to it with 0-weighted
        rows."""
        total, rows = 0.0, 0
        batch_size = max(self.training_config["batch_size"], 1)
        for batch in self.val_dataset.segment_batches(batch_size, self.segment_size,
                                                      shuffle=False):
            batch.pop("basenames", None)
            batch, n_true = pad_batch_for_eval(batch, 1, batch_size)
            batch = _decompress(to_device(compress_for_transfer(batch, self.compressed),
                                          self.device))
            fake = self.generator(batch["mel"])
            with no_tf32():
                diff = (self._log_mel(batch["audio"]) - self._log_mel(fake)).abs()
            weights = batch["row_weights"]
            loss = (diff.mean(dim=(1, 2)) * weights).sum() / weights.sum().clamp(min=1.0)
            total += float(loss) * n_true
            rows += n_true
        return {"total": total / max(rows, 1)}

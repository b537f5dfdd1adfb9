"""The ranks of the port's multi-rank CPU tests: gloo ranks started with
``spawn``, each importing only torch, numpy and the port (nothing of JAX),
writing what rank 0 sees under an output directory for the test to compare.

``spawn(job, args)`` runs ``job(local_rank, coordinator, *args)`` on two
ranks with a time limit of its own; a rank's failure or the limit raises.
The test's own reference (``meanwhile``) runs while the ranks do.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

WEIGHTS = {"mel": 1.0, "postnet": 1.0, "pitch": 0.1, "energy": 0.1, "duration": 0.1,
           "attn_ctc": 0.1, "attn_bin": 0.1}
STRATEGIES = {"ddp": (1, False), "fsdp": (1, True), "tp2": (2, False)}


def spawn(job, args: tuple = (), nprocs: int = 2, timeout: float = 240.0, meanwhile=None):
    """Run the ranks; returns ``meanwhile()``'s result, computed in this
    process (on one thread) while they run."""
    import torch.multiprocessing as mp

    from everyvoice_tpu_torch.parallel.launch import _run, free_port

    context = mp.start_processes(_run, args=(job, f"127.0.0.1:{free_port()}", 1, args),
                                 nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the two ranks and the other test workers
    try:
        result = meanwhile() if meanwhile is not None else None
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.__name__} ran past {timeout} s")
    finally:
        torch.set_num_threads(threads)
        for process in context.processes:
            if process.is_alive():
                process.kill()
    return result


def _meshes(local_rank: int, coordinator: str):
    """This rank's ddp mesh (data 2) and tp2 mesh (model 2) over one
    two-rank gloo group."""
    from everyvoice_tpu_torch.parallel import make_mesh, setup_mesh

    mesh = setup_mesh("cpu", 2, 1, 1, local_rank, address=coordinator)
    return mesh, make_mesh(torch.device("cpu"), 2)


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order."""
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out)


def _no_dropout(*modules) -> None:
    from everyvoice_tpu_torch.models.layers import Dropout

    for module in modules:
        for m in module.modules():
            if isinstance(m, Dropout):
                m.p = 0.0


# ---------------------------------------------------------------------------
# FastSpeech2


def fs2_grads(local_rank: int, coordinator: str, work: str) -> None:
    """One FastSpeech2 gradient of the global batch in ``work/batch.npz``
    from the parameters in ``work/state.pt``, under ddp, fsdp and tp2:
    rank 0 writes the reduced gradients, whole, and the global losses;
    then the dryrun's step on the same two ranks (rank 0 writes what it
    printed)."""
    import contextlib
    import io

    from everyvoice_tpu_torch.parallel import dryrun
    from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
    from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
    from everyvoice_tpu_torch.parallel import data_parallel, local_rows, shard_params, teardown
    from everyvoice_tpu_torch.parallel.sharding import gathered

    work = Path(work)
    spec = json.loads((work / "spec.json").read_text())
    state = torch.load(work / "state.pt")
    batch = dict(np.load(work / "batch.npz"))
    meshes = dict(zip(("ddp", "tp2"), _meshes(local_rank, coordinator)))
    try:
        for name, (model_parallel, fsdp) in STRATEGIES.items():
            mesh = meshes["tp2" if model_parallel > 1 else "ddp"]
            model = FastSpeech2.from_config(spec["config"], spec["n_symbols"], spec["n_speakers"])
            model.load_state_dict(state)
            model.eval()
            placement = shard_params(dict(model.named_parameters()), mesh, model=model, fsdp=fsdp)
            rows = {k: torch.from_numpy(v) for k, v in local_rows(batch, mesh).items()}
            kwargs = {k: rows[k] for k in ("mel", "mel_lengths", "pitch", "energy", "speaker_id",
                                           "language_id", "attn_prior")}
            with data_parallel(mesh), gathered(placement):
                losses = compute_fs2_losses(model(rows["text"], rows["text_lengths"], **kwargs),
                                            rows, WEIGHTS, bin_loss_ramp=0.3)
                losses["total"].backward()
                grads = {n: p.grad for n, p in placement.params.items()}
            whole = placement.full(placement.reduce_grads(grads))
            keys = sorted(losses)
            total = torch.stack([losses[k].detach() for k in keys])
            import torch.distributed as dist

            dist.all_reduce(total, group=mesh.batch_group)
            total /= mesh.data_size
            if mesh.is_main:
                torch.save({"grads": {n: g.detach() for n, g in whole.items()},
                            "losses": dict(zip(keys, total.tolist())),
                            "sharded": len(placement.shards)}, work / f"grads_{name}.pt")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            dryrun._step(local_rank, coordinator, 2, "cpu")
        if meshes["ddp"].is_main:
            (work / "dryrun.txt").write_text(printed.getvalue())
    finally:
        teardown(meshes["ddp"])


def _fs2_trainer(raw: dict, run_dir: Path, mesh=None, fsdp: bool = False, device=None):
    from everyvoice_tpu_torch.config import fs2_training_config
    from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
    from everyvoice_tpu_torch.text.lookups import lookuptables_from_data
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    config = fs2_training_config(raw)
    train = generic_psv_filelist_reader(raw["training"]["training_filelist"])
    val = generic_psv_filelist_reader(raw["training"]["validation_filelist"])
    lang2id, speaker2id = lookuptables_from_data((train, val))
    ds = FastSpeech2Dataset(train, config, lang2id, speaker2id)
    vds = FastSpeech2Dataset(val, config, lang2id, speaker2id, text_processor=ds.text_processor)
    trainer = FastSpeech2Trainer(config, ds, vds, lang2id, speaker2id, run_dir=run_dir,
                                 mesh=mesh, fsdp=fsdp, device=device)
    trainer.model.postnet.drop.p = 0.0  # as the JAX side's NoDropPostnet
    return trainer


def resident_bytes(placement, opt_state: dict, min_size: int = 16_384) -> int:
    """Bytes this rank holds between steps for the parameters of at least
    ``min_size`` elements: the parameters' storage, their shards and their
    Adam moments."""
    total = 0
    for name, p in placement.params.items():
        if placement.full_shapes.get(name, p.shape).numel() < min_size:
            continue
        total += p.data.numel() * p.element_size()
        if name in placement.zero:
            total += placement.zero[name].numel() * placement.zero[name].element_size()
        total += sum(opt_state[k][name].numel() * opt_state[k][name].element_size()
                     for k in ("mu", "nu"))
    return total


def fs2_fits(local_rank: int, coordinator: str, raw: dict, dropout_raw: dict, out: str) -> None:
    """FastSpeech2 fits of two steps under ddp, fsdp and tp2 (rank 0
    writes each run's metrics and checkpoints under ``out/<strategy>``), a
    resume of ddp's checkpoint under fsdp and of fsdp's under ddp, the
    resident bytes after the ddp and fsdp fits, and the dropout masks each
    rank draws under ddp and tp2."""
    from everyvoice_tpu_torch.parallel import teardown

    out = Path(out)
    meshes = dict(zip(("ddp", "tp2"), _meshes(local_rank, coordinator)))
    try:
        report = {}
        for name, (model_parallel, fsdp) in STRATEGIES.items():
            mesh = meshes["tp2" if model_parallel > 1 else "ddp"]
            trainer = _fs2_trainer(raw, out / name, mesh, fsdp)
            trainer.fit(max_steps=2, log_every=1)
            report[name] = {"bytes": resident_bytes(trainer.placement, trainer.opt_state),
                            "sharded": len(trainer.placement.shards)}
        # two steps a dispatch (--steps-per-execution 2): each batch's rows
        # taken before the batches are stacked
        _fs2_trainer(raw, out / "spe2", meshes["ddp"]).fit(max_steps=2, log_every=1,
                                                            steps_per_execution=2)
        for name, source, fsdp in (("resume_fsdp", "ddp", True), ("resume_ddp", "fsdp", False)):
            resumed = {**raw, "training": {**raw["training"], "finetune_checkpoint": str(
                out / source / "checkpoints" / "last.ckpt")}}
            trainer = _fs2_trainer(resumed, out / name, meshes["ddp"], fsdp)
            trainer.fit(max_steps=3, log_every=1)
        for name in ("ddp", "tp2"):
            trainer = _fs2_trainer(dropout_raw, out / f"dropout_{name}", meshes[name])
            trainer.model.train()
            mask = trainer.model.encoder.drop(torch.ones(256)) > 0
            report[f"masks_{name}"] = _gather_rows(mask.float(), meshes[name]).tolist()
        if meshes["ddp"].is_main:
            (out / "report.json").write_text(json.dumps(report))
    finally:
        teardown(meshes["ddp"])


# ---------------------------------------------------------------------------
# HiFiGAN and StyleTTS2


def _spy_updates(trainer, seen: dict) -> None:
    """Record the whole reduced gradients each update of ``trainer`` steps
    with, by network (``gen``/``disc``)."""
    update = trainer._update

    def recorded(optimizer, placement, grads, state):
        key = "gen" if optimizer is trainer.gen_opt else "disc"
        reduced = placement.full(placement.reduce_grads(grads))
        seen.setdefault(key, []).append(
            {n: torch.zeros_like(placement.params[n]) if g is None else g.detach().clone()
             for n, g in reduced.items()})
        return update(optimizer, placement, grads, state)

    trainer._update = recorded


def hifigan_trainer(config: dict, run_dir: Path, mesh=None, fsdp: bool = False):
    from everyvoice_tpu_torch.parallel import fresh_sharded_opt_state
    from everyvoice_tpu_torch.train.loop import HiFiGANTrainer

    class Data:
        items: list = []

    trainer = HiFiGANTrainer(config, Data(), Data(), run_dir=run_dir, mesh=mesh, fsdp=fsdp,
                             device=None if mesh is not None else "cpu")
    _adam_eps(trainer.gen_opt, trainer.disc_opt)
    trainer.init_params()
    trainer.place()
    trainer.gen_opt_state = fresh_sharded_opt_state(trainer.gen_opt, trainer.gen_placement)
    trainer.disc_opt_state = fresh_sharded_opt_state(trainer.disc_opt, trainer.disc_placement)
    return trainer


def hifigan_batch(b: int = 2, frames: int = 16, hop: int = 16, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(frames * hop) / 22050
    freqs = 120.0 + 40.0 * torch.arange(b, dtype=torch.float32)[:, None]
    audio = 0.5 * torch.sin(2 * np.pi * freqs * t) + 0.05 * torch.randn(b, frames * hop,
                                                                         generator=gen)
    return {"mel": torch.randn(b, frames, 20, generator=gen) - 4.0, "audio": audio}


def styletts2_batch(b: int = 2, n_text: int = 12, frames: int = 32, hop: int = 256,
                    seed: int = 0) -> dict:
    """A StyleTTS2 training batch of seeded values with rows of unequal
    lengths, as ``StyleTTS2Dataset`` lays one out (uniform durations and
    their token means)."""
    gen = torch.Generator().manual_seed(seed)
    text_lengths = torch.tensor([n_text, n_text - 4, n_text - 2, n_text - 7][:b])
    mel_lengths = torch.tensor([frames, frames * 3 // 4, frames // 2, frames - 3][:b])
    text = torch.randint(2, 28, (b, n_text), generator=gen)
    text[torch.arange(n_text)[None] >= text_lengths[:, None]] = 0
    valid = torch.arange(frames)[None] < mel_lengths[:, None]
    f0 = torch.where(valid, 80 + 170 * torch.rand(b, frames, generator=gen), 0.0)
    energy = torch.where(valid, torch.randn(b, frames, generator=gen), 0.0)
    durations = torch.zeros(b, n_text, dtype=torch.int32)
    for i in range(b):
        n, t = int(text_lengths[i]), int(mel_lengths[i])
        durations[i, :n] = t // n
        durations[i, n - 1] += t - int(durations[i, :n].sum())
    cum = torch.cumsum(durations.long(), 1)
    starts = cum - durations.long()
    f0_tok = torch.stack([torch.stack([f0[i, s:e].mean() if e > s else torch.tensor(0.0)
                                       for s, e in zip(starts[i], cum[i])]) for i in range(b)])
    energy_tok = torch.stack([torch.stack([energy[i, s:e].mean() if e > s else torch.tensor(0.0)
                                           for s, e in zip(starts[i], cum[i])]) for i in range(b)])
    t = torch.arange(frames * hop) / 22050
    freqs = 140.0 + 35.0 * torch.arange(b, dtype=torch.float32)[:, None]
    audio = 0.5 * torch.sin(2 * np.pi * freqs * t) + 0.05 * torch.randn(b, frames * hop,
                                                                         generator=gen)
    audio = torch.where(torch.arange(frames * hop)[None] < mel_lengths[:, None] * hop, audio, 0.0)
    return {"text": text, "text_lengths": text_lengths.int(), "mel_lengths": mel_lengths.int(),
            "mel": torch.where(valid[..., None], torch.randn(b, frames, 80, generator=gen) - 4, 0.0),
            "f0_frames": f0, "energy_frames": energy, "f0_tokens": f0_tok,
            "energy_tokens": energy_tok, "durations": durations, "audio": audio}


def styletts2_trainer(config: dict, mode: str, run_dir: Path, mesh=None, fsdp: bool = False):
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.parallel import fresh_sharded_opt_state
    from everyvoice_tpu_torch.text import TextProcessor

    class Data:
        text_processor = TextProcessor(config["text"])
        n_symbols = len(text_processor.symbols)
        items: list = []

    trainer = StyleTTS2Trainer(config, Data(), Data(), {"default": 0}, run_dir=run_dir,
                               mode=mode, mesh=mesh, fsdp=fsdp,
                               device=None if mesh is not None else "cpu")
    _no_dropout(trainer.model)
    _adam_eps(trainer.gen_opt, trainer.disc_opt)
    trainer.init_params(seed=0)
    with torch.no_grad():
        # wavs of about an audio's size, as test_torch_styletts2_train.py's
        # ``audio_sized`` makes them: at seeded scale they peak near 900,
        # and float32 then cannot resolve the discriminators' gradients
        post = trainer.model.decoder.conv_post
        post.bias[: trainer.model.decoder.n_fft // 2 + 1] = -2.0
        post.scale *= 0.02
    trainer.place()
    trainer.gen_opt_state = fresh_sharded_opt_state(trainer.gen_opt, trainer.gen_placement)
    trainer.disc_opt_state = fresh_sharded_opt_state(trainer.disc_opt, trainer.disc_placement)
    return trainer


# Adam's epsilon in the GAN step tests: a gradient at float32's noise
# floor (zero in exact arithmetic) has a sign that its first update turns
# into ±lr under the default 1e-8, and the next step's losses against the
# updated discriminators inherit that; at 1e-3 such an entry moves in
# proportion to its gradient, so two summation orders give the same step.
ADAM_EPS = 1e-3


def _adam_eps(*optimizers) -> None:
    for opt in optimizers:
        for sub in getattr(opt, "groups", {"": opt}).values():
            sub.config = {**sub.config, "eps": ADAM_EPS}


def _local(trainer, batch: dict) -> dict:
    """This rank's rows of a global device batch, as ``_device_batches``
    hands them over."""
    host = {k: v.numpy() for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            trainer._local_rows(host).items()}


def gan_steps(trainer, batches: list, step) -> dict:
    """Losses and recorded gradients of one step a batch."""
    seen: dict = {}
    _spy_updates(trainer, seen)
    losses = [{k: float(v) for k, v in trainer._global_mean(step(b)).items()} for b in batches]
    return {"losses": losses, "grads": seen}


# stage 1 before its TMA phase (the bootstrap targets), stage 2 with the
# TMA and the diffusion on
STYLETTS2_STEPS = (("first", 0), ("second", 1))


def gan_suite(local_rank: int, coordinator: str, hifigan_config: dict, st2_config: dict,
              out: str) -> None:
    """A HiFiGAN step and a StyleTTS2 stage-1 and stage-2 step under ddp,
    fsdp and tp2; rank 0 writes each run's losses and whole gradients."""
    from everyvoice_tpu_torch.parallel import teardown

    out = Path(out)
    meshes = dict(zip(("ddp", "tp2"), _meshes(local_rank, coordinator)))
    try:
        for name, (model_parallel, fsdp) in STRATEGIES.items():
            mesh = meshes["tp2" if model_parallel > 1 else "ddp"]
            result = {}
            trainer = hifigan_trainer(hifigan_config, out / f"hifigan_{name}", mesh, fsdp)
            batches = [_local(trainer, hifigan_batch())]
            result["hifigan"] = gan_steps(trainer, batches,
                                          lambda b: trainer.train_step(b, gan_on=True))
            result["hifigan_sharded"] = len(trainer.gen_placement.shards) + len(
                trainer.disc_placement.shards)
            for mode, epoch in STYLETTS2_STEPS:
                st2 = styletts2_trainer(st2_config, mode, out / f"st2_{mode}_{name}", mesh, fsdp)
                batch = _local(st2, styletts2_batch())
                result[f"st2_{mode}"] = gan_steps(st2, [batch],
                                                  lambda b: st2.train_step(b, epoch=epoch))
            if mesh.is_main:
                torch.save(result, out / f"gan_{name}.pt")
    finally:
        teardown(meshes["ddp"])

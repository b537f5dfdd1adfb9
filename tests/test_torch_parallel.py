"""Multi-device FastSpeech2 training in the port (``everyvoice_tpu_torch
.parallel``) against the JAX package, on the CPU: two gloo ranks started
with ``spawn`` (``torch_parallel_workers``) against the JAX step on the
global batch.

- ``parse_strategy``, the device resolution, the tensor-parallel and FSDP
  layouts (the JAX package's rules over the same parameters);
- one gradient of a 4-row batch whose two halves hold different numbers of
  valid frames and tokens, under ddp, fsdp and tp2, against ``jax.grad``
  of the JAX loss on the whole batch: 1e-4 of each leaf's peak (the
  attention key bias, zero in exact arithmetic, within 1e-6 of the largest
  peak), losses 1e-5 relative; the plain mean of the two halves' own
  gradients misses that bound;
- two training steps of an uneven batch (3 rows on 2 ranks, padded as
  ``pad_batch_to_devices`` pads it) under each strategy, and two as one
  stacked dispatch, against the JAX trainer's on a two-device mesh: each
  step's losses 1e-4 relative;
- fsdp's fit equal to ddp's, resumes across the two, per-rank resident
  bytes, per-rank dropout masks, and a two-process ``--nodes 2`` join.

Dropout is 0 on both sides but in the dropout test (the JAX postnet's
fixed 0.5 through a subclass at 0, as in ``test_torch_train_loop.py``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from everyvoice_tpu.dataloader import FastSpeech2Dataset as JaxDataset
from everyvoice_tpu.models import layers as jax_layers
from everyvoice_tpu.models.fs2 import FastSpeech2 as JaxFastSpeech2
from everyvoice_tpu.models.fs2 import model as jax_fs2_model
from everyvoice_tpu.models.fs2.config import FastSpeech2Config
from everyvoice_tpu.models.fs2.loss import compute_fs2_losses as jax_losses
from everyvoice_tpu.parallel import make_mesh as jax_make_mesh
from everyvoice_tpu.parallel import parse_strategy as jax_parse_strategy
from everyvoice_tpu.parallel.sharding import fsdp_shardings as jax_fsdp_shardings
from everyvoice_tpu.parallel.sharding import param_shardings as jax_param_shardings
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.text.lookups import lookuptables_from_data as jax_lookups
from everyvoice_tpu.train import FastSpeech2Trainer as JaxTrainer
from everyvoice_tpu.train import load_checkpoint as jax_load
from everyvoice_tpu.train import save_checkpoint as jax_save
from everyvoice_tpu.utils import generic_psv_filelist_reader as jax_reader
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.convert import _table, flax_to_torch
from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.onchip import write_corpus
from everyvoice_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    fsdp_shardings,
    param_shardings,
    parse_strategy,
    resolve_devices,
)
from everyvoice_tpu_torch.parallel.mesh import local_rows
from model_stubs import CONTACT, SMALL_FS2_MODEL, make_fs2_config
import torch_parallel_workers as workers

REPO = Path(__file__).resolve().parents[1]
STEPS = ("audio", "text", "spec", "attn", "energy", "pitch")
# Wide enough that FSDP shards something (16,384 elements) and the
# Conformer's heads split in two.
MODEL = {**SMALL_FS2_MODEL,
         "encoder": {**SMALL_FS2_MODEL["encoder"], "input_dim": 128, "feedforward_dim": 256},
         "decoder": {**SMALL_FS2_MODEL["decoder"], "input_dim": 128, "feedforward_dim": 256},
         "variance_predictors": {k: {**v, "input_dim": 128}
                                 for k, v in SMALL_FS2_MODEL["variance_predictors"].items()}}


class NoDropPostnet(jax_layers.Postnet):
    dropout: float = 0.0


def _no_dropout(model: dict, p: float = 0.0) -> dict:
    model = {**model, "max_length": 200}
    for stack in ("encoder", "decoder"):
        model[stack] = {**model[stack], "dropout": p}
    model["variance_predictors"] = {k: {**v, "dropout": p}
                                    for k, v in model["variance_predictors"].items()}
    return model


class _Mesh:
    """The sizes a layout reads, without a process group."""

    def __init__(self, data: int, model: int):
        self.axis_names, self.data_size, self.model_size = (DATA_AXIS, MODEL_AXIS), data, model


# ---------------------------------------------------------------------------
# strategies, devices and layouts


@pytest.mark.parametrize("text", ["ddp", "", "auto", "fsdp", "tp2", "ddp_tp4", "TP2", "tp0"])
def test_parse_strategy_matches_jax(text):
    want = jax_parse_strategy(text)
    got = parse_strategy(text)
    assert (got.model_parallel, got.fsdp) == (want.model_parallel, want.fsdp)


@pytest.mark.parametrize("text", ["fsdp2", "ddp_fsdp", "zero3"])
def test_unknown_strategy_raises_the_jax_message(text):
    with pytest.raises(ValueError) as want:
        jax_parse_strategy(text)
    with pytest.raises(ValueError) as got:
        parse_strategy(text)
    assert str(got.value) == str(want.value)


def test_an_explicit_card_without_one_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for accelerator in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA card"):
            resolve_devices(accelerator, "auto")
    assert resolve_devices("cpu", "auto") == [torch.device("cpu")]
    assert resolve_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        resolve_devices("tpu")


@pytest.fixture(scope="module")
def flax_and_port(tmp_path_factory):
    """The JAX model's parameter shapes and the port's model, one config."""
    base = make_fs2_config(tmp_path_factory.mktemp("layouts"))
    config = FastSpeech2Config(contact=CONTACT, model=MODEL, preprocessing=base.preprocessing,
                               text=base.text)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols, 1)
    batch = _batch(n_symbols)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0),
                                          "dropout": jax.random.PRNGKey(1)},
                            batch["text"], batch["text_lengths"], **_kwargs(batch))
    port = FastSpeech2.from_config(fs2_config(config.model_checkpoint_dump()), n_symbols, 1)
    return shapes, port


def _flax_paths(tree, keep) -> set:
    return {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec")) if keep(leaf)}


def _port_paths(model, names) -> set:
    return {"/".join(fpath) for fpath, tkey, _ in _table(model) if tkey in names}


def test_tensor_parallel_layout_is_the_jax_rules(flax_and_port):
    shapes, port = flax_and_port
    mesh = jax_make_mesh(jax.devices("cpu")[:2], model_parallel=2)
    want = _flax_paths(jax_param_shardings(shapes, mesh), lambda s: s.spec != P())
    got = param_shardings(port, _Mesh(1, 2))
    assert want and _port_paths(port, got) == want
    assert param_shardings(port, _Mesh(2, 1)) == {}


def test_fsdp_layout_shards_the_jax_leaves(flax_and_port):
    shapes, port = flax_and_port
    mesh = jax_make_mesh(jax.devices("cpu")[:2])
    want = _flax_paths(jax_fsdp_shardings(shapes, mesh), lambda s: s.spec != P())
    got = fsdp_shardings(dict(port.named_parameters()), _Mesh(2, 1))
    assert want and _port_paths(port, got) == want
    assert all(DATA_AXIS in spec for spec in got.values())


def test_local_rows_split_the_batch_axis():
    batch = {"a": np.arange(8).reshape(4, 2), "b": np.arange(4), "names": ["w", "x", "y", "z"]}
    got = [local_rows(batch, _Rank(r)) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([g["a"] for g in got]), batch["a"])
    assert got[1]["names"] == batch["names"] and list(got[1]["b"]) == [2, 3]


class _Rank(_Mesh):
    def __init__(self, rank):
        super().__init__(2, 1)
        self.data_rank = rank


@pytest.mark.parametrize("fsdp", [False, True])
def test_one_rank_mesh_calls_no_collective_and_outlives_its_group(fsdp):
    """A one-rank mesh reduces nothing: its placement, gradients and loss
    denominators are the no-mesh ones, so they work after ``teardown`` has
    left the group."""
    import torch.distributed as dist

    from everyvoice_tpu_torch.parallel import (
        data_parallel,
        mean_denominator,
        setup_mesh,
        shard_params,
        teardown,
    )

    mesh = setup_mesh("cpu", 1)
    teardown(mesh)
    assert not dist.is_initialized()
    model = torch.nn.Linear(256, 128)  # 32,768 weights: an FSDP leaf on several ranks
    placement = shard_params(dict(model.named_parameters()), mesh, model=model, fsdp=fsdp)
    assert not placement.shards and placement.norm_fn is None
    grads = {n: torch.full_like(p, 2.0) for n, p in model.named_parameters()}
    assert placement.reduce_grads(grads) is grads
    with data_parallel(mesh):
        assert float(mean_denominator(torch.tensor(0.0))) == 1.0
        assert float(mean_denominator(torch.tensor(7.0))) == 7.0


# ---------------------------------------------------------------------------
# one gradient of the global batch


def _batch(n_symbols, seed=0):
    """Four rows whose halves hold different numbers of valid tokens and
    frames (12+10 and 5+4 tokens, 60+48 and 20+12 frames), padded to 12
    tokens and the model's 256 frames."""
    rng = np.random.default_rng(seed)
    b, n, t = 4, 12, 256
    text_lengths = np.asarray([12, 10, 5, 4], np.int32)
    mel_lengths = np.asarray([60, 48, 20, 12], np.int32)
    text = np.zeros((b, n), np.int32)
    mel = np.zeros((b, t, 80), np.float32)
    pitch = np.zeros((b, t), np.float32)
    energy = np.zeros((b, t), np.float32)
    prior = np.zeros((b, t, n), np.float32)
    for i in range(b):
        text[i, : text_lengths[i]] = rng.integers(2, n_symbols, text_lengths[i])
        m = mel_lengths[i]
        mel[i, :m] = rng.standard_normal((m, 80)) - 4.0
        pitch[i, :m] = rng.standard_normal(m)
        energy[i, :m] = rng.standard_normal(m)
        prior[i, :m, : text_lengths[i]] = rng.uniform(0.01, 1.0, (m, text_lengths[i]))
    return {"text": text, "text_lengths": text_lengths, "mel": mel, "mel_lengths": mel_lengths,
            "pitch": pitch, "energy": energy, "speaker_id": np.zeros(b, np.int32),
            "language_id": np.zeros(b, np.int32), "attn_prior": prior}


def _kwargs(batch):
    return {k: batch[k] for k in ("mel", "mel_lengths", "pitch", "energy", "speaker_id",
                                  "language_id", "attn_prior")}


@pytest.fixture(scope="module")
def gradients(tmp_path_factory):
    """The JAX gradient of the global batch, the port's two-rank gradients
    under each strategy, and the plain mean of the halves' own gradients."""
    work = tmp_path_factory.mktemp("grads")
    base = make_fs2_config(work)
    config = FastSpeech2Config(contact=CONTACT, model=MODEL, preprocessing=base.preprocessing,
                               text=base.text)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols, 1)
    batch = _batch(n_symbols)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(3),
                                   "dropout": jax.random.PRNGKey(4)},
                                  batch["text"], batch["text_lengths"], **_kwargs(batch))
    params = jax.tree.map(np.asarray, params)

    def loss_fn(p, b):
        out = jmodel.apply(p, b["text"], b["text_lengths"], deterministic=True, **_kwargs(b))
        losses = jax_losses(out, b, workers.WEIGHTS, bin_loss_ramp=0.3)
        return losses["total"], losses

    port_config = fs2_config(config.model_checkpoint_dump())
    model = FastSpeech2.from_config(port_config, n_symbols, 1)
    state, _ = flax_to_torch(params, model)
    torch.save(state, work / "state.pt")
    np.savez(work / "batch.npz", **batch)
    (work / "spec.json").write_text(json.dumps(
        {"config": port_config, "n_symbols": n_symbols, "n_speakers": 1}, default=str))

    def references() -> dict:
        (_, want_losses), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params,
                                                                                    batch)
        # Each half alone, its masked means over its own rows, then averaged.
        model.load_state_dict(state)
        model.eval()
        halves = []
        for rows in (slice(0, 2), slice(2, 4)):
            half = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
            model.zero_grad()
            losses = compute_fs2_losses(model(half["text"], half["text_lengths"],
                                              **_kwargs(half)),
                                        half, workers.WEIGHTS, bin_loss_ramp=0.3)
            losses["total"].backward()
            halves.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return {"want": flax_to_torch(jax.tree.map(np.asarray, want), model)[0],
                "want_losses": {k: float(v) for k, v in want_losses.items()},
                "plain": {n: (halves[0][n] + halves[1][n]) / 2 for n in halves[0]}}

    out = workers.spawn(workers.fs2_grads, (str(work),), timeout=300, meanwhile=references)
    out["got"] = {name: torch.load(work / f"grads_{name}.pt") for name in workers.STRATEGIES}
    out["dryrun"] = (work / "dryrun.txt").read_text()
    return out


def _worst(got: dict, want: dict) -> float:
    """The largest error of a leaf over its peak, the attention key biases
    (zero in exact arithmetic) over the largest peak."""
    largest = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[name].numpy() - w).max())
        if name.endswith("attn.key.bias"):
            worst = max(worst, err / (1e-2 * largest))
        else:
            worst = max(worst, err / max(float(np.abs(w).max()), 1e-12))
    return worst


@pytest.mark.parametrize("strategy", sorted(workers.STRATEGIES))
def test_two_rank_gradient_is_the_jax_global_gradient(gradients, strategy):
    got = gradients["got"][strategy]
    assert set(got["grads"]) == set(gradients["want"])
    assert _worst(got["grads"], gradients["want"]) <= 1e-4
    for key, want in gradients["want_losses"].items():
        assert got["losses"][key] == pytest.approx(want, rel=1e-5), key
    assert got["sharded"] > 0 or strategy == "ddp"


def test_plain_mean_of_per_rank_means_is_not_the_global_gradient(gradients):
    assert _worst(gradients["plain"], gradients["want"]) > 1e-2


def test_dryrun_takes_a_tensor_parallel_step(gradients):
    """``parallel.dryrun``'s step on the same two ranks, a dp1 × tp2 mesh."""
    assert ("dryrun: 2 ranks, mesh {'data': 1, 'model': 2} (gloo), 26 tensor-parallel"
            in gradients["dryrun"])


# ---------------------------------------------------------------------------
# fits on a corpus


def _raw(root, model, **training) -> dict:
    pre = root / "pre"
    return {
        "contact": CONTACT,
        "model": model,
        "preprocessing": {"dataset": "seeded", "save_dir": str(pre), "source_data": [{
            "label": "seeded", "permissions_obtained": True,
            "data_dir": str(root / "corpus" / "wavs"),
            "filelist": str(root / "corpus" / "filelist.psv")}]},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "training": {
            "batch_size": 3, "val_check_interval": 1000, "save_top_k_ckpts": 1,
            "optimizer": {"learning_rate": 1e-3, "warmup_steps": 4},
            "training_filelist": str(pre / "training_filelist.psv"),
            "validation_filelist": str(pre / "validation_filelist.psv"),
            "logger": {"save_dir": str(root / "logs"), "name": "parallel"},
            **training,
        },
    }


def _metrics(run_dir) -> dict:
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r for r in rows if "training/total" in r}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_fits")
    write_corpus(root / "corpus", 10, seed=7)
    raw = _raw(root, _no_dropout(MODEL))
    JaxPreprocessor(FastSpeech2Config(**raw)).preprocess(to_process=STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fs2_model, "Postnet", NoDropPostnet)
        config = FastSpeech2Config(**raw)
        train = jax_reader(raw["training"]["training_filelist"])
        val = jax_reader(raw["training"]["validation_filelist"])
        lang2id, speaker2id = jax_lookups((train, val))
        ds = JaxDataset(train, config, lang2id, speaker2id)
        vds = JaxDataset(val, config, lang2id, speaker2id, text_processor=ds.text_processor)
        init = JaxTrainer(config, ds, vds, lang2id, speaker2id,
                          mesh=jax_make_mesh(jax.devices("cpu")[:1]), run_dir=root / "init")
        start = jax_save(root / "start.ckpt", "FastSpeech2", init.config, init.init_params())
        raw = _raw(root, _no_dropout(MODEL), finetune_checkpoint=str(start))

        def jax_fit() -> None:
            jax_run = JaxTrainer(FastSpeech2Config(**raw), ds, vds, lang2id, speaker2id,
                                 mesh=jax_make_mesh(jax.devices("cpu")[:2]),
                                 run_dir=root / "jax")
            jax_run.fit(max_steps=2, log_every=1)

        dropout_raw = _raw(root, _no_dropout(MODEL, 0.5))
        workers.spawn(workers.fs2_fits, (raw, dropout_raw, str(root / "port")), timeout=420,
                      meanwhile=jax_fit)
    return {"root": root, "jax": root / "jax", "port": root / "port",
            "report": json.loads((root / "port" / "report.json").read_text())}


@pytest.mark.parametrize("strategy", sorted(workers.STRATEGIES))
def test_uneven_batch_steps_match_the_jax_two_device_steps(fits, strategy):
    want = _metrics(fits["jax"])
    got = _metrics(fits["port"] / strategy)
    assert sorted(got) == sorted(want) == [1, 2]
    for step in want:
        for key, value in want[step].items():
            if key.startswith("training/"):
                assert got[step][key] == pytest.approx(value, rel=1e-4), (strategy, step, key)


def test_stacked_dispatches_take_each_batchs_rows(fits):
    """``--steps-per-execution 2`` on two ranks: the logged (last) step of
    the dispatch equals the JAX trainer's step."""
    want = _metrics(fits["jax"])
    got = _metrics(fits["port"] / "spe2")
    assert sorted(got) == [2]
    for step in got:
        for key, value in want[step].items():
            if key.startswith("training/"):
                assert got[step][key] == pytest.approx(value, rel=1e-4), (step, key)


def _state(path) -> dict:
    tree = jax_load(path)  # the JAX package's loader reads the port's files
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree["state_dict"])}


def test_fsdp_fit_equals_ddp_fit_and_resumes_across(fits):
    ckpts = {name: fits["port"] / name / "checkpoints" / "last.ckpt"
             for name in ("ddp", "fsdp", "resume_ddp", "resume_fsdp")}
    ddp, fsdp = _state(ckpts["ddp"]), _state(ckpts["fsdp"])
    assert set(ddp) == set(fsdp)
    for key in ddp:
        np.testing.assert_allclose(fsdp[key], ddp[key], rtol=1e-6, atol=1e-7, err_msg=key)
    a, b = _state(ckpts["resume_ddp"]), _state(ckpts["resume_fsdp"])
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7, err_msg=key)
    for name in ("resume_ddp", "resume_fsdp"):
        ckpt = jax_load(ckpts[name])
        assert ckpt["global_step"] == 3
        assert int(np.asarray(ckpt["optimizer_states"]["0"]["count"])) == 3
        assert sorted(_metrics(fits["port"] / name)) == [3]
    assert fits["report"]["fsdp"]["sharded"] > 0 and fits["report"]["ddp"]["sharded"] == 0


def test_fsdp_halves_resident_parameter_and_optimizer_bytes(fits):
    report = fits["report"]
    assert report["fsdp"]["bytes"] <= 0.55 * report["ddp"]["bytes"]


def test_only_rank_zero_writes(fits):
    for name in ("ddp", "fsdp", "tp2"):
        run = fits["port"] / name
        assert (run / "hparams.yaml").exists() and (run / "metrics.jsonl").exists()
        assert len(list(run.glob("events.out.tfevents.*"))) == 1
        assert sorted(p.name for p in (run / "checkpoints").iterdir())[-1] == "last.ckpt"
    # tensor-parallel shards are gathered whole into the JAX layouts
    ddp = _state(fits["port"] / "ddp" / "checkpoints" / "last.ckpt")
    tp2 = _state(fits["port"] / "tp2" / "checkpoints" / "last.ckpt")
    assert {k: v.shape for k, v in tp2.items()} == {k: v.shape for k, v in ddp.items()}


def test_ranks_draw_their_own_dropout_masks(fits):
    ddp = np.asarray(fits["report"]["masks_ddp"])
    tp2 = np.asarray(fits["report"]["masks_tp2"])
    assert 0.3 < ddp.mean() < 0.7
    assert not np.array_equal(ddp[0], ddp[1])  # data ranks: different rows, masks
    np.testing.assert_array_equal(tp2[0], tp2[1])  # model ranks: the same rows


def test_two_nodes_join_over_node_rank_and_master_port(tmp_path):
    """Two processes, one a node, each joining with --nodes 2 from
    NODE_RANK and MASTER_PORT, build the (node, data, model) mesh and
    all-reduce over its batch axes."""
    script = tmp_path / "node.py"
    script.write_text(
        "import torch, torch.distributed as dist\n"
        "from everyvoice_tpu_torch.parallel import setup_mesh, teardown\n"
        "mesh = setup_mesh('cpu', 1, nodes=2)\n"
        "t = torch.tensor([float(mesh.rank + 1)])\n"
        "dist.all_reduce(t, group=mesh.batch_group)\n"
        "print('RESULT', mesh.axis_names, mesh.shape, mesh.data_rank, float(t))\n"
        "teardown(mesh)\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "NODE_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "PYTHONPATH": str(REPO)}
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "EVERYVOICE_NODE_RANK",
                    "EVERYVOICE_COORDINATOR_ADDRESS"):
            env.pop(key, None)
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"RESULT ('node', 'data', 'model') (2, 1, 1) {rank} 3.0" in out

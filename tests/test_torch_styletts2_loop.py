"""StyleTTS2 training as a whole, the port's trainer against the JAX
package's, on the CPU, on a seeded 12-utterance corpus
(``onchip.write_corpus``) that the JAX ``Preprocessor`` preprocessed: the
datasets, and the first three steps of both trainers with the validation
after them.

Both trainers run in float32 at small widths (hidden 32, style 16, one
upsampling stage; the decoder's convs are 512 channels whatever the config
says), with dropout off on both sides (flax's ``Dropout`` swapped for the
identity while this file runs, the port's at rate 0). The port's steps take
the draws the JAX trainer's keys give (``training_rng(17)``, split as its
step splits it), and its validation the JAX package's fixed source noise.
Tolerances:
- dataset batches: bit-equal;
- the steps' losses and the validation losses: 1e-4 relative (float32
  sums in another order through the step, the optimizers and the next
  forward; atol 1e-6 for the TMA losses);
- ``metrics.jsonl`` keys equal, ``hparams.yaml`` equal after
  ``yaml.safe_load``.
"""

import json
import shutil

import numpy as np
import pytest
import torch
import yaml

import flax.linen
import jax

from everyvoice_tpu.dataloader import StyleTTS2Dataset as JaxDataset
from everyvoice_tpu.models.styletts2.config import StyleTTS2Config
from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu.train import loop as jax_loop
from everyvoice_tpu.train.loop import training_rng
from everyvoice_tpu.utils import generic_psv_filelist_reader as jax_reader
from everyvoice_tpu_torch.config import model_checkpoint_dump, styletts2_config
from everyvoice_tpu_torch.convert import hifigan_tree
from everyvoice_tpu_torch.dataloader import StyleTTS2Dataset
from everyvoice_tpu_torch.models.layers import Dropout
from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
from everyvoice_tpu_torch.onchip import write_corpus
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint
from everyvoice_tpu_torch.utils import generic_psv_filelist_reader
from model_stubs import CONTACT
from test_torch_styletts2_train import N_FFT, MODEL, _IdentityDropout, jax_step_draws

N_UTTS = 12  # 10 for training, 2 for validation
MAX_LEN, SEGMENT, HOP = 48, 16, 256
STEPS = 3


def _raw(root, save_dir="pre", **training) -> dict:
    pre = root / save_dir
    return {
        "contact": CONTACT,
        "model": MODEL,
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "preprocessing": {"dataset": "seeded", "save_dir": str(pre),
                          "source_data": [{
                              "label": "seeded", "permissions_obtained": True,
                              "data_dir": str(root / "corpus" / "wavs"),
                              "filelist": str(root / "corpus" / "filelist.psv")}]},
        "training": {
            "batch_size": 2, "save_top_k_ckpts": 0, "max_len": MAX_LEN,
            "decoder_segment_frames": SEGMENT,
            "losses": {"tma_epoch": 1, "diff_epoch": 0},
            "training_filelist": str(pre / "training_filelist.psv"),
            "validation_filelist": str(pre / "validation_filelist.psv"),
            "logger": {"save_dir": str(root / "logs"), "name": "parity"},
            **training,
        },
    }


@pytest.fixture(autouse=True, scope="module")
def no_dropout_one_thread():
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen, "Dropout", _IdentityDropout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    patch.undo()


def _jax_trainer(raw, run_dir, mode="second"):
    config = StyleTTS2Config(**raw)
    t = raw["training"]
    ds = JaxDataset(jax_reader(t["training_filelist"]), config)
    vds = JaxDataset(jax_reader(t["validation_filelist"]), config, text_processor=ds.text_processor)
    return JaxTrainer(config, ds, vds, lang2id={"default": 0},
                      mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=run_dir, mode=mode,
                      compute_dtype="float32")


def _port_trainer(raw, run_dir, mode="second"):
    config = styletts2_config(raw)
    t = config["training"]
    ds = StyleTTS2Dataset(generic_psv_filelist_reader(t["training_filelist"]), config)
    vds = StyleTTS2Dataset(generic_psv_filelist_reader(t["validation_filelist"]), config,
                           text_processor=ds.text_processor)
    trainer = StyleTTS2Trainer(config, ds, vds, {"default": 0}, run_dir=run_dir, mode=mode,
                               compute_dtype="float32", device="cpu")
    for module in trainer.model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    return trainer


def _records(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus preprocessed by the JAX package, and a copy of its
    artifacts with ``duration/`` files (some longer than their frames, so
    the trimming loop runs)."""
    root = tmp_path_factory.mktemp("st2_loop")
    write_corpus(root / "corpus", N_UTTS, seed=6)
    JaxPreprocessor(StyleTTS2Config(**_raw(root))).preprocess(
        to_process=("audio", "text", "spec", "attn", "energy", "pitch"))
    shutil.copytree(root / "pre", root / "pre_dur")
    rng = np.random.default_rng(8)
    (root / "pre_dur" / "duration").mkdir()
    for spec in (root / "pre_dur" / "spec").glob("*.npy"):
        stem = spec.name.rsplit("--", 1)[0]
        n_tokens = 80  # more than any text: the dataset cuts them to the text
        np.save(root / "pre_dur" / "duration" / f"{stem}--duration.npy",
                rng.integers(0, 9, n_tokens).astype(np.int64))
    return root


@pytest.mark.parametrize("mode", ["seed0", "seed1", "unshuffled", "durations"])
def test_dataset_batches_are_bit_equal(corpus, mode):
    """Token ids, mel, frame and token F0/energy, durations (the uniform
    fallback, or ``duration/`` artifacts trimmed to fit) and audio."""
    raw = _raw(corpus, "pre_dur" if mode == "durations" else "pre")
    rows = jax_reader(raw["training"]["training_filelist"])
    want = JaxDataset(rows, StyleTTS2Config(**raw))
    got = StyleTTS2Dataset(generic_psv_filelist_reader(raw["training"]["training_filelist"]),
                           styletts2_config(raw))
    assert len(got) == len(want) == N_UTTS - 2
    shuffle = mode != "unshuffled"
    seed = 1 if mode == "seed1" else 0
    pairs = list(zip(want.batches(4, shuffle=shuffle, seed=seed),
                     got.batches(4, shuffle=shuffle, seed=seed)))
    assert len(pairs) == 3  # the ragged last batch is padded
    for w, g in pairs:
        assert set(w) == set(g)
        assert w["basenames"] == g["basenames"]
        for key in w:
            if key != "basenames":
                assert w[key].dtype == g[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if mode == "durations":
        assert any((p[1]["durations"].sum(1) == p[1]["mel_lengths"]).any() for p in pairs)


@pytest.fixture(scope="module")
def runs(corpus):
    """Both trainers, three stage-2 steps each (the diffusion on from epoch
    0) from one checkpoint of the port's initial parameters, its iSTFT head
    lowered to audio-sized wavs, as ``test_torch_styletts2_train.py`` lowers
    its own (at flax's initial scale the head's log-magnitude clips, and
    the gradients of most of the decoder are float32 noise, which Adam's
    first steps turn into ±lr in either package's own direction); then the
    validation."""
    init = _port_trainer(_raw(corpus), corpus / "init")
    init.init_params()
    with torch.no_grad():
        init.model.decoder.conv_post.bias[: N_FFT // 2 + 1] = -2.0
        init.model.decoder.conv_post.scale.mul_(0.02)
    params = hifigan_tree(init.model.state_dict(), init.discriminators.state_dict(),
                          init.model, init.discriminators)
    start = save_checkpoint(corpus / "start.ckpt", "StyleTTS2Module",
                            model_checkpoint_dump(init.config), params, lang2id={"default": 0},
                            extra=init.checkpoint_extra())
    raw = _raw(corpus, finetune_checkpoint=str(start))
    jax_run = _jax_trainer(raw, corpus / "jax_run")
    # Two shortcuts of the JAX fit that change none of its numbers: the
    # resume replaces every initial parameter, so its jitted init is
    # skipped; and its step key starts committed to the mesh, as the step
    # returns it, or the second step compiles the whole step again.
    jax_run.init_params = lambda example, rng=None: (None, None)
    replicated = jax.sharding.NamedSharding(jax_run.mesh, jax.sharding.PartitionSpec())
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_loop, "training_rng",
                      lambda seed: jax.device_put(training_rng(seed), replicated))
        jax_run.fit(max_steps=STEPS, log_every=1)
    port = _port_trainer(raw, corpus / "port_run")
    rng = training_rng(17)
    draws = []
    for batch in list(port.dataset.batches(2, shuffle=True, seed=0, drop_last=True))[:STEPS]:
        rng, _, step_draws = jax_step_draws(rng, batch, 16)
        draws.append(step_draws)
    port.draw_step = lambda batch, generator=None: draws.pop(0)
    noise = jax.random.normal(jax.random.PRNGKey(0), (2, MAX_LEN * HOP, 1))[..., 0]
    port.validation_noise = lambda b: torch.from_numpy(np.array(noise))
    port.fit(max_steps=STEPS, log_every=1)
    return {"root": corpus, "jax": jax_run, "port": port}


def test_first_steps_and_validation_match(runs):
    """The first three steps' losses and the validation after them, both
    runs resuming a checkpoint the port wrote."""
    want, got = _records(runs["jax"].run_dir), _records(runs["port"].run_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key, value in w.items():
            if "/" in key:
                np.testing.assert_allclose(g[key], value, rtol=1e-4, atol=1e-6, err_msg=key)
    for ckpt_dir in (runs["jax"].ckpt_dir, runs["port"].ckpt_dir):
        assert sorted(p.name for p in ckpt_dir.iterdir()) == ["stage-2-last.ckpt"]
    assert (yaml.safe_load((runs["port"].run_dir / "hparams.yaml").read_text())
            == yaml.safe_load((runs["jax"].run_dir / "hparams.yaml").read_text()))

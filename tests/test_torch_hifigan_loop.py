"""HiFiGAN training as a whole, the port's trainer against the JAX package's,
on the CPU, on a seeded corpus (``onchip.write_corpus``) that the JAX
``Preprocessor`` preprocessed (audio and spec).

Both trainers run in float32 from the same parameters (a checkpoint of the
port's seeded initial parameters, written in the JAX layout, given to both as
``finetune_checkpoint``), with a small generator, one MPD period, one MSD
scale, segments of 768 samples and a two-step
generator warmup, so the first three steps take both branches of the gate.
Tolerances:
- dataset batches: bit-equal;
- the first three steps' losses and the validation loss: 1e-4 relative
  (float32 sums in another order through the step, the optimizers and the
  next forward);
- resumes across packages: both optimizer states come back (their step
  counts continue) and the gate picks the same mode;
- ``metrics.jsonl`` keys equal, ``hparams.yaml`` equal after
  ``yaml.safe_load``;
- an exported generator: both packages' wavs from it within 2e-4.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from everyvoice_tpu.dataloader import HiFiGANDataset as JaxDataset
from everyvoice_tpu.models.fs2.synthesize import export_generator as jax_export
from everyvoice_tpu.models.fs2.synthesize import load_vocoder_from_checkpoint as jax_load_vocoder
from everyvoice_tpu.models.hifigan.config import HiFiGANConfig
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu.train import HiFiGANTrainer as JaxTrainer
from everyvoice_tpu.train import load_checkpoint as jax_load
from everyvoice_tpu.utils import generic_psv_filelist_reader as jax_reader
from everyvoice_tpu_torch.config import hifigan_training_config, model_checkpoint_dump
from everyvoice_tpu_torch.convert import hifigan_tree
from everyvoice_tpu_torch.dataloader import HiFiGANDataset
from everyvoice_tpu_torch.models.fs2.synthesize import export_generator, load_vocoder_from_checkpoint
from everyvoice_tpu_torch.onchip import write_corpus
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from everyvoice_tpu_torch.train.loop import HiFiGANTrainer
from everyvoice_tpu_torch.utils import generic_psv_filelist_reader
from model_stubs import CONTACT

N_UTTS = 12  # 10 for training, 2 for validation
SEGMENT = 768
MODEL = {"upsample_rates": [16, 16], "upsample_kernel_sizes": [32, 32],
         "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
         "resblock_dilation_sizes": [[1, 3]], "mpd_layers": [3], "msd_layers": 1}


def _raw(root, **training) -> dict:
    pre = root / "pre"
    return {
        "contact": CONTACT,
        "model": MODEL,
        "preprocessing": {"dataset": "seeded", "save_dir": str(pre),
                          "audio": {"vocoder_segment_size": SEGMENT},
                          "source_data": [{
                              "label": "seeded", "permissions_obtained": True,
                              "data_dir": str(root / "corpus" / "wavs"),
                              "filelist": str(root / "corpus" / "filelist.psv")}]},
        "training": {
            "batch_size": 4, "val_check_interval": 1000, "save_top_k_ckpts": 2,
            "generator_warmup_steps": 2,
            "training_filelist": str(pre / "training_filelist.psv"),
            "validation_filelist": str(pre / "validation_filelist.psv"),
            "logger": {"save_dir": str(root / "logs"), "name": "parity"},
            **training,
        },
    }


def _jax_trainer(raw, run_dir):
    config = HiFiGANConfig(**raw)
    t = raw["training"]
    ds = JaxDataset(jax_reader(t["training_filelist"]), config)
    vds = JaxDataset(jax_reader(t["validation_filelist"]), config)
    return JaxTrainer(config, ds, vds, mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=run_dir)


def _port_trainer(raw, run_dir):
    config = hifigan_training_config(raw)
    t = config["training"]
    ds = HiFiGANDataset(generic_psv_filelist_reader(t["training_filelist"]), config)
    vds = HiFiGANDataset(generic_psv_filelist_reader(t["validation_filelist"]), config)
    return HiFiGANTrainer(config, ds, vds, run_dir=run_dir, device="cpu")


def _metrics(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _steps(run_dir) -> list:
    return [r["step"] for r in _metrics(run_dir) if "training/gen/total" in r]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hifigan_loop")
    write_corpus(root / "corpus", N_UTTS, seed=6)
    JaxPreprocessor(HiFiGANConfig(**_raw(root))).preprocess(to_process=("audio", "spec"))
    return root


@pytest.fixture(scope="module")
def runs(corpus):
    """Both trainers, three steps each from one checkpoint of the port's
    initial parameters."""
    init = _port_trainer(_raw(corpus), corpus / "init")
    init.init_params()
    params = hifigan_tree(init.generator.state_dict(), init.discriminators.state_dict(),
                          init.generator, init.discriminators)
    start = save_checkpoint(corpus / "start.ckpt", "HiFiGAN",
                            model_checkpoint_dump(init.config), params)
    raw = _raw(corpus, finetune_checkpoint=str(start))
    jax_run = _jax_trainer(raw, corpus / "jax_run")
    jax_run.fit(max_steps=3, log_every=1)
    port = _port_trainer(raw, corpus / "port_run")
    port.fit(max_steps=3, log_every=1)
    return {"root": corpus, "jax": jax_run, "port": port}


@pytest.mark.parametrize("mode", ["seed0", "seed1", "ragged", "utterances", "finetune"])
def test_dataset_batches_are_bit_equal(corpus, mode):
    """Segments and whole utterances; under ``finetune`` both read the
    teacher-forced ``synthesized_spec/`` (here the spec files, shifted, so a
    read of ``spec/`` would show)."""
    raw = _raw(corpus)
    rows = jax_reader(raw["training"]["training_filelist"])
    finetune = mode == "finetune"
    if finetune:
        synthesized = corpus / "pre" / "synthesized_spec"
        synthesized.mkdir(exist_ok=True)
        for path in (corpus / "pre" / "spec").glob("*.npy"):
            np.save(synthesized / path.name, np.load(path) + 1.0)
    jax_ds = JaxDataset(rows, HiFiGANConfig(**raw), finetune=finetune)
    port_ds = HiFiGANDataset(rows, hifigan_training_config(raw), finetune=finetune)
    assert len(port_ds) == len(jax_ds) == 10
    if finetune:
        spec = np.load(port_ds._path(port_ds.items[0], "spec", port_ds._spec_name())).T
        np.testing.assert_array_equal(port_ds.load_item(0)["mel"], spec + 1.0)
    if mode == "utterances":
        pairs = zip(jax_ds.batches(4, seed=3), port_ds.batches(4, seed=3), strict=True)
    else:
        kwargs = {"seed0": dict(seed=0, drop_last=True), "seed1": dict(seed=1, drop_last=True),
                  "ragged": dict(shuffle=False), "finetune": dict(seed=2)}[mode]
        pairs = zip(jax_ds.segment_batches(4, SEGMENT, **kwargs),
                    port_ds.segment_batches(4, SEGMENT, **kwargs), strict=True)
    n = 0
    for a, b in pairs:
        assert a["basenames"] == b["basenames"] and set(a) == set(b)
        for key in a:
            if key != "basenames":
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        n += 1
    assert n == (2 if mode in ("seed0", "seed1") else 3)


def test_first_steps_match_jax(runs):
    """Two warmup steps (no discriminator update) and one GAN step."""
    want = {r["step"]: r for r in _metrics(runs["jax"].run_dir)}
    got = {r["step"]: r for r in _metrics(runs["port"].run_dir)}
    assert _steps(runs["port"].run_dir) == _steps(runs["jax"].run_dir) == [1, 2, 3]
    for step in (1, 2, 3):
        for key, value in want[step].items():
            if key.startswith(("training/", "validation/")):
                assert got[step][key] == pytest.approx(value, rel=1e-4), (step, key)
    assert got[3]["training/gen/adv"] > 0 and np.isfinite(got[3]["training/gen/total"])


def test_discriminator_skips_the_warmup(runs):
    """After 2 warmup steps of 3, each package's discriminator optimizer has
    counted 1 update, the generator's 3."""
    for trainer in (runs["port"], runs["jax"]):
        opt = load_checkpoint(trainer.ckpt_dir / "last.ckpt")["optimizer_states"]
        assert sorted(opt) == ["disc", "gen"]
        assert (int(opt["gen"]["0"]["count"]), int(opt["disc"]["0"]["count"])) == (3, 1)


def test_metrics_keys_and_hparams_match(runs):
    def kinds(run_dir):
        return sorted({tuple(sorted(r)) for r in _metrics(run_dir)})

    assert kinds(runs["port"].run_dir) == kinds(runs["jax"].run_dir)
    want = yaml.safe_load((runs["jax"].run_dir / "hparams.yaml").read_text())
    got = yaml.safe_load((runs["port"].run_dir / "hparams.yaml").read_text())
    assert got == want
    assert list(runs["port"].run_dir.glob("events.out.tfevents.*"))


def test_port_checkpoint_resumes_in_jax(runs):
    """The JAX trainer's resume path takes the port's checkpoint: the gate
    reads ``full``, the step goes on from 3, and flax restores both optax
    states against its own trees (it raises on any other tree), with their
    counts. (Its ``fit`` would then compile the GAN step again; the
    reverse resume below runs a step.)"""
    root = runs["root"]
    last = runs["port"].ckpt_dir / "last.ckpt"
    ckpt = load_checkpoint(last)
    assert ckpt["global_step"] == 3 and sorted(ckpt["state_dict"]) == ["discriminators", "generator"]
    assert sorted(ckpt["state_dict"]["discriminators"]) == ["mpd", "msd"]
    jax_run = _jax_trainer(_raw(root, finetune_checkpoint=str(last)), root / "jax_resumed")
    state, opt = jax_run.load_finetune_checkpoint(None)
    assert jax_run.global_step == 3 and opt is not None
    gen_state = serialization.from_state_dict(jax_run.gen_opt.init(state["generator"]), opt["gen"])
    disc_state = serialization.from_state_dict(jax_run.disc_opt.init(state["discriminators"]),
                                               opt["disc"])
    assert (int(gen_state[0].count), int(disc_state[0].count)) == (3, 1)
    assert jax.tree.structure(gen_state[0].mu) == jax.tree.structure(state["generator"])


def test_jax_checkpoint_resumes_in_port(runs):
    root = runs["root"]
    last = runs["jax"].ckpt_dir / "last.ckpt"
    port = _port_trainer(_raw(root, finetune_checkpoint=str(last)), root / "port_resumed")
    port.fit(max_steps=4, log_every=1)
    assert port.resumed == "full" and _steps(port.run_dir) == [4]
    resumed = load_checkpoint(port.ckpt_dir / "last.ckpt")
    opt = resumed["optimizer_states"]
    assert (int(opt["gen"]["0"]["count"]), int(opt["disc"]["0"]["count"])) == (4, 2)
    # The moments written back keep the JAX trainer's trees, leaf for leaf.
    assert jax.tree.structure(opt) == jax.tree.structure(jax_load(last)["optimizer_states"])
    assert jax.tree.structure(resumed["state_dict"]) == jax.tree.structure(
        jax_load(last)["state_dict"])


def test_exported_generator_loads_in_both(runs):
    """Each package's export of its own checkpoint serves in both, with the
    same wav."""
    root = runs["root"]
    mel = np.random.default_rng(0).standard_normal((1, 9, 80)).astype(np.float32)
    for name, export in (("port", export_generator), ("jax", jax_export)):
        path = export(runs[name].ckpt_dir / "last.ckpt", root / f"{name}_generator.ckpt")
        ckpt = load_checkpoint(path)
        assert ckpt["model_info"]["name"] == "HiFiGANGenerator" and "optimizer_states" not in ckpt
        generator, _ = load_vocoder_from_checkpoint(path, "float32", device="cpu")
        jgen, jparams, _ = jax_load_vocoder(path, "float32")
        got = generator(torch.from_numpy(mel)).numpy()
        want = np.asarray(jgen.apply(jparams, jnp.asarray(mel)))
        assert got.shape == want.shape == (1, 9 * 256)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_steps_per_execution_and_profile(runs):
    """Two steps from one stacked transfer give the single steps' losses
    (the second step's are logged), and ``profile_steps`` leaves a trace."""
    root = runs["root"]
    port = _port_trainer(_raw(root, finetune_checkpoint=str(root / "start.ckpt")),
                         root / "port_stacked")
    port.fit(max_steps=4, log_every=1, profile_steps=1, steps_per_execution=2)
    got = {r["step"]: r for r in _metrics(port.run_dir) if "training/gen/total" in r}
    want = {r["step"]: r for r in _metrics(runs["port"].run_dir) if "training/gen/total" in r}
    assert sorted(got) == [2, 4]
    for key, value in want[2].items():
        if key.startswith("training/"):
            assert got[2][key] == pytest.approx(value, rel=1e-6), key
    assert (port.run_dir / "profile" / "trace.json").stat().st_size > 0

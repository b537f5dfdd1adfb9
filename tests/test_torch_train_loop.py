"""FastSpeech2 training as a whole, the port's trainer against the JAX
package's, on the CPU, on a seeded corpus (``onchip.write_corpus``) that the
JAX ``Preprocessor`` preprocessed.

Both trainers run in float32 with every dropout rate at 0 (the JAX
package's postnet keeps a fixed 0.5, so this test's JAX model takes a
postnet subclass at 0) and start from the same parameters (a JAX-initialised
checkpoint given to both as ``finetune_checkpoint``). Tolerances:
- dataset batches: bit-equal;
- the first three steps' losses: 1e-4 relative (float32 sums in another
  order through the step, the optimizer and the next forward);
- resumes across packages: the optimizer state comes back (its step counts
  continue) and the gate picks the same mode;
- ``metrics.jsonl`` keys equal, ``hparams.yaml`` equal after
  ``yaml.safe_load``, event files framed with valid CRCs.
"""

import json
import struct

import numpy as np
import pytest
import yaml

import jax

from everyvoice_tpu.dataloader import FastSpeech2Dataset as JaxDataset
from everyvoice_tpu.dataloader import imbalanced_sample_weights as jax_weights
from everyvoice_tpu.models import layers as jax_layers
from everyvoice_tpu.models.fs2 import model as jax_fs2_model
from everyvoice_tpu.models.fs2.config import FastSpeech2Config
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu.text.lookups import lookuptables_from_data as jax_lookups
from everyvoice_tpu.train import FastSpeech2Trainer as JaxTrainer
from everyvoice_tpu.train import load_checkpoint as jax_load
from everyvoice_tpu.train import save_checkpoint as jax_save
from everyvoice_tpu.utils import generic_psv_filelist_reader as jax_reader
from everyvoice_tpu_torch.config import fs2_training_config
from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset, imbalanced_sample_weights
from everyvoice_tpu_torch.onchip import write_corpus
from everyvoice_tpu_torch.text.lookups import lookuptables_from_data
from everyvoice_tpu_torch.train.checkpoint import (
    InvalidConfiguration,
    changed_config_values,
    load_checkpoint,
    resume_mode,
)
from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
from everyvoice_tpu_torch.train.tensorboard import masked_crc
from everyvoice_tpu_torch.utils import generic_psv_filelist_reader
from model_stubs import CONTACT, SMALL_FS2_MODEL

STEPS = ("audio", "text", "spec", "attn", "energy", "pitch")
N_UTTS = 12  # 10 for training, 2 for validation


class NoDropPostnet(jax_layers.Postnet):
    dropout: float = 0.0


def _raw(root, **training) -> dict:
    model = {**SMALL_FS2_MODEL, "max_length": 200}
    for stack in ("encoder", "decoder"):
        model[stack] = {**model[stack], "dropout": 0.0}
    model["variance_predictors"] = {k: {**v, "dropout": 0.0}
                                    for k, v in model["variance_predictors"].items()}
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
            "batch_size": 4, "val_check_interval": 1000, "save_top_k_ckpts": 2,
            "optimizer": {"learning_rate": 1e-3, "warmup_steps": 4},
            "training_filelist": str(pre / "training_filelist.psv"),
            "validation_filelist": str(pre / "validation_filelist.psv"),
            "logger": {"save_dir": str(root / "logs"), "name": "parity"},
            **training,
        },
    }


def _lists(raw):
    t = raw["training"]
    return jax_reader(t["training_filelist"]), jax_reader(t["validation_filelist"])


def _jax_trainer(raw, run_dir):
    config = FastSpeech2Config(**raw)
    train, val = _lists(raw)
    lang2id, speaker2id = jax_lookups((train, val))
    ds = JaxDataset(train, config, lang2id, speaker2id)
    vds = JaxDataset(val, config, lang2id, speaker2id, text_processor=ds.text_processor)
    return JaxTrainer(config, ds, vds, lang2id, speaker2id,
                      mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=run_dir)


def _port_trainer(raw, run_dir):
    config = fs2_training_config(raw)
    train = generic_psv_filelist_reader(raw["training"]["training_filelist"])
    val = generic_psv_filelist_reader(raw["training"]["validation_filelist"])
    lang2id, speaker2id = lookuptables_from_data((train, val))
    ds = FastSpeech2Dataset(train, config, lang2id, speaker2id)
    vds = FastSpeech2Dataset(val, config, lang2id, speaker2id, text_processor=ds.text_processor)
    trainer = FastSpeech2Trainer(config, ds, vds, lang2id, speaker2id, run_dir=run_dir,
                                 device="cpu")
    trainer.model.postnet.drop.p = 0.0  # as the JAX side's NoDropPostnet
    return trainer


def _metrics(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop")
    write_corpus(root / "corpus", N_UTTS, seed=5)
    raw = _raw(root)
    JaxPreprocessor(FastSpeech2Config(**raw)).preprocess(to_process=STEPS)
    return root


@pytest.fixture(scope="module")
def runs(corpus):
    """Both trainers, three steps each from one JAX-initialised checkpoint."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fs2_model, "Postnet", NoDropPostnet)
        raw = _raw(corpus)
        init = _jax_trainer(raw, corpus / "init")
        start = jax_save(corpus / "start.ckpt", "FastSpeech2", init.config, init.init_params())
        raw = _raw(corpus, finetune_checkpoint=str(start))
        jax_run = _jax_trainer(raw, corpus / "jax_run")
        jax_run.fit(max_steps=3, log_every=1)
        port = _port_trainer(raw, corpus / "port_run")
        port.fit(max_steps=3, log_every=1)
    return {"root": corpus, "jax": jax_run, "port": port}


def _same_batches(a_iter, b_iter):
    n = 0
    for a, b in zip(a_iter, b_iter, strict=True):
        assert a["basenames"] == b["basenames"]
        assert set(a) == set(b)
        for key in a:
            if key != "basenames":
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        n += 1
    return n


@pytest.mark.parametrize("mode", ["seed0", "seed1", "weighted", "ragged"])
def test_dataset_batches_are_bit_equal(corpus, mode):
    raw = _raw(corpus)
    train, val = _lists(raw)
    jax_ds = JaxDataset(train, FastSpeech2Config(**raw), *jax_lookups((train, val)))
    port_ds = FastSpeech2Dataset(train, fs2_training_config(raw),
                                 *lookuptables_from_data((train, val)))
    assert port_ds.max_text_len == jax_ds.max_text_len
    labels = [f'{it.get("language")}/{it.get("speaker")}' for it in port_ds.items]
    kwargs = {
        "seed0": dict(batch_size=4, seed=0, drop_last=True),
        "seed1": dict(batch_size=4, seed=1, drop_last=True),
        "weighted": dict(batch_size=4, seed=2, drop_last=True),
        "ragged": dict(batch_size=3, shuffle=False),
    }[mode]
    if mode == "weighted":
        np.testing.assert_array_equal(imbalanced_sample_weights(labels), jax_weights(labels))
        kwargs["weights"] = imbalanced_sample_weights(labels)
    n = _same_batches(jax_ds.batches(**kwargs), port_ds.batches(**kwargs))
    assert n == (4 if mode == "ragged" else 2)


def test_first_steps_match_jax(runs):
    want = {r["step"]: r for r in _metrics(runs["jax"].run_dir) if "training/total" in r}
    got = {r["step"]: r for r in _metrics(runs["port"].run_dir) if "training/total" in r}
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for step in want:
        for key, value in want[step].items():
            if key.startswith("training/"):
                assert got[step][key] == pytest.approx(value, rel=1e-4), (step, key)
    assert got[1]["training/total"] > 0 and np.isfinite(got[3]["training/total"])


def test_metrics_keys_and_hparams_match(runs):
    def kinds(run_dir):
        return sorted({tuple(sorted(r)) for r in _metrics(run_dir)})

    assert kinds(runs["port"].run_dir) == kinds(runs["jax"].run_dir)
    want = yaml.safe_load((runs["jax"].run_dir / "hparams.yaml").read_text())
    got = yaml.safe_load((runs["port"].run_dir / "hparams.yaml").read_text())
    assert got == want


def _records(path):
    blob = path.read_bytes()
    pos, out = 0, []
    while pos < len(blob):
        header = blob[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", blob[pos + 8 : pos + 12])[0] == masked_crc(header)
        data = blob[pos + 12 : pos + 12 + length]
        assert struct.unpack("<I", blob[pos + 12 + length : pos + 16 + length])[0] == masked_crc(data)
        out.append(data)
        pos += 16 + length
    return out


def test_event_file_reads_back(runs):
    [port_events] = list(runs["port"].run_dir.glob("events.out.tfevents.*"))
    [jax_events] = list(runs["jax"].run_dir.glob("events.out.tfevents.*"))
    got, want = _records(port_events), _records(jax_events)
    assert len(got) == len(want)
    assert b"brain.Event:2" in got[0]
    for tag in (b"training/total", b"training/lr", b"validation/mel_predicted",
                b"validation/mel_target"):
        assert sum(tag in r for r in got) == sum(tag in r for r in want) > 0, tag
    png = next(r for r in got if b"validation/mel_target" in r)
    assert b"\x89PNG\r\n\x1a\n" in png and b"IEND" in png


def test_port_checkpoint_resumes_in_jax(runs):
    """The JAX trainer restores the port's optimizer state (flax checks the
    tree against its own) and goes on counting from it."""
    root = runs["root"]
    last = runs["port"].ckpt_dir / "last.ckpt"
    ckpt = load_checkpoint(last)
    assert ckpt["global_step"] == 3 and "alignment" in ckpt["state_dict"]["params"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fs2_model, "Postnet", NoDropPostnet)
        jax_run = _jax_trainer(_raw(root, finetune_checkpoint=str(last)), root / "jax_resumed")
        jax_run.fit(max_steps=4, log_every=1)
    assert [r["step"] for r in _metrics(jax_run.run_dir) if "training/total" in r] == [4]
    resumed = jax_load(jax_run.ckpt_dir / "last.ckpt")
    opt = resumed["optimizer_states"]
    assert (resumed["global_step"], int(opt["0"]["count"]), int(opt["2"]["count"])) == (4, 4, 4)


def test_jax_checkpoint_resumes_in_port(runs):
    root = runs["root"]
    last = runs["jax"].ckpt_dir / "last.ckpt"
    port = _port_trainer(_raw(root, finetune_checkpoint=str(last)), root / "port_resumed")
    port.fit(max_steps=4, log_every=1)
    assert port.resumed == "full"
    assert [r["step"] for r in _metrics(port.run_dir) if "training/total" in r] == [4]
    resumed = load_checkpoint(port.ckpt_dir / "last.ckpt")
    opt = resumed["optimizer_states"]
    assert (resumed["global_step"], int(opt["0"]["count"]), int(opt["2"]["count"])) == (4, 4, 4)
    # The moments written back keep the JAX trainer's tree, leaf for leaf.
    want = jax.tree.structure(jax_load(last)["optimizer_states"])
    assert jax.tree.structure(opt) == want


def test_changed_config_values_ignores_additions():
    old = {"model": {"dim": 256, "old_only": 1}, "training": {}}
    new = {"model": {"dim": 256, "new_only": 2}, "training": {}}
    assert changed_config_values(old, new) == []
    assert resume_mode(old, new, "FastSpeech2") == "full"
    # StyleTTS2 skips the gate even with an arch diff (two-stage recipe)
    assert resume_mode({"model": {"dim": 128}}, new, "StyleTTS2Module") == "full"


def test_arch_diff_raises():
    old = {"model": {"dim": 256}, "training": {"optimizer": {"lr": 1e-4}}}
    new = {"model": {"dim": 512}, "training": {"optimizer": {"lr": 1e-4}}}
    with pytest.raises(InvalidConfiguration, match="architecture"):
        resume_mode(old, new, "FastSpeech2")


def test_optimizer_diff_restarts():
    old = {"model": {"dim": 256}, "training": {"optimizer": {"lr": 1e-4}}}
    new = {"model": {"dim": 256}, "training": {"optimizer": {"lr": 5e-5}}}
    assert resume_mode(old, new, "FastSpeech2") == "fresh_optimizer"


def test_steps_per_execution_and_profile(runs):
    """Two steps from one stacked transfer give the single steps' losses
    (the second step's are logged), and ``profile_steps`` leaves a trace."""
    root = runs["root"]
    raw = _raw(root, finetune_checkpoint=str(root / "start.ckpt"))
    port = _port_trainer(raw, root / "port_stacked")
    port.fit(max_steps=4, log_every=1, profile_steps=1, steps_per_execution=2)
    got = {r["step"]: r for r in _metrics(port.run_dir) if "training/total" in r}
    want = {r["step"]: r for r in _metrics(runs["port"].run_dir) if "training/total" in r}
    assert sorted(got) == [2, 4]
    for key, value in want[2].items():
        if key.startswith("training/"):
            assert got[2][key] == pytest.approx(value, rel=1e-6), key
    assert (port.run_dir / "profile" / "trace.json").stat().st_size > 0

"""The port stands alone: importing every module of ``everyvoice_tpu_torch``,
running a small CPU synthesis, a small CPU preprocess and two CPU training
steps on its artifacts loads nothing of JAX, flax, pydantic, regex, msgpack,
PyYAML, PIL or ``everyvoice_tpu``. This file's process has imported JAX
already (tests/conftest.py), so the check runs in a fresh interpreter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "pydantic", "regex", "msgpack", "yaml", "PIL", "everyvoice_tpu")

CHILD = """
import importlib, json, pkgutil, sys, tempfile
from pathlib import Path
import torch
import everyvoice_tpu_torch
for mod in pkgutil.walk_packages(everyvoice_tpu_torch.__path__, "everyvoice_tpu_torch."):
    importlib.import_module(mod.name)
from everyvoice_tpu_torch.config import fs2_config, hifigan_config
from everyvoice_tpu_torch.convert import torch_to_flax
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint

torch.manual_seed(0)
conformer = {"layers": 1, "input_dim": 16, "feedforward_dim": 32, "conv_kernel_size": 3}
vp = {"n_layers": 1}
fs2_raw = {"model": {"encoder": conformer, "decoder": conformer, "max_length": 64,
                     "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}},
           "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
voc_raw = {"model": {"upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                     "resblock_dilation_sizes": [[1, 3]]}}
cfg = fs2_config(fs2_raw)
fs2 = FastSpeech2.from_config(cfg, len(TextProcessor(cfg["text"]).symbols))
voc = HiFiGANGenerator.from_config(hifigan_config(voc_raw))
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    f = save_checkpoint(tmp / "fs2.ckpt", "FastSpeech2", fs2_raw, torch_to_flax(fs2.state_dict(), fs2))
    v = save_checkpoint(tmp / "voc.ckpt", "HiFiGANGenerator", voc_raw, torch_to_flax(voc.state_dict(), voc))
    synth = Synthesizer(f, v, device="cpu")
    results = synth.synthesize(["Hello world.", "A second, slightly longer text."])
    written = synth.write_outputs(results, tmp / "out", ("wav", "spec"))

    from everyvoice_tpu_torch.onchip import write_corpus
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    filelist, wavs, _ = write_corpus(tmp / "corpus", 2)
    pre = Preprocessor({"preprocessing": {"save_dir": str(tmp / "pre"), "source_data": [
        {"permissions_obtained": True, "data_dir": str(wavs), "filelist": str(filelist)}]},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}, device="cpu")
    pre.preprocess(to_process=("audio", "text", "spec", "attn", "energy", "pitch"), cpus=2)
    specs = len(list((tmp / "pre" / "spec").glob("*.npy")))

    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec
    small = {"encoder": conformer, "decoder": conformer, "max_length": 64,
             "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}}
    trainer = train_text_to_spec({
        "contact": {"contact_name": "Isolation", "contact_email": "iso@example.org"},
        "model": small, "preprocessing": {"save_dir": str(tmp / "pre")},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "training": {"batch_size": 1, "max_steps": 2,
                     "training_filelist": str(tmp / "pre" / "training_filelist.psv"),
                     "validation_filelist": str(tmp / "pre" / "validation_filelist.psv"),
                     "vocoder_path": str(v), "logger": {"save_dir": str(tmp / "logs")}},
    }, device="cpu", log_every=1)
    steps = trainer.global_step
    ckpts = sorted(p.name for p in trainer.ckpt_dir.iterdir())
roots = sorted({name.split(".")[0] for name in sys.modules})
print(json.dumps({"roots": roots, "written": len(written), "specs": specs,
                  "samples": [len(r["wav"]) for r in results], "steps": steps,
                  "ckpts": ckpts}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["written"] == 4
    assert report["specs"] == 2
    assert all(n > 0 for n in report["samples"])
    assert report["steps"] == 2 and "last.ckpt" in report["ckpts"]
    loaded = set(report["roots"])
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable here")
    from everyvoice_tpu_torch.device import resolve_device
    from everyvoice_tpu_torch.models.fs2.synthesize import (
        Synthesizer,
        load_fs2_from_checkpoint,
        load_vocoder_from_checkpoint,
    )
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec

    missing = tmp_path / "never-read.ckpt"  # the device is resolved first
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_text_to_spec({"training": {"training_filelist": str(missing)}})
    run_dir = tmp_path / "never-run"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastSpeech2Trainer({"training": {}}, None, None, {}, {}, run_dir=run_dir)
    assert not run_dir.exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(missing, missing)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Preprocessor({"preprocessing": {"save_dir": str(tmp_path / "never-made")}})
    assert not (tmp_path / "never-made").exists()
    for load in (load_fs2_from_checkpoint, load_vocoder_from_checkpoint):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(missing)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_imports_nothing_of_jax():
    source = (REPO / "chip_smoke.py").read_text()
    for name in FORBIDDEN:
        assert f"import {name}" not in source and f"from {name} " not in source
        assert f"from {name}." not in source

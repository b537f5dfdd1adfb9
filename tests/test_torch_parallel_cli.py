"""The port's ``train`` command across processes on the CPU: from a fresh
project (``onchip.write_project``, the port's ``preprocess``),
``train text-to-spec -a cpu -d 2 -s fsdp`` and ``train spec-to-wav -a cpu
-d 2`` each start two gloo ranks and leave one run directory, written by
rank 0, whose checkpoints the JAX package's loader reads; a failing worker
fails the command."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from everyvoice_tpu.train import load_checkpoint as jax_load
from everyvoice_tpu_torch import cli
from everyvoice_tpu_torch.onchip import CONFIG_STEMS, write_corpus, write_project

REPO = Path(__file__).resolve().parents[1]
FS2 = ["-c", "model.encoder.input_dim=128", "-c", "model.encoder.feedforward_dim=256",
       "-c", "model.encoder.layers=1", "-c", "model.decoder.input_dim=128",
       "-c", "model.decoder.feedforward_dim=256", "-c", "model.decoder.layers=1",
       "-c", "model.variance_predictors.pitch.input_dim=128",
       "-c", "model.variance_predictors.energy.input_dim=128",
       "-c", "model.variance_predictors.duration.input_dim=128",
       "-c", "training.batch_size=4", "-c", "training.max_steps=2"]
VOCODER = ["-c", "model.upsample_initial_channel=32", "-c", "model.mpd_layers=[2]",
           "-c", "model.msd_layers=0", "-c", "preprocessing.audio.vocoder_segment_size=1024",
           "-c", "training.batch_size=2", "-c", "training.max_steps=2"]


def _train(config, kind, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for key in ("EVERYVOICE_DEVICE", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    return subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "train", kind,
                           str(config), "-a", "cpu", "-d", "2", *args],
                          capture_output=True, text=True, timeout=timeout, env=env)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    filelist, wavs, _ = write_corpus(root / "corpus", 12, seed=11)
    config_dir = write_project(root, filelist, wavs,
                               symbols={"characters": list("abcdefghijklmnopqrstuvwxyz")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVERYVOICE_DEVICE", "cpu")
        assert cli.main(["preprocess", "text-to-spec",
                         str(config_dir / f"{CONFIG_STEMS['text-to-spec']}.yaml")]) == 0
    return config_dir


def _runs(config_dir, name):
    logs = config_dir.parent / "logs_and_checkpoints"
    return [p for p in logs.glob(f"{name}/*/*") if p.is_dir()]


def test_fsdp_text_to_spec_on_two_ranks(project):
    proc = _train(project / f"{CONFIG_STEMS['text-to-spec']}.yaml", "text-to-spec",
                  "-s", "fsdp", *FS2, "-c", "training.logger.name=fs2_fsdp")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Training complete") == 1
    [run] = _runs(project, "fs2_fsdp")
    assert len(list(run.glob("events.out.tfevents.*"))) == 1 and (run / "hparams.yaml").exists()
    ckpt = jax_load(run / "checkpoints" / "last.ckpt")
    assert ckpt["global_step"] == 2
    assert int(np.asarray(ckpt["optimizer_states"]["0"]["count"])) == 2
    kernel = ckpt["state_dict"]["params"]["encoder"]["ConformerBlock_0"]["FeedForwardModule_0"]
    assert np.asarray(kernel["Dense_0"]["kernel"]).shape == (128, 256)  # whole, flax layout


def test_two_rank_vocoder(project):
    proc = _train(project / f"{CONFIG_STEMS['spec-to-wav']}.yaml", "spec-to-wav", *VOCODER,
                  "-c", "training.logger.name=voc_ddp")
    assert proc.returncode == 0, proc.stderr[-3000:]
    [run] = _runs(project, "voc_ddp")
    names = sorted(p.name for p in (run / "checkpoints").iterdir())
    assert names[-1] == "last.ckpt" and len(names) == 2
    ckpt = jax_load(run / "checkpoints" / "last.ckpt")
    assert ckpt["global_step"] == 2
    assert set(ckpt["state_dict"]) == {"generator", "discriminators"}
    assert set(ckpt["optimizer_states"]) == {"gen", "disc"}


def test_a_failing_worker_fails_the_command(project):
    # 128 features do not split into 3 heads: each rank's first step raises.
    proc = _train(project / f"{CONFIG_STEMS['text-to-spec']}.yaml", "text-to-spec", *FS2,
                  "-c", "model.encoder.heads=3", "-c", "training.logger.name=fails")
    assert proc.returncode == 1
    assert "a training worker failed" in proc.stderr
    assert not any((run / "checkpoints" / "last.ckpt").exists()
                   for run in _runs(project, "fails"))


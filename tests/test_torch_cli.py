"""The port's command line (everyvoice_tpu_torch/cli.py) against the JAX
package's (everyvoice_tpu/cli.py), on the CPU, on the same files: projects
the JAX wizard writes (``write_config_package``, YAML and JSON) over a
seeded ``onchip.write_corpus`` corpus, tiny checkpoints the port's CLI
trains on it, and the session's ``dummy_ckpts`` that the JAX package wrote.
The JAX CLI runs through click's ``CliRunner``, the port's through
``cli.main`` under ``EVERYVOICE_DEVICE=cpu``, each from a working directory
outside ``config/``.

Tolerances, with their reasons:
- loaded configs, checkpoint headers, file names, printed text, exit codes
  and checkpoints written by ``export`` and ``rename-speaker``: exact;
- preprocessing artifacts: ``test_torch_preprocess.py``'s (spec 1e-4
  absolute; energy and pitch 1e-3 on at least 99% of frames; priors 1e-6;
  stats 1e-4 relative; filelists byte-identical);
- synthesized wavs: one 16-bit step (``test_torch_synthesize.py``); specs
  1e-4;
- ``check data``'s losses: 1e-4 relative (float32 forwards);
- ``evaluate``'s JSON: 1e-6 (rounded metrics from float32 DSP).
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from everyvoice_tpu.cli import _load_config as jax_load_config
from everyvoice_tpu.cli import main as jax_main
from everyvoice_tpu.wizard.steps import write_config_package
from everyvoice_tpu_torch import cli
from everyvoice_tpu_torch.config_files import ConfigError, load_config_from_path
from everyvoice_tpu_torch.dsp import read_wav, write_wav
from everyvoice_tpu_torch.onchip import write_corpus, write_project
from everyvoice_tpu_torch.utils import generic_psv_filelist_reader, load_config_file

REPO = Path(__file__).resolve().parents[1]
LETTERS = list("abcdefghijklmnopqrstuvwxyz")
CONTACT = {"contact_name": "Test Runner", "contact_email": "info@everyvoice.ca"}
UTTERANCES = 6
KINDS = ("text-to-spec", "spec-to-wav")
TINY = {
    "text-to-spec": [
        "model.encoder.layers=1", "model.encoder.input_dim=16", "model.encoder.feedforward_dim=32",
        "model.encoder.conv_kernel_size=3", "model.decoder.layers=1",
        "model.decoder.input_dim=16", "model.decoder.feedforward_dim=32",
        "model.decoder.conv_kernel_size=3", "model.variance_predictors.energy.n_layers=1",
        "model.variance_predictors.energy.input_dim=16",
        "model.variance_predictors.pitch.n_layers=1",
        "model.variance_predictors.pitch.input_dim=16",
        "model.variance_predictors.duration.n_layers=1",
        "model.variance_predictors.duration.input_dim=16",
        "model.max_length=128", "training.batch_size=2", "training.max_steps=2"],
    "spec-to-wav": [
        "model.upsample_initial_channel=16", "model.resblock_kernel_sizes=[3]",
        "model.resblock_dilation_sizes=[[1, 3]]", "model.mpd_layers=[2]", "model.msd_layers=1",
        "preprocessing.audio.vocoder_segment_size=1024", "training.batch_size=2",
        "training.max_steps=2"],
    # StyleTTS2's decoder is 512 channels whatever the config says; one
    # upsampling stage and an iSTFT of hop 32 keep it short
    "text-to-wav": [
        "model.hidden_dim=32", "model.style_dim=16", "model.decoder.mpd_layers=[2]",
        "model.decoder.msd_layers=1", "model.decoder.upsample_rates=[8]",
        "model.decoder.upsample_kernel_sizes=[16]", "model.decoder.gen_istft_n_fft=64",
        "model.decoder.gen_istft_hop_size=32", "model.diffusion.transformer.num_layers=1",
        "model.diffusion.transformer.num_heads=2", "model.diffusion.transformer.head_features=8",
        "training.max_len=48", "training.decoder_segment_frames=16", "training.batch_size=2",
        "training.max_steps=2", "training.epochs_1st=1", "training.epochs_2nd=1",
        "training.save_top_k_ckpts=0"],
}


def wizard_state(root: Path, name: str, rows: list, wavs: Path) -> dict:
    return {"name": name, "output_path": str(root), **CONTACT, "datasets": [
        {"label": "ds", "rows": rows, "data_dir": str(wavs), "symbols": {"characters": LETTERS}}]}


def jax_cli(*args):
    """The JAX CLI through CliRunner, with EVERYVOICE_DEVICE unset (the
    test process's JAX is on the CPU already)."""
    saved = os.environ.pop("EVERYVOICE_DEVICE", None)
    try:
        return CliRunner().invoke(jax_main, [str(a) for a in args])
    finally:
        if saved is not None:
            os.environ["EVERYVOICE_DEVICE"] = saved


def overrides(kind: str) -> list:
    return [x for o in TINY[kind] for x in ("-c", o)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A seeded corpus and three wizard projects over it: ``jax`` and
    ``port`` (YAML, one per package's preprocessing) and ``json``."""
    root = tmp_path_factory.mktemp("cli")
    filelist, wavs, _ = write_corpus(root / "corpus", UTTERANCES)
    rows = generic_psv_filelist_reader(filelist)
    configs = {}
    for name, fmt in (("jax", "yaml"), ("port", "yaml"), ("json", "json")):
        write_config_package(wizard_state(root, name, rows, wavs), fmt)
        configs[name] = root / name / "config"
    (root / "elsewhere").mkdir()
    return {"root": root, "filelist": filelist, "wavs": wavs, "rows": rows, "configs": configs,
            "cwd": root / "elsewhere"}


def config_path(world, project: str, kind: str) -> Path:
    suffix = ".json" if project == "json" else ".yaml"
    return world["configs"][project] / f"everyvoice-{kind}{suffix}"


@pytest.fixture
def port_cli(monkeypatch, world, capsys):
    """``cli.main`` from the other working directory, on the CPU; returns
    (exit code, stdout, stderr)."""
    monkeypatch.chdir(world["cwd"])
    monkeypatch.setenv("EVERYVOICE_DEVICE", "cpu")

    def run(*args):
        capsys.readouterr()
        rc = cli.main([str(a) for a in args])
        out = capsys.readouterr()
        return rc, out.out, out.err

    return run


@pytest.fixture(scope="module")
def preprocessed(world):
    """Both CLIs' ``preprocess text-to-spec`` on their own project."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(world["cwd"])
        result = jax_cli("preprocess", "text-to-spec", config_path(world, "jax", "text-to-spec"))
        assert result.exit_code == 0, result.output
        mp.setenv("EVERYVOICE_DEVICE", "cpu")
        assert cli.main(["preprocess", "text-to-spec",
                         str(config_path(world, "port", "text-to-spec"))]) == 0
    return {name: world["root"] / name / "preprocessed" for name in ("jax", "port")}


@pytest.fixture(scope="module")
def trained(world, preprocessed):
    """Two-step tiny runs of both port trainers through the CLI, on the CPU
    by ``-a cpu`` (no EVERYVOICE_DEVICE), and the vocoder's generator
    exported by the JAX CLI: the checkpoints the synthesis tests serve."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(world["cwd"])
        mp.delenv("EVERYVOICE_DEVICE", raising=False)
        torch.manual_seed(0)
        for kind, name in (("text-to-spec", "fs2"), ("spec-to-wav", "vocoder")):
            args = [*overrides(kind), "-c", f"training.logger.name={name}"]
            assert cli.main(["train", kind, str(config_path(world, "port", kind)), "-a", "cpu",
                             *args]) == 0
            [out[kind]] = (world["root"] / "port" / "logs_and_checkpoints").glob(
                f"{name}/base/*/checkpoints/last.ckpt")
    out["generator"] = world["root"] / "generator.ckpt"
    assert jax_cli("export", "spec-to-wav", out["spec-to-wav"], out["generator"]).exit_code == 0
    return out


@pytest.fixture(scope="module")
def st2_world(world):
    """Two more wizard projects over the corpus (``st2jax``, ``st2port``)
    whose text-to-wav config takes out-of-domain text from a plain-text
    file and from the validation split, each preprocessed by its package's
    ``preprocess text-to-wav`` (the default steps, ood included)."""
    from everyvoice_tpu_torch.onchip import TEXTS
    from everyvoice_tpu_torch.utils import write_config_file

    root = world["root"]
    (root / "ood.txt").write_text("\n".join(TEXTS) + "\n", encoding="utf8")
    configs, printed = {}, {}
    for name in ("st2jax", "st2port"):
        write_config_package(wizard_state(root, name, world["rows"], world["wavs"]), "yaml")
        path = root / name / "config" / "everyvoice-text-to-wav.yaml"
        data = load_config_file(path)
        data["training"]["ood_raw_data"] = {"default": {"local_path": str(root / "ood.txt")}}
        data["training"]["use_validation_as_ood"] = True
        write_config_file(path, data)
        configs[name] = path
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(world["cwd"])
        result = jax_cli("preprocess", "text-to-wav", configs["st2jax"])
        assert result.exit_code == 0, result.output
        printed["jax"] = result.output
        mp.setenv("EVERYVOICE_DEVICE", "cpu")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["preprocess", "text-to-wav", str(configs["st2port"])]) == 0
        printed["port"] = out.getvalue()
    return {"configs": configs, "printed": printed,
            "preprocessed": {k: root / f"st2{k}" / "preprocessed" for k in ("jax", "port")}}


# ---------------------------------------------------------------------------
# config files


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_write_project_writes_what_the_wizard_writes(world, tmp_path, fmt):
    write_config_package(wizard_state(tmp_path / "jax", "proj", world["rows"], world["wavs"]), fmt)
    write_project(tmp_path / "port", world["filelist"], world["wavs"], name="proj", label="ds",
                  symbols={"characters": LETTERS}, contact=CONTACT, fmt=fmt)
    jax_dir, port_dir = tmp_path / "jax" / "proj", tmp_path / "port" / "proj"
    names = sorted(p.name for p in (jax_dir / "config").iterdir())
    assert names == sorted(p.name for p in (port_dir / "config").iterdir()) and len(names) == 5
    for name in names:
        assert load_config_file(port_dir / "config" / name) == load_config_file(
            jax_dir / "config" / name), name
    assert (port_dir / "ds-filelist.psv").read_bytes() == (jax_dir / "ds-filelist.psv").read_bytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("project", ["port", "json"])
@pytest.mark.parametrize("with_overrides", [False, True])
def test_loaded_config_equals_the_jax_dump(world, monkeypatch, kind, project, with_overrides):
    monkeypatch.chdir(world["cwd"])
    extra = TINY[kind] + ["preprocessing.source_data.0.label=other",
                          "training.optimizer.learning_rate=0.5"] if with_overrides else []
    path = config_path(world, project, kind)
    want = jax_load_config(kind, path, extra).model_dump(mode="json")
    got = load_config_from_path(kind, path, extra)
    assert got == want
    assert got["training"]["training_filelist"] == str(
        (world["root"] / project / "preprocessed" / "training_filelist.psv").resolve())


@pytest.mark.parametrize("project", ["port", "json"])
def test_shared_configs_equal_the_jax_dump(world, monkeypatch, project):
    from everyvoice_tpu.config import PreprocessingConfig, TextConfig
    from everyvoice_tpu_torch.config_files import load_text_config_from_path

    monkeypatch.chdir(world["cwd"])
    suffix = ".json" if project == "json" else ".yaml"
    data = world["configs"][project] / f"everyvoice-shared-data{suffix}"
    want = PreprocessingConfig.load_config_from_path(data).model_dump(mode="json")
    assert load_config_from_path("preprocessing", data)["preprocessing"] == want
    text = world["configs"][project] / f"everyvoice-shared-text{suffix}"
    want = TextConfig.load_config_from_path(text).model_dump(mode="json")
    assert load_text_config_from_path(text) == want


def _bad_config(world, case: str) -> Path:
    """A copy of the port project's text-to-spec config with one fault."""
    config_dir = world["configs"]["port"]
    data = load_config_file(config_dir / "everyvoice-text-to-spec.yaml")
    if case == "no contact":
        del data["contact"]
    elif case == "no permission":
        shared = load_config_file(config_dir / "everyvoice-shared-data.yaml")
        shared["source_data"][0]["permissions_obtained"] = False
        (config_dir / "bad-data.yaml").write_text(json.dumps(shared))
        data["path_to_preprocessing_config_file"] = "bad-data.yaml"
    elif case == "misspelt key":
        data["training"]["max_step"] = 3
    elif case == "misspelt nested key":
        data["model"]["encoder"] = {"layer": 2}
    elif case == "version 2":
        data["VERSION"] = "2.0"
    elif case == "missing partial":
        data["path_to_text_config_file"] = "nowhere.yaml"
    elif case == "bad e-mail":
        data["contact"]["contact_email"] = "nobody"
    path = config_dir / f"bad-{case.replace(' ', '-')}.yaml"
    path.write_text(json.dumps(data))  # JSON is YAML
    return path


@pytest.mark.parametrize("case", ["no contact", "no permission", "misspelt key",
                                  "misspelt nested key", "version 2", "missing partial",
                                  "bad e-mail"])
def test_config_faults_raise_in_both(world, port_cli, case):
    path = _bad_config(world, case)
    with pytest.raises(Exception):
        jax_load_config("text-to-spec", path, ())
    with pytest.raises(ConfigError):
        load_config_from_path("text-to-spec", path)
    assert jax_cli("preprocess", "text-to-spec", path).exit_code != 0
    rc, _, err = port_cli("preprocess", "text-to-spec", path)
    assert rc == 1 and err.startswith("Error: ")


def test_an_override_with_a_misspelt_key_raises_in_both(world, monkeypatch):
    monkeypatch.chdir(world["cwd"])
    path = config_path(world, "port", "text-to-spec")
    with pytest.raises(Exception):
        jax_load_config("text-to-spec", path, ["training.max_step=3"])
    with pytest.raises(ConfigError, match="max_step"):
        load_config_from_path("text-to-spec", path, ["training.max_step=3"])


# ---------------------------------------------------------------------------
# preprocess and train


def test_preprocess_artifacts_match(preprocessed):
    jax_dir, port_dir = preprocessed["jax"], preprocessed["port"]
    for name in ("filelist.psv", "training_filelist.psv", "validation_filelist.psv"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.npy"))
    assert names == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*.npy"))
    assert len(names) == 4 * UTTERANCES
    for name in names:
        want, got = np.load(jax_dir / name), np.load(port_dir / name)
        assert got.shape == want.shape, name
        if name.parts[0] == "spec":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        elif name.parts[0] == "attn":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            close = np.abs(got - want) <= 1e-3 * np.maximum(np.abs(want), 1.0)
            assert close.mean() >= 0.99, name
    want = json.loads((jax_dir / "stats.json").read_text())
    got = json.loads((port_dir / "stats.json").read_text())
    for kind in ("energy", "pitch"):
        for key, value in want[kind].items():
            np.testing.assert_allclose(got[kind][key], value, rtol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_trained_checkpoints_carry_the_jax_config(world, trained, monkeypatch, kind):
    from everyvoice_tpu.train.checkpoint import load_checkpoint_header as jax_header

    monkeypatch.chdir(world["cwd"])
    extra = TINY[kind] + [f"training.logger.name={'fs2' if kind == 'text-to-spec' else 'vocoder'}"]
    want = jax_load_config(kind, config_path(world, "port", kind), extra).model_checkpoint_dump()
    header = jax_header(trained[kind])
    assert header["hyper_parameters"]["config"] == want
    assert header["global_step"] == 2


def test_preprocess_text_to_wav_writes_what_the_jax_cli_writes(st2_world):
    """The same artifacts and split as text-to-spec's, and the ood step's
    ``ood/default.psv``: the text file's long sentences, then the
    validation split's texts (all shorter than ``OOD_min_length``, kept)."""
    jax_dir, port_dir = st2_world["preprocessed"]["jax"], st2_world["preprocessed"]["port"]

    def names(root):
        return sorted(p.relative_to(root) for p in root.rglob("*")
                      if p.is_file() and p.suffix in (".psv", ".npy", ".wav"))

    assert names(port_dir) == names(jax_dir)
    for name in ("filelist.psv", "training_filelist.psv", "validation_filelist.psv",
                 "ood/default.psv"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    assert len((port_dir / "ood" / "default.psv").read_text().splitlines()) > 2
    for printed in st2_world["printed"].values():
        assert "Wrote OOD text for languages: default" in printed


@pytest.fixture
def one_torch_thread():
    """torch on one thread beside the other test workers: StyleTTS2's
    512-channel decoder on every core of a shared machine oversubscribes
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_text_to_wav_both_stages_on_the_cpu(world, st2_world, monkeypatch, caplog,
                                                  tmp_path, one_torch_thread):
    """``train text-to-wav --mode first`` then ``--mode second`` with ``-a
    cpu``: the JAX trainer's run layout (the logger's directory, hparams,
    metrics, events and its ``stage-N-last.ckpt``), the JAX config and the
    stage in the headers, and stage 2 starting from stage 1's checkpoint."""
    from types import SimpleNamespace

    import jax
    import yaml

    from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
    from everyvoice_tpu.parallel import make_mesh
    from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
    from everyvoice_tpu.train.checkpoint import load_checkpoint_header as jax_header

    monkeypatch.chdir(world["cwd"])
    monkeypatch.delenv("EVERYVOICE_DEVICE", raising=False)
    caplog.set_level("INFO", logger="everyvoice_tpu_torch.models.styletts2.train")
    path = st2_world["configs"]["st2port"]
    config = jax_load_config("text-to-wav", path, TINY["text-to-wav"])
    lc = config.training.logger
    version_dir = Path(lc.save_dir) / lc.name / lc.version
    runs = {}
    for n, mode in enumerate(("first", "second"), start=1):
        assert cli.main(["train", "text-to-wav", str(path), "--mode", mode, "-a", "cpu",
                         *overrides("text-to-wav")]) == 0
        [ckpt] = version_dir.glob(f"*/checkpoints/stage-{n}-last.ckpt")
        runs[mode] = ckpt.parents[1]
    assert f"Loaded stage-1 checkpoint from {runs['first'] / 'checkpoints'}" in caplog.text
    tp = JaxTextProcessor(config.text)
    data = SimpleNamespace(text_processor=tp, n_symbols=len(tp.symbols))
    for mode, run in runs.items():
        jt = JaxTrainer(config, data, data, lang2id={"default": 0},
                        mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=tmp_path / mode,
                        mode=mode, compute_dtype="float32")
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
            jt.last_checkpoint_name]
        assert {"hparams.yaml", "metrics.jsonl"} <= {p.name for p in run.iterdir()}
        assert list(run.glob("events.out.tfevents.*"))
        assert (yaml.safe_load((run / "hparams.yaml").read_text())
                == yaml.safe_load((jt.run_dir / "hparams.yaml").read_text()))
        header = jax_header(run / "checkpoints" / jt.last_checkpoint_name)
        assert header["hyper_parameters"]["config"] == config.model_checkpoint_dump()
        assert header["stage"] == mode and header["global_step"] == 2


def test_train_text_to_wav_with_pretrained_components_on_the_cpu(
        world, st2_world, monkeypatch, caplog, tmp_path, one_torch_thread):
    """Both stages with ``-a cpu`` and the ``-c`` overrides that point at
    seeded components in the published formats (small widths): the JAX
    trainer's run layout, the components' geometries in both headers as the
    JAX trainer records them, the JDC's F0 and the ASR aligner's ``s2s``
    loss in stage 1, and the SLM's terms (out-of-domain ones included) in
    stage 2."""
    from types import SimpleNamespace

    import jax

    from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
    from everyvoice_tpu.parallel import make_mesh
    from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
    from everyvoice_tpu.train.checkpoint import load_checkpoint_header as jax_header
    from everyvoice_tpu_torch.onchip import pretrained_overrides, write_pretrained_components
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    small = {"asr": {"input_dim": 80, "hidden_dim": 32, "n_token": 178, "n_layers": 1,
                     "token_embedding_dim": 16},
             "plbert": {"vocab_size": 178, "hidden_size": 32, "num_layers": 1, "num_heads": 2,
                        "intermediate_size": 64, "embedding_size": 16,
                        "max_position_embeddings": 512},
             "wavlm": {"hidden_size": 32, "num_layers": 1, "num_heads": 2,
                       "intermediate_size": 64, "conv_dim": (16,) * 7,
                       "conv_kernel": (10, 3, 3, 3, 3, 2, 2), "conv_stride": (5, 2, 2, 2, 2, 2, 2),
                       "num_buckets": 32, "max_distance": 80, "num_conv_pos_embeddings": 15,
                       "num_conv_pos_embedding_groups": 4}}
    paths = write_pretrained_components(tmp_path / "pretrained", torch.Generator().manual_seed(1),
                                        **small)
    staged = pretrained_overrides(paths) + [
        "model.slm.hidden=32", "model.slm.nlayers=2", "model.slm.initial_channel=8",
        "training.losses.joint_epoch=0", "training.OOD_min_length=10",
        "training.logger.name=pretrained"]
    monkeypatch.chdir(world["cwd"])
    monkeypatch.delenv("EVERYVOICE_DEVICE", raising=False)
    caplog.set_level("INFO", logger="everyvoice_tpu_torch.models.styletts2.train")
    path = st2_world["configs"]["st2port"]
    options = TINY["text-to-wav"] + staged
    config = jax_load_config("text-to-wav", path, options)
    lc = config.training.logger
    version_dir = Path(lc.save_dir) / lc.name / lc.version
    runs = {}
    for n, mode in enumerate(("first", "second"), start=1):
        assert cli.main(["train", "text-to-wav", str(path), "--mode", mode, "-a", "cpu",
                         *[x for o in options for x in ("-c", o)]]) == 0
        [ckpt] = version_dir.glob(f"*/checkpoints/stage-{n}-last.ckpt")
        runs[mode] = ckpt.parents[1]
    assert f"Loaded stage-1 checkpoint from {runs['first'] / 'checkpoints'}" in caplog.text
    assert "SLM-adversarial training enabled" in caplog.text
    tp = JaxTextProcessor(config.text)
    data = SimpleNamespace(text_processor=tp, n_symbols=len(tp.symbols))
    for mode, run in runs.items():
        jt = JaxTrainer(config, data, data, lang2id={"default": 0},
                        mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=tmp_path / mode,
                        mode=mode, compute_dtype="float32")
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
            jt.last_checkpoint_name]
        header = jax_header(run / "checkpoints" / jt.last_checkpoint_name)
        assert header["pretrained_components"] == jt._ckpt_extra()["pretrained_components"]
        assert header["stage"] == mode and header["global_step"] == 2
        ckpt = load_checkpoint(run / "checkpoints" / jt.last_checkpoint_name)
        discriminators, opt = ckpt["state_dict"]["discriminators"], ckpt["optimizer_states"]
        assert ("slm" in discriminators) == ("slm" in opt["disc"]["0"]["mu"]) == (mode == "second")
        assert set(opt["gen"]["inner_states"]) == {"base", "bert", "ft"}
    assert "SLM-adversarial OOD bank: " in caplog.text
    shutil.rmtree(Path(lc.save_dir) / lc.name)  # about 2 GB of checkpoints


@pytest.mark.parametrize("extra", [[], ["é", "ß", "ŋ̊", "7", "x̩"]],
                         ids=["covered", "missing-symbols"])
def test_check_pretrained_symbols_matches(world, port_cli, tmp_path, extra):
    """The same report and exit code as the JAX CLI's: every symbol in the
    frozen table, or the missing ones with the substitutions suggested."""
    state = wizard_state(tmp_path, "symbols", world["rows"], world["wavs"])
    state["datasets"][0]["symbols"] = {"characters": LETTERS + extra}
    write_config_package(state, "yaml")
    path = tmp_path / "symbols" / "config" / "everyvoice-text-to-wav.yaml"
    want = jax_cli("check", "pretrained-symbols", path)
    rc, out, _ = port_cli("check", "pretrained-symbols", path)
    assert (rc, out) == (want.exit_code, want.output)
    assert rc == (1 if extra else 0)


def test_preprocess_refuses_a_huggingface_ood_source(st2_world, port_cli, tmp_path):
    """A HuggingFace OOD source needs the network: the ood step exits 1
    saying so, and names the local file to give instead."""
    from everyvoice_tpu_torch.utils import write_config_file

    data = load_config_file(st2_world["configs"]["st2port"])
    data["training"]["ood_raw_data"] = {"fra": {"hf": {"repo_id": "someone/ood-text"}}}
    path = st2_world["configs"]["st2port"].with_name("hf-ood.yaml")
    write_config_file(path, data)
    rc, _, err = port_cli("preprocess", "text-to-wav", path, "-s", "ood")
    assert rc == 1 and "network" in err and "ood_raw_data.fra.local_path" in err


def test_check_data_matches(world, trained, port_cli, tmp_path, monkeypatch):
    import jax

    from everyvoice_tpu.models.fs2 import synthesize as jax_synthesize

    plain = jax_synthesize.load_fs2_from_checkpoint

    def jitted(path):
        """The JAX CLI applies the model eagerly, item by item; jit it."""
        model, *rest = plain(path)
        return (type("Jitted", (), {"max_frames": model.max_frames,
                                    "apply": staticmethod(jax.jit(model.apply))})(), *rest)

    monkeypatch.setattr(jax_synthesize, "load_fs2_from_checkpoint", jitted)
    config = config_path(world, "port", "text-to-spec")
    result = jax_cli("check", "data", config, "--model-path", trained["text-to-spec"],
                     "-o", tmp_path / "jax.json")
    assert result.exit_code == 0, result.output
    rc, out, _ = port_cli("check", "data", config, "--model-path", trained["text-to-spec"],
                          "-o", tmp_path / "port.json")
    assert rc == 0 and "Worst 5 items by total loss:" in out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [r["basename"] for r in got] == [r["basename"] for r in want]
    assert len(got) == int(UTTERANCES * 0.9)
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for key in w:
            if key != "basename":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# synthesis, export, checkpoints


def _same_audio_files(jax_dir: Path, port_dir: Path) -> int:
    files = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*") if p.is_file())
    for name in files:
        a, b = jax_dir / name, port_dir / name
        if a.suffix == ".wav":
            ra, rb = a.read_bytes(), b.read_bytes()
            assert ra[:44] == rb[:44]
            pa, pb = (np.frombuffer(r[44:], "<i2").astype(int) for r in (ra, rb))
            assert np.abs(pa - pb).max() <= 1, name
        elif a.suffix == ".npy":
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=1e-4, atol=1e-4)
        else:
            assert b.read_text() == a.read_text(), name
    return len(files)


def test_synthesize_from_text_and_from_spec_match(trained, port_cli, tmp_path):
    texts = ["-t", "Hello world!", "-t", "The quick brown fox jumps over the lazy dog."]
    types = ["-O", "wav", "-O", "spec", "-O", "textgrid", "-O", "readalong-xml"]
    args = ["synthesize", "from-text", trained["text-to-spec"], *texts, *types,
            "--vocoder-path", trained["generator"]]
    result = jax_cli(*args, "-o", tmp_path / "jax")
    assert result.exit_code == 0, result.output
    rc, out, _ = port_cli(*args, "-o", tmp_path / "port")
    assert rc == 0 and out == result.stdout.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert _same_audio_files(tmp_path / "jax", tmp_path / "port") == 8

    specs = tmp_path / "jax" / "synthesized_spec"
    args = ["synthesize", "from-spec", trained["generator"], "-i", specs]
    result = jax_cli(*args, "-o", tmp_path / "jax-spec")
    assert result.exit_code == 0, result.output
    rc, _, _ = port_cli(*args, "-o", tmp_path / "port-spec")
    assert rc == 0
    assert _same_audio_files(tmp_path / "jax-spec", tmp_path / "port-spec") == 2


def test_synthesize_from_text_serves_a_jax_written_checkpoint(dummy_ckpts, port_cli, tmp_path):
    args = ["synthesize", "from-text", dummy_ckpts["fs2"], "-t", "Hello world!", "-O", "wav",
            "-O", "spec", "--vocoder-path", dummy_ckpts["generator"]]
    result = jax_cli(*args, "-o", tmp_path / "jax")
    assert result.exit_code == 0, result.output
    rc, out, _ = port_cli(*args, "-o", tmp_path / "port")
    assert rc == 0 and out == result.stdout.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert _same_audio_files(tmp_path / "jax", tmp_path / "port") == 2


def test_export_and_rename_speaker_cross_packages(trained, port_cli, tmp_path):
    from everyvoice_tpu.models.fs2.synthesize import load_vocoder_from_checkpoint as jax_vocoder
    from everyvoice_tpu.train.checkpoint import load_checkpoint as jax_load
    from everyvoice_tpu_torch.models.fs2.synthesize import load_vocoder_from_checkpoint
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    assert jax_cli("export", "spec-to-wav", trained["spec-to-wav"], tmp_path / "jax.ckpt"
                   ).exit_code == 0
    rc, out, _ = port_cli("export", "spec-to-wav", trained["spec-to-wav"], tmp_path / "port.ckpt")
    assert rc == 0 and out == f"Exported generator to {tmp_path / 'port.ckpt'}\n"
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    jax_vocoder(tmp_path / "port.ckpt")
    load_vocoder_from_checkpoint(tmp_path / "jax.ckpt", device="cpu")

    args = ["checkpoint", "rename-speaker", trained["text-to-spec"], "default", "narrator"]
    assert jax_cli(*args, tmp_path / "jax-renamed.ckpt").exit_code == 0
    rc, _, _ = port_cli(*args, tmp_path / "port-renamed.ckpt")
    assert rc == 0
    assert (tmp_path / "port-renamed.ckpt").read_bytes() == (
        tmp_path / "jax-renamed.ckpt").read_bytes()
    assert jax_load(tmp_path / "port-renamed.ckpt")["hyper_parameters"]["speaker2id"] == {
        "narrator": 0}
    assert load_checkpoint(tmp_path / "jax-renamed.ckpt")["hyper_parameters"]["speaker2id"] == {
        "narrator": 0}
    assert jax_cli(*args[:3], "nobody", "x", tmp_path / "x.ckpt").exit_code == 1
    assert port_cli(*args[:3], "nobody", "x", tmp_path / "x.ckpt")[0] == 1


@pytest.mark.parametrize("flags", [[], ["--show-architecture"], ["--no-show-config"]])
def test_checkpoint_inspect_prints_the_same(trained, port_cli, flags):
    result = jax_cli("checkpoint", "inspect", trained["text-to-spec"], *flags)
    rc, out, _ = port_cli("checkpoint", "inspect", trained["text-to-spec"], *flags)
    assert (rc, out) == (result.exit_code, result.stdout)


# ---------------------------------------------------------------------------
# g2p, check text-config, evaluate


@pytest.mark.parametrize("lang,text", [("eng", "hello world"), ("und", "ça va bien"),
                                       ("fra", "bonjour"), ("zzz", "nothing")])
def test_g2p_matches(port_cli, lang, text):
    result = jax_cli("g2p", lang, text)
    rc, out, _ = port_cli("g2p", lang, text)
    assert rc == result.exit_code
    if rc == 0:
        assert out == result.stdout


@pytest.mark.parametrize("texts", [None, ["Ça, ß & ж!", "tschüß ß", "g̱an"]])
def test_check_text_config_matches(world, port_cli, tmp_path, texts):
    filelist = world["filelist"]
    if texts is not None:
        filelist = tmp_path / "texts.psv"
        filelist.write_text("basename|characters\n" + "".join(
            f"t{i}|{t}\n" for i, t in enumerate(texts)), encoding="utf8")
    args = ["check", "text-config", world["configs"]["port"] / "everyvoice-shared-text.yaml",
            "-f", filelist]
    result = jax_cli(*args)
    rc, out, _ = port_cli(*args)
    assert (rc, out) == (result.exit_code, result.stdout)
    assert rc == (0 if texts is None else 1)


def test_evaluate_matches(world, port_cli, tmp_path):
    wavs, refs = tmp_path / "wavs", tmp_path / "refs"
    wavs.mkdir()
    refs.mkdir()
    rng = np.random.default_rng(3)
    for path in sorted(world["wavs"].glob("*.wav"))[:2]:
        audio, sr = read_wav(path)
        clip = audio.mean(axis=0)[: 3 * sr]
        write_wav(refs / path.name, clip, sr)
        write_wav(wavs / path.name, 0.8 * clip + 0.01 * rng.standard_normal(clip.size), sr)
    for args in (["-d", wavs, "-g", refs], ["-f", wavs / path.name]):
        result = jax_cli("evaluate", *args, "-o", tmp_path / "jax.json")
        assert result.exit_code == 0, result.output
        rc, _, _ = port_cli("evaluate", *args, "-o", tmp_path / "port.json")
        assert rc == 0
        want = json.loads((tmp_path / "jax.json").read_text())
        got = json.loads((tmp_path / "port.json").read_text())
        assert len(got) == len(want) and all(sorted(g) == sorted(w) for g, w in zip(got, want))
        for w, g in zip(want, got):
            for key, value in w.items():
                if isinstance(value, float):
                    np.testing.assert_allclose(g[key], value, rtol=0, atol=1e-6, err_msg=key)
                else:
                    assert g[key] == value, key
    assert port_cli("evaluate", "-d", wavs, "-f", wavs / path.name)[0] == 1


# ---------------------------------------------------------------------------
# the surface


def test_help_loads_no_torch_and_lists_the_pipeline_first(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "everyvoice_tpu_torch", "--help"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert not {m for m in imported if m.split(".")[0] in ("torch", "numpy", "jax")}
    listing = proc.stdout.split("COMMAND\n", 1)[1].split("\n\n", 1)[0]
    verbs = [line.split()[0] for line in listing.splitlines()
             if line.startswith("    ") and not line.startswith("     ")]
    assert verbs == ["new-project", "preprocess", "train", "synthesize", "check", "checkpoint",
                     "demo", "evaluate", "export", "fetch-pretrained", "g2p", "segment"]


@pytest.mark.parametrize("verb", ["preprocess", "train", "train text-to-wav", "synthesize from-text",
                                  "synthesize from-spec", "check data", "evaluate", "demo",
                                  "segment align", "segment extract"])
def test_computing_verbs_need_the_card_or_the_cpu_switch(world, trained, port_cli,
                                                         monkeypatch, verb):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("EVERYVOICE_DEVICE")
    config = config_path(world, "json", "text-to-spec")
    args = {
        "preprocess": ["preprocess", "text-to-spec", config],
        "train": ["train", "text-to-spec", config],
        "train text-to-wav": ["train", "text-to-wav", config_path(world, "json", "text-to-wav")],
        "synthesize from-text": ["synthesize", "from-text", trained["text-to-spec"], "-t", "hi",
                                 "-O", "spec"],
        "synthesize from-spec": ["synthesize", "from-spec", trained["generator"],
                                 "-i", world["cwd"]],
        "check data": ["check", "data", config, "--model-path", trained["text-to-spec"]],
        "evaluate": ["evaluate", "-d", world["wavs"], "-o", world["cwd"] / "evaluation.json"],
        "demo": ["demo", trained["text-to-spec"], "--vocoder-path", trained["generator"]],
        "segment align": ["segment", "align", next(world["wavs"].glob("*.wav")), config,
                          "--acoustic-model", world["cwd"]],
        "segment extract": ["segment", "extract", next(world["wavs"].glob("*.wav")), config],
    }[verb]
    rc, _, err = port_cli(*args)
    assert rc == 1 and "runs on a CUDA card by default" in err and "EVERYVOICE_DEVICE=cpu" in err


def test_unported_flags_name_their_roadmap_item(world, port_cli, tmp_path):
    fs2 = config_path(world, "json", "text-to-spec")
    st2 = config_path(world, "json", "text-to-wav")
    cases = [
        (["fetch-pretrained", "text-to-wav", "--config-path", st2], "fetch-pretrained"),
    ]
    for args, item in cases:
        rc, _, err = port_cli(*args)
        assert rc == 1 and f"ROADMAP.md, queue 1, '{item}'" in err, (args, err)
    assert port_cli("train", "text-to-spec", fs2, "-a", "tpu")[0] == 1
    # parallelism is ported: a bad --strategy, --devices or --nodes is a usage error
    rc, _, err = port_cli("train", "text-to-spec", fs2, "-s", "fsdp2")
    assert rc == 1 and "Unknown --strategy 'fsdp2'; expected ddp, auto, fsdp" in err
    assert port_cli("train", "text-to-spec", fs2, "-d", "two")[0] == 1
    assert port_cli("train", "text-to-spec", fs2, "-n", "0")[0] == 1
    rc, _, err = port_cli("train", "text-to-spec", fs2, "-a", "cpu", "-d", "3", "-s", "tp2")
    assert rc == 1 and "tensor-parallel groups of 2" in err
    with pytest.raises(SystemExit) as usage:
        cli.main(["train", "text-to-wav", str(st2), "--mode", "third"])
    assert usage.value.code == 2


def test_preprocess_device_audio_matches_the_jax_cli(world, port_cli, tmp_path, monkeypatch):
    """``preprocess --device-audio`` (the audio step on the device, here the
    CPU) writes the JAX CLI's ``--device-audio`` artifacts within 1 LSB and
    its filelist byte for byte; without the CPU switch it needs the card."""
    from everyvoice_tpu.dsp import read_wav

    fs2 = config_path(world, "json", "text-to-spec")
    saves = {name: tmp_path / name for name in ("jax", "port")}
    args = ["preprocess", "text-to-spec", fs2, "-s", "audio", "--device-audio",
            "-c", "preprocessing.audio.output_sampling_rate=44100"]
    result = jax_cli(*args, "-c", f"preprocessing.save_dir={saves['jax']}")
    assert result.exit_code == 0, result.output
    rc, _, err = port_cli(*args, "-c", f"preprocessing.save_dir={saves['port']}")
    assert rc == 0, err
    assert (saves["port"] / "filelist.psv").read_bytes() == (
        saves["jax"] / "filelist.psv").read_bytes()
    names = sorted(p.name for p in (saves["jax"] / "audio").glob("*.wav"))
    assert len(names) == 2 * UTTERANCES
    assert names == sorted(p.name for p in (saves["port"] / "audio").glob("*.wav"))
    for name in names:
        want, sr_want = read_wav(saves["jax"] / "audio" / name)
        got, sr_got = read_wav(saves["port"] / "audio" / name)
        assert sr_got == sr_want and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1.01 / 32768, err_msg=name)
    if not torch.cuda.is_available():
        monkeypatch.delenv("EVERYVOICE_DEVICE")
        rc, _, err = port_cli(*args, "-c", f"preprocessing.save_dir={tmp_path / 'none'}")
        assert rc == 1 and "runs on a CUDA card by default" in err


def test_new_project_reports_a_short_input_and_a_missing_session(world, tmp_path):
    """``new-project`` reads its answers from standard input: one that ends
    before the wizard's last question exits 1 with a message, and
    ``--resume-from`` needs an existing file (a usage error). The whole
    journey on stdin is in tests/test_torch_wizard.py."""
    answers = ["Piped", "Test Runner", "info@everyvoice.ca", str(tmp_path),
               str(world["filelist"]), "yes"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cut = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "new-project"],
                         input="\n".join(answers) + "\n", cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert cut.returncode == 1 and "input ended" in cut.stderr
    assert not (tmp_path / "Piped").exists()
    missing = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "new-project", "-r",
                              str(tmp_path / "nope.yaml")], capture_output=True, text=True,
                             timeout=120, env=env)
    assert missing.returncode == 2 and "does not exist" in missing.stderr

"""The port's config defaults (everyvoice_tpu_torch.config) against the JAX
package's pydantic classes: a config that names only its contact fills in
to the same values, section by section, with no field left out. Exact
equality (the values are JSON)."""

import pytest

from everyvoice_tpu.models.fs2.config import FastSpeech2Config
from everyvoice_tpu.models.hifigan.config import HiFiGANConfig
from everyvoice_tpu_torch.config import fs2_config, hifigan_config
from model_stubs import CONTACT

SECTIONS = {
    "fs2_model": (FastSpeech2Config, fs2_config, ("model",)),
    "fs2_audio": (FastSpeech2Config, fs2_config, ("preprocessing", "audio")),
    "fs2_text": (FastSpeech2Config, fs2_config, ("text",)),
    "hifigan_model": (HiFiGANConfig, hifigan_config, ("model",)),
    "hifigan_audio": (HiFiGANConfig, hifigan_config, ("preprocessing", "audio")),
}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_defaults_match_pydantic(section):
    pydantic_cls, fill, path = SECTIONS[section]
    want = _at(pydantic_cls(contact=CONTACT).model_dump(mode="json"), path)
    got = _at(fill({"contact": CONTACT}), path)
    assert got == want


def test_given_values_override_nested_defaults():
    cfg = fs2_config({"model": {"encoder": {"layers": 2},
                                "variance_predictors": {"pitch": {"level": "frame"}}}})
    m = cfg["model"]
    assert m["encoder"]["layers"] == 2 and m["encoder"]["input_dim"] == 256
    assert m["decoder"]["layers"] == 4
    assert m["variance_predictors"]["pitch"]["level"] == "frame"
    assert m["variance_predictors"]["pitch"]["n_bins"] == 256
    assert m["variance_predictors"]["energy"]["level"] == "phone"


def _sections():
    """(pydantic class, the port's default dict) for every section the port
    checks for unknown keys."""
    from everyvoice_tpu.config.preprocessing_config import AudioConfig, Dataset, PreprocessingConfig
    from everyvoice_tpu.config.shared_types import ContactInformation, LoggerConfig
    from everyvoice_tpu.config.text_config import Punctuation, TextConfig
    from everyvoice_tpu.models.fs2.config import (
        ConformerConfig,
        FastSpeech2ModelConfig,
        FastSpeech2TrainingConfig,
        VariancePredictorBase,
        VariancePredictorConfig,
        VariancePredictors,
    )
    from everyvoice_tpu.models.hifigan.config import HiFiGANModelConfig, HiFiGANTrainingConfig
    from everyvoice_tpu_torch import config, config_files

    fs2, voc = config_files.SCHEMA["text-to-spec"], config_files.SCHEMA["spec-to-wav"]
    return {
        "fs2": (FastSpeech2Config, fs2[()]),
        "hifigan": (HiFiGANConfig, voc[()]),
        "contact": (ContactInformation, fs2[("contact",)]),
        "fs2_model": (FastSpeech2ModelConfig, fs2[("model",)]),
        "conformer": (ConformerConfig, fs2[("model", "encoder")]),
        "variance_predictors": (VariancePredictors, fs2[("model", "variance_predictors")]),
        "variance_predictor": (VariancePredictorConfig,
                               fs2[("model", "variance_predictors", "pitch")]),
        "duration_predictor": (VariancePredictorBase,
                               fs2[("model", "variance_predictors", "duration")]),
        "fs2_training": (FastSpeech2TrainingConfig, fs2[("training",)]),
        "hifigan_model": (HiFiGANModelConfig, voc[("model",)]),
        "hifigan_training": (HiFiGANTrainingConfig, voc[("training",)]),
        "logger": (LoggerConfig, fs2[("training", "logger")]),
        "preprocessing": (PreprocessingConfig, fs2[("preprocessing",)]),
        "audio": (AudioConfig, fs2[("preprocessing", "audio")]),
        "dataset": (Dataset, fs2[("preprocessing", "source_data", "*")]),
        "text": (TextConfig, fs2[("text",)]),
        "punctuation": (Punctuation, config.PUNCTUATION),
    }


@pytest.mark.parametrize("section", sorted(_sections()))
def test_default_key_sets_equal_the_pydantic_fields(section):
    pydantic_cls, defaults = _sections()[section]
    assert set(defaults) == set(pydantic_cls.model_fields)


@pytest.mark.parametrize("name", ["adam", "adamw", "rms", "noam"])
def test_optimizer_key_sets_equal_the_pydantic_fields(name):
    from everyvoice_tpu.config import shared_types
    from everyvoice_tpu_torch.config import OPTIMIZERS

    cls = {"adam": shared_types.AdamOptimizer, "adamw": shared_types.AdamWOptimizer,
           "rms": shared_types.RMSOptimizer, "noam": shared_types.NoamOptimizer}[name]
    assert set(OPTIMIZERS[name]) == set(cls.model_fields)


def test_relative_vocoder_path_resolves_against_the_config_in_the_port(tmp_path, monkeypatch):
    """A relative ``training.vocoder_path``: the JAX loader keeps it as
    written, so it resolves against the working directory; the port
    resolves it against the config file's directory, as it does
    ``preprocessing.save_dir`` in both."""
    import json
    from pathlib import Path

    from everyvoice_tpu_torch.config_files import load_config_from_path

    config_dir = tmp_path / "project" / "config"
    config_dir.mkdir(parents=True)
    path = config_dir / "everyvoice-text-to-spec.json"
    path.write_text(json.dumps({"contact": CONTACT, "training": {"vocoder_path": "../voc.ckpt"},
                                "preprocessing": {"save_dir": "../preprocessed"}}))
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    monkeypatch.chdir(elsewhere)
    jax_config = FastSpeech2Config.load_config_from_path(path)
    port_config = load_config_from_path("text-to-spec", path)
    assert jax_config.training.vocoder_path == Path("../voc.ckpt")
    assert jax_config.training.vocoder_path.resolve() == tmp_path / "voc.ckpt"
    assert Path(port_config["training"]["vocoder_path"]) == tmp_path / "project" / "voc.ckpt"
    assert (Path(jax_config.preprocessing.save_dir) == Path(port_config["preprocessing"]["save_dir"])
            == tmp_path / "project" / "preprocessed")

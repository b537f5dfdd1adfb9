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

"""The port's FastSpeech2 forward against the JAX package's ``fs2.apply``, on
the CPU, in float32, with the small stub model (tests/model_stubs.py).

Inputs come from seeded numpy. ``duration_used`` must agree exactly (it is
an integer rounding of the duration head); ``mel`` and ``postnet_mel`` to
rtol = atol = 1e-4 (float32 sums in another order through two Conformer
stacks and the postnet). The traps of the port get their own checks:
attention masking with flax's finite fill value, norm epsilons, and
GroupNorm statistics that span the padding.
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from everyvoice_tpu.models.fs2 import FastSpeech2 as JaxFastSpeech2
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.convert import flax_to_torch
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.layers import MultiHeadAttention, group_norm_1, layer_norm
from model_stubs import make_fs2_config

TOL = 1e-4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    config = make_fs2_config(tmp_path_factory.mktemp("fs2"))
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols=n_symbols)
    rng = jax.random.PRNGKey(7)
    # With a mel, init creates the alignment encoder too: a complete tree.
    params = jax.jit(jmodel.init)(
        {"params": rng, "dropout": rng}, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        mel=jnp.zeros((1, 16, 80)), mel_lengths=jnp.asarray([16]),
    )
    params = jax.tree.map(np.asarray, params)
    tmodel = FastSpeech2.from_config(fs2_config(config.model_checkpoint_dump()), n_symbols)
    state, absent = flax_to_torch(params, tmodel)
    assert absent == []
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel.eval(), n_symbols


LENGTHS = [16, 9, 4]


def _batch(n_symbols, n_text, seed=0):
    """The same three texts (16, 9 and 4 tokens) padded to ``n_text``."""
    rng = np.random.default_rng(seed)
    text = rng.integers(2, n_symbols, size=(len(LENGTHS), 16)).astype(np.int32)
    padded = np.zeros((len(LENGTHS), n_text), np.int32)
    for i, n in enumerate(LENGTHS):
        padded[i, :n] = text[i, :n]
    return padded, np.asarray(LENGTHS, np.int32)


def _run_both(models, text, lengths, **kwargs):
    jmodel, params, tmodel, _ = models
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    apply = jax.jit(jmodel.apply, static_argnames=("teacher_forcing",))
    want = apply(params, jnp.asarray(text), jnp.asarray(lengths), **jkw)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(text), torch.from_numpy(lengths), **tkw)
    return {k: np.asarray(v) for k, v in want.items()}, {
        k: v.numpy() for k, v in got.items() if v is not None
    }


@pytest.fixture(scope="module")
def free_running(models):
    """Both forwards on the same batch padded to 16 and to 32 tokens."""
    return {n: _run_both(models, *_batch(models[3], n)) for n in (16, 32)}


@pytest.mark.parametrize("n_text", [16, 32])
def test_forward_matches_flax_on_unequal_lengths(free_running, n_text):
    want, got = free_running[n_text]
    np.testing.assert_array_equal(got["duration_used"], want["duration_used"])
    np.testing.assert_array_equal(got["predicted_frame_lengths"], want["predicted_frame_lengths"])
    assert want["predicted_frame_lengths"].max() < 256  # inside max_frames
    for key in ("mel", "postnet_mel", "log_duration_prediction", "pitch_prediction"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


def test_outputs_depend_on_padded_length_in_both(free_running):
    """GroupNorm(num_groups=1) spans the padded rows, so the same texts padded
    to 16 and to 32 tokens give different outputs — in the JAX package and
    in the port alike. The port must keep the JAX package's padded shapes."""
    for side in (0, 1):
        a = free_running[16][side]["log_duration_prediction"][:, :16]
        b = free_running[32][side]["log_duration_prediction"][:, :16]
        assert np.abs(a - b).max() > 1e-6


def test_duration_control_matches_flax(models):
    want, got = _run_both(models, *_batch(models[3], 16, seed=1), duration_control=1.7)
    np.testing.assert_array_equal(got["duration_used"], want["duration_used"])
    np.testing.assert_allclose(got["postnet_mel"], want["postnet_mel"], rtol=TOL, atol=TOL)


def test_teacher_forced_durations_isolate_the_decoder(models):
    text, lengths = _batch(models[3], 16, seed=2)
    durations = np.random.default_rng(3).integers(1, 9, size=text.shape).astype(np.int32)
    durations[text == 0] = 0
    want, got = _run_both(models, text, lengths, durations=durations, teacher_forcing=True)
    np.testing.assert_array_equal(got["duration_used"], durations)
    np.testing.assert_array_equal(got["predicted_frame_lengths"], durations.sum(1))
    for key in ("mel", "postnet_mel"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


def test_fully_masked_attention_rows_stay_finite_like_flax():
    rng = np.random.default_rng(5)
    dim, heads = 16, 2
    x = rng.standard_normal((2, 6, dim)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    mod = fnn.MultiHeadDotProductAttention(num_heads=heads)
    params = mod.init(jax.random.PRNGKey(0), x, x)
    pair = mask[:, None, None, :] & mask[:, None, :, None]
    want = np.asarray(mod.apply(params, x, x, mask=pair))
    attn = MultiHeadAttention(dim, heads)
    p = jax.tree.map(np.array, params["params"])
    with torch.no_grad():
        for name in ("query", "key", "value"):
            getattr(attn, name).weight.copy_(torch.from_numpy(p[name]["kernel"].reshape(dim, dim).T))
            getattr(attn, name).bias.copy_(torch.from_numpy(p[name]["bias"].reshape(dim)))
        attn.out.weight.copy_(torch.from_numpy(p["out"]["kernel"].reshape(dim, dim).T))
        attn.out.bias.copy_(torch.from_numpy(p["out"]["bias"]))
        got = attn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # padded rows too


def test_layer_norm_uses_flax_epsilon():
    """Rows of variance ~1e-6 make the epsilon visible: 1e-6 (flax), not 1e-5."""
    rng = np.random.default_rng(6)
    x = (1e-3 * rng.standard_normal((3, 8))).astype(np.float32)
    mod = fnn.LayerNorm()
    params = mod.init(jax.random.PRNGKey(0), x)
    want = np.asarray(mod.apply(params, x))
    norm = torch.nn.LayerNorm(8)
    got = layer_norm(torch.from_numpy(x), norm, torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    loose = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,), eps=1e-5).numpy()
    assert np.abs(loose - want).max() > 1e-2


def test_group_norm_uses_flax_epsilon_over_all_rows():
    """GroupNorm(num_groups=1): one mean and variance per item over all its
    (T, C), zero-padded rows included, eps 1e-6; small-variance items make
    the epsilon visible."""
    rng = np.random.default_rng(8)
    x = (1e-3 * rng.standard_normal((2, 6, 8))).astype(np.float32)
    x[0, 4:] = 0.0  # padded rows count in the statistics
    mod = fnn.GroupNorm(num_groups=1)
    params = mod.init(jax.random.PRNGKey(0), x)
    want = np.asarray(mod.apply(params, x))
    norm = torch.nn.GroupNorm(1, 8)
    got = group_norm_1(torch.from_numpy(x), norm, torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    loose = torch.nn.functional.group_norm(
        torch.from_numpy(x).transpose(1, 2), 1, eps=1e-5
    ).transpose(1, 2).numpy()
    assert np.abs(loose - want).max() > 1e-2


def test_converter_reports_alignment_and_rejects_strays(models):
    """The alignment subtree maps like the rest; a tree initialised without
    a mel (no alignment subtree at all) keeps the model's own alignment
    weights and reports their flax paths; a stray or missing leaf raises."""
    jmodel, params, tmodel, _ = models
    tree = {"params": dict(params["params"])}
    alignment = tree["params"].pop("alignment")
    state, absent = flax_to_torch(tree, tmodel)
    assert absent == sorted(f"params/alignment/{c}/{leaf}" for c in alignment
                            for leaf in ("bias", "kernel"))
    assert torch.equal(state["alignment.key_in.weight"], tmodel.alignment.key_in.weight)
    tree["params"]["alignment"] = {"Dense_0": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="alignment"):
        flax_to_torch(tree, tmodel)
    tree["params"]["alignment"] = {**alignment, "Dense_0": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(ValueError, match="alignment/Dense_0"):
        flax_to_torch(tree, tmodel)
    tree["params"]["alignment"] = alignment
    tree["params"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="bogus"):
        flax_to_torch(tree, tmodel)
    del tree["params"]["bogus"]
    del tree["params"]["mel_head"]
    with pytest.raises(KeyError, match="mel_head"):
        flax_to_torch(tree, tmodel)


def _vp(**extra):
    return {"n_layers": 1, "input_dim": 64, **extra}


VARIANTS = {
    "speakers_and_languages": ({"multispeaker": True, "multilingual": True}, 3, 2),
    "frame_level_variances": ({"variance_predictors": {
        "pitch": _vp(level="frame"), "energy": _vp(level="frame"), "duration": _vp(),
    }}, 1, 1),
    "plain_convs_no_postnet": ({"use_postnet": False, "variance_predictors": {
        "pitch": _vp(depthwise=False), "energy": _vp(depthwise=False),
        "duration": _vp(depthwise=False),
    }}, 1, 1),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variants_match_flax(variant, tmp_path):
    """Options the stub leaves at their defaults: speaker and language
    embeddings, frame-level pitch and energy, plain (not depthwise) predictor
    convs and no postnet. Same tolerances as above."""
    from everyvoice_tpu.models.fs2.config import FastSpeech2Config
    from model_stubs import CONTACT, SMALL_FS2_MODEL

    override, n_speakers, n_langs = VARIANTS[variant]
    base = make_fs2_config(tmp_path)
    config = FastSpeech2Config(
        contact=CONTACT, model={**SMALL_FS2_MODEL, **override},
        preprocessing=base.preprocessing, text=base.text,
    )
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols, n_speakers, n_langs)
    rng = jax.random.PRNGKey(11)
    params = jax.jit(jmodel.init)(
        {"params": rng, "dropout": rng}, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8])
    )
    params = jax.tree.map(np.asarray, params)
    tmodel = FastSpeech2.from_config(
        fs2_config(config.model_checkpoint_dump()), n_symbols, n_speakers, n_langs
    )
    state, _ = flax_to_torch(params, tmodel)
    tmodel.load_state_dict(state)
    ids = {"speaker_id": np.asarray([2, 0, 1], np.int32),
           "language_id": np.asarray([1, 1, 0], np.int32)}
    want, got = _run_both((jmodel, params, tmodel.eval(), n_symbols),
                          *_batch(n_symbols, 16, seed=4), **ids)
    np.testing.assert_array_equal(got["duration_used"], want["duration_used"])
    keys = ["mel", "pitch_prediction", "energy_prediction"]
    assert ("postnet_mel" in got) == ("postnet_mel" in want) == (variant != "plain_convs_no_postnet")
    for key in keys + (["postnet_mel"] if "postnet_mel" in want else []):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


def test_unported_options_raise():
    """GST and phonological-feature input, once unported, now build: the
    port's model has exactly the flax tree (paths and shapes) that the JAX
    package's ``init`` on a mel makes for each option (tests/test_torch_gst.py
    holds their numbers to flax)."""
    from everyvoice_tpu.models.fs2.config import FastSpeech2Config
    from everyvoice_tpu_torch.convert import torch_to_flax
    from model_stubs import CONTACT, SMALL_FS2_MODEL

    for model, text in (({"use_global_style_token_module": True}, jnp.zeros((1, 8), jnp.int32)),
                        ({"target_text_representation_level": "phonological_features"},
                         jnp.zeros((1, 8, 43)))):
        config = FastSpeech2Config(contact=CONTACT, model={**SMALL_FS2_MODEL, **model})
        jmodel = JaxFastSpeech2.from_config(config, n_symbols=10)
        rng = jax.random.PRNGKey(0)
        want = jax.eval_shape(jmodel.init, {"params": rng, "dropout": rng}, text,
                              jnp.asarray([8]), mel=jnp.zeros((1, 16, 80)),
                              mel_lengths=jnp.asarray([16]))
        tmodel = FastSpeech2.from_config(fs2_config(config.model_checkpoint_dump()), n_symbols=10)
        got = torch_to_flax(tmodel.state_dict(), tmodel)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [g.shape for g in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]

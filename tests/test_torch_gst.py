"""The port's global style tokens (GST) and phonological-feature input
against the JAX package's, on the CPU, in float32, at small widths, on
inputs made from seeded numpy.

Tolerances, with their reasons:
- ``GlobalStyleTokens`` and the FastSpeech2 forwards: 1e-4 (rtol and atol),
  float32 sums in another order through six convs and two Conformer stacks;
  ``duration_used`` exactly (an integer rounding of the duration head);
- the phone-level GST training forward, losses and gradients: those of
  tests/test_torch_fs2_train.py (1e-4; losses 1e-5 relative; gradients 1e-4
  of each leaf's largest magnitude);
- ``convert.py``'s round trip of the ``gst`` and ``pfs_proj`` leaves:
  exact.

The JAX package's ``phonological_features`` level has a fault, recorded in
the last test: its dataset and ``Synthesizer`` hand phone ids to a model
whose ``pfs_proj`` wants (B, N, 43) features. The port raises a
``ValueError`` there instead.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from everyvoice_tpu.models.fs2 import FastSpeech2 as JaxFastSpeech2
from everyvoice_tpu.models.fs2.config import FastSpeech2Config
from everyvoice_tpu.models.fs2.loss import compute_fs2_losses as jax_losses
from everyvoice_tpu.models.layers import GlobalStyleTokens as JaxGST
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu_torch import convert
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.layers import GlobalStyleTokens
from model_stubs import CONTACT, SMALL_FS2_MODEL, make_fs2_config

TOL = 1e-4
WEIGHTS = {"mel": 1.0, "postnet": 1.0, "pitch": 0.1, "energy": 0.1, "duration": 0.1,
           "attn_ctc": 0.1, "attn_bin": 0.1}


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("frames, n_mels", [(37, 80), (40, 80), (64, 19)])
def test_global_style_tokens_match_flax(frames, n_mels):
    """Odd and even frame counts and mel widths: flax's "SAME" stride-2
    padding is (0, 1) on an even axis and (1, 1) on an odd one, and the
    flattened features are (M', C) channels-last."""
    rng = np.random.default_rng(frames)
    ref = (rng.standard_normal((3, frames, n_mels)) - 4.0).astype(np.float32)
    ref[1, frames // 2:] = 0.0  # a padded row: pooled over, unmasked
    mod = JaxGST(token_dim=32, heads=4)
    params = jax.tree.map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(frames), ref))
    want = np.asarray(jax.jit(mod.apply)(params, ref))
    gst = GlobalStyleTokens(n_mels, token_dim=32, heads=4)
    # convert.py's own table for the subtree, rooted at the module.
    gst.load_state_dict({
        tkey.removeprefix("gst."): _t(np.ascontiguousarray(
            convert._to_torch(_get(params["params"], fpath), kind)))
        for fpath, tkey, kind in convert._gst((), "gst", gst)
    })
    with torch.no_grad():
        got = gst(_t(ref)).numpy()
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _config(tmp_path, **model) -> FastSpeech2Config:
    base = make_fs2_config(tmp_path)
    return FastSpeech2Config(contact=CONTACT, model={**SMALL_FS2_MODEL, **model},
                             preprocessing=base.preprocessing, text=base.text)


def _models(config, n_symbols, text, lengths, **init_kwargs):
    jmodel = JaxFastSpeech2.from_config(config, n_symbols)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                                  text, lengths, **init_kwargs)
    params = jax.tree.map(np.asarray, params)
    tmodel = FastSpeech2.from_config(fs2_config(config.model_checkpoint_dump()), n_symbols)
    state, absent = flax_to_torch(params, tmodel)
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel.eval(), absent


@pytest.fixture(scope="module")
def gst_models(tmp_path_factory):
    config = _config(tmp_path_factory.mktemp("gst"), use_global_style_token_module=True)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    out = _models(config, n_symbols, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                  mel=jnp.zeros((1, 16, 80)), mel_lengths=jnp.asarray([16]))
    assert out[3] == []
    return out[:3], n_symbols


def _text_batch(n_symbols, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([16, 9, 4], np.int32)
    text = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(2, n_symbols, n)
    return text, lengths


def _run_both(models, text, lengths, **kwargs):
    jmodel, params, tmodel = models
    want = jax.jit(jmodel.apply)(params, jnp.asarray(text), jnp.asarray(lengths),
                                 **{k: jnp.asarray(v) for k, v in kwargs.items()})
    with torch.no_grad():
        got = tmodel(_t(text), _t(lengths), **{k: _t(v) for k, v in kwargs.items()})
    return ({k: np.asarray(v) for k, v in want.items() if v is not None},
            {k: v.numpy() for k, v in got.items() if v is not None})


def _assert_forward_matches(want, got):
    np.testing.assert_array_equal(got["duration_used"], want["duration_used"])
    for key in ("encoder_output", "mel", "postnet_mel", "log_duration_prediction",
                "pitch_prediction", "energy_prediction"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("reference", ["style_reference", "mel", "neither"])
def test_fs2_with_gst_matches_flax(gst_models, reference):
    """GST conditions on ``style_reference``, else on ``mel``, else is
    skipped; a free-running forward (no ``mel_lengths``) either way."""
    models, n_symbols = gst_models
    text, lengths = _text_batch(n_symbols)
    rng = np.random.default_rng(1)
    ref = (rng.standard_normal((3, 45, 80)) - 4.0).astype(np.float32)
    kwargs = {} if reference == "neither" else {reference: ref}
    want, got = _run_both(models, text, lengths, **kwargs)
    _assert_forward_matches(want, got)
    plain_want, _ = _run_both(models, text, lengths)
    changed = np.abs(want["encoder_output"] - plain_want["encoder_output"]).max()
    assert (changed > 1e-3) == (reference != "neither")


def test_fs2_with_phonological_features_matches_flax(tmp_path):
    config = _config(tmp_path, target_text_representation_level="phonological_features")
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    models = _models(config, n_symbols, jnp.zeros((1, 8, 43)), jnp.asarray([8]),
                     mel=jnp.zeros((1, 16, 80)), mel_lengths=jnp.asarray([16]))
    assert models[3] == [] and models[2].symbol_embed is None
    _, lengths = _text_batch(n_symbols)
    rng = np.random.default_rng(2)
    pfs = rng.choice(np.asarray([-1.0, 0.0, 1.0], np.float32), size=(3, 16, 43))
    pfs[np.arange(16)[None, :] >= lengths[:, None]] = 0.0
    want, got = _run_both(models[:3], pfs, lengths)
    _assert_forward_matches(want, got)


def _train_batch(n_symbols, seed=0):
    """Three items of 12, 7 and 4 phones and 48, 31 and 13 frames, padded
    to 12 phones and the stub's 256 frames."""
    rng = np.random.default_rng(seed)
    b, n, t = 3, 12, 256
    text_lengths = np.asarray([12, 7, 4], np.int32)
    mel_lengths = np.asarray([48, 31, 13], np.int32)
    out = {"text": np.zeros((b, n), np.int32), "text_lengths": text_lengths,
           "mel": np.zeros((b, t, 80), np.float32), "mel_lengths": mel_lengths,
           "pitch": np.zeros((b, t), np.float32), "energy": np.zeros((b, t), np.float32),
           "attn_prior": np.zeros((b, t, n), np.float32),
           "speaker_id": np.zeros(b, np.int32), "language_id": np.zeros(b, np.int32)}
    for i in range(b):
        out["text"][i, : text_lengths[i]] = rng.integers(2, n_symbols, text_lengths[i])
        m = mel_lengths[i]
        out["mel"][i, :m] = rng.standard_normal((m, 80)) - 4.0
        out["pitch"][i, :m] = rng.standard_normal(m)
        out["energy"][i, :m] = rng.standard_normal(m)
        out["attn_prior"][i, :m, : text_lengths[i]] = rng.uniform(0.01, 1.0, (m, text_lengths[i]))
    return out


def _kwargs(batch):
    keys = ("mel", "mel_lengths", "pitch", "energy", "speaker_id", "language_id", "attn_prior")
    return {k: batch[k] for k in keys}


def test_phone_level_gst_training_forward_losses_and_gradients_match_jax(tmp_path):
    """The trainer's forward: GST on the padded target mel (nothing masks
    its pools), the learned alignment, losses and every gradient, the
    ``gst`` subtree's included."""
    config = _config(tmp_path, use_global_style_token_module=True,
                     target_text_representation_level="phones")
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    batch = _train_batch(n_symbols)
    jmodel, params, tmodel, absent = _models(config, n_symbols, batch["text"],
                                             batch["text_lengths"], **_kwargs(batch))
    assert absent == [] and "gst" in params["params"]

    def loss_fn(p):
        out = jmodel.apply(p, batch["text"], batch["text_lengths"], deterministic=True,
                           **_kwargs(batch))
        losses = jax_losses(out, batch, WEIGHTS, learn_alignment=True, bin_loss_ramp=0.3)
        return losses["total"], (losses, out)

    (_, (want, want_out)), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tb = {k: _t(v) for k, v in batch.items()}
    out = tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb))
    for key in ("attn_hard", "duration_target"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want_out[key]), err_msg=key)
    for key in ("encoder_output", "mel", "postnet_mel", "attn_soft"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want_out[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    got = compute_fs2_losses(out, tb, WEIGHTS, learn_alignment=True, bin_loss_ramp=0.3)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)
    got["total"].backward()
    flat_got = _flat(torch_to_flax({n: p.grad for n, p in tmodel.named_parameters()}, tmodel))
    flat_want = _flat(want_grads)
    assert set(flat_got) == set(flat_want)
    assert any("['gst']" in key for key in flat_want)
    largest = max(np.abs(w).max() for w in flat_want.values())
    for key, w in flat_want.items():
        if key.endswith("['key']['bias']"):
            # Softmax ignores a constant added to a row of logits: both
            # sides hold noise where the exact gradient is zero.
            assert np.abs(flat_got[key]).max() <= 1e-6 * largest, key
            continue
        assert np.abs(flat_got[key] - w).max() <= 1e-4 * np.abs(w).max(), key


@pytest.mark.parametrize("model", [
    {"use_global_style_token_module": True},
    {"target_text_representation_level": "phonological_features"},
])
def test_convert_round_trips_gst_and_pfs_proj_exactly(tmp_path, model):
    config = _config(tmp_path, **model)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    pfs = "target_text_representation_level" in model
    text = jnp.zeros((1, 8, 43)) if pfs else jnp.zeros((1, 8), jnp.int32)
    _, params, tmodel, _ = _models(config, n_symbols, text, jnp.asarray([8]),
                                   mel=jnp.zeros((1, 16, 80)), mel_lengths=jnp.asarray([16]))
    back = _flat(torch_to_flax(tmodel.state_dict(), tmodel))
    want = _flat(params)
    assert set(back) == set(want)
    new = [k for k in want if "['gst']" in k or "['pfs_proj']" in k]
    assert new and (("['symbol_embed']" in "".join(want)) != pfs)
    for key, value in want.items():
        assert back[key].dtype == np.float32 and back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    if not pfs:
        # A tree without the gst subtree (init saw no mel) keeps the model's
        # own style-token weights and names what it lacked.
        tree = {"params": {k: v for k, v in params["params"].items() if k != "gst"}}
        state, absent = flax_to_torch(tree, tmodel)
        assert absent and all(p.startswith("params/gst/") for p in absent)
        assert torch.equal(state["gst.style_tokens"], tmodel.gst.style_tokens)


def test_reference_feeds_phone_ids_to_pfs_proj_and_the_port_refuses(tmp_path):
    """A fault inside the JAX package: at ``phonological_features`` its
    ``FastSpeech2Dataset`` reads ``phone_tokens`` ids and its
    ``Synthesizer.encode`` gives ids too, so ``pfs_proj`` (a Dense over
    (B, N, 43) features) gets a (B, N) int tensor and the forward breaks.
    The port raises a ValueError that names the reason in both places."""
    from everyvoice_tpu.config import TextConfig
    from everyvoice_tpu.dataloader import FastSpeech2Dataset as JaxDataset
    from everyvoice_tpu.models.fs2.synthesize import Synthesizer as JaxSynthesizer
    from everyvoice_tpu.train import save_checkpoint
    from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from model_stubs import STATS

    base = make_fs2_config(tmp_path)
    config = FastSpeech2Config(
        contact=CONTACT, preprocessing=base.preprocessing,
        model={**SMALL_FS2_MODEL, "target_text_representation_level": "phonological_features"},
        text=TextConfig(symbols={"ipa": ["h", "ʌ", "ɛ", "l", "o", "ʊ"]}),
    )
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 8, 43)), jnp.asarray([8]))
    ckpt = save_checkpoint(tmp_path / "pfs.ckpt", "FastSpeech2", config, params,
                           lang2id={"eng": 0}, speaker2id={"default": 0}, stats=STATS)
    jax_synth = JaxSynthesizer(ckpt, compute_dtype="float32")
    [ids] = jax_synth.encode("hello", "eng")
    assert ids.ndim == 1 and ids.dtype == np.int32  # ids, not (N, 43) features
    # A kernel of (43, dim) meets a padded (1, 16) ids row.
    with pytest.raises(Exception, match="pfs_proj"):
        jax_synth.synthesize(["hello"], language="eng")
    assert JaxDataset([], config, {}, {})._token_column() == "phone_tokens"

    with pytest.raises(ValueError, match="phonological_features"):
        Synthesizer(ckpt, device="cpu")
    with pytest.raises(ValueError, match="phonological_features"):
        FastSpeech2Dataset([], fs2_config(config.model_checkpoint_dump()), {}, {})

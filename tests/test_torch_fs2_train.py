"""The port's FastSpeech2 training pieces against the JAX package's, on the
CPU, in float32, at small widths, on inputs made from seeded numpy.

Tolerances, with their reasons:
- ``forward_sum_loss`` values and gradients (against ``jax.grad``): 1e-5
  relative, float32 log-sum-exps in another order;
- ``viterbi_alignment``: exactly equal, ties included (a tie stays on the
  same phone in both), and so ``attn_hard`` and ``duration_target``;
- ``binarization_loss`` and the phone averages: 1e-6;
- the alignment encoder and the training forward: 1e-4 (rtol and atol),
  float32 sums in another order through the Conformer stacks;
- ``compute_fs2_losses``: 1e-5 relative; gradients mapped with
  ``torch_to_flax`` against ``jax.grad`` of the trainer's loss: 1e-4 of each
  leaf's largest magnitude (the attention key biases, whose gradient is
  zero in exact arithmetic, within 1e-6 of the largest gradient);
- the optimizers, 1 and 10 steps on the same gradients: 1e-6 absolute on
  the parameters and the moments.
Dropout is off on both sides (``deterministic=True``; ``eval()``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from everyvoice_tpu.config.shared_types import (
    AdamOptimizer,
    AdamWOptimizer,
    NoamOptimizer,
    RMSOptimizer,
)
from everyvoice_tpu.models.fs2 import FastSpeech2 as JaxFastSpeech2
from everyvoice_tpu.models.fs2 import alignment as jal
from everyvoice_tpu.models.fs2.config import FastSpeech2Config
from everyvoice_tpu.models.fs2.loss import compute_fs2_losses as jax_losses
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.train.optim import build_optimizer as jax_build_optimizer
from everyvoice_tpu.train.optim import learning_rate_at as jax_learning_rate_at
from everyvoice_tpu_torch.config import fs2_config
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.fs2 import alignment as tal
from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.train.optim import build_optimizer, learning_rate_at
from model_stubs import CONTACT, SMALL_FS2_MODEL, make_fs2_config

WEIGHTS = {"mel": 1.0, "postnet": 1.0, "pitch": 0.1, "energy": 0.1, "duration": 0.1,
           "attn_ctc": 0.1, "attn_bin": 0.1}
SRC = np.asarray([9, 6, 3, 9], np.int32)
MEL = np.asarray([40, 25, 11, 2], np.int32)  # the last row is shorter than its text


def _logprob(seed, shape=(4, 40, 9)):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal(shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_forward_sum_loss_and_gradient_match_jax(weighted):
    logprob = _logprob(0)
    rows = np.asarray([1, 1, 0, 1], np.float32) if weighted else None
    want, want_grad = jax.value_and_grad(
        lambda a: jal.forward_sum_loss(a, SRC, MEL, row_weights=rows))(jnp.asarray(logprob))
    x = _t(logprob).requires_grad_(True)
    got = tal.forward_sum_loss(x, _t(SRC), _t(MEL), row_weights=None if rows is None else _t(rows))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    assert np.abs(x.grad.numpy() - want_grad).max() <= 1e-5 * np.abs(want_grad).max()


def _tie_cases():
    flat = np.zeros((4, 40, 9), np.float32)  # every path ties
    steps = np.repeat(np.arange(9, dtype=np.float32)[None, None, :], 40, axis=1)
    steps = np.repeat(steps, 4, axis=0)  # rows tie on stay-vs-advance
    coarse = np.round(_logprob(3)).astype(np.float32)  # integer-valued: many ties
    return {"random": _logprob(1), "flat": flat, "steps": steps, "coarse": coarse}


@pytest.mark.parametrize("case", sorted(_tie_cases()))
def test_viterbi_matches_jax_exactly(case):
    logprob = _tie_cases()[case]
    want = np.asarray(jal.viterbi_alignment(jnp.asarray(logprob), SRC, MEL))
    got = tal.viterbi_alignment(_t(logprob), _t(SRC), _t(MEL)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tal.durations_from_hard_attention(_t(got)).numpy(),
                                  np.asarray(jal.durations_from_hard_attention(want)))


def test_binarization_and_phone_averages_match_jax():
    rng = np.random.default_rng(4)
    logprob = _logprob(5)
    soft = np.asarray(jax.nn.softmax(logprob, axis=-1))
    hard = np.asarray(jal.viterbi_alignment(jnp.asarray(logprob), SRC, MEL))
    values = rng.standard_normal((4, 40)).astype(np.float32)
    durations = rng.integers(0, 6, size=(4, 9)).astype(np.int32)
    pairs = [
        (tal.binarization_loss(_t(soft), _t(hard)), jal.binarization_loss(soft, hard)),
        (tal.phone_average(_t(values), _t(hard)), jal.phone_average(values, hard)),
        (tal.phone_average_by_durations(_t(values), _t(durations)),
         jal.phone_average_by_durations(values, durations)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_alignment_encoder_matches_jax():
    rng = np.random.default_rng(6)
    dim, b, t, n = 32, 3, 30, 7
    text_enc = rng.standard_normal((b, n, dim)).astype(np.float32)
    mel = rng.standard_normal((b, t, 80)).astype(np.float32)
    src_mask = np.arange(n)[None] < np.asarray([7, 5, 2])[:, None]
    mel_mask = np.arange(t)[None] < np.asarray([30, 20, 9])[:, None]
    prior = rng.uniform(0.0, 1.0, (b, t, n)).astype(np.float32)
    mod = jal.AlignmentEncoder(dim=dim)
    params = mod.init(jax.random.PRNGKey(0), text_enc, mel, src_mask, mel_mask, prior)
    want = mod.apply(params, text_enc, mel, src_mask, mel_mask, prior)
    enc = tal.AlignmentEncoder(dim)
    p = jax.tree.map(np.asarray, params["params"])
    names = ("key_in", "key_out", "query_in", "query_mid", "query_out")
    with torch.no_grad():
        for i, name in enumerate(names):
            conv = getattr(enc, name)
            conv.weight.copy_(_t(p[f"Conv_{i}"]["kernel"].transpose(2, 1, 0).copy()))
            conv.bias.copy_(_t(p[f"Conv_{i}"]["bias"]))
        got = enc(_t(text_enc), _t(mel), _t(src_mask), _t(mel_mask), _t(prior))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _vp(**extra):
    return {"n_layers": 1, "input_dim": 64, **extra}


MODEL_CASES = {
    "learned_alignment": ({}, 1),
    "given_durations": ({"learn_alignment": False}, 1),
    "frame_level_variances": ({"variance_predictors": {
        "pitch": _vp(level="frame"), "energy": _vp(level="frame"), "duration": _vp()}}, 1),
    "multispeaker": ({"multispeaker": True}, 3),
}


def _case_models(case, tmp_path, dropout=0.0):
    override, n_speakers = MODEL_CASES[case]
    base = make_fs2_config(tmp_path)
    model = {**SMALL_FS2_MODEL, **override}
    for stack in ("encoder", "decoder"):
        model[stack] = {**model[stack], "dropout": dropout}
    config = FastSpeech2Config(contact=CONTACT, model=model,
                               preprocessing=base.preprocessing, text=base.text)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    jmodel = JaxFastSpeech2.from_config(config, n_symbols, n_speakers)
    batch = _batch(n_symbols, learn_alignment=config.model.learn_alignment)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                                  batch["text"], batch["text_lengths"], **_kwargs(batch))
    params = jax.tree.map(np.asarray, params)
    tmodel = FastSpeech2.from_config(fs2_config(config.model_checkpoint_dump()), n_symbols,
                                     n_speakers)
    state, absent = flax_to_torch(params, tmodel)
    assert absent == []
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel.eval(), batch, config


def _batch(n_symbols, learn_alignment=True, seed=0):
    """Three items of 12, 7 and 4 tokens and 48, 30 and 13 frames, padded to
    12 tokens and the stub's 256 frames; z-scored pitch and energy."""
    rng = np.random.default_rng(seed)
    b, n, t = 3, 12, 256
    text_lengths = np.asarray([12, 7, 4], np.int32)
    mel_lengths = np.asarray([48, 30, 13], np.int32)
    text = np.zeros((b, n), np.int32)
    mel = np.zeros((b, t, 80), np.float32)
    pitch = np.zeros((b, t), np.float32)
    energy = np.zeros((b, t), np.float32)
    prior = np.zeros((b, t, n), np.float32)
    for i in range(b):
        text[i, : text_lengths[i]] = rng.integers(2, n_symbols, text_lengths[i])
        m = mel_lengths[i]
        mel[i, :m] = rng.standard_normal((m, 80)) - 4.0
        pitch[i, :m] = rng.standard_normal(m)
        energy[i, :m] = rng.standard_normal(m)
        prior[i, :m, : text_lengths[i]] = rng.uniform(0.01, 1.0, (m, text_lengths[i]))
    out = {"text": text, "text_lengths": text_lengths, "mel": mel, "mel_lengths": mel_lengths,
           "pitch": pitch, "energy": energy, "speaker_id": np.asarray([2, 0, 1], np.int32),
           "language_id": np.zeros(b, np.int32)}
    if learn_alignment:
        out["attn_prior"] = prior
    else:
        durations = np.zeros((b, n), np.int32)
        for i in range(b):  # split each mel length over its tokens
            k = text_lengths[i]
            durations[i, :k] = mel_lengths[i] // k
            durations[i, k - 1] += mel_lengths[i] - durations[i, :k].sum()
        out["durations"] = durations
    return out


def _kwargs(batch):
    keys = ("mel", "mel_lengths", "pitch", "energy", "speaker_id", "language_id",
            "attn_prior", "durations")
    return {k: batch[k] for k in keys if k in batch}


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_training_forward_matches_jax(case, tmp_path):
    jmodel, params, tmodel, batch, _ = _case_models(case, tmp_path)
    want = jmodel.apply(params, batch["text"], batch["text_lengths"], deterministic=True,
                        **_kwargs(batch))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb))
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    assert set(got) == set(want)
    for key in ("attn_hard", "duration_target", "duration_used", "frame_mask", "src_mask"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in sorted(set(want) - {"attn_hard", "duration_target", "duration_used"}):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_losses_and_gradients_match_jax(case, tmp_path):
    jmodel, params, tmodel, batch, config = _case_models(case, tmp_path)
    learn = config.model.learn_alignment
    eval_batch = {**batch, "row_weights": np.asarray([1, 1, 0], np.float32)}

    def loss_fn(p, b, ramp):
        out = jmodel.apply(p, b["text"], b["text_lengths"], deterministic=True, **_kwargs(b))
        losses = jax_losses(out, b, WEIGHTS, learn_alignment=learn, bin_loss_ramp=ramp)
        return losses["total"], losses

    (_, want), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, 0.3)
    tmodel.zero_grad()
    tb = _torch_batch(batch)
    got = compute_fs2_losses(tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb)), tb, WEIGHTS,
                             learn_alignment=learn, bin_loss_ramp=0.3)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)
    got["total"].backward()
    grads = torch_to_flax({n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    flat_want = {jax.tree_util.keystr(k): np.asarray(v)
                 for k, v in jax.tree_util.tree_leaves_with_path(want_grads)}
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(grads)}
    assert set(flat_got) == set(flat_want)
    largest = max(np.abs(w).max() for w in flat_want.values())
    for key, w in flat_want.items():
        if key.endswith("['key']['bias']"):
            # Softmax ignores a constant added to a row of logits, so this
            # gradient is zero in exact arithmetic: both sides hold noise.
            assert np.abs(flat_got[key]).max() <= 1e-6 * largest, key
            continue
        assert np.abs(flat_got[key] - w).max() <= 1e-4 * np.abs(w).max(), key

    # Validation: pad rows weighted out of every term.
    _, want_eval = loss_fn(params, eval_batch, 1.0)
    with torch.no_grad():
        te = _torch_batch(eval_batch)
        got_eval = compute_fs2_losses(tmodel(te["text"], te["text_lengths"], **_kwargs(te)), te,
                                      WEIGHTS, learn_alignment=learn)
    for key in want_eval:
        np.testing.assert_allclose(got_eval[key].item(), float(want_eval[key]), rtol=1e-5,
                                   err_msg=key)


def test_port_dropout_draws_from_its_generator_only(tmp_path):
    """Training mode draws every mask from the trainer's generator (the same
    seed gives the same forward), never from the global RNG; eval mode is
    the identity, as serving needs."""
    from everyvoice_tpu_torch.models.layers import set_dropout_generator

    _, _, tmodel, batch, _ = _case_models("learned_alignment", tmp_path, dropout=0.2)
    tb = _torch_batch(batch)
    outs = []
    for _ in range(2):
        set_dropout_generator(tmodel, torch.Generator().manual_seed(11))
        tmodel.train()
        state = torch.random.get_rng_state()
        with torch.no_grad():
            outs.append(tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb))["mel"])
        assert torch.equal(torch.random.get_rng_state(), state)
    tmodel.eval()
    with torch.no_grad():
        plain = tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb))["mel"]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], plain)
    set_dropout_generator(tmodel, None)
    tmodel.train()
    with pytest.raises(RuntimeError, match="Generator"):
        tmodel(tb["text"], tb["text_lengths"], **_kwargs(tb))


OPTIMIZERS = {
    "noam_adamw": (NoamOptimizer(learning_rate=1e-3, weight_decay=1e-2, betas=[0.9, 0.999],
                                 warmup_steps=4), None),
    "noam_adamw_clipped": (NoamOptimizer(learning_rate=1e-3, weight_decay=1e-2,
                                         betas=[0.9, 0.999], warmup_steps=4), 0.5),
    "adamw": (AdamWOptimizer(learning_rate=1e-3), None),
    "adam": (AdamOptimizer(learning_rate=1e-3), None),
    "rms": (RMSOptimizer(learning_rate=1e-3, eps=1e-6), None),
}


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name, steps):
    cfg, clip = OPTIMIZERS[name]
    rng = np.random.default_rng(8)
    shapes = {"a": (5,), "b/k": (3, 4), "b/bias": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (2.0 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]

    def tree(flat):
        return {"params": {"a": flat["a"], "b": {"k": flat["b/k"], "bias": flat["b/bias"]}}}

    def untree(t):
        return {"a": t["params"]["a"], "b/k": t["params"]["b"]["k"],
                "b/bias": t["params"]["b"]["bias"]}

    jopt = jax_build_optimizer(cfg, gradient_clip_val=clip)
    jparams = tree({k: jnp.asarray(v) for k, v in params.items()})
    jstate = jopt.init(jparams)
    for g in grads:
        updates, jstate = jopt.update(tree({k: jnp.asarray(v) for k, v in g.items()}), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)

    opt = build_optimizer(cfg.model_dump(), gradient_clip_val=clip)
    tparams = {k: _t(v.copy()) for k, v in params.items()}
    state = opt.init(tparams)
    for g in grads:
        opt.step(tparams, {k: _t(v) for k, v in g.items()}, state)
    want = untree(jax.tree.map(np.asarray, jparams))
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)

    # The state in the optax layout: same tree, same values.
    want_state = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    got_state = opt.to_optax(state, lambda named: tree({k: v.numpy() for k, v in named.items()}))
    assert jax.tree.structure(got_state) == jax.tree.structure(want_state)
    for g, w in zip(jax.tree.leaves(got_state), jax.tree.leaves(want_state)):
        assert np.asarray(g).dtype == w.dtype and np.asarray(g).shape == w.shape
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=1e-6)
    back = opt.from_optax(got_state, lambda t: {k: _t(v) for k, v in untree(t).items()})
    assert (back["count"], back["schedule_count"]) == (state["count"], state["schedule_count"])


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 1000])
def test_learning_rate_at_matches_jax(step):
    for cfg, _ in OPTIMIZERS.values():
        assert learning_rate_at(cfg.model_dump(), step) == pytest.approx(
            jax_learning_rate_at(cfg, step), rel=1e-12)


def test_first_noam_update_uses_the_pre_increment_count():
    """optax evaluates the schedule at the count before the update, and
    Noam adds 1 to it: the first step's rate is noam(0)."""
    cfg = NoamOptimizer(learning_rate=1e-3, warmup_steps=4, weight_decay=0.0)
    opt = build_optimizer(cfg.model_dump())
    p = {"w": torch.zeros(1)}
    state = opt.init(p)
    opt.step(p, {"w": torch.ones(1)}, state)
    # Adam's first update is g/|g| = 1, so the parameter moves by the rate.
    assert -p["w"].item() == pytest.approx(1e-3 * 4**0.5 * 4**-1.5, rel=1e-6)
    assert learning_rate_at(cfg.model_dump(), 0) == pytest.approx(-p["w"].item(), rel=1e-6)

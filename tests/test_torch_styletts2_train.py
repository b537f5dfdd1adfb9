"""The port's StyleTTS2 training pieces (everyvoice_tpu_torch/models/
styletts2/{loss,model,train}.py) against the JAX package's, on the CPU, in
float32, at small widths (hidden 32, style 16, one upsampling stage; the
decoder's convs are 512 channels whatever the config says), on inputs made from seeded numpy, with flax
parameters in shapes from ``jax.eval_shape``. The JAX step's draws (clip
starts, both decodes' source noise, the diffusion's σ and noises) are made
with ``jax.random`` from the JAX trainer's keys, as its step splits them,
and handed to the port; dropout is off on both sides (flax's ``Dropout``
swapped for the identity while this file runs; the port's at rate 0).

Tolerances, with their reasons:
- each loss: 1e-5 relative, float32 reductions in another order;
- the training forward, every output key: rtol 1e-4, atol 1e-5 on the
  text side; the wav 2e-4 of max|ref| (the decoder's tolerance in
  ``test_torch_styletts2.py``);
- one step's discriminator and generator gradients against ``jax.grad``:
  1e-4 of each leaf's largest magnitude, elementwise (a leaf whose
  gradient is zero, as the stage-1 denoiser's, exactly zero; the scale
  and bias of a ResBlock's first conv, whose gradient is zero in exact
  arithmetic because an AdaIN follows, 1e-4 of that conv's kernel
  gradient's largest magnitude), float32
  sums in another order through the 512-channel decoder and the
  discriminators; the discriminators' 5e-4, since their first layers'
  gradients are linear in the decoded wav, itself held to 2e-4 of its
  peak; the step's losses 1e-4 relative (atol 1e-7 for the
  losses that are 0 before the TMA phase);
- the optimizer against ``optax.adamw`` over three updates: 1e-6 absolute
  on the parameters and the moments;
- ``phase_weights``: exact.
"""

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp
import optax
from flax import serialization

from everyvoice_tpu.models.hifigan.model import MultiPeriodDiscriminator, MultiScaleDiscriminator
from everyvoice_tpu.models.styletts2 import loss as jax_loss
from everyvoice_tpu.models.styletts2.config import StyleTTS2Config
from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu_torch.config import styletts2_config
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.layers import Dropout
from everyvoice_tpu_torch.models.styletts2 import loss as port_loss
from everyvoice_tpu_torch.models.styletts2.train import (
    StepDraws,
    StyleTTS2Trainer,
    adamw_config,
)
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.optim import build_optimizer
from model_stubs import CONTACT

B, N_TEXT, MAX_LEN, SEGMENT, HOP = 2, 12, 48, 16, 256
TEXT_LENGTHS = np.asarray([12, 8], np.int32)
MEL_LENGTHS = np.asarray([48, 35], np.int32)
LOSS_TOL = 1e-5
TEXT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-4
DISC_GRAD_TOL = 5e-4
# One upsampling stage of 8 and an iSTFT of hop 32 (n_fft 64) for the
# rest of the 256-sample hop: the decoder's convs stay 512 channels with
# kernels 3/7/11, the JAX package's compile of a step halves.
N_FFT = 64
MODEL = {"hidden_dim": 32, "style_dim": 16, "max_dur": 20,
         "decoder": {"mpd_layers": [2], "msd_layers": 1, "upsample_rates": [8],
                     "upsample_kernel_sizes": [16], "gen_istft_n_fft": N_FFT,
                     "gen_istft_hop_size": 32},
         "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2, "head_features": 8}}}


def _raw(tmp, **losses) -> dict:
    return {
        "contact": CONTACT,
        "model": MODEL,
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "preprocessing": {"save_dir": str(tmp / "pre")},
        "training": {"batch_size": B, "max_len": MAX_LEN, "decoder_segment_frames": SEGMENT,
                     "losses": {"tma_epoch": 1, "diff_epoch": 1, **losses},
                     "logger": {"save_dir": str(tmp / "logs"), "name": "parity"}},
    }


class _Data:
    """What the trainers read of a dataset before ``fit``."""

    def __init__(self, text_processor):
        self.text_processor = text_processor
        self.n_symbols = len(text_processor.symbols)
        self.items: list = []


class _NoiseKey(flax.linen.Module):
    """The key a top-level module's ``make_rng("noise")`` gives: the one
    ``StyleTTS2Module.__call__`` hands its decoder's source."""

    @flax.linen.compact
    def __call__(self):
        return self.make_rng("noise")


def source_noise(key, n: int):
    """The decoder source's (B, n) standard normal draw in a JAX forward
    given ``rngs={"noise": key}``."""
    return jax.random.normal(_NoiseKey().apply({}, rngs={"noise": key}), (B, n, 1))[..., 0]


class _IdentityDropout(flax.linen.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(autouse=True, scope="module")
def no_dropout_one_thread():
    """flax's dropout is the identity in this file (the port's runs at rate
    0 instead); torch on one thread beside the other test workers."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen, "Dropout", _IdentityDropout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    patch.undo()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seeded_tree(shapes, seed: int):
    """Seeded values in a flax tree's shapes: kernels of variance
    1/fan-in, embeddings of unit variance, biases about 0 and scales
    (norms, weight norms, snake alphas) about 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(shape.shape).astype(np.float32)
        if "kernel" in name and "scale" not in name:
            return noise / np.sqrt(np.prod(shape.shape[:-1]))
        if "scale" in name or "alpha" in name:
            return 1.0 + 0.1 * noise
        return noise if len(shape.shape) > 1 else 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(seed: int = 0) -> dict:
    """A batch as ``StyleTTS2Dataset`` gives one: padded text, a loud
    real-like mel and tone-plus-noise audio, F0 and energy frames with
    their token means over the (uniform) durations."""
    rng = np.random.default_rng(seed)
    text = rng.integers(2, 28, (B, N_TEXT)).astype(np.int32)
    text[np.arange(N_TEXT)[None] >= TEXT_LENGTHS[:, None]] = 0
    frames = np.arange(MAX_LEN)[None] < MEL_LENGTHS[:, None]
    mel = np.where(frames[..., None], rng.normal(-4.0, 2.0, (B, MAX_LEN, 80)), 0.0)
    f0 = np.where(frames, rng.uniform(80, 250, (B, MAX_LEN)), 0.0)
    energy = np.where(frames, rng.normal(0.0, 1.0, (B, MAX_LEN)), 0.0)
    durations = np.zeros((B, N_TEXT), np.int32)
    f0_tok, energy_tok = np.zeros((B, N_TEXT)), np.zeros((B, N_TEXT))
    for i in range(B):
        n, t = TEXT_LENGTHS[i], MEL_LENGTHS[i]
        durations[i, :n] = t // n
        durations[i, n - 1] += t - durations[i, :n].sum()
        ends = np.cumsum(durations[i, :n])
        for j, (a, b) in enumerate(zip(ends - durations[i, :n], ends)):
            f0_tok[i, j], energy_tok[i, j] = f0[i, a:b].mean(), energy[i, a:b].mean()
    t = np.arange(MAX_LEN * HOP) / 22050
    audio = (0.5 * np.sin(2 * np.pi * np.array([[140.0], [210.0]]) * t)
             + 0.05 * rng.standard_normal((B, t.size)))
    audio *= np.arange(MAX_LEN * HOP)[None] < MEL_LENGTHS[:, None] * HOP
    f32 = np.float32
    return {"text": text, "text_lengths": TEXT_LENGTHS, "mel": mel.astype(f32),
            "mel_lengths": MEL_LENGTHS, "f0_frames": f0.astype(f32),
            "energy_frames": energy.astype(f32), "f0_tokens": f0_tok.astype(f32),
            "energy_tokens": energy_tok.astype(f32), "durations": durations,
            "audio": audio.astype(f32)}


def jax_step_draws(rng, batch: dict, style_dim: int) -> tuple:
    """(the key the step hands on, StepDraws) as the JAX step splits its
    key: ``split(rng, 4)`` into the next key, d, g and segment keys; the
    segment starts uniform over each row's span; the disc decode's noise
    from the ``noise`` stream ``split(rng_d, 3)[0]``; the gen decode's
    from ``split(rng_g, 4)[0]``; the diffusion's from ``split(rng_g,
    4)[1]``: split again for σ and its noise, and whole for the style
    reconstruction's noise."""
    rng, rng_d, rng_g, rng_seg = jax.random.split(rng, 4)
    max_start = jnp.maximum(jnp.asarray(batch["mel_lengths"]) - SEGMENT, 0)
    starts = jax.random.randint(rng_seg, (B,), 0, max_start + 1)
    n = SEGMENT * HOP
    d_noise = source_noise(jax.random.split(rng_d, 3)[0], n)
    g_noise_key, g_diff = jax.random.split(rng_g, 4)[:2]
    g_noise = source_noise(g_noise_key, n)
    key_sigma, key_noise = jax.random.split(g_diff)
    draws = StepDraws(
        segment_starts=_t(starts).long(), disc_noise=_t(d_noise), gen_noise=_t(g_noise),
        log_sigma=_t(jax.random.normal(key_sigma, (B,))),
        diffusion_noise=_t(jax.random.normal(key_noise, (B, 2 * style_dim))),
        style_noise=_t(jax.random.normal(g_diff, (B, 2 * style_dim))))
    return rng, {"rng_d": rng_d, "rng_g": rng_g, "starts": starts}, draws


def port_trainer(raw, tmp, mode, text_processor, **kwargs) -> StyleTTS2Trainer:
    config = styletts2_config(raw)
    data = _Data(text_processor)
    trainer = StyleTTS2Trainer(config, data, data, {"default": 0}, run_dir=tmp / f"port-{mode}",
                               mode=mode, compute_dtype="float32", device="cpu", **kwargs)
    for module in trainer.model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    return trainer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' trainers of both stages, seeded parameters in flax's
    shapes (``eval_shape``: nothing compiles), one batch."""
    tmp = tmp_path_factory.mktemp("st2_train")
    raw = _raw(tmp)
    config = StyleTTS2Config(**raw)
    jax_tp = JaxTextProcessor(config.text)
    mesh = make_mesh(jax.devices("cpu")[:1])
    jax_trainers = {}
    for mode in ("first", "second"):
        trainer = JaxTrainer(config, _Data(jax_tp), _Data(jax_tp), lang2id={"default": 0},
                             mesh=mesh, run_dir=tmp / f"jax-{mode}", mode=mode,
                             compute_dtype="float32")
        trainer.build_steps()
        jax_trainers[mode] = trainer
    batch = make_batch()
    model = jax_trainers["first"].model
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "dropout": key, "noise": key}, batch["text"],
                           batch["text_lengths"], batch["mel"], durations=batch["durations"],
                           f0_frames=batch["f0_frames"], energy_frames=batch["energy_frames"],
                           deterministic=False))
    wav = jnp.zeros((2, 4096))
    disc_shapes = {
        "mpd": jax.eval_shape(MultiPeriodDiscriminator(periods=(2,)).init, key, wav),
        "msd": jax.eval_shape(MultiScaleDiscriminator(n_scales=1).init, key, wav)}
    tp = TextProcessor(styletts2_config(raw)["text"])
    return {"tmp": tmp, "raw": raw, "jax": jax_trainers, "batch": batch, "tp": tp,
            "gen_params": audio_sized(seeded_tree(shapes, 1)),
            "disc_params": seeded_tree(disc_shapes, 2)}


def audio_sized(params):
    """Seeded generator parameters whose decoder's iSTFT head gives wavs of
    about an audio's size (the magnitude's log near −2, its weight norm's
    scale cut 50-fold), as ``onchip.write_styletts2_checkpoint`` lowers its
    own: at seeded scale the wavs peak near 400, and float32 cannot then
    resolve the discriminators' gradients to 1e-4."""
    decoder = params["params"]["decoder"]
    decoder["Conv_2"]["bias"][: N_FFT // 2 + 1] = -2.0
    decoder["WeightNorm_2"]["Conv_2/kernel/scale"] *= 0.02
    return params


# ---------------------------------------------------------------------------
# losses


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, N_TEXT, 20)).astype(np.float32) * 2
    targets = rng.integers(0, 30, (B, N_TEXT)).astype(np.int32)  # some above max_dur - 1
    mask = np.arange(N_TEXT)[None] < TEXT_LENGTHS[:, None]
    pred, want = rng.standard_normal((2, B, N_TEXT)).astype(np.float32)
    s2s = rng.standard_normal((B, N_TEXT + 1, 30)).astype(np.float32)
    style, clean = rng.standard_normal((2, B, 8)).astype(np.float32)
    emb = rng.standard_normal((B, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    key_sigma, key_noise = jax.random.split(key)
    w = rng.standard_normal((8 + 6, 8)).astype(np.float32) * 0.3
    cases = {
        "ce": (port_loss.duration_ce_loss(_t(logits), _t(targets), _t(mask), 20),
               jax_loss.duration_ce_loss(logits, targets, mask, 20)),
        "dur": (port_loss.duration_l1_loss(_t(logits), _t(targets), _t(mask)),
                jax_loss.duration_l1_loss(logits, targets, mask)),
        "f0": (port_loss.f0_loss(_t(pred), _t(want), _t(mask)), jax_loss.f0_loss(pred, want, mask)),
        "norm": (port_loss.norm_loss(_t(pred), _t(want), _t(mask)),
                 jax_loss.norm_loss(pred, want, mask)),
        "s2s": (port_loss.asr_s2s_loss(_t(s2s), _t(targets % 30), _t(mask)),
                jax_loss.asr_s2s_loss(s2s, targets % 30, mask)),
        "sty": (port_loss.style_reconstruction_loss(_t(style), _t(clean)),
                jax_loss.style_reconstruction_loss(style, clean)),
        "diff": (port_loss.diffusion_edm_loss(
                     lambda x, s, e: torch.cat([x, e], -1) @ _t(w) * s[:, None],
                     _t(jax.random.normal(key_sigma, (B,))), _t(jax.random.normal(key_noise, (B, 8))),
                     _t(clean), _t(emb)),
                 jax_loss.diffusion_edm_loss(
                     lambda x, s, e: jnp.concatenate([x, e], -1) @ w * s[:, None], key, clean, emb)),
        "mel": (port_loss.mel_reconstruction_loss(_t(style), _t(clean), torch.exp, torch.tanh),
                jax_loss.mel_reconstruction_loss(style, clean, jnp.exp, jnp.tanh)),
    }
    for name, (got, want_value) in cases.items():
        np.testing.assert_allclose(got.item(), float(want_value), rtol=LOSS_TOL, err_msg=name)


def test_phase_weights_and_tma_flags_match(setup, tmp_path):
    jt = setup["jax"]
    for mode in ("first", "second"):
        port = port_trainer(setup["raw"], tmp_path, mode, setup["tp"])
        for epoch in range(4):
            assert port.phase_weights(epoch) == tuple(float(x) for x in jt[mode].phase_weights(epoch))
            # the JAX fit's static flag (train.py:1166-1169)
            assert port.tma_active(epoch) == (mode == "second" or epoch >= 1)


# ---------------------------------------------------------------------------
# the training forward


def test_training_forward_matches_apply(setup, tmp_path):
    """Every output key of the JAX module's ``__call__`` with teacher
    durations and F0, a clip an utterance and the JAX noise draw."""
    batch, params = setup["batch"], setup["gen_params"]
    model = setup["jax"]["first"].model
    starts = np.asarray([5, 19], np.int32)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p: model.apply(
        p, batch["text"], batch["text_lengths"], batch["mel"], durations=batch["durations"],
        f0_frames=batch["f0_frames"], energy_frames=batch["energy_frames"],
        mel_lengths=batch["mel_lengths"], deterministic=False,
        rngs={"noise": key, "dropout": key}, segment_starts=starts))(params)
    noise = source_noise(key, SEGMENT * HOP)
    port = port_trainer(setup["raw"], tmp_path, "first", setup["tp"])
    port.load_params({"generator": params})
    got = port.model(_t(batch["text"]).long(), _t(batch["text_lengths"]), _t(batch["mel"]),
                     _t(batch["mel_lengths"]), _t(batch["durations"]), _t(batch["f0_frames"]),
                     _t(noise), segment_starts=_t(starts))
    assert set(got) == set(want)
    for key_name, value in want.items():
        g, w = got[key_name].detach().numpy(), np.asarray(value)
        assert g.shape == w.shape, key_name
        if key_name == "wav":
            assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()
        elif w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key_name)
        else:
            np.testing.assert_allclose(g, w, **TEXT_TOL, err_msg=key_name)


# ---------------------------------------------------------------------------
# one step's gradients


def _assert_grads_close(got: dict, want: dict, what: str, tol: float = GRAD_TOL):
    assert set(got) <= set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape, name
        err, peak = float(np.abs(g - w).max()), float(np.abs(w).max())
        if ".convs1." in name and not name.endswith(".weight"):
            # An AdaIN normalizes this conv's output per channel next: the
            # gradient of its scale and bias is 0 in exact arithmetic.
            peak = float(np.abs(np.asarray(want[name.rsplit(".", 1)[0] + ".weight"])).max())
        assert err <= tol * peak, (what, name, err, peak)


_JITTED: dict = {}


def _jitted(trainer, name: str, static: tuple):
    """``jax.value_and_grad`` of a JAX trainer's loss closure, jitted once
    per trainer."""
    key = (id(trainer), name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.value_and_grad(trainer._step_closures[name], has_aux=True),
                               static_argnums=static)
    return _JITTED[key]


@pytest.mark.parametrize("mode,epoch", [("first", 0), ("first", 1), ("second", 0)],
                         ids=["stage1-before-tma", "stage1-tma", "stage2"])
def test_step_gradients_match_jax_grad(setup, tmp_path, mode, epoch):
    """``train_step`` hands its optimizers the gradients ``jax.grad`` gives
    of the JAX trainer's two loss functions with the same draws: the
    discriminators' at the step's start, the generator's against the
    discriminators after their update. In stage 2 at epoch 0 the diffusion
    losses are computed and weighted 0, as in the JAX step."""
    jt = setup["jax"][mode]
    closures = jt._step_closures
    batch, gen_params, disc_params = setup["batch"], setup["gen_params"], setup["disc_params"]
    tma = mode == "second" or epoch >= 1
    phase = jt.phase_weights(epoch)
    _, keys, draws = jax_step_draws(jax.random.PRNGKey(epoch + 7), batch, 16)
    jbatch = jax.tree.map(jnp.asarray, batch)
    targets = jax.jit(closures["alignment_targets"], static_argnums=2)(gen_params, jbatch, tma)
    targets["segment_starts"] = keys["starts"]

    port = port_trainer(setup["raw"], tmp_path, mode, setup["tp"])
    port.load_params({"generator": gen_params, "discriminators": disc_params})
    port.gen_opt_state = port.gen_opt.init(port.gen_params)
    port.disc_opt_state = port.disc_opt.init(port.disc_params)
    seen = {}

    def spy(name, opt):
        step = opt.step

        def recorded(params, grads, state):
            seen[name] = {n: None if g is None else g.detach().clone() for n, g in grads.items()}
            return step(params, grads, state)
        return recorded

    port.gen_opt.step = spy("gen", port.gen_opt)
    port.disc_opt.step = spy("disc", port.disc_opt)
    tbatch = {k: _t(v).long() if k == "text" else _t(v) for k, v in batch.items()}
    losses = port.train_step(tbatch, draws, epoch=epoch)
    updated_disc = torch_to_flax(port.discriminators.state_dict(), port.discriminators)

    # Everything an argument, nothing closed over: XLA would fold the
    # parameters in as constants, for minutes.
    (d_loss, _), d_grads = _jitted(setup["jax"]["first"], "disc_loss_fn", (7,))(
        disc_params, gen_params, jbatch, keys["rng_d"], None, phase, targets, False)
    (g_loss, g_losses), g_grads = _jitted(jt, "gen_loss_fn", (7, 8))(
        gen_params, updated_disc, jbatch, keys["rng_g"], None, phase, targets, False, tma)
    np.testing.assert_allclose(losses["disc/total"].item(), float(d_loss), rtol=1e-4)
    assert {f"gen/{k}" for k in g_losses} | {"disc/total"} == set(losses)
    for k, v in g_losses.items():
        np.testing.assert_allclose(losses[f"gen/{k}"].item(), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    _assert_grads_close(seen["disc"], flax_to_torch(_np(d_grads), port.discriminators)[0], "disc",
                        DISC_GRAD_TOL)
    _assert_grads_close(seen["gen"], flax_to_torch(_np(g_grads), port.model)[0], "gen")


# ---------------------------------------------------------------------------
# the optimizer


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax_adamw(clip):
    """``optax.adamw(lr)`` with optax's defaults (weight decay 1e-4), after
    ``clip_by_global_norm`` with a clip value, over three updates; the
    state converts to optax's layout and back."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    base = optax.adamw(1e-3)
    opt = optax.chain(optax.clip_by_global_norm(clip), base) if clip else base
    state = opt.init(params)
    want = params
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)
    port = build_optimizer(adamw_config(1e-3), gradient_clip_val=clip)
    got = {k: _t(v) for k, v in params.items()}
    port_state = port.init(got)
    for g in grads:
        port.step(got, {k: _t(v) for k, v in g.items()}, port_state)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6)
    identity = lambda named: {k: v.numpy() for k, v in named.items()}  # noqa: E731
    layout = port.to_optax(port_state, identity)
    restored = serialization.from_state_dict(opt.init(params), layout)
    for got_leaf, want_leaf in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_allclose(np.asarray(got_leaf), np.asarray(want_leaf), atol=1e-6)
    back = port.from_optax(serialization.to_state_dict(state), lambda t: {k: _t(v) for k, v in t.items()})
    assert back["count"] == 3
    for k in params:
        np.testing.assert_allclose(back["mu"][k].numpy(), port_state["mu"][k].numpy(), atol=1e-6)

"""HiFiGAN training's modules, the port's against the JAX package's, on the
CPU in float32: the ResBlock2 and iSTFT generators, spectral norm, the MPD
and MSD, the losses and the gradients of both GAN steps.

Inputs are seeded numpy arrays; JAX parameters cross over through
``flax_to_torch``. Tolerances:
- generators: rtol = atol = 2e-4 (tests/test_ops.py's for the generator);
- spectral norm, MPD and MSD scores and features: 1e-4 of max|ref| (float32
  sums in another order; features compared transposed to the JAX NHWC/NWC);
- losses: 1e-5 relative;
- gradients against ``jax.grad``: 1e-4 of each leaf's largest magnitude.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from everyvoice_tpu.dsp import get_spectral_transform as jax_spectral_transform
from everyvoice_tpu.dsp.spectral import dynamic_range_compression as jax_drc
from everyvoice_tpu.models.hifigan import loss as jax_loss
from everyvoice_tpu.models.hifigan import model as jax_model
from everyvoice_tpu.models.hifigan.config import HiFiGANConfig
from everyvoice_tpu_torch.config import hifigan_training_config, model_checkpoint_dump
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.hifigan import loss as port_loss
from everyvoice_tpu_torch.models.hifigan import model as port_model
from everyvoice_tpu_torch.train.loop import HiFiGANTrainer
from model_stubs import CONTACT

TOL = 1e-4


def _scaled(params, seed=0):
    """Non-unit weight-norm scales and nonzero biases, so folding and bias
    paths are exercised."""
    rng = np.random.default_rng(seed)

    def bump(path, v):
        key = jax.tree_util.keystr(path)
        if "scale" in key:
            return v * (1.0 + 0.5 * jnp.asarray(rng.uniform(-1, 1, v.shape), v.dtype))
        if "bias" in key:
            return v + 0.05 * jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(bump, params)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, params):
    state, absent = flax_to_torch(_np(params), module)
    assert absent == []
    module.load_state_dict(state)
    return module


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


# -- config -------------------------------------------------------------------

DATASET = {"label": "d", "permissions_obtained": True, "data_dir": "/data", "filelist": "/data/f.psv"}


@pytest.mark.parametrize("given", ["defaults", "istft_wgan"])
def test_training_config_dumps_as_pydantic(given):
    """``hifigan_training_config`` fills in the JAX ``HiFiGANConfig``'s
    defaults: the checkpoint dumps are equal, path fields dropped alike."""
    raw = {"contact": CONTACT, "preprocessing": {"source_data": [DATASET]},
           "training": {"logger": {"save_dir": "/logs"}, "training_filelist": "/t.psv"}}
    if given == "istft_wgan":
        raw["model"] = {"istft_layer": True, "upsample_rates": [8, 8],
                        "upsample_kernel_sizes": [16, 16], "resblock": "2"}
        raw["training"].update(gan_type="wgan", generator_warmup_steps=5, wgan_clip_value=0.02)
    want = HiFiGANConfig(**raw).model_checkpoint_dump()
    assert model_checkpoint_dump(hifigan_training_config(raw)) == want


@pytest.mark.parametrize("bad", ["no_contact", "rates_not_hop", "istft_rates_not_dividing"])
def test_training_config_refuses_as_pydantic(bad):
    raw = {"contact": CONTACT}
    if bad == "no_contact":
        raw = {}
    elif bad == "rates_not_hop":
        raw["model"] = {"upsample_rates": [8, 8, 2]}
    else:
        raw["model"] = {"istft_layer": True, "upsample_rates": [8, 3]}
    with pytest.raises(ValueError):
        HiFiGANConfig(**raw)
    with pytest.raises(ValueError, match="contact" if bad == "no_contact" else "upsample_rates"):
        hifigan_training_config(raw)


# -- generators ---------------------------------------------------------------

GENERATORS = {
    # tests/test_ops.py:143-183's shapes
    "resblock2": dict(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                      upsample_initial_channel=32, resblock="2",
                      resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3))),
    "istft_resblock1": dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3),), istft_layer=True,
                            istft_n_fft=16, istft_hop=4),
    "istft_resblock2": dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                            upsample_initial_channel=32, resblock="2",
                            resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (2,)),
                            istft_layer=True, istft_n_fft=16, istft_hop=4),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_variants_match_flax(name):
    kwargs = GENERATORS[name]
    jgen = jax_model.HiFiGANGenerator(**kwargs)
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 15, 80)).astype(np.float32)  # odd T
    params = _scaled(jgen.init(jax.random.PRNGKey(3), jnp.asarray(mel)))
    tgen = _load(port_model.HiFiGANGenerator(**kwargs), params)
    want = np.asarray(jgen.apply(params, jnp.asarray(mel)))
    hop = int(np.prod(kwargs["upsample_rates"])) * kwargs.get("istft_hop", 1)
    assert want.shape == (2, 15 * hop)
    with torch.no_grad():
        trained = tgen.train_forward(torch.from_numpy(mel)).numpy()
    served = tgen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(trained, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(served, want, rtol=2e-4, atol=2e-4)
    back = torch_to_flax(tgen.state_dict(), tgen)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(_at(back, path), np.asarray(leaf))


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_inference_forward_refolds_after_an_update():
    """The packed MRF weights follow an in-place parameter update (an
    optimizer step) without a call to ``prepare``."""
    kwargs = {k: v for k, v in GENERATORS["istft_resblock1"].items()}
    tgen = port_model.HiFiGANGenerator(**kwargs)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tgen.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen) + (p.dim() == 1))
    mel = torch.randn(1, 6, 80, generator=gen)
    before = tgen(mel)
    with torch.no_grad():
        tgen.resblocks[0].convs[0].weight.mul_(1.5)
        want = tgen.train_forward(mel)
    after = tgen(mel)
    assert not torch.allclose(before, after)
    np.testing.assert_allclose(after.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("length,kernel,stride,dilation", [
    (100, 41, 2, 1), (101, 41, 4, 1), (64, 41, 4, 1), (33, 15, 1, 1), (50, 3, 1, 5),
    (7, 11, 3, 2),
])
def test_conv_same_matches_flax_padding(length, kernel, stride, dilation):
    """flax's "SAME" pads strided convs asymmetrically (k 41: stride 2 pads
    19 | 20, stride 4 pads 18 | 19); the port pads alike."""
    rng = np.random.default_rng(length + kernel)
    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    mod = nn.Conv(4, (kernel,), strides=(stride,), kernel_dilation=(dilation,), padding="SAME")
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    kern = np.asarray(params["params"]["kernel"]).transpose(2, 1, 0)
    bias = np.asarray(params["params"]["bias"]) + 0.1
    want = want + 0.1
    got = port_model.conv_same(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(kern)),
                               torch.from_numpy(bias), stride=stride, dilation=dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_same_padding_of_the_msd():
    assert port_model.same_padding(8192, 41, 2) == (19, 20)
    assert port_model.same_padding(8192, 41, 4) == (18, 19)
    assert port_model.same_padding(8192, 4, 2) == (1, 1)
    assert port_model.same_padding(8191, 4, 2) == (1, 2)


# -- discriminators -------------------------------------------------------------


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 4), (4, 16)])
def test_spectral_norm_conv_matches_flax(stride, groups):
    rng = np.random.default_rng(stride * 10 + groups)
    x = rng.standard_normal((2, 77, 32)).astype(np.float32)
    mod = jax_model.SpectralNormConv(64, kernel_size=41, strides=stride, feature_group_count=groups)
    params = _scaled(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    conv = port_model.SpectralNormConv1d(32, 64, 41, stride=stride, groups=groups)
    p = params["params"]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).transpose(2, 1, 0).copy()))
        conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    _close(got, want)


def _disc_pair(kind):
    if kind == "mpd":
        return (jax_model.MultiPeriodDiscriminator(periods=(2, 3)),
                port_model.MultiPeriodDiscriminator(periods=(2, 3)))
    return (jax_model.MultiScaleDiscriminator(n_scales=2),
            port_model.MultiScaleDiscriminator(n_scales=2))


def _to_jax_layout(feat: np.ndarray) -> np.ndarray:
    # (B, C, T/p, p) → NHWC, (B, C, T) → NWC
    return feat.transpose(0, 2, 3, 1) if feat.ndim == 4 else feat.transpose(0, 2, 1)


@pytest.mark.parametrize("kind,length", [("mpd", 301), ("msd", 301), ("mpd", 300)])
def test_discriminators_match_flax(kind, length):
    """Scores and every feature map; T = 301 is a multiple of neither
    period (the MPD reflect-pads its end) and odd (the MSD's pool pads
    1 | 2)."""
    jd, td = _disc_pair(kind)
    rng = np.random.default_rng(length)
    wav = (0.5 * rng.standard_normal((2, length))).astype(np.float32)
    params = _scaled(jax.jit(jd.init)(jax.random.PRNGKey(4), jnp.asarray(wav)), seed=4)
    _load(td, params)
    want_scores, want_feats = jax.jit(jd.apply)(params, jnp.asarray(wav))
    with torch.no_grad():
        scores, feats = td(torch.from_numpy(wav))
    assert len(scores) == len(want_scores) == 2
    for got, want in zip(scores, want_scores):
        _close(got.numpy(), want)
    for got_layers, want_layers in zip(feats, want_feats, strict=True):
        assert len(got_layers) == len(want_layers)
        for got, want in zip(got_layers, want_layers):
            _close(_to_jax_layout(got.numpy()), want)


def test_avg_pool_matches_flax():
    for length in (10, 11):
        x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
        want = nn.avg_pool(jnp.asarray(x)[..., None], (4,), strides=(2,), padding="SAME")[..., 0]
        got = port_model.avg_pool_same(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


# -- losses ---------------------------------------------------------------------


@pytest.mark.parametrize("gan_type", ["original", "wgan"])
def test_losses_match_jax(gan_type):
    rng = np.random.default_rng(7)
    real = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    fake = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    feats_r = [[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (6, 3)]
               for _ in range(3)]
    feats_f = [[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (6, 3)]
               for _ in range(3)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    pairs = [
        (port_loss.discriminator_loss(t(real), t(fake), gan_type),
         jax_loss.discriminator_loss(real, fake, gan_type)),
        (port_loss.generator_adversarial_loss(t(fake), gan_type),
         jax_loss.generator_adversarial_loss(fake, gan_type)),
        (port_loss.feature_matching_loss([t(f) for f in feats_r], [t(f) for f in feats_f]),
         jax_loss.feature_matching_loss(feats_r, feats_f)),
        (port_loss.mel_l1_loss(torch.from_numpy(real[1]), torch.from_numpy(fake[1])),
         jax_loss.mel_l1_loss(real[1], fake[1])),
    ]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert (port_loss.MEL_LOSS_WEIGHT, port_loss.FEATURE_MATCHING_WEIGHT) == (
        jax_loss.MEL_LOSS_WEIGHT, jax_loss.FEATURE_MATCHING_WEIGHT)


# -- gradients of the GAN step --------------------------------------------------

SMALL_AUDIO = {"n_fft": 128, "fft_window_size": 128, "fft_hop_size": 16, "n_mels": 20,
               "vocoder_segment_size": 256}
SMALL_MODEL = {"upsample_rates": [8, 2], "upsample_kernel_sizes": [16, 4],
               "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 5],
               "resblock_dilation_sizes": [[1, 3], [1, 2]], "mpd_layers": [3],
               "msd_layers": 2}


def _small_trainer(tmp_path, gan_type):
    config = hifigan_training_config({
        "contact": CONTACT, "model": SMALL_MODEL,
        "preprocessing": {"audio": SMALL_AUDIO},
        "training": {"gan_type": gan_type, "logger": {"save_dir": str(tmp_path)}},
    })

    class Data:
        items: list = []

    return HiFiGANTrainer(config, Data(), Data(), run_dir=tmp_path / "run", device="cpu")


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= TOL * scale, name


JAX_GEN = dict(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4), upsample_initial_channel=32,
               resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)))


@pytest.fixture(scope="module")
def gan_inputs():
    """The JAX modules, their parameters and one batch, for both gan types."""
    jgen = jax_model.HiFiGANGenerator(**JAX_GEN)
    mpd = jax_model.MultiPeriodDiscriminator(periods=(3,))
    msd = jax_model.MultiScaleDiscriminator(n_scales=2)
    rng = np.random.default_rng(11)
    frames = SMALL_AUDIO["vocoder_segment_size"] // SMALL_AUDIO["fft_hop_size"]
    mel = rng.standard_normal((2, frames, SMALL_AUDIO["n_mels"])).astype(np.float32)
    # A loud tone, unlike the random generator's output: the wgan gradient of
    # a score layer is the difference of the real and fake features' means,
    # which float32 cannot resolve to 1e-4 where the two nearly agree.
    t = np.arange(SMALL_AUDIO["vocoder_segment_size"]) / 22050
    audio = (0.8 * np.sin(2 * np.pi * np.array([[220.0], [330.0]]) * t)
             + 0.05 * rng.standard_normal((2, t.size))).astype(np.float32)
    gen_params = _np(_scaled(jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel)), seed=1))
    disc_params = _np({
        "mpd": _scaled(jax.jit(mpd.init)(jax.random.PRNGKey(1), jnp.asarray(audio)), 2),
        "msd": _scaled(jax.jit(msd.init)(jax.random.PRNGKey(2), jnp.asarray(audio)), 3)})
    return jgen, mpd, msd, mel, audio, gen_params, disc_params


@pytest.mark.parametrize("gan_type", ["original", "wgan"])
def test_gan_step_gradients_match_jax_grad(tmp_path, gan_type, gan_inputs):
    """The port's train_step hands its optimizers the gradients that
    ``jax.grad`` gives of the JAX trainer's two loss functions: the
    discriminators' at the step's start, the generator's against the
    discriminators after their update."""
    jgen, mpd, msd, mel, audio, gen_params, disc_params = gan_inputs
    trainer = _small_trainer(tmp_path, gan_type)
    trainer.load_params({"generator": gen_params, "discriminators": disc_params})
    trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
    trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)

    seen = {}

    def spy(name, opt):
        step = opt.step

        def recorded(params, grads, state):
            seen[name] = {n: g.detach().clone() for n, g in grads.items()}
            return step(params, grads, state)
        return recorded

    trainer.gen_opt.step = spy("gen", trainer.gen_opt)
    trainer.disc_opt.step = spy("disc", trainer.disc_opt)
    losses = trainer.train_step({"mel": torch.from_numpy(mel), "audio": torch.from_numpy(audio)},
                                gan_on=True)
    updated_disc = torch_to_flax(trainer.discriminators.state_dict(), trainer.discriminators)

    mel_fn = jax_spectral_transform("mel-librosa", 128, 128, 16, 22050, 20, 0, 8000)

    def gen_loss(gp, dp):
        fake = jgen.apply(gp, mel)
        loss_mel = jax_loss.mel_l1_loss(jax_drc(mel_fn(audio)), jax_drc(mel_fn(fake)))
        _, fr = mpd.apply(dp["mpd"], audio)
        sf, ff = mpd.apply(dp["mpd"], fake)
        _, fr2 = msd.apply(dp["msd"], audio)
        sf2, ff2 = msd.apply(dp["msd"], fake)
        adv = jax_loss.generator_adversarial_loss(sf + sf2, gan_type)
        fm = jax_loss.feature_matching_loss(fr + fr2, ff + ff2)
        return 45.0 * loss_mel + adv + 2.0 * fm

    def disc_loss(dp, gp):
        fake = jax.lax.stop_gradient(jgen.apply(gp, mel))
        sr, _ = mpd.apply(dp["mpd"], audio)
        sf, _ = mpd.apply(dp["mpd"], fake)
        sr2, _ = msd.apply(dp["msd"], audio)
        sf2, _ = msd.apply(dp["msd"], fake)
        return jax_loss.discriminator_loss(sr + sr2, sf + sf2, gan_type)

    d_loss, d_grads = jax.jit(jax.value_and_grad(disc_loss))(disc_params, gen_params)
    g_loss, g_grads = jax.jit(jax.value_and_grad(gen_loss))(gen_params, updated_disc)
    assert float(losses["disc/total"]) == pytest.approx(float(d_loss), rel=1e-4)
    assert float(losses["gen/total"]) == pytest.approx(float(g_loss), rel=1e-4)
    _assert_grads_close({n: g.numpy() for n, g in seen["disc"].items()},
                        flax_to_torch(_np(d_grads), trainer.discriminators)[0])
    _assert_grads_close({n: g.numpy() for n, g in seen["gen"].items()},
                        flax_to_torch(_np(g_grads), trainer.generator)[0])
    if gan_type == "wgan":
        clip = trainer.wgan_clip
        assert all(float(p.detach().abs().max()) <= clip for p in trainer.disc_params.values())

"""The port's HiFiGAN generator against the JAX package's, on the CPU.

Same seeded numpy mel into ``gen.apply`` (flax convs), into
``fused_generator_apply`` (the Pallas MRF kernel in interpret mode) and into
the port's ``HiFiGANGenerator`` loaded through ``flax_to_torch``; rtol = atol
= 2e-4 (tests/test_ops.py's tolerance for the generator: float32 sums in
another order). The transposed convolution's sample alignment is checked on
its own against flax ``nn.ConvTranspose(padding="SAME")`` at 1e-5.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from everyvoice_tpu.models.hifigan.model import HiFiGANGenerator as JaxGenerator
from everyvoice_tpu.ops.mrf_pallas import fused_generator_apply
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator, conv_transpose_same
from everyvoice_tpu_torch.ops.mrf import mrf_stage

TOL = 2e-4
GEN = dict(
    upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
    upsample_initial_channel=32,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)),
)


@pytest.fixture(scope="module")
def generators():
    jgen = JaxGenerator(**GEN)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 25, 80)).astype(np.float32)  # odd T
    params = jgen.init(jax.random.PRNGKey(2), jnp.asarray(mel))
    # Non-unit weight-norm scales so the folding is exercised.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * (1.0 + 0.5 * jnp.cos(jnp.arange(v.size).reshape(v.shape)))
        if "scale" in jax.tree_util.keystr(path) else v,
        params,
    )
    tgen = HiFiGANGenerator(**GEN)
    state, skipped = flax_to_torch(jax.tree.map(np.asarray, params), tgen)
    assert skipped == []
    tgen.load_state_dict(state)
    return jgen, params, tgen, mel


def test_generator_matches_flax_and_fused_pallas(generators):
    jgen, params, tgen, mel = generators
    before = mrf_stage.launches
    got = tgen(torch.from_numpy(mel)).numpy()
    assert mrf_stage.launches == before  # CPU tensors take the plain version
    want = np.asarray(jgen.apply(params, jnp.asarray(mel)))
    fused = np.asarray(fused_generator_apply(jgen, params, jnp.asarray(mel), interpret=True))
    assert got.shape == want.shape == (2, 25 * 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, fused, rtol=TOL, atol=TOL)


def test_forward_turns_tf32_off_and_restores_the_callers_flags(generators, monkeypatch):
    """Float32 work inside the forward is full float32 (TF32 off for cuBLAS
    and cuDNN); the caller's flags come back afterwards."""
    from everyvoice_tpu_torch.models.hifigan import model as hifigan

    _, _, tgen, mel = generators
    seen = []

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return mrf_stage(*args)

    monkeypatch.setattr(hifigan, "mrf_stage", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tgen(torch.from_numpy(mel))
    assert seen == [(False, False)] * len(GEN["upsample_rates"])
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_converter_round_trip_is_exact(generators):
    _, params, tgen, _ = generators
    back = torch_to_flax(tgen.state_dict(), tgen)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))


@pytest.mark.parametrize("kernel,stride", [(16, 8), (4, 2), (3, 1), (2, 4), (5, 2)])
def test_conv_transpose_same_alignment(kernel, stride):
    """Output length T·stride and the same sample alignment as flax (which
    neither flips nor swaps the kernel), including the strides where lax
    pads asymmetrically."""
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    mod = nn.ConvTranspose(4, kernel_size=(kernel,), strides=(stride,), padding="SAME")
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda v: v + 0.3, params)
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    kern = np.asarray(params["params"]["kernel"])  # (k, in, out)
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(1, 2, 0)[..., ::-1]))
    bias = torch.from_numpy(np.array(params["params"]["bias"]))
    got = conv_transpose_same(torch.from_numpy(x), weight, bias, stride).numpy()
    assert got.shape == want.shape == (2, 7 * stride, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unported_variants_raise():
    """ResBlock2 and the iSTFT head are ported now (their parity is in
    tests/test_torch_hifigan_train.py); only a resblock the JAX package does
    not know still raises."""
    from everyvoice_tpu_torch.config import hifigan_config

    gen = HiFiGANGenerator.from_config(hifigan_config({"model": {"resblock": "2"}}))
    assert gen.resblock == "2" and len(gen.resblocks[0].convs) == 3
    gen = HiFiGANGenerator.from_config(hifigan_config(
        {"model": {"istft_layer": True, "upsample_rates": [8, 8],
                   "upsample_kernel_sizes": [16, 16]}}))
    assert (gen.istft_hop, gen.istft_n_fft, gen.conv_post.weight.shape[0]) == (4, 16, 18)
    with pytest.raises(ValueError, match="resblock"):
        HiFiGANGenerator.from_config(hifigan_config({"model": {"resblock": "3"}}))

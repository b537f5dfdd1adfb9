"""The port's MRF stage (everyvoice_tpu_torch.ops.mrf) against the JAX
package's fused_mrf (interpret mode) and the flax ResBlock1 loop, on the CPU,
at the two shapes of tests/test_ops.py::TestFusedMRF.

Tolerance: rtol = atol = 2e-4, the JAX package's own for this kernel (float32
sums in another order). On the CPU the wrapper runs the plain version and
never counts a launch; the CUDA kernel itself is held to the plain version on
the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from everyvoice_tpu.models.hifigan.model import ResBlock1
from everyvoice_tpu.ops.mrf_pallas import fused_mrf, weight_norm_kernel
from everyvoice_tpu_torch.ops.mrf import (
    mrf_stage,
    mrf_stage_reference,
    pack_mrf_weights,
    resblock1_halo,
)

TOL = 2e-4
CASES = {
    # (B, T, C), kernels, dilations, seed — tests/test_ops.py:79-80, 111-112
    "three_chains": ((2, 800, 32), (3, 7, 11), ((1, 3, 5),) * 3, 0),
    "multi_tile_edges": ((1, 1000, 8), (3, 7), ((1, 3), (1, 3)), 1),
}


def _flax_mrf(x, kernels, dils, seed):
    import flax.linen as nn

    class MRF(nn.Module):
        @nn.compact
        def __call__(self, v):
            acc = None
            for k, ds in zip(kernels, dils):
                y = ResBlock1(v.shape[-1], k, tuple(ds))(v)
                acc = y if acc is None else acc + y
            return acc / len(kernels)

    mod = MRF()
    params = mod.init(jax.random.PRNGKey(seed), x)
    return params, mod.apply(params, x)


def _folded(params, kernels, dils, c):
    weights, biases = [], []
    p = params["params"]
    for r, ds in enumerate(dils):
        block = p[f"ResBlock1_{r}"]
        for u in range(2 * len(ds)):
            kern = weight_norm_kernel(
                block[f"Conv_{u}"]["kernel"],
                block[f"WeightNorm_{u}"][f"Conv_{u}/kernel/scale"],
            )
            weights.append(np.array(kern).reshape(-1, c))
            biases.append(np.array(block[f"Conv_{u}"]["bias"]))
    return weights, biases


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    (b, t, c), kernels, dils, seed = CASES[request.param]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    params, want_flax = _flax_mrf(jnp.asarray(x), kernels, dils, seed)
    weights, biases = _folded(params, kernels, dils, c)
    want_pallas = fused_mrf(
        jnp.asarray(x), tuple(jnp.asarray(w) for w in weights),
        tuple(jnp.asarray(bb)[None, :] for bb in biases),
        kernel_sizes=kernels, dilation_sizes=dils, interpret=True,
    )
    w, bias = pack_mrf_weights(
        [torch.from_numpy(w) for w in weights],
        [torch.from_numpy(bb) for bb in biases], torch.float32,
    )
    before = mrf_stage.launches
    got = mrf_stage(torch.from_numpy(x), w, bias, kernels, dils).numpy()
    return {
        "got": got, "flax": np.asarray(want_flax), "pallas": np.asarray(want_pallas),
        "launches": mrf_stage.launches - before, "x": x, "w": w, "b": bias,
        "kernels": kernels, "dils": dils,
    }


def test_matches_flax_resblocks(case):
    np.testing.assert_allclose(case["got"], case["flax"], rtol=TOL, atol=TOL)


def test_matches_fused_mrf_interpret(case):
    np.testing.assert_allclose(case["got"], case["pallas"], rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(case):
    assert case["launches"] == 0
    ref = mrf_stage_reference(
        torch.from_numpy(case["x"]), case["w"], case["b"], case["kernels"], case["dils"]
    )
    np.testing.assert_array_equal(case["got"], ref.numpy())


def test_bf16_rounds_operands_like_the_kernel():
    """In bfloat16 the conv operands are rounded to bf16 while the chain
    state stays float32: the result sits within bf16 rounding of the float32
    stage computed from the same bf16 inputs."""
    rng = np.random.default_rng(3)
    c = 16
    x = torch.from_numpy(rng.standard_normal((1, 300, c)).astype(np.float32))
    weights = [torch.from_numpy(rng.standard_normal((3 * c, c)).astype(np.float32) / 7)
               for _ in range(4)]
    biases = [torch.zeros(c) for _ in range(4)]
    xb = x.to(torch.bfloat16)
    w32, b32 = pack_mrf_weights(weights, biases, torch.float32)
    wbf, bbf = pack_mrf_weights(weights, biases, torch.bfloat16)
    got = mrf_stage(xb, wbf, bbf, (3,), ((1, 3),))
    want = mrf_stage(xb.float(), w32, b32, (3,), ((1, 3),))
    assert got.dtype == torch.bfloat16
    scale = want.abs().max().item()
    assert (got.float() - want).abs().max().item() < 2e-2 * scale


def test_rejects_bad_inputs():
    x = torch.zeros(1, 10, 8)
    w, b = pack_mrf_weights([torch.zeros(24, 8)] * 2, [torch.zeros(8)] * 2, torch.float32)
    with pytest.raises(ValueError, match="packed MRF weights"):
        mrf_stage(x, w, b, (3,), ((1, 3),))  # needs 4 convs, given 2
    with pytest.raises(ValueError):
        mrf_stage(x.to("meta"), w.to("meta"), b.to("meta"), (3,), ((1,),))
    with pytest.raises(TypeError):
        mrf_stage(x.half(), w.half(), b.half(), (3,), ((1,),))


def test_halo_matches_jax_definition():
    from everyvoice_tpu.ops.mrf_pallas import resblock1_halo as jax_halo

    for k in (3, 7, 11):
        assert resblock1_halo(k, (1, 3, 5)) == jax_halo(k, (1, 3, 5))
    assert resblock1_halo(11, (1, 3, 5)) == 60

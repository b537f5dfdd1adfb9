"""The port's log-mel (everyvoice_tpu_torch.ops.mel) against the JAX package's
fused_log_mel (interpret mode) and its XLA mel-librosa path, on the CPU, on
the same seeded inputs.

Tolerance: 1e-4 absolute, the JAX package's own kernel-vs-XLA tolerance
(tests/test_ops.py); float32 sums in another order. On the CPU the wrapper
runs the plain version and never counts a launch; the CUDA kernel itself is
held to the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from everyvoice_tpu.dsp.spectral import dynamic_range_compression, get_spectral_transform
from everyvoice_tpu.ops.mel_pallas import fused_log_mel
from everyvoice_tpu_torch.dsp.spectral import _rdft_basis, librosa_mel_basis
from everyvoice_tpu_torch.ops.mel import BIN_TILE, _kernel_constants, log_mel, log_mel_reference

SR = 22050
TOL = 1e-4
CASES = {
    # (B, S), n_fft, win, hop
    "k4_100_frames": ((2, 256 * 100), 1024, 1024, 256),
    "k4_200_frames": ((2, 256 * 200), 1024, 1024, 256),
    "odd_tail": ((2, 256 * 100 + 77), 1024, 1024, 256),
    "win_800": ((2, 256 * 100), 1024, 800, 256),
    "k8_hop_128": ((2, 128 * 150), 1024, 1024, 128),
    "k4_n_fft_2048": ((1, 512 * 60), 2048, 2048, 512),
    "k4_n_fft_1000": ((2, 250 * 100 + 31), 1000, 1000, 250),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    (b, s), n_fft, win, hop = CASES[request.param]
    x = (np.random.default_rng(0).standard_normal((b, s)) * 0.3).astype(np.float32)
    args = (SR, n_fft, win, hop, 80, 0.0, 8000.0)
    pallas = np.asarray(fused_log_mel(jnp.asarray(x), *args, interpret=True))
    xla_fn = get_spectral_transform("mel-librosa", n_fft, win, hop, SR, 80, 0, 8000)
    xla = np.asarray(dynamic_range_compression(xla_fn(jnp.asarray(x))))
    before = log_mel.launches
    got = log_mel(torch.from_numpy(x), *args)
    return {"x": x, "args": args, "got": got, "pallas": pallas, "xla": xla,
            "launches": log_mel.launches - before, "frames": s // hop + 1}


@pytest.mark.parametrize("want", ["pallas", "xla"])
def test_matches_jax(case, want):
    got = case["got"].numpy()
    assert got.shape == case[want].shape == (case["x"].shape[0], 80, case["frames"])
    assert np.abs(got - case[want]).max() < TOL


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(case):
    assert case["launches"] == 0
    ref = log_mel_reference(torch.from_numpy(case["x"]), *case["args"])
    assert torch.equal(case["got"], ref)


@pytest.mark.parametrize("n_fft, win", [(1024, 1024), (1024, 800), (2048, 2048), (1000, 1000)])
def test_kernel_constants_hold_the_bases_in_tiles(n_fft, win):
    """The kernel's (n_tiles, n_fft, 2·64) basis tiles and zero-padded mel
    weights hold the numpy bases bit for bit."""
    window, basis, melw = (t.numpy() for t in _kernel_constants(
        SR, n_fft, win, 80, 0.0, 8000.0, torch.device("cpu")))
    cos_b, msin_b = _rdft_basis(n_fft)
    n_bins = n_fft // 2 + 1
    n_tiles = basis.shape[0]
    assert n_tiles == -(-n_bins // BIN_TILE) and basis.shape[1:] == (n_fft, 2 * BIN_TILE)
    cos_t = basis[:, :, :BIN_TILE].transpose(1, 0, 2).reshape(n_fft, -1)
    msin_t = basis[:, :, BIN_TILE:].transpose(1, 0, 2).reshape(n_fft, -1)
    assert np.array_equal(cos_t[:, :n_bins], cos_b) and not cos_t[:, n_bins:].any()
    assert np.array_equal(msin_t[:, :n_bins], msin_b) and not msin_t[:, n_bins:].any()
    assert np.array_equal(melw[:n_bins], librosa_mel_basis(SR, n_fft, 80, 0.0, 8000.0).T)
    assert not melw[n_bins:].any() and window.shape == (n_fft,)


@pytest.mark.parametrize("audio, kwargs, error", [
    (torch.zeros(4096), {}, ValueError),                       # not (B, S)
    (torch.zeros(1, 4096, dtype=torch.float64), {}, TypeError),
    (torch.zeros(1, 512), {}, ValueError),                     # too short to reflect
    (torch.zeros(1, 4096), {"win_length": 2048}, ValueError),  # window wider than n_fft
    (torch.zeros(1, 4096), {"hop_length": 0}, ValueError),
    (torch.zeros(1, 4096, device="meta"), {}, ValueError),     # neither cuda nor cpu
])
def test_rejects_bad_inputs(audio, kwargs, error):
    with pytest.raises(error):
        log_mel(audio, **kwargs)

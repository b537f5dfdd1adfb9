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
from everyvoice_tpu_torch.dsp.spectral import _rdft_basis, librosa_mel_basis, padded_window
from everyvoice_tpu_torch.ops.mel import (
    BIN_TILE,
    _dft_constants,
    _fft_constants,
    fft_route,
    log_mel,
    log_mel_reference,
)

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
    """The DFT kernel's (n_tiles, n_fft, 2·64) basis tiles and zero-padded mel
    weights hold the numpy bases bit for bit."""
    window, basis, melw = (t.numpy() for t in _dft_constants(
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


def _fft_tables(n_fft, win):
    window, tw, weights, ranges, n_used = _fft_constants(
        SR, n_fft, win, 80, 0.0, 8000.0, torch.device("cpu"))
    return window.numpy(), tw.numpy(), weights.numpy(), ranges.numpy(), n_used


@pytest.mark.parametrize("n_fft, win", [(1024, 1024), (1024, 800), (2048, 2048), (256, 256)])
def test_fft_constants_hold_the_twiddles_and_the_mel_ranges(n_fft, win):
    """The FFT kernel's twiddle table is numpy's float64 cos/sin rounded to
    float32; its per-mel [lo, hi) ranges cover exactly the nonzeros of the
    slaney basis, and its compacted weights are those nonzeros bit for bit."""
    assert fft_route(n_fft)
    window, tw, weights, ranges, n_used = _fft_tables(n_fft, win)
    half = n_fft // 2
    angles = [k / (2.0 * ns) for ns in (2**e for e in range(half.bit_length() - 1))
              for k in range(ns)]
    angles += [k / n_fft for k in range(half + 1)]
    angle = -2.0 * np.pi * np.asarray(angles, np.float64)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float32
    assert np.array_equal(tw[:, 0], np.cos(angle).astype(np.float32))
    assert np.array_equal(tw[:, 1], np.sin(angle).astype(np.float32))

    basis = librosa_mel_basis(SR, n_fft, 80, 0.0, 8000.0)
    covered = np.zeros(basis.shape, bool)
    for m, (lo, hi, off) in enumerate(ranges.T):
        covered[m, lo:hi] = True
        assert np.array_equal(weights[off : off + hi - lo], basis[m, lo:hi])
    assert np.array_equal(covered, basis != 0)
    assert ranges[2, -1] + ranges[1, -1] - ranges[0, -1] == weights.size
    assert n_used == np.flatnonzero(basis.any(axis=0)).max() + 1
    assert np.array_equal(window, padded_window(win, n_fft))


def _stockham_log_mel(x, n_fft, win, hop):
    """The FFT kernel's arithmetic in numpy (complex64), step for step: the
    packed half-length Stockham FFT with the table's twiddles, the split
    step, the magnitudes of the used bins and the ranged mel sums."""
    window, tw, weights, ranges, n_used = _fft_tables(n_fft, win)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    half, s = n_fft // 2, x.shape[-1]
    g = np.arange(s // hop + 1)[:, None] * hop + np.arange(n_fft) - n_fft // 2
    g = np.abs(g)
    g = np.where(g >= s, 2 * (s - 1) - g, g)
    frames = x[..., g] * window
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    a = np.empty_like(z)
    a[..., 0::2] = z[..., : half // 2] + z[..., half // 2 :]
    a[..., 1::2] = z[..., : half // 2] - z[..., half // 2 :]
    ns = 2
    while ns < half:
        j = np.arange(half // 2)
        k = j & (ns - 1)
        v0, v1 = a[..., j], a[..., j + half // 2] * tw[ns - 1 + k]
        c = np.empty_like(a)
        c[..., ((j - k) << 1) + k] = v0 + v1
        c[..., ((j - k) << 1) + k + ns] = v0 - v1
        a, ns = c, 2 * ns
    k = np.arange(n_used)
    p, q = a[..., k & (half - 1)], np.conj(a[..., (half - k) & (half - 1)])
    spec = 0.5 * (p + q) + tw[half - 1 + k] * (0.5j * (q - p))
    mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
    mel = np.stack([mag[..., lo:hi] @ weights[off : off + hi - lo] for lo, hi, off in ranges.T])
    return np.log(np.maximum(mel, 1e-5)).transpose(1, 0, 2)


@pytest.mark.parametrize("n_fft, win, hop", [(1024, 1024, 256), (1024, 800, 128), (2048, 2048, 512), (256, 256, 64)])
def test_fft_kernel_arithmetic_matches_plain_version(n_fft, win, hop):
    """The FFT kernel's algorithm, run in numpy on its constants, agrees with
    the plain version (1e-4 absolute, as on the card)."""
    x = (np.random.default_rng(1).standard_normal((2, hop * 40 + 33)) * 0.3).astype(np.float32)
    got = _stockham_log_mel(x, n_fft, win, hop)
    ref = log_mel_reference(torch.from_numpy(x), SR, n_fft, win, hop).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < TOL


def test_fft_arithmetic_is_nearer_float64_than_the_plain_version():
    """Why the FFT kernel and the plain version differ most on quiet bins: on
    a noise-modulated 110 Hz tone over a -50 dB floor (the make-up of the
    on-card check's corpus), the FFT's log-mel lies nearer the float64
    log-mel than the plain version's does, whose float32 DFT bases carry one
    rounding an entry. Both share the float32 window and mel weights."""
    rng = np.random.default_rng(0)
    n, hop = 256 * 120, 256
    tone = 0.5 * np.sin(2 * np.pi * 110 * np.arange(n) / SR) * (1 + 0.3 * rng.standard_normal(n))
    x = (tone + 0.5 * 10 ** (-50 / 20) * rng.standard_normal(n)).astype(np.float32)[None]
    g = np.abs(np.arange(n // hop + 1)[:, None] * hop + np.arange(1024) - 512)
    g = np.where(g >= n, 2 * (n - 1) - g, g)
    frames = x[0][g].astype(np.float64) * padded_window(1024, 1024)
    mag = np.sqrt(np.abs(np.fft.rfft(frames)) ** 2 + 1e-9)
    basis = librosa_mel_basis(SR, 1024, 80, 0.0, 8000.0).astype(np.float64)
    exact = np.log(np.maximum(mag @ basis.T, 1e-5)).T[None]
    fft_err = np.abs(_stockham_log_mel(x, 1024, 1024, hop) - exact).max()
    plain_err = np.abs(log_mel_reference(torch.from_numpy(x)).numpy() - exact).max()
    assert fft_err < plain_err / 2 < TOL


def test_routes_by_n_fft():
    assert all(fft_route(n) for n in (64, 256, 1024, 2048))
    assert not any(fft_route(n) for n in (32, 1000, 1536, 4096))


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

"""The port's DSP (everyvoice_tpu_torch.dsp) against the JAX package's, on the
CPU, on the same seeded numpy inputs.

Tolerances, with their reasons:
- host constants (window, DFT and mel bases, sinc kernel, K-weighting
  biquads) and host numpy/scipy code (resampling, loudness, sox effects,
  priors, wav reading): bit-equal, the same code on the same inputs;
- float32 transforms on tensors (STFT, mel, iSTFT, energy): 1e-4 of the
  reference's largest magnitude, float32 sums in another order;
- F0: every frame within 1e-3 relative (no CMNDF threshold decision flips
  on these signals).
"""

import importlib
import struct
import wave

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# The modules themselves: everyvoice_tpu.dsp re-exports functions that
# shadow some of their names.
(jax_audio_io, jax_loudness, jax_pitch, jax_prior, jax_resample, jax_sox, jax_spectral,
 audio_io, loudness, pitch, prior, resample, sox, spectral) = (
    importlib.import_module(f"{package}.dsp.{name}")
    for package in ("everyvoice_tpu", "everyvoice_tpu_torch")
    for name in ("audio_io", "loudness", "pitch", "prior", "resample", "sox", "spectral")
)

SR = 22050
RNG = np.random.default_rng(0)
AUDIO = (RNG.standard_normal((2, 256 * 40 + 13)) * 0.3).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("name, args", [
    ("hann_window", (1024,)), ("hann_window", (800,)), ("hann_window", (64, False)),
    ("_rdft_basis", (1024,)), ("_rdft_basis", (2048,)),
    ("librosa_mel_basis", (22050, 1024, 80, 0.0, 8000.0)),
    ("librosa_mel_basis", (16000, 512, 64, 50.0, 7600.0)),
    ("htk_mel_basis", (22050, 1024, 80, 0.0, 8000.0)),
])
def test_spectral_constants_are_bit_equal(name, args):
    got, want = getattr(spectral, name)(*args), getattr(jax_spectral, name)(*args)
    for g, w in zip(np.atleast_1d(got) if name != "_rdft_basis" else got,
                    np.atleast_1d(want) if name != "_rdft_basis" else want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("up, down", [(320, 441), (441, 320), (2, 1)])
def test_sinc_kernel_is_bit_equal(up, down):
    assert np.array_equal(resample._sinc_kernel(up, down), jax_resample._sinc_kernel(up, down))


@pytest.mark.parametrize("sr", [16000, 22050, 44100])
def test_biquads_are_equal(sr):
    assert loudness._biquad_coeffs(float(sr)) == jax_loudness._biquad_coeffs(float(sr))


@pytest.mark.parametrize("win, hop", [(1024, 256), (800, 256), (1024, 128)])
def test_stft_real_imag(win, hop):
    got = spectral.stft_real_imag(_t(AUDIO), 1024, win, hop)
    want = jax_spectral.stft_real_imag(jnp.asarray(AUDIO), 1024, win, hop)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_stft_power(power):
    got = spectral.stft_power(_t(AUDIO), 1024, 1024, 256, power=power)
    _close(got.numpy(), jax_spectral.stft_power(jnp.asarray(AUDIO), 1024, 1024, 256, power=power))


@pytest.mark.parametrize("spec_type", ["mel-librosa", "mel", "linear", "raw"])
def test_every_spectral_transform(spec_type):
    args = (spec_type, 1024, 1024, 256, SR, 80, 0, 8000)
    got = spectral.get_spectral_transform(*args)(_t(AUDIO))
    want = jax_spectral.get_spectral_transform(*args)(jnp.asarray(AUDIO))
    if spec_type == "raw":
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    else:
        _close(got.numpy(), want)
    if spec_type == "mel-librosa":
        _close(spectral.compute_energy(spectral.dynamic_range_compression(got)).numpy(),
               jax_spectral.compute_energy(jax_spectral.dynamic_range_compression(want)))
    assert spectral.get_spectral_transform("nonsense", 1024, 1024, 256) is None


@pytest.mark.parametrize("n_fft, win, hop", [(1024, 1024, 256), (16, 16, 4), (1024, 800, 128)])
def test_istft_round_trip(n_fft, win, hop):
    x = AUDIO[:, : 256 * 40]
    real, imag = spectral.stft_real_imag(_t(x), n_fft, win, hop)
    got = spectral.istft(real, imag, n_fft, win, hop, length=x.shape[-1])
    want = jax_spectral.istft(*jax_spectral.stft_real_imag(jnp.asarray(x), n_fft, win, hop),
                              n_fft, win, hop, length=x.shape[-1])
    _close(got.numpy(), want)
    inner = slice(n_fft, -n_fft)  # the window sum is full away from the edges
    np.testing.assert_allclose(got.numpy()[:, inner], x[:, inner], atol=1e-4)
    with pytest.raises(ValueError):
        spectral.istft(real, imag, n_fft, win, hop - 1)


def _signals():
    t = np.arange(int(SR * 1.5)) / SR
    rng = np.random.default_rng(1)
    return {
        "tone_220": 0.4 * np.sin(2 * np.pi * 220 * t),
        "glide": 0.4 * np.sin(2 * np.pi * np.cumsum(120 + 200 * t / 1.5) / SR),
        "noise": 0.2 * rng.standard_normal(t.size),
        "tone_in_noise": 0.3 * np.sin(2 * np.pi * 150 * t) * (t > 0.5)
        + 0.02 * rng.standard_normal(t.size),
    }


@pytest.mark.parametrize("name", sorted(_signals()))
@pytest.mark.parametrize("hop", [256, 128])
def test_estimate_f0(name, hop):
    x = _signals()[name]
    x = np.stack([x, 0.5 * x]).astype(np.float32)
    want = np.asarray(jax_pitch.estimate_f0(jnp.asarray(x), SR, hop))
    got = pitch.estimate_f0(_t(x), SR, hop).numpy()
    assert got.shape == want.shape == (2, x.shape[1] // hop + 1)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert (rel <= 1e-3).all(), f"{int((rel > 1e-3).sum())} frames differ"
    if name == "tone_220":
        assert np.median(got) == pytest.approx(220.0, rel=1e-2)


@pytest.mark.parametrize("orig, new", [(22050, 16000), (16000, 22050), (22050, 22050)])
def test_resample_host(orig, new):
    x = AUDIO[:, :5000]
    got = resample.resample_host(x, orig, new)
    assert np.array_equal(got, jax_resample.resample_host(x, orig, new))
    assert got.shape[-1] == -(-x.shape[-1] * new // orig)


@pytest.mark.parametrize("orig, new", [(22050, 16000), (16000, 10000), (16000, 22050),
                                       (44100, 16000), (22050, 22050)])
def test_resample_on_tensors(orig, new):
    x = AUDIO[:, :5000]
    got = resample.resample(_t(x), orig, new).numpy()
    want = np.asarray(jax_resample.resample(jnp.asarray(x), orig, new))
    assert got.shape == want.shape == (2, -(-x.shape[-1] * new // orig))
    _close(got, want)
    _close(resample.resample(_t(x[0]), orig, new).numpy(), want[0])
    _close(got, jax_resample.resample_host(x, orig, new))


@pytest.mark.parametrize("scale", [1.0, 0.01, 0.0])
def test_integrated_loudness_host(scale):
    for x in (AUDIO * scale, AUDIO[0] * scale, AUDIO[:, :4000] * scale):
        got = loudness.integrated_loudness_host(x, SR)
        assert got == jax_loudness.integrated_loudness_host(x, SR)


@pytest.mark.parametrize("scale", [1.0, 0.01, 0.0])
def test_integrated_loudness_on_tensors(scale):
    """The truncated-FIR loudness against the JAX device version: 1e-4 LU,
    float32 convolutions summed in another order."""
    for x in (AUDIO * scale, AUDIO[0] * scale, AUDIO[:, :4000] * scale):
        got = loudness.integrated_loudness(_t(x), SR)
        want = float(jax_loudness.integrated_loudness(jnp.asarray(x), SR))
        if np.isinf(want):
            assert got == want
        else:
            assert got == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("effects", [
    [["channels", "1"]], [["channels", "2"]], [["gain", "-3"]], [["norm"]], [["norm", "-1"]],
    [["trim", "0.1"]], [["trim", "0.1", "0.2"]], [["vol", "0.5"]], [["remix", "2", "1"]],
    [["reverse"]], [["rate", "16000"]], [["channels", "1"], ["gain", "6"], ["norm", "-3"]],
])
def test_apply_sox_effects(effects):
    x = AUDIO if effects[0] != ["channels", "2"] else AUDIO[:1]
    got, sr = sox.apply_sox_effects(x, SR, effects)
    want, want_sr = jax_sox.apply_sox_effects(x, SR, effects)
    assert sr == want_sr and np.array_equal(got, want)


def test_unsupported_sox_effect_raises():
    with pytest.raises(sox.UnsupportedSoxEffect):
        sox.apply_sox_effects(AUDIO, SR, [["flanger"]])
    with pytest.raises(sox.UnsupportedSoxEffect):
        sox.apply_sox_effects(AUDIO, SR, [["channels", "3"]])


@pytest.mark.parametrize("w, h", [(87, 12), (300, 40), (5, 1), (1000, 150)])
def test_beta_binomial_interpolator(w, h):
    got = prior.BetaBinomialInterpolator()(w, h)
    assert got.shape == (w, h)
    assert np.array_equal(got, jax_prior.BetaBinomialInterpolator()(w, h))
    assert np.array_equal(prior.beta_binomial_prior_distribution(h, w),
                          jax_prior.beta_binomial_prior_distribution(h, w))


def _write_pcm(path, data, width, sr=SR):
    """(channels, samples) ints as PCM of ``width`` bytes a sample."""
    frames = data.T.reshape(-1)
    if width == 3:
        raw = np.stack([(frames >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.uint8).tobytes()
    else:
        raw = frames.astype({1: np.uint8, 2: "<i2", 4: "<i4"}[width]).tobytes()
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(data.shape[0])
        wf.setsampwidth(width)
        wf.setframerate(sr)
        wf.writeframes(raw)


def _write_float(path, data, sr=SR):
    body = data.T.reshape(-1).astype("<f4").tobytes()
    n_ch = data.shape[0]
    fmt = struct.pack("<HHIIHH", 3, n_ch, sr, sr * 4 * n_ch, 4 * n_ch, 32)
    blob = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(body)) + body)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(blob)) + blob)


@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "port_writer"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav(tmp_path, kind, channels):
    rng = np.random.default_rng(2)
    path = tmp_path / f"{kind}.wav"
    n = 1001
    if kind == "pcm8":
        _write_pcm(path, rng.integers(0, 256, (channels, n)), 1)
    elif kind in ("pcm16", "pcm24", "pcm32"):
        bits = int(kind[3:])
        data = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), (channels, n))
        _write_pcm(path, data, bits // 8)
    elif kind == "float32":
        _write_float(path, (rng.standard_normal((channels, n)) * 0.3).astype(np.float32))
    else:
        audio_io.write_wav(path, (rng.standard_normal((channels, n)) * 0.3).astype(np.float32), SR)
    got, sr = audio_io.read_wav(path)
    want, want_sr = jax_audio_io.read_wav(path)
    assert sr == want_sr == SR and got.dtype == np.float32 and got.shape == (channels, n)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# DIO and the segment samplers (dsp/dio.py, dsp/segments.py). Tolerances:
# voicing equal exactly on the vibrato tone and on silence, on at least 99%
# of frames on the glide and noise (a dispersion near the threshold can flip
# under float32 sums in another order); F0 within 1e-3 relative where both
# are voiced; the segments bit for bit.

def _dio_signals() -> dict:
    rng = np.random.default_rng(11)
    t = np.arange(int(2.0 * SR)) / SR
    f_true = 180 + 10 * np.sin(2 * np.pi * 3 * t)
    phase = 2 * np.pi * np.cumsum(f_true) / SR
    glide = 2 * np.pi * np.cumsum(np.linspace(90.0, 420.0, t.size)) / SR
    return {
        "vibrato": (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.3 * np.sin(3 * phase)),
        "glide": 0.6 * np.sin(glide) + 0.2 * np.sin(2 * glide) + 0.01 * rng.standard_normal(t.size),
        "noise": 0.3 * rng.standard_normal(t.size),
        "silence": np.zeros(t.size),
    }


@pytest.fixture(scope="module")
def dio_runs():
    from everyvoice_tpu.dsp.dio import estimate_f0_dio as jax_dio
    from everyvoice_tpu_torch.dsp.dio import estimate_f0_dio

    signals = {k: v.astype(np.float32) for k, v in _dio_signals().items()}
    batch = np.stack(list(signals.values()))
    want = np.asarray(jax_dio(jnp.asarray(batch), SR, 256, interpolate=False))
    got = estimate_f0_dio(_t(batch), SR, 256, interpolate=False).numpy()
    return {name: (got[i], want[i], signals[name]) for i, name in enumerate(signals)}


@pytest.mark.parametrize("name", ["vibrato", "glide", "noise", "silence"])
def test_dio_matches_jax(dio_runs, name):
    got, want, _ = dio_runs[name]
    assert got.shape == want.shape == (int(2.0 * SR) // 256 + 1,)
    same = (got > 0) == (want > 0)
    if name in ("vibrato", "silence"):
        assert same.all()
    else:
        assert same.mean() >= 0.99
    both = (got > 0) & (want > 0)
    assert np.all(np.abs(got[both] - want[both]) <= 1e-3 * want[both])
    if name == "silence":
        assert not got.any()


def test_dio_tracks_the_vibrato_contour(dio_runs):
    """The JAX test's bound (tests/test_dsp.py::TestDioCrossValidation):
    voiced on 95% of the core frames, median error under 0.5 Hz."""
    got, _, x = dio_runs["vibrato"]
    t = np.arange(x.size) / SR
    f_true = 180 + 10 * np.sin(2 * np.pi * 3 * t)
    centers = np.minimum(np.arange(got.size) * 256, x.size - 1)
    core = slice(10, -10)
    voiced = got[core] > 0
    assert voiced.mean() > 0.95
    assert np.median(np.abs(got[core][voiced] - f_true[centers][core][voiced])) < 0.5


def test_dio_interpolates_as_jax_and_keeps_batch_shape():
    from everyvoice_tpu.dsp.dio import estimate_f0_dio as jax_dio
    from everyvoice_tpu_torch.dsp.dio import estimate_f0_dio

    x = _dio_signals()["glide"][: 256 * 60].astype(np.float32).reshape(2, 1, -1)
    want = np.asarray(jax_dio(jnp.asarray(x), SR, 256))
    got = estimate_f0_dio(_t(x), SR, 256).numpy()
    assert got.shape == want.shape == (2, 1, x.shape[-1] // 256 + 1)
    _close(got, want, rel=1e-3)


def test_get_segment_matches_jax():
    import jax

    from everyvoice_tpu.dsp.segments import get_segment as jax_get_segment
    from everyvoice_tpu_torch.dsp.segments import get_segment

    x = np.random.default_rng(5).standard_normal((2, 100)).astype(np.float32)
    for start in (0, 17, 90, 95):  # 95 is past the last start: both clamp to 90
        want, want_start = jax_get_segment(jnp.asarray(x), 10, start=start)
        got, got_start = get_segment(_t(x), 10, start=start)
        assert np.array_equal(got.numpy(), np.asarray(want)) and got_start == int(want_start)
    want, _ = jax_get_segment(jnp.asarray(x[:, :5]), 10, key=jax.random.PRNGKey(0))
    got, start = get_segment(_t(x[:, :5]), 10, torch.Generator().manual_seed(0))
    assert start == 0 and np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        get_segment(_t(x), 10)


def test_get_segments_batched_matches_jax():
    import jax

    from everyvoice_tpu.dsp.segments import get_segments_batched as jax_batched
    from everyvoice_tpu_torch.dsp.segments import get_segments_batched

    rng = np.random.default_rng(6)
    for shape, axis in (((4, 120), 1), ((4, 120, 3), 1), ((4, 3, 120), 2)):
        batch = rng.standard_normal(shape).astype(np.float32)
        lengths = np.array([120, 70, 30, 55])
        starts = np.array([60, 15, 0, 50])  # row 3 runs past its length: masked
        want, want_starts = jax_batched(jnp.asarray(batch), jnp.asarray(lengths), 50,
                                        jax.random.PRNGKey(0), axis=axis,
                                        starts=jnp.asarray(starts))
        got, got_starts = get_segments_batched(_t(batch), _t(lengths), 50, axis=axis,
                                               starts=_t(starts))
        assert np.array_equal(got.numpy(), np.asarray(want)), shape
        assert np.array_equal(got_starts.numpy(), np.asarray(want_starts))


def test_random_segments_are_in_range_and_reproducible():
    from everyvoice_tpu_torch.dsp.segments import get_segment, get_segments_batched

    batch = torch.arange(4 * 200, dtype=torch.float32).reshape(4, 200)
    lengths = torch.tensor([200, 120, 50, 10])
    segs, starts = get_segments_batched(batch, lengths, 50, torch.Generator().manual_seed(3))
    again, starts2 = get_segments_batched(batch, lengths, 50, torch.Generator().manual_seed(3))
    assert torch.equal(segs, again) and torch.equal(starts, starts2)
    assert all(0 <= int(s) <= max(int(n) - 50, 0) for s, n in zip(starts, lengths))
    for row, (s, n) in enumerate(zip(starts.tolist(), lengths.tolist())):
        valid = min(50, n - s)
        assert torch.equal(segs[row, :valid], batch[row, s : s + valid])
        assert not segs[row, valid:].any()
    draws = {get_segment(batch[:1], 50, torch.Generator().manual_seed(k))[1] for k in range(20)}
    assert len(draws) > 1 and all(0 <= d <= 150 for d in draws)
    assert get_segment(batch[:1], 50, torch.Generator().manual_seed(4))[1] == get_segment(
        batch[:1], 50, torch.Generator().manual_seed(4))[1]

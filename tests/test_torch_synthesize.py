"""The whole serving path: the port's ``Synthesizer`` (CPU, float32) against
the JAX package's on the ``dummy_ckpts`` stubs. Durations, tokens and the
frame counts must agree exactly; mels to 1e-4 and wavs to 1e-5 absolute
(float32 sums in another order; the wav is a tanh of small values); the
wav writer byte for byte on the same samples."""

import jax
import numpy as np
import pytest

from everyvoice_tpu.models.fs2.synthesize import Synthesizer as JaxSynthesizer
from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer

TEXTS = [
    "Hello there, world!",
    "A much longer sentence, long enough to be chunked. " * 8,
    "xyz",
    "???",
    "$$$",  # no valid symbols at all
]


@pytest.fixture(scope="module")
def both(dummy_ckpts):
    jax_synth = JaxSynthesizer(dummy_ckpts["fs2"], dummy_ckpts["generator"], compute_dtype="float32")
    port = Synthesizer(dummy_ckpts["fs2"], dummy_ckpts["generator"],
                       compute_dtype="float32", device="cpu")
    return jax_synth, port, jax_synth.synthesize(TEXTS), port.synthesize(TEXTS)


def test_results_match(both):
    _, _, want, got = both
    assert len(got) == len(want) == len(TEXTS)
    for w, g in zip(want, got):
        assert g["text"] == w["text"]
        if w["mel"] is None:
            assert g["mel"] is None and g["wav"] is None
            continue
        assert [t.tolist() for t in g["tokens"]] == [t.tolist() for t in w["tokens"]]
        assert [d.tolist() for d in g["durations"]] == [d.tolist() for d in w["durations"]]
        assert g["mel"].shape == w["mel"].shape
        np.testing.assert_allclose(g["mel"], w["mel"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["wav"], w["wav"], rtol=0, atol=1e-5)
    assert len(got[1]["tokens"]) > 1  # the long text was chunked


def test_written_outputs_match(both, tmp_path):
    """Same files; each wav's PCM within one step of the JAX file's (the two
    float32 wavs differ by ~1e-7, which can cross a rounding boundary)."""
    jax_synth, port, want, got = both
    jax_files = jax_synth.write_outputs(want, tmp_path / "jax", ("wav", "spec"))
    port_files = port.write_outputs(got, tmp_path / "port", ("wav", "spec"))
    assert [p.relative_to(tmp_path / "jax") for p in jax_files] == [
        p.relative_to(tmp_path / "port") for p in port_files
    ]
    for a, b in zip(jax_files, port_files):
        if a.suffix == ".wav":
            ra, rb = a.read_bytes(), b.read_bytes()
            assert ra[:44] == rb[:44]  # RIFF header
            pa, pb = (np.frombuffer(r[44:], "<i2").astype(int) for r in (ra, rb))
            assert np.abs(pa - pb).max() <= 1
        else:
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=1e-4, atol=1e-4)


def test_wav_writer_bytes_match_jax(monkeypatch, tmp_path):
    """The same samples give the same file as everyvoice_tpu's write_wav
    (its native writer, used whenever it is built). Its numpy fallback
    differs only at exact .5 ties, which it rounds to even."""
    from everyvoice_tpu.dsp import audio_io
    from everyvoice_tpu_torch.dsp import write_wav

    rng = np.random.default_rng(0)
    audio = np.concatenate([
        np.clip(rng.standard_normal(5000) * 0.4, -1.2, 1.2),
        np.array([0.0, 1.0, -1.0, 1.5, -1.5]),
    ]).astype(np.float32)
    write_wav(tmp_path / "port.wav", audio, 22050)
    port = (tmp_path / "port.wav").read_bytes()
    if audio_io._native() is not None:
        audio_io.write_wav(tmp_path / "native.wav", audio, 22050)
        assert (tmp_path / "native.wav").read_bytes() == port
    monkeypatch.setattr(audio_io, "_native", lambda: None)
    audio_io.write_wav(tmp_path / "numpy.wav", audio, 22050)
    fallback = (tmp_path / "numpy.wav").read_bytes()
    assert fallback[:44] == port[:44]
    a, b = (np.frombuffer(r[44:], "<i2") for r in (fallback, port))
    scaled = audio * np.float32(32767.0)
    ties = scaled == np.trunc(scaled) + np.copysign(np.float32(0.5), scaled)
    np.testing.assert_array_equal(a[~ties], b[~ties])
    assert ties.sum() < 20


def test_full_hifigan_checkpoint_loads(dummy_ckpts, both):
    _, port, _, got = both
    full = Synthesizer(dummy_ckpts["fs2"], dummy_ckpts["hifigan"],
                       compute_dtype="float32", device="cpu")
    again = full.synthesize(TEXTS[:1])
    np.testing.assert_array_equal(again[0]["wav"], got[0]["wav"])


def test_stub_checkpoints_read_and_rewrite_exactly(dummy_ckpts, tmp_path):
    """The port reads the stubs the JAX package wrote into the same arrays,
    and writes them back in the bytes the JAX package would write."""
    from everyvoice_tpu.train.checkpoint import load_checkpoint as jax_load
    from everyvoice_tpu.train.checkpoint import save_checkpoint as jax_save
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    for name in ("fs2", "hifigan", "generator"):
        want = jax_load(dummy_ckpts[name])
        got = load_checkpoint(dummy_ckpts[name])
        flat_want = jax.tree_util.tree_leaves_with_path(want["state_dict"])
        flat_got = jax.tree_util.tree_leaves_with_path(got["state_dict"])
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, a), (_, b) in zip(flat_got, flat_want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        args = (got["model_info"]["name"], got["hyper_parameters"]["config"], got["state_dict"])
        ours = save_checkpoint(tmp_path / f"{name}-port.ckpt", *args)
        theirs = jax_save(tmp_path / f"{name}-jax.ckpt", *args)
        assert ours.read_bytes() == theirs.read_bytes()


def test_auto_dtype_is_float32_on_cpu_and_unported_outputs_raise(both, tmp_path):
    _, port, _, got = both
    assert port.compute_dtype == "float32"
    with pytest.raises(NotImplementedError, match="textgrid"):
        port.write_outputs(got, tmp_path, ("textgrid",))
    with pytest.raises(ValueError, match="Unknown speaker"):
        port.synthesize(["hi"], speaker="nobody")

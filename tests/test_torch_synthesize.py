"""The whole serving path: the port's ``Synthesizer`` (CPU, float32) against
the JAX package's on the ``dummy_ckpts`` stubs, and on a phone-level GST
checkpoint with a style reference. Durations, tokens and the frame counts
must agree exactly; mels to 1e-4 and wavs to 1e-5 absolute (float32 sums in
another order; the wav is a tanh of small values); the wav writer byte for
byte on the same samples; TextGrid and read-along files character for
character; teacher-forced specs to 1e-4."""

from pathlib import Path

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


TEXT_FORMATS = ("textgrid", "readalong-xml", "readalong-html")


def _assert_text_outputs_identical(jax_synth, port, want, got, out: Path):
    """The TextGrid, ``.readalong`` and ``.html`` files: same names, same
    text, character for character."""
    jax_files = jax_synth.write_outputs(want, out / "jax", TEXT_FORMATS, language="eng")
    port_files = port.write_outputs(got, out / "port", TEXT_FORMATS, language="eng")
    assert [p.relative_to(out / "jax") for p in jax_files] == [
        p.relative_to(out / "port") for p in port_files
    ]
    assert {p.suffix for p in port_files} == {".TextGrid", ".readalong", ".html"}
    for a, b in zip(jax_files, port_files):
        assert b.read_text(encoding="utf8") == a.read_text(encoding="utf8"), b.name


def test_auto_dtype_is_float32_on_cpu_and_unported_outputs_raise(both, tmp_path):
    """Float32 on the CPU; the text outputs, once unported, are now written
    exactly as the JAX package writes them; an unknown speaker raises."""
    jax_synth, port, want, got = both
    assert port.compute_dtype == "float32"
    _assert_text_outputs_identical(jax_synth, port, want, got, tmp_path)
    with pytest.raises(ValueError, match="Unknown speaker"):
        port.synthesize(["hi"], speaker="nobody")


@pytest.fixture(scope="module")
def phone_voice(dummy_ckpts, tmp_path_factory):
    """A phone-level GST checkpoint written by the JAX package (the stub's
    widths, 1000 frames) over a four-utterance English corpus that the
    port's Preprocessor made from characters through G2P."""
    import jax.numpy as jnp

    from everyvoice_tpu.config import PreprocessingConfig, TextConfig
    from everyvoice_tpu.models.fs2 import FastSpeech2 as JaxFastSpeech2
    from everyvoice_tpu.models.fs2 import FastSpeech2Config
    from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
    from everyvoice_tpu.text.phonemizer import _BUILTIN_FACTORIES
    from everyvoice_tpu.train import save_checkpoint
    from everyvoice_tpu_torch.onchip import CORPUS_WORDS, write_corpus
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from model_stubs import CONTACT, SMALL_FS2_MODEL, STATS

    root = tmp_path_factory.mktemp("phone_voice")
    filelist, wavs, _ = write_corpus(root, 4, seed=5, language="eng")
    engine = _BUILTIN_FACTORIES["eng"]()
    words = CORPUS_WORDS + [w.strip(",.!?") for t in PHONE_TEXTS for w in t.lower().split()]
    phones = sorted({t for w in words for t in engine(w)} - {" "})
    text = TextConfig(symbols={"eng_phones": phones},
                      cleaners=["everyvoice_tpu.utils.lower",
                                "everyvoice_tpu.utils.collapse_whitespace"])
    save_dir = root / "preprocessed"
    Preprocessor({"contact": CONTACT, "text": text.model_dump(mode="json"), "preprocessing": {
        "save_dir": str(save_dir), "source_data": [{
            "permissions_obtained": True, "data_dir": str(wavs), "filelist": str(filelist)}]}},
        device="cpu").preprocess(to_process=("audio", "text", "spec", "attn", "energy", "pitch"))
    config = FastSpeech2Config(
        contact=CONTACT, text=text, preprocessing=PreprocessingConfig(save_dir=save_dir),
        model={**SMALL_FS2_MODEL, "max_length": 1000, "use_global_style_token_module": True,
               "target_text_representation_level": "phones"},
    )
    jmodel = JaxFastSpeech2.from_config(config, len(JaxTextProcessor(text).symbols))
    rng = jax.random.PRNGKey(21)
    params = jax.jit(jmodel.init)({"params": rng, "dropout": rng}, jnp.zeros((1, 8), jnp.int32),
                                  jnp.asarray([8]), mel=jnp.zeros((1, 16, 80)),
                                  mel_lengths=jnp.asarray([16]))
    ckpt = save_checkpoint(root / "phones.ckpt", "FastSpeech2", config, params,
                           lang2id={"eng": 0}, speaker2id={"default": 0}, stats=STATS)
    style = sorted((save_dir / "audio").iterdir())[0]
    return {"ckpt": ckpt, "generator": dummy_ckpts["generator"], "save_dir": save_dir,
            "style": style, "config": config}


PHONE_TEXTS = ["Hello there, my big red house!", "The quick brown fox jumps over a lazy dog."]


def test_phone_level_gst_synthesis_and_text_outputs_match(phone_voice, tmp_path):
    jax_synth = JaxSynthesizer(phone_voice["ckpt"], phone_voice["generator"],
                               compute_dtype="float32")
    port = Synthesizer(phone_voice["ckpt"], phone_voice["generator"], compute_dtype="float32",
                       device="cpu")
    kwargs = {"language": "eng", "style_reference": phone_voice["style"]}
    want = jax_synth.synthesize(PHONE_TEXTS, **kwargs)
    got = port.synthesize(PHONE_TEXTS, **kwargs)
    plain = port.synthesize(PHONE_TEXTS, language="eng")
    for w, g, p in zip(want, got, plain):
        assert [t.tolist() for t in g["tokens"]] == [t.tolist() for t in w["tokens"]]
        assert [d.tolist() for d in g["durations"]] == [d.tolist() for d in w["durations"]]
        np.testing.assert_allclose(g["mel"], w["mel"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["wav"], w["wav"], rtol=0, atol=1e-5)
        assert p["mel"].shape != g["mel"].shape or np.abs(p["mel"] - g["mel"]).max() > 1e-3
    np.testing.assert_allclose(port.load_style_reference(phone_voice["style"]).numpy(),
                               np.asarray(jax_synth.load_style_reference(phone_voice["style"])),
                               rtol=1e-4, atol=1e-4)
    _assert_text_outputs_identical(jax_synth, port, want, got, tmp_path)


def test_teacher_forced_specs_match(phone_voice, tmp_path, monkeypatch):
    from everyvoice_tpu.models.fs2 import synthesize as jax_synthesize
    from everyvoice_tpu.models.fs2.synthesize import (
        synthesize_teacher_forced_specs as jax_teacher_forced,
    )
    from everyvoice_tpu_torch.models.fs2.synthesize import synthesize_teacher_forced_specs
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    rows = generic_psv_filelist_reader(phone_voice["save_dir"] / "filelist.psv")
    assert len(rows) == 4  # one padded batch of 8: stop at the corpus size
    # The JAX writer applies its model eagerly (half a minute here): give it
    # a jitted apply, the same function.
    load = jax_synthesize.load_fs2_from_checkpoint

    def load_jitted(*args, **kwargs):
        model, *rest = load(*args, **kwargs)
        apply = jax.jit(model.apply, static_argnames=("teacher_forcing",))
        return (type("Jitted", (), {"apply": staticmethod(apply)})(), *rest)

    monkeypatch.setattr(jax_synthesize, "load_fs2_from_checkpoint", load_jitted)
    # A checkpoint's config keeps no save_dir: the training config says
    # where the artifacts are.
    config = phone_voice["config"]
    n_jax = jax_teacher_forced(phone_voice["ckpt"], [dict(r) for r in rows], config,
                               output_dir=tmp_path / "jax")
    n_port = synthesize_teacher_forced_specs(
        phone_voice["ckpt"], [dict(r) for r in rows], config.model_dump(mode="json"),
        output_dir=tmp_path / "port", device="cpu")
    assert n_jax == n_port == 4
    names = sorted(p.name for p in (tmp_path / "jax" / "synthesized_spec").iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / "synthesized_spec").iterdir()) == names
    for name in names:
        assert name.endswith("--default--eng--spec-22050-mel-librosa.npy")
        want = np.load(tmp_path / "jax" / "synthesized_spec" / name)
        got = np.load(tmp_path / "port" / "synthesized_spec" / name)
        spec = np.load(phone_voice["save_dir"] / "spec" / name)
        assert got.shape == want.shape == spec.shape  # (80, frames)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)

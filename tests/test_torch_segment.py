"""The port's long-audio CTC segmentation (everyvoice_tpu_torch/models/
aligner) against the JAX package's (everyvoice_tpu/models/aligner), on the
CPU, in float32, at small widths, on inputs made from seeded numpy: the
forced alignment, the TextGrid writer and parser, the wav2vec2-CTC model in
both encoder orders, the windowed scoring, the committed transformers
golden, the loader against directories ``transformers`` wrote and read,
``align_long_audio``/``extract_segments`` and the ``segment`` verbs.

Tolerances, with their reasons:
- forced-alignment spans, TextGrids, extracted wavs and filelists: exact
  (the same float64 trellis and tie order; the same 16-bit writer);
- the model and the windowed log-probs against the JAX module on the same
  parameters: 1e-5 absolute, float32 sums in another order;
- the golden (``tests/data/golden_pretrained/wav2vec2.npz``, computed by
  ``transformers.Wav2Vec2ForCTC``): the JAX golden test's atol 5e-4, rtol
  5e-3;
- against ``transformers`` on a directory either side wrote: 1e-5
  absolute.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp
from everyvoice_tpu.cli import main as jax_main
from everyvoice_tpu.dsp import write_wav as jax_write_wav
from everyvoice_tpu.models.aligner import segment as J
from everyvoice_tpu.models.aligner.wav2vec2 import Wav2Vec2CTC as JaxWav2Vec2CTC
from everyvoice_tpu.models.aligner.wav2vec2 import windowed_log_probs as jax_windowed
from everyvoice_tpu_torch import cli
from everyvoice_tpu_torch.models.aligner import segment as P
from everyvoice_tpu_torch.models.aligner.wav2vec2 import (
    load_wav2vec2_ctc,
    wav2vec2_from_flax,
    window_plan,
    windowed_log_probs,
)
from everyvoice_tpu_torch.models.styletts2.slm import load_wavlm_params
from everyvoice_tpu_torch.onchip import BASE_960H_VOCAB, write_wav2vec2_ctc
from test_styletts2_goldens import load_fixture

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
TINY = dict(vocab_size=12, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
VARIANTS = {
    "group_postnorm": dict(feat_extract_norm="group", do_stable_layer_norm=False,
                           conv_bias=False),
    "layer_stable_conv_bias": dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                                   conv_bias=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread here, beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_params(module, seed: int, n_samples: int = 2000) -> dict:
    """Seeded numpy values in a flax module's parameter shapes (from
    ``jax.eval_shape``: nothing compiles): kernels of variance 1/fan-in,
    scales about 1, biases about 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), jnp.zeros((1, n_samples)))

    def leaf(path, shape):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(shape.shape).astype(np.float32)
        if "kernel" in name:
            return noise / np.sqrt(np.prod(shape.shape[:-1]))
        if "scale" in name:
            return 1.0 + 0.1 * noise
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_models(variant: str, pos_kernel: int = 16, seed: int = 0) -> tuple:
    geometry = dict(TINY, num_conv_pos_embeddings=pos_kernel, **VARIANTS[variant])
    jax_model = JaxWav2Vec2CTC(**geometry)
    params = seeded_params(jax_model, seed)
    return jax_model, params, wav2vec2_from_flax(geometry, params)


def near_one_hot(frame_labels, vocab_size: int) -> np.ndarray:
    lp = np.full((len(frame_labels), vocab_size), -20.0)
    lp[np.arange(len(frame_labels)), frame_labels] = 0.0
    return lp


# ---------------------------------------------------------------------------
# the forced alignment


@pytest.mark.parametrize("frames, vocab, targets, want", [
    ([0, 1, 1, 1, 0, 2, 2, 2, 0, 3, 3, 3, 0], 4, [1, 2, 3], [(0, 1, 4), (1, 5, 8), (2, 9, 12)]),
    ([1, 1, 0, 1, 1], 2, [1, 1], [(0, 0, 2), (1, 3, 5)]),
    ([1, 1, 1], 3, [1, 2], [(0, 0, 2), (1, 2, 3)]),  # the tail label forced in
    ([1], 3, [1, 2], [(0, 0, 0), (1, 0, 0)]),  # squeezed labels: zero length
])
def test_forced_alignment_cases(frames, vocab, targets, want):
    lp = near_one_hot(frames, vocab)
    assert P.ctc_forced_alignment(lp, targets) == J.ctc_forced_alignment(lp, targets) == want


@pytest.mark.parametrize("frames, n_targets, vocab, seed", [
    (40, 5, 8, 0), (57, 12, 8, 1), (200, 60, 30, 2), (30, 20, 5, 3),
    (12_000, 150, 30, 4),  # a long recording's trellis
])
def test_forced_alignment_spans_equal_jax(frames, n_targets, vocab, seed):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(vocab), size=frames)).astype(np.float32)
    targets = rng.integers(1, vocab, n_targets).tolist()
    assert P.ctc_forced_alignment(lp, targets) == J.ctc_forced_alignment(lp, targets)


def test_flat_log_probs_tie_the_same_way():
    """Every path scores the same: the tie order (stay, advance, skip)
    alone picks the spans."""
    lp = np.full((50, 6), np.log(1 / 6), np.float32)
    targets = [1, 2, 2, 3, 4, 5, 1]
    assert P.ctc_forced_alignment(lp, targets) == J.ctc_forced_alignment(lp, targets)


# ---------------------------------------------------------------------------
# TextGrids


SEGMENTS = [("Hello there", 0.0, 1.25), ('She said "hi"', 1.25, 2.5), ("", 2.5, 2.75),
            ("  ", 2.75, 2.8), ("last one", 2.8, 3.14159265)]


def test_textgrid_bytes_and_round_trip(tmp_path):
    text = P.segments_to_textgrid(SEGMENTS, 3.2, tier_name="lines")
    assert text.encode() == J.segments_to_textgrid(SEGMENTS, 3.2, tier_name="lines").encode()
    path = tmp_path / "a.TextGrid"
    path.write_text(text, encoding="utf8")
    parsed = P.parse_textgrid(path)
    assert parsed == J.parse_textgrid(path)
    assert [s[0] for s in parsed] == ["Hello there", 'She said "hi"', "last one"]
    assert parsed[-1][1:] == (2.8, 3.141593)


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("pos_kernel", [16, 15], ids=["even_pos_kernel", "odd_pos_kernel"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_jax(variant, pos_kernel):
    jax_model, params, model = both_models(variant, pos_kernel)
    wav = np.random.default_rng(1).standard_normal((2, 2000)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(jax_model.apply)(params, jnp.asarray(wav)))
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, model.output_frames(2000), TINY["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_samples", [400, 1234, 8000, 26_500])
def test_output_frames_and_stride(n_samples):
    jax_model, params, model = both_models("group_postnorm")
    assert model.output_frames(n_samples) == jax_model.output_frames(n_samples)
    assert model.total_stride == jax_model.total_stride == 20
    if n_samples <= 8000:
        with torch.no_grad():
            frames = model(torch.zeros(1, n_samples)).shape[1]
        assert frames == model.output_frames(n_samples)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n_samples, window_s, overlap_s", [
    (8000, 1.0, 0.1),  # one window: the unpadded audio in one forward
    (26_500, 0.5, 0.2),  # several windows, the last one padded
    (32_000, 0.5, 0.1),  # the last window ends on the audio's end
], ids=["one_window", "windows_last_padded", "windows_last_flush"])
def test_windowed_log_probs_match_jax(variant, n_samples, window_s, overlap_s):
    jax_model, params, model = both_models(variant)
    audio = np.random.default_rng(n_samples).standard_normal(n_samples).astype(np.float32)
    want = jax_windowed(jax_model, params, audio, window_s=window_s, overlap_s=overlap_s)
    got = windowed_log_probs(model, audio, window_s=window_s, overlap_s=overlap_s)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (model.output_frames(n_samples), TINY["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)



@pytest.mark.parametrize("n_samples, window_s, overlap_s, want", [
    (8000, 1.0, 0.1, (16_000, [0])),
    (16_000, 1.0, 0.1, (16_000, [0])),
    # 399 frames a window, 160 of overlap: a hop of 239 frames of 20 samples
    (26_500, 0.5, 0.2, (8000, [0, 4780, 9560, 14340, 19120])),
], ids=["shorter_than_a_window", "one_full_window", "five_windows"])
def test_window_plan(n_samples, window_s, overlap_s, want):
    model = wav2vec2_from_flax(dict(TINY, **VARIANTS["group_postnorm"]),
                               seeded_params(JaxWav2Vec2CTC(**TINY), 0))
    win, starts = window_plan(model, n_samples, window_s, overlap_s)
    assert (win, starts) == want
    assert starts[-1] + win >= n_samples and (len(starts) == 1 or starts[-2] + win < n_samples)
    with pytest.raises(ValueError, match="overlap"):
        window_plan(model, n_samples, window_s, overlap_s=window_s)

def test_matches_the_transformers_golden():
    variables, geometry, inputs, expected = load_fixture("wav2vec2")
    geometry["conv_dim"] = tuple(geometry["conv_dim"])
    model = wav2vec2_from_flax(geometry, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(inputs["wav"])).numpy()
    np.testing.assert_allclose(got, expected["log_probs"], atol=5e-4, rtol=5e-3)


# ---------------------------------------------------------------------------
# loading HuggingFace directories


def tiny_hf_geometry(stable: bool) -> dict:
    return dict(TINY, vocab_size=30, **VARIANTS["layer_stable_conv_bias" if stable
                                                 else "group_postnorm"])


@pytest.fixture(scope="module")
def transformers_dir(tmp_path_factory):
    """A tiny ``Wav2Vec2ForCTC`` and ``Wav2Vec2Processor`` saved by
    ``transformers`` (the recipe of tests/test_segment.py), whose tokenizer
    adds <s>, </s> and <unk> beyond its vocab.json."""
    from test_segment import _tiny_torch_wav2vec2
    from transformers import Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor, Wav2Vec2Processor

    torch_model, _ = _tiny_torch_wav2vec2(vocab_size=30)
    model_dir = tmp_path_factory.mktemp("w2v2") / "w2v2-tiny"
    torch_model.save_pretrained(model_dir)
    vocab = {"<pad>": 0, "|": 1}
    for i, ch in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ'-", start=2):
        vocab[ch] = i
    vocab_file = model_dir / "vocab.json"
    vocab_file.write_text(json.dumps(vocab), encoding="utf8")
    tokenizer = Wav2Vec2CTCTokenizer(str(vocab_file), pad_token="<pad>", word_delimiter_token="|")
    processor = Wav2Vec2Processor(Wav2Vec2FeatureExtractor(do_normalize=True), tokenizer)
    processor.save_pretrained(model_dir)
    return model_dir, torch_model, processor


def hf_log_probs(torch_model, wav: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return torch.log_softmax(torch_model(torch.from_numpy(wav)).logits, dim=-1).numpy()


def test_loader_reads_a_transformers_directory(transformers_dir):
    model_dir, torch_model, processor = transformers_dir
    model, vocab, do_normalize = load_wav2vec2_ctc(model_dir, device="cpu")
    assert do_normalize is processor.feature_extractor.do_normalize is True
    hf_vocab = processor.tokenizer.get_vocab()
    assert len(hf_vocab) > 30  # the added specials
    for ch in {c for token in hf_vocab for c in token} | set("|'-ÉE "):
        assert vocab.get(ch) == hf_vocab.get(ch), ch
    wav = np.random.default_rng(5).standard_normal((1, 3000)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, hf_log_probs(torch_model, wav), rtol=0, atol=ATOL)


@pytest.mark.parametrize("stable", [False, True], ids=["base_layout", "stable_layout"])
def test_written_directory_loads_in_transformers(tmp_path, stable):
    from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

    model_dir = write_wav2vec2_ctc(tmp_path / "w2v2", torch.Generator().manual_seed(3),
                                   tiny_hf_geometry(stable))
    model, vocab, do_normalize = load_wav2vec2_ctc(model_dir, device="cpu")
    hf_model = Wav2Vec2ForCTC.from_pretrained(str(model_dir)).eval()
    processor = Wav2Vec2Processor.from_pretrained(str(model_dir))
    assert hf_model.config.vocab_size == len(BASE_960H_VOCAB) == 32
    assert vocab == processor.tokenizer.get_vocab() == {t: i for i, t in
                                                         enumerate(BASE_960H_VOCAB)}
    assert do_normalize and processor.feature_extractor.do_normalize
    wav = np.random.default_rng(6).standard_normal((1, 3000)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    want = hf_log_probs(hf_model, wav)
    assert want.std() > 0.1  # seeded weights give log-probs that are not flat
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)



class Planted:
    """An object whose unpickling creates ``marker``."""

    def __init__(self, marker: Path):
        self.marker = marker

    def __reduce__(self):
        return Path.touch, (self.marker,)


@pytest.mark.parametrize("loader", ["wav2vec2_directory", "wavlm_directory", "wavlm_file"])
def test_loaders_refuse_a_pickle_that_carries_more_than_tensors(tmp_path, loader):
    """Published weights load with ``weights_only=True``: a
    ``pytorch_model.bin`` (or bare state-dict file) that carries an object
    is refused, and the object's code does not run."""
    marker = tmp_path / "ran"
    state = {"lm_head.bias": torch.zeros(32), "payload": Planted(marker)}
    if loader == "wav2vec2_directory":
        weights = write_wav2vec2_ctc(tmp_path / "w2v2", torch.Generator().manual_seed(3),
                                     tiny_hf_geometry(False)) / "pytorch_model.bin"
        load = lambda: load_wav2vec2_ctc(weights.parent, device="cpu")  # noqa: E731
    elif loader == "wavlm_directory":
        weights = tmp_path / "wavlm" / "pytorch_model.bin"
        weights.parent.mkdir()
        (weights.parent / "config.json").write_text("{}", encoding="utf8")
        load = lambda: load_wavlm_params(weights.parent)  # noqa: E731
    else:
        weights = tmp_path / "WavLM-Base+.pt"
        load = lambda: load_wavlm_params(weights)  # noqa: E731
    torch.save(state, weights)
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights only load failed"):
        load()
    assert not marker.exists()
    torch.load(weights, weights_only=False)  # the control: a full unpickle runs it
    assert marker.exists()

def test_logprob_fn_normalizes_the_whole_utterance(transformers_dir):
    """The scoring function normalizes as ``Wav2Vec2Processor`` does, over
    the whole utterance, before the windows."""
    model_dir, torch_model, processor = transformers_dir
    log_prob_fn, vocab = P.load_wav2vec2_logprob_fn(str(model_dir), device="cpu")
    audio = (0.3 + 0.1 * np.random.default_rng(7).standard_normal(4000)).astype(np.float32)
    inputs = processor(audio, sampling_rate=16000, return_tensors="pt").input_values.numpy()
    np.testing.assert_allclose(P.normalize_utterance(audio)[None], inputs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log_prob_fn(audio), hf_log_probs(torch_model, inputs)[0],
                               rtol=0, atol=ATOL)


def test_model_path_comes_from_the_environment(transformers_dir, monkeypatch):
    model_dir, _, _ = transformers_dir
    monkeypatch.delenv("EVERYVOICE_WAV2VEC2_PATH", raising=False)
    with pytest.raises(RuntimeError, match="EVERYVOICE_WAV2VEC2_PATH"):
        P.load_wav2vec2_logprob_fn(device="cpu")
    monkeypatch.setenv("EVERYVOICE_WAV2VEC2_PATH", str(model_dir))
    assert P.load_wav2vec2_logprob_fn(device="cpu")[1]["|"] == 1


# ---------------------------------------------------------------------------
# align and extract


def stub_vocab() -> dict:
    vocab = {"<pad>": 0}
    for i, ch in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ", start=1):
        vocab[ch] = i
    vocab["|"] = len(vocab)
    return vocab


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 2.5 s stereo recording at 22,050 Hz and a three-line transcript."""
    root = tmp_path_factory.mktemp("recording")
    sr = 22050
    t = np.arange(int(2.5 * sr)) / sr
    rng = np.random.default_rng(11)
    left = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(len(t))
    audio = np.stack([left, 0.8 * left]).astype(np.float32)
    wav = root / "long.wav"
    jax_write_wav(wav, audio, sr)
    transcript = root / "transcript.txt"
    transcript.write_text('hi there\n\n  "quoted" words  \nthe end\n', encoding="utf8")
    return wav, transcript


def assert_same_extraction(port_dir: Path, jax_dir: Path, n: int) -> None:
    for name in ["metadata.psv"] + [f"wavs/segment-{i:05d}.wav" for i in range(n)]:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


def test_align_and_extract_with_a_scoring_function_match_jax(recording, tmp_path):
    """Seeded log-probs, a 16 kHz length checked: the TextGrid, the wavs
    and the filelist byte for byte."""
    wav, transcript = recording
    vocab = stub_vocab()
    lengths = []

    def log_prob_fn(audio_16k):
        lengths.append(len(audio_16k))
        rng = np.random.default_rng(0)
        return np.log(rng.dirichlet(np.ones(len(vocab)), size=125)).astype(np.float32)

    segments = {}
    for name, package in (("port", P), ("jax", J)):
        options = {"device": "cpu"} if package is P else {}
        segments[name] = package.align_long_audio(
            wav, transcript, tmp_path / f"{name}.TextGrid", log_prob_fn=log_prob_fn,
            vocab=vocab, **options)
    assert lengths[0] == lengths[1] == 40_000  # 2.5 s at 16 kHz
    assert segments["port"] == segments["jax"]
    assert [s[0] for s in segments["port"]] == ["hi there", '"quoted" words', "the end"]
    assert (tmp_path / "port.TextGrid").read_bytes() == (tmp_path / "jax.TextGrid").read_bytes()
    parsed = P.parse_textgrid(tmp_path / "port.TextGrid")
    rows = P.extract_segments(wav, parsed, tmp_path / "port-out")
    assert rows == J.extract_segments(wav, J.parse_textgrid(tmp_path / "jax.TextGrid"),
                                      tmp_path / "jax-out")
    assert_same_extraction(tmp_path / "port-out", tmp_path / "jax-out", len(rows))


def test_align_with_a_model_directory_matches_jax(recording, transformers_dir, tmp_path):
    """The whole align: resampling, normalization, the model, the windows
    (shrunk to fit the tiny model) and the alignment, from the directory
    ``transformers`` wrote."""
    wav, transcript = recording
    model_dir, _, _ = transformers_dir
    want = J.align_long_audio(wav, transcript, tmp_path / "jax.TextGrid",
                              acoustic_model=str(model_dir))
    got = P.align_long_audio(wav, transcript, tmp_path / "port.TextGrid",
                             acoustic_model=str(model_dir), device="cpu")
    assert got == want
    assert (tmp_path / "port.TextGrid").read_bytes() == (tmp_path / "jax.TextGrid").read_bytes()


def test_resampled_audio_matches_jax(recording):
    from everyvoice_tpu.dsp import read_wav, resample

    from everyvoice_tpu_torch.dsp.resample import resample as port_resample

    audio, sr = read_wav(recording[0])
    mono = audio.mean(axis=0)
    want = np.asarray(resample(jnp.asarray(mono), sr, 16000))
    got = port_resample(torch.from_numpy(mono), sr, 16000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the verbs


@pytest.fixture
def port_cli(monkeypatch, capsys):
    monkeypatch.setenv("EVERYVOICE_DEVICE", "cpu")

    def run(*args):
        capsys.readouterr()
        rc = cli.main([str(a) for a in args])
        out = capsys.readouterr()
        return rc, out.out, out.err

    return run


def test_segment_verbs_match_jax(recording, transformers_dir, tmp_path, port_cli):
    wav, transcript = recording
    model_dir, _, _ = transformers_dir
    result = CliRunner().invoke(jax_main, [
        "segment", "align", str(wav), str(transcript), "-o", str(tmp_path / "jax.TextGrid"),
        "--acoustic-model", str(model_dir)])
    assert result.exit_code == 0, result.output
    rc, out, _ = port_cli("segment", "align", wav, transcript, "-o", tmp_path / "port.TextGrid",
                          "--acoustic-model", model_dir)
    assert rc == 0 and out.strip() == f"Wrote {tmp_path / 'port.TextGrid'}"
    assert (tmp_path / "port.TextGrid").read_bytes() == (tmp_path / "jax.TextGrid").read_bytes()

    result = CliRunner().invoke(jax_main, [
        "segment", "extract", str(wav), str(tmp_path / "jax.TextGrid"), "-o",
        str(tmp_path / "jax-segs"), "--prefix", "clip"])
    assert result.exit_code == 0, result.output
    rc, out, _ = port_cli("segment", "extract", wav, tmp_path / "port.TextGrid", "-o",
                          tmp_path / "port-segs", "--prefix", "clip")
    assert rc == 0 and out.strip() == result.output.strip().replace("jax-segs", "port-segs")
    names = sorted(p.name for p in (tmp_path / "port-segs" / "wavs").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax-segs" / "wavs").iterdir())
    assert len(names) == 3 and names[0] == "clip-00000.wav"
    for name in ["metadata.psv"] + [f"wavs/{n}" for n in names]:
        assert ((tmp_path / "port-segs" / name).read_bytes()
                == (tmp_path / "jax-segs" / name).read_bytes())


def test_segment_verbs_defaults_and_exit_codes(recording, tmp_path, port_cli, monkeypatch):
    wav, transcript = recording
    monkeypatch.chdir(tmp_path)
    empty = tmp_path / "empty.TextGrid"
    empty.write_text(P.segments_to_textgrid([("", 0.0, 1.0)], 1.0), encoding="utf8")
    rc, _, err = port_cli("segment", "extract", wav, empty)
    assert rc == 1 and err.strip().splitlines()[-1] == (
        f"Error: No non-empty intervals found in {empty}")
    grid = tmp_path / "one.TextGrid"
    grid.write_text(P.segments_to_textgrid([("hello", 0.5, 1.0)], 2.5), encoding="utf8")
    rc, _, _ = port_cli("segment", "extract", wav, grid)
    assert rc == 0 and (tmp_path / "segments" / "wavs" / "segment-00000.wav").is_file()
    assert (tmp_path / "segments" / "metadata.psv").read_text().splitlines() == [
        "basename|characters", "segment-00000|hello"]
    monkeypatch.delenv("EVERYVOICE_WAV2VEC2_PATH", raising=False)
    rc, _, err = port_cli("segment", "align", wav, transcript)
    assert rc == 1 and "EVERYVOICE_WAV2VEC2_PATH" in err
    assert not (tmp_path / "alignment.TextGrid").exists()
    for args in (["segment", "align", tmp_path / "missing.wav", transcript],
                 ["segment", "align", wav, transcript, "--acoustic-model", tmp_path / "none"],
                 ["segment", "extract", wav, tmp_path / "missing.TextGrid"]):
        with pytest.raises(SystemExit) as usage:
            port_cli(*args)
        assert usage.value.code == 2
        assert CliRunner().invoke(jax_main, [str(a) for a in args]).exit_code == 2


def test_align_needs_the_card_or_the_cpu_switch(recording, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    wav, transcript = recording
    env = {k: v for k, v in os.environ.items() if k != "EVERYVOICE_DEVICE"}
    proc = subprocess.run(
        [sys.executable, "-m", "everyvoice_tpu_torch", "segment", "align", str(wav),
         str(transcript), "-o", str(tmp_path / "a.TextGrid")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 1 and "EVERYVOICE_DEVICE=cpu" in proc.stderr
    assert not (tmp_path / "a.TextGrid").exists()

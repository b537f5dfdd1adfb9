"""The port's Preprocessor (everyvoice_tpu_torch.preprocessor) against the JAX
package's, end to end on the CPU: the same seeded corpus and config through
both, steps audio, text, spec, attn, energy and pitch, into two save dirs.

Tolerances, with their reasons:
- 16-bit wavs, filelists, split files, reports and the config lock:
  byte-identical (same host code, same rounding);
- attention priors: 1e-6 (the same float64 formula and scipy zoom);
- spec: 1e-4 absolute, the JAX package's own kernel-vs-XLA tolerance
  (tests/test_ops.py); float32 sums in another order;
- z-scored energy and pitch: 1e-3 on at least 99% of frames. A frame whose
  CMNDF threshold or voicing decision sits on the edge can flip under
  float32 rounding of the difference function; none does on this corpus;
- stats.json: 1e-4 relative.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from everyvoice_tpu.config import TextConfig
from everyvoice_tpu.dsp.audio_io import write_wav as jax_write_wav
from everyvoice_tpu.models.fs2 import FastSpeech2Config
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu_torch.config import fs2_config, preprocessing_config
from everyvoice_tpu_torch.preprocessor import Preprocessor
from everyvoice_tpu_torch.preprocessor.preprocessor import G2P_LANGUAGES
from everyvoice_tpu_torch.text import TextProcessor

SR = 22050
STEPS = ("audio", "text", "spec", "attn", "energy", "pitch")
CONTACT = {"contact_name": "Test Runner", "contact_email": "info@everyvoice.ca"}
LABEL = "TORCH_TEST"
TEXT = {
    "symbols": {
        "letters": list("abcdefghijklmnopqrstuvwxyz"),
        "ipa": ["h", "ə", "l", "o", "ʊ", "w", "ɜ", "d"],
    },
    "cleaners": ["everyvoice_tpu.utils.lower", "everyvoice_tpu.utils.collapse_whitespace"],
    "dataset_to_replace": {LABEL: {"fox": "cat"}},
}


def _corpus(root: Path) -> Path:
    """About seven seeded utterances of 0.5–2 s: mono tones, a glide and
    noise, one stereo file (mixed down by the default ``channels 1``
    effect), one with three channels (rejected), one too quiet (rejected)
    and one missing file."""
    rng = np.random.default_rng(0)
    data = root / "data"
    data.mkdir(parents=True)

    def t(seconds):
        return np.arange(int(seconds * SR)) / SR

    def floor(seconds):
        # A recording's noise floor, about -50 dB. Without one, a bin far
        # from a pure tone holds only 16-bit quantization noise, and the log
        # turns float32 rounding of the tone's DFT there into errors of 1e-2.
        return 0.003 * rng.standard_normal(t(seconds).size)

    clips = {
        "tone": 0.4 * np.sin(2 * np.pi * 220 * t(1.2)) + floor(1.2),
        "glide": 0.4 * np.sin(2 * np.pi * np.cumsum(120 + 150 * t(0.8)) / SR) + floor(0.8),
        "noisy": 0.3 * np.sin(2 * np.pi * 180 * t(2.0)) + 0.1 * rng.standard_normal(t(2.0).size),
        "short": 0.3 * np.sin(2 * np.pi * 300 * t(0.5)) + 0.05 * rng.standard_normal(t(0.5).size),
        "stereo": np.stack([0.4 * np.sin(2 * np.pi * 200 * t(1.5)),
                            0.2 * rng.standard_normal(t(1.5).size)]),
        "three": np.stack([0.4 * np.sin(2 * np.pi * 220 * t(1.0))] * 3),
        "quiet": 0.0005 * np.sin(2 * np.pi * 440 * t(1.0)),
    }
    for name, clip in clips.items():
        jax_write_wav(data / f"{name}.wav", clip.astype(np.float32), SR)
    rows = [
        "basename|characters|phones|speaker|language",
        "tone|The quick brown FOX.|həlo|spk_a|default",
        "glide|Hello,   world!||spk_b|",
        "noisy|A fox, a box and a dog?|wɜld|spk_a|git",
        "short|Short one||spk_b|",
        "stereo|Two channels, mixed down.||spk_a|",
        "three|Three channels|||",
        "quiet|Too quiet|||",
        "missing|Not there|||",
    ]
    filelist = root / "filelist.psv"
    filelist.write_text("\n".join(rows) + "\n", encoding="utf8")
    return filelist


def _raw_config(root: Path, filelist: Path, save_dir: Path) -> dict:
    return {
        "contact": CONTACT,
        "preprocessing": {
            "dataset": "torch-parity",
            "save_dir": str(save_dir),
            "source_data": [{
                "label": LABEL, "permissions_obtained": True,
                "data_dir": str(root / "data"), "filelist": str(filelist),
            }],
        },
        "text": TEXT,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    filelist = _corpus(root)
    jax_dir, torch_dir = root / "jax", root / "torch"
    JaxPreprocessor(FastSpeech2Config(**_raw_config(root, filelist, jax_dir))).preprocess(
        to_process=STEPS
    )
    port = Preprocessor(_raw_config(root, filelist, torch_dir), device="cpu")
    port.preprocess(to_process=STEPS)
    return {"root": root, "filelist": filelist, "jax": jax_dir, "torch": torch_dir, "port": port}


def _files(save_dir: Path, folder: str) -> list:
    return sorted(p.name for p in (save_dir / folder).iterdir())


@pytest.mark.parametrize("name", [
    "filelist.psv", "training_filelist.psv", "validation_filelist.psv",
    "multichannel_files.txt", "missing_files.txt", "summary.txt", ".config-lock",
])
def test_text_artifacts_are_byte_identical(runs, name):
    assert (runs["torch"] / name).read_bytes() == (runs["jax"] / name).read_bytes()


def test_wavs_are_byte_identical(runs):
    names = _files(runs["jax"], "audio")
    assert _files(runs["torch"], "audio") == names
    assert len(names) == 5  # three channels, quiet and missing are rejected
    for name in names:
        assert (runs["torch"] / "audio" / name).read_bytes() == (
            runs["jax"] / "audio" / name
        ).read_bytes(), name


def test_reports_and_counters(runs):
    summary = json.loads((runs["torch"] / "summary.txt").read_text())
    assert summary["processed_files"] == 5
    assert summary["multichannel"] == summary["audio_empty"] == summary["missing_files"] == 1
    assert "three.wav" in (runs["torch"] / "multichannel_files.txt").read_text()


def test_dataset_replace_rule_reaches_the_tokens(runs):
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    rows = {r["basename"]: r for r in generic_psv_filelist_reader(runs["torch"] / "filelist.psv")}
    # Replace rules run before the cleaners, so "FOX" is lowercased but kept.
    assert rows["noisy"]["character_tokens"].startswith("a/ /c/a/t/,")
    assert "f/o/x" in rows["tone"]["character_tokens"]
    assert rows["tone"]["phone_tokens"] == "h/ə/l/o"  # declared phones too


def test_spec_matches(runs):
    names = _files(runs["jax"], "spec")
    assert _files(runs["torch"], "spec") == names and len(names) == 5
    for name in names:
        want = np.load(runs["jax"] / "spec" / name)
        got = np.load(runs["torch"] / "spec" / name)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() < 1e-4, name


@pytest.mark.parametrize("kind", ["energy", "pitch"])
def test_normalized_features_match(runs, kind):
    names = _files(runs["jax"], kind)
    assert _files(runs["torch"], kind) == names and len(names) == 5
    close = total = 0
    for name in names:
        want = np.load(runs["jax"] / kind / name)
        got = np.load(runs["torch"] / kind / name)
        assert got.shape == want.shape
        spec = np.load(runs["torch"] / "spec" / name.replace(kind, f"spec-{SR}-mel-librosa"))
        assert got.shape == (spec.shape[1],)  # frames == samples // hop
        close += int((np.abs(got - want) <= 1e-3).sum())
        total += want.size
    assert close >= 0.99 * total, f"{total - close} of {total} frames differ"


def test_stats_match(runs):
    want = json.loads((runs["jax"] / "stats.json").read_text())
    got = json.loads((runs["torch"] / "stats.json").read_text())
    assert set(got) == set(want) == {"energy", "pitch"}
    for kind in want:
        assert got[kind]["sample_size"] == want[kind]["sample_size"]
        for key, value in want[kind].items():
            assert got[kind][key] == pytest.approx(value, rel=1e-4, abs=1e-6), (kind, key)


def test_attention_priors_match(runs):
    names = _files(runs["jax"], "attn")
    assert _files(runs["torch"], "attn") == names
    assert len(names) == 7  # five character priors, two phone priors
    for name in names:
        want = np.load(runs["jax"] / "attn" / name)
        got = np.load(runs["torch"] / "attn" / name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cpu_run_counts_no_kernel_launch(runs):
    from everyvoice_tpu_torch.ops.mel import log_mel

    assert log_mel.launches == 0
    assert runs["port"].last_batch_shapes == [(16, 2 * 128 * 256)]


def test_rerun_writes_nothing_and_does_not_normalize_twice(runs):
    save_dir = runs["torch"]
    files = [p for p in save_dir.rglob("*") if p.is_file() and p.name != ".config-lock"]
    before = {p: p.stat().st_mtime_ns for p in files}
    stats = (save_dir / "stats.json").read_text()
    pitch = {p: np.load(p) for p in (save_dir / "pitch").iterdir()}
    port = Preprocessor(_raw_config(runs["root"], runs["filelist"], save_dir), device="cpu")
    port.preprocess(to_process=STEPS)
    assert (save_dir / "stats.json").read_text() == stats
    for path, value in pitch.items():
        np.testing.assert_array_equal(np.load(path), value)
    changed = [p.name for p in files if p.stat().st_mtime_ns != before[p]
               and p.suffix in (".npy", ".wav")]
    assert changed == []
    assert port.counters.value("previously_processed_files") == 5


def test_missing_permission_raises(tmp_path):
    raw = _raw_config(tmp_path, tmp_path / "f.psv", tmp_path / "out")
    del raw["preprocessing"]["source_data"][0]["permissions_obtained"]
    with pytest.raises(ValueError, match="permission"):
        preprocessing_config(raw)
    with pytest.raises(ValueError, match="permission"):
        Preprocessor(raw, device="cpu")


@pytest.mark.parametrize("call", ["device_audio", "pfs", "ood", "g2p", "arpabet"])
def test_later_slices_raise(runs, tmp_path, call):
    port = Preprocessor(_raw_config(runs["root"], runs["filelist"], tmp_path / "out"), device="cpu")
    with pytest.raises(NotImplementedError):
        if call == "device_audio":
            port.preprocess(to_process=STEPS, device_audio=True)
        elif call == "pfs":
            port.preprocess(to_process=("audio", "text", "pfs"))
        elif call == "ood":
            port.preprocess_ood({"eng": ["hello"]})
        elif call == "g2p":
            port.process_text({"characters": "hello", "language": "eng"})
        else:
            port.process_text({"arpabet": "HH AH0"})


def test_g2p_languages_are_the_jax_registry():
    from everyvoice_tpu.text.phonemizer import AVAILABLE_G2P_ENGINES

    assert G2P_LANGUAGES == set(AVAILABLE_G2P_ENGINES)


@pytest.mark.parametrize("label, lang", [(LABEL, None), (LABEL, "git"), ("OTHER", None), (None, None)])
def test_normalize_text_takes_the_dataset_label(label, lang):
    """dataset > language > global: the dataset's replace rule applies only
    for its own label, in the port as in the JAX TextProcessor."""
    text = {**TEXT, "language_to_replace": {"git": {"dog": "wolf"}}}
    jtp = JaxTextProcessor(TextConfig(**text))
    ttp = TextProcessor(fs2_config({"text": TextConfig(**text).model_dump(mode="json")})["text"])
    sentence = "The fox and the   Dog."
    want = jtp.normalize_text(sentence, dataset_label=label, lang_id=lang)
    assert ttp.normalize_text(sentence, lang_id=lang, dataset_label=label) == want
    assert ("cat" in want) == (label == LABEL)


def test_feature_batches_pad_like_the_jax_package(runs):
    """Sorted by length, 16 rows, a power-of-two multiple of 128 hops, int16
    PCM that decodes back to the written 16-bit wav."""
    port = Preprocessor(_raw_config(runs["root"], runs["filelist"], runs["torch"]), device="cpu")
    port.overwrite = True
    filelist = port.load_filelist(runs["torch"] / "filelist.psv")
    [(chunk, batch)] = list(port.feature_batches(filelist, ("spec",)))
    lengths = [len(a) for _, a, _ in chunk]
    assert lengths == sorted(lengths) and len(chunk) == 5
    assert batch.shape == (16, 2 * 128 * 256) and batch.dtype == np.int16
    assert not batch[len(chunk):].any()
    np.testing.assert_array_equal(batch[0, : lengths[0]] / 32768.0, chunk[0][1])
    assert os.path.basename(str(chunk[0][2]["spec"])).startswith("short--")


@pytest.mark.parametrize("name", ["tone", "stereo", "short"])
@pytest.mark.parametrize("rate, hop", [(None, 256), (16000, 200), (44100, 512)])
def test_process_audio_matches(runs, name, rate, hop):
    """One file conditioned through process_audio (effects, resampling,
    mixdown, peak normalization, hop cut), with either package."""
    raw = _raw_config(runs["root"], runs["filelist"], runs["root"] / "unused")
    jax_pre = JaxPreprocessor(FastSpeech2Config(**raw))
    port = Preprocessor(raw, device="cpu")
    wav = runs["root"] / "data" / f"{name}.wav"
    kwargs = {"resample_rate": rate, "sox_effects": [["channels", "1"]], "hop_size": hop}
    got, sr = port.process_audio(wav, **kwargs)
    want, want_sr = jax_pre.process_audio(wav, **kwargs)
    assert sr == want_sr and got.dtype == np.float32 and len(got) % hop == 0
    assert np.array_equal(got, want)

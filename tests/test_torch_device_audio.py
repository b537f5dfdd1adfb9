"""The port's device audio path (``Preprocessor.process_all_audio(
device_audio=True)``, ``dsp/loudness.py::batched_loudness``) against the JAX
package's device path, run on the CPU, and against the port's own host path.

Inputs: those of tests/test_preprocessing.py::TestDeviceAudioPath (a tone,
noise and a quiet clip at 22,050 Hz, output rates 22,050 and 44,100), with a
48,000 Hz source, a stereo file and, in one case, a sox effect that leaves
the 16-bit grid, so that the float32 program runs instead of the int16 one.

Tolerances, with their reasons:
- 16-bit artifacts: 1 LSB (atol 1.01/32768, the JAX test's): the resampling
  sums float32 products in another order in each package and on each path.
  The stereo file is held to the JAX host path's artifact instead of the
  JAX device path's: the JAX device path ships its mixdown, which lies
  between the 16-bit steps, as int16 and then normalizes it, up to 2 LSB off
  (``test_jax_device_path_quantizes_a_stereo_mixdown``); the port ships a
  batch holding such a clip as float32;
- the counters, the kept rows and the artifacts' shapes: equal;
- the batched loudness: 1e-3 LU of the JAX function's, float32 sums in
  another order; a row under the absolute gate gives -inf in both.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from everyvoice_tpu.dsp import read_wav as jax_read_wav
from everyvoice_tpu.dsp.audio_io import write_wav as jax_write_wav
from everyvoice_tpu.dsp.loudness import integrated_loudness as jax_integrated_loudness
from everyvoice_tpu.models.fs2 import FastSpeech2Config
from everyvoice_tpu.preprocessor import Preprocessor as JaxPreprocessor
from everyvoice_tpu_torch.dsp.loudness import batched_loudness
from everyvoice_tpu_torch.preprocessor import Preprocessor

LSB = 1.01 / 32768
CONTACT = {"contact_name": "Test Runner", "contact_email": "info@everyvoice.ca"}
GRID_SAFE = [["channels", "1"]]
FLOAT32 = [["channels", "1"], ["gain", "-1.5"]]  # off the 16-bit grid
COUNTERS = ("processed_files", "audio_empty", "duration", "missing_files", "multichannel",
            "previously_processed_files")


def _corpus(root: Path) -> tuple:
    """(filelist, data dir, names): the JAX test's tone, noise and quiet
    clip at 22,050 Hz, a 48,000 Hz tone with noise, and a stereo file."""
    rng = np.random.default_rng(7)
    data = root / "data"
    data.mkdir(parents=True)
    t = np.arange(int(22050 * 1.7)) / 22050
    t48 = np.arange(int(48000 * 1.3)) / 48000
    clips = {
        "tone": (22050, 0.4 * np.sin(2 * np.pi * 220 * t)),
        "noise": (22050, 0.2 * rng.standard_normal(len(t))),
        "quiet": (22050, 0.0005 * np.sin(2 * np.pi * 440 * t)),
        "native48": (48000, 0.3 * np.sin(2 * np.pi * 190 * t48)
                     + 0.05 * rng.standard_normal(len(t48))),
        "stereo": (22050, np.stack([0.4 * np.sin(2 * np.pi * 200 * t),
                                    0.2 * rng.standard_normal(len(t))])),
    }
    rows = ["basename|characters"]
    for name, (sr, clip) in clips.items():
        jax_write_wav(data / f"{name}.wav", clip.astype(np.float32), sr, 16)
        rows.append(f"{name}|hello world")
    filelist = root / "filelist.psv"
    filelist.write_text("\n".join(rows) + "\n")
    return filelist, data, tuple(clips)


def _raw_config(save_dir: Path, filelist: Path, data: Path, effects) -> dict:
    return {
        "contact": CONTACT,
        "preprocessing": {
            "save_dir": str(save_dir),
            "audio": {"output_sampling_rate": 44100},
            "source_data": [{"label": "LJ_TEST", "permissions_obtained": True,
                             "data_dir": str(data), "filelist": str(filelist),
                             "sox_effects": effects}],
        },
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
    }


@pytest.fixture(scope="module", params=["int16", "float32"])
def runs(request, tmp_path_factory):
    """The corpus through four audio steps: the JAX package's device path
    (on the CPU), the port's device path and the port's host path on the
    CPU, and the JAX host path."""
    root = tmp_path_factory.mktemp(f"device-audio-{request.param}")
    filelist, data, names = _corpus(root)
    effects = GRID_SAFE if request.param == "int16" else FLOAT32
    out = {"names": names, "pcm16": request.param == "int16"}
    for label, device_audio in (("jax device", True), ("jax host", False)):
        pre = JaxPreprocessor(FastSpeech2Config(
            **_raw_config(root / label, filelist, data, effects)))
        out[label] = (pre, pre.process_all_audio(cpus=2, device_audio=device_audio))
    for label, device_audio in (("port device", True), ("port host", False)):
        pre = Preprocessor(_raw_config(root / label, filelist, data, effects), device="cpu")
        out[label] = (pre, pre.process_all_audio(cpus=2, device_audio=device_audio))
    return out


def _artifacts(pre) -> dict:
    return {p.name: p for p in sorted((Path(pre.save_dir) / "audio").glob("*.wav"))}


@pytest.mark.parametrize("other", ["jax device", "port host", "jax host"])
def test_device_path_writes_the_same_artifacts(runs, other):
    """The port's device path writes, at both rates, the artifacts of the
    JAX device path, of its own host path and of the JAX host path, within
    1 LSB; the quiet clip is rejected by every path."""
    port, _ = runs["port device"]
    ref, _ = runs[other]
    mine, theirs = _artifacts(port), _artifacts(ref)
    if other == "jax device" and runs["pcm16"]:
        host = _artifacts(runs["jax host"][0])
        theirs.update({n: host[n] for n in theirs if n.startswith("stereo--")})
    assert sorted(mine) == sorted(theirs)
    assert len(mine) == 2 * (len(runs["names"]) - 1)  # both rates, all but "quiet"
    assert not any(name.startswith("quiet--") for name in mine)
    for name, path in mine.items():
        a, sr_a = jax_read_wav(path)
        b, sr_b = jax_read_wav(theirs[name])
        assert sr_a == sr_b
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=LSB, rtol=0, err_msg=f"{name} vs {other}")


@pytest.mark.parametrize("other", ["jax device", "port host"])
def test_device_path_counts_and_keeps_the_same_rows(runs, other):
    port, port_rows = runs["port device"]
    ref, ref_rows = runs[other]
    assert port_rows == ref_rows
    assert [r["basename"] for r in port_rows] == ["tone", "noise", "native48", "stereo"]
    for name in COUNTERS:
        assert port.counters.value(name) == pytest.approx(ref.counters.value(name), rel=1e-12), name
    assert port.counters.value("audio_empty") == 1


def test_device_path_batches_and_transfers(runs):
    """One batch per native rate, padded to a power-of-two number of
    128-hop buckets; int16 both ways where the effects keep the 16-bit grid
    and every clip of the batch is on it (the 48 kHz one), else float32 (the
    22,050 Hz batch holds the stereo mixdown); the bytes up and down are
    those of the batches and of the outputs."""
    port, _ = runs["port device"]
    int16 = "int16" if runs["pcm16"] else "float32"
    assert sorted(port.last_audio_batch_shapes) == [
        (22050, (16, 65536), "float32"), (48000, (16, 65536), int16)]
    assert port.last_audio_transfer_bytes["up"] == 16 * 65536 * (4 + (2 if runs["pcm16"] else 4))
    # loudness (16 float32) and both rates' rows, each rate's in its batch's type
    down = 0
    for native, (_, t), dtype in port.last_audio_batch_shapes:
        size = 2 if dtype == "int16" else 4
        down += 16 * 4 + sum(16 * -(-t * target // native) * size for target in (22050, 44100))
    assert port.last_audio_transfer_bytes["down"] == down


def test_jax_device_path_quantizes_a_stereo_mixdown(runs):
    """A fault of the JAX device path, which the port does not copy: with
    effects that keep the 16-bit grid it ships a stereo source's mixdown as
    int16, rounding the half-LSB steps before the peak normalization scales
    them, so its artifact parts from its own host path's by more than 1
    LSB; the port's stays within 1 LSB of both host paths. Under an effect
    off the grid both packages run the float32 program, and agree."""
    name = "stereo--default--default--audio-22050.wav"
    jax_dev = jax_read_wav(_artifacts(runs["jax device"][0])[name])[0]
    jax_host = jax_read_wav(_artifacts(runs["jax host"][0])[name])[0]
    port = jax_read_wav(_artifacts(runs["port device"][0])[name])[0]
    assert (np.abs(jax_dev - jax_host).max() > LSB) == runs["pcm16"]
    assert np.abs(port - jax_host).max() <= LSB
    assert np.abs(port - jax_dev).max() <= (3 if runs["pcm16"] else 1.01) / 32768


def test_rerun_reuses_the_artifacts(runs, tmp_path):
    """A second device pass over the same save dir writes nothing and counts
    the files as processed before, as the host path does."""
    port, rows = runs["port device"]
    again = Preprocessor(port.config, device="cpu")
    assert again.process_all_audio(device_audio=True) == rows
    assert again.counters.value("previously_processed_files") == len(rows)
    assert again.counters.value("processed_files") == 0


def test_batched_loudness_matches_jax():
    rng = np.random.default_rng(3)
    for sr, t in ((22050, 3 * 32768), (48000, 4 * 32768)):
        x = np.zeros((5, 1, t), np.float32)
        x[0, 0] = 0.3 * rng.standard_normal(t)
        x[1, 0, : t // 2] = 0.0005 * np.sin(np.arange(t // 2) * 0.12)  # quiet, gated out
        x[2, 0, : t // 3] = 0.2 * np.sin(np.arange(t // 3) * 0.05)
        x[3, 0, : sr // 4] = 0.5 * rng.standard_normal(sr // 4)  # shorter than a block
        # row 4 stays silent
        want = np.asarray(jax_integrated_loudness(jnp.asarray(x), sr))
        got = batched_loudness(torch.from_numpy(x), sr).numpy()
        assert got.shape == (5,)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        assert np.isneginf(got[4])
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], atol=1e-3, rtol=0)
    stereo = rng.standard_normal((2, 2, 65536)).astype(np.float32) * 0.1
    np.testing.assert_allclose(batched_loudness(torch.from_numpy(stereo), 22050).numpy(),
                               np.asarray(jax_integrated_loudness(jnp.asarray(stereo), 22050)),
                               atol=1e-3, rtol=0)

"""The port stands alone: importing every module of ``everyvoice_tpu_torch``,
running a small CPU synthesis that writes every output format, a small CPU
preprocess of an English corpus through G2P and phonological features, two
CPU training steps on its artifacts (and one more as a rank of a one-rank
gloo mesh under FSDP), a small CPU StyleTTS2 synthesis and a
StyleTTS2 training step on the same artifacts, a CTC alignment of a short
recording with a seeded wav2vec2 directory, one demo request over HTTP, a
scripted new-project wizard whose project is then preprocessed on the
device audio path, and DIO and the segment samplers loads nothing of JAX,
flax, pydantic, regex, msgpack, PyYAML, click, PIL, ``transformers``,
``safetensors`` or ``everyvoice_tpu``. This file's
process has imported JAX already (tests/conftest.py), so the check runs in
a fresh interpreter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "pydantic", "regex", "msgpack", "yaml", "click", "PIL",
             "everyvoice_tpu", "transformers", "safetensors")

CHILD = """
import importlib, json, pkgutil, sys, tempfile
from pathlib import Path
import torch
import everyvoice_tpu_torch
for mod in pkgutil.walk_packages(everyvoice_tpu_torch.__path__, "everyvoice_tpu_torch."):
    importlib.import_module(mod.name)
from everyvoice_tpu_torch.config import fs2_config, hifigan_config
from everyvoice_tpu_torch.convert import torch_to_flax
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint

torch.manual_seed(0)
conformer = {"layers": 1, "input_dim": 16, "feedforward_dim": 32, "conv_kernel_size": 3}
vp = {"n_layers": 1}
fs2_raw = {"model": {"encoder": conformer, "decoder": conformer, "max_length": 64,
                     "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}},
           "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
voc_raw = {"model": {"upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                     "resblock_dilation_sizes": [[1, 3]]}}
cfg = fs2_config(fs2_raw)
fs2 = FastSpeech2.from_config(cfg, len(TextProcessor(cfg["text"]).symbols))
voc = HiFiGANGenerator.from_config(hifigan_config(voc_raw))
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    f = save_checkpoint(tmp / "fs2.ckpt", "FastSpeech2", fs2_raw, torch_to_flax(fs2.state_dict(), fs2))
    v = save_checkpoint(tmp / "voc.ckpt", "HiFiGANGenerator", voc_raw, torch_to_flax(voc.state_dict(), voc))
    synth = Synthesizer(f, v, device="cpu")
    results = synth.synthesize(["Hello world.", "A second, slightly longer text."])
    written = synth.write_outputs(results, tmp / "out",
                                  ("wav", "spec", "textgrid", "readalong-xml", "readalong-html"))

    from everyvoice_tpu_torch.onchip import CORPUS_WORDS, write_corpus
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.text.phonemizer import get_g2p_engine
    filelist, wavs, _ = write_corpus(tmp / "corpus", 2, language="eng")
    phones = sorted({t for w in CORPUS_WORDS for t in get_g2p_engine("eng")(w)})
    pre = Preprocessor({"preprocessing": {"save_dir": str(tmp / "pre"), "source_data": [
        {"permissions_obtained": True, "data_dir": str(wavs), "filelist": str(filelist)}]},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz"),
                             "eng_phones": phones}}}, device="cpu")
    pre.preprocess(to_process=("audio", "text", "pfs", "spec", "attn", "energy", "pitch"), cpus=2)
    specs = len(list((tmp / "pre" / "spec").glob("*.npy")))
    pfs = len(list((tmp / "pre" / "pfs").glob("*.npy")))

    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec
    small = {"encoder": conformer, "decoder": conformer, "max_length": 64,
             "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}}
    trainer = train_text_to_spec({
        "contact": {"contact_name": "Isolation", "contact_email": "iso@example.org"},
        "model": small, "preprocessing": {"save_dir": str(tmp / "pre")},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "training": {"batch_size": 1, "max_steps": 2,
                     "training_filelist": str(tmp / "pre" / "training_filelist.psv"),
                     "validation_filelist": str(tmp / "pre" / "validation_filelist.psv"),
                     "vocoder_path": str(v), "logger": {"save_dir": str(tmp / "logs")}},
    }, device="cpu", log_every=1)
    steps = trainer.global_step
    ckpts = sorted(p.name for p in trainer.ckpt_dir.iterdir())

    # the same training as one rank of a gloo mesh under FSDP
    from everyvoice_tpu_torch.parallel import setup_mesh, teardown
    mesh = setup_mesh("cpu", 1)
    try:
        meshed = train_text_to_spec({
            "contact": {"contact_name": "Isolation", "contact_email": "iso@example.org"},
            "model": small, "preprocessing": {"save_dir": str(tmp / "pre")},
            "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
            "training": {"batch_size": 1, "max_steps": 1,
                         "training_filelist": str(tmp / "pre" / "training_filelist.psv"),
                         "validation_filelist": str(tmp / "pre" / "validation_filelist.psv"),
                         "logger": {"save_dir": str(tmp / "logs"), "name": "meshed"}},
        }, mesh=mesh, fsdp=True, log_every=1)
        meshed_steps = (meshed.global_step, mesh.backend, mesh.world)
    finally:
        teardown(mesh)

    from everyvoice_tpu_torch.config import styletts2_config
    from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
    from everyvoice_tpu_torch.models.styletts2.synthesize import load_styletts2_model, synthesize_text
    from everyvoice_tpu_torch.onchip import seeded_init_
    st2_raw = {"contact": {"contact_name": "Isolation", "contact_email": "iso@example.org"},
               "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 8,
                         "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                       "head_features": 8}}},
               "training": {"max_len": 16},
               "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
    st2_cfg = styletts2_config(st2_raw)
    st2 = StyleTTS2.from_config(st2_cfg, len(TextProcessor(st2_cfg["text"]).symbols))
    seeded_init_(st2, torch.Generator().manual_seed(0))
    s = save_checkpoint(tmp / "st2.ckpt", "StyleTTS2Module", st2_raw,
                        {"generator": torch_to_flax(st2.state_dict(), st2)})
    model, config, tp, _ = load_styletts2_model(s, device="cpu")
    st2_samples = len(synthesize_text(model, config, tp, "Hello world."))

    from everyvoice_tpu_torch.train.text_to_wav import train_text_to_wav
    torch.set_num_threads(1)  # beside the other test workers
    st2_trainer = train_text_to_wav({
        **st2_raw,
        "model": {**st2_raw["model"], "decoder": {"mpd_layers": [2], "msd_layers": 1}},
        "preprocessing": {"save_dir": str(tmp / "pre")},
        "training": {"batch_size": 1, "max_steps": 1, "max_len": 16, "epochs_1st": 1,
                     "training_filelist": str(tmp / "pre" / "training_filelist.psv"),
                     "validation_filelist": str(tmp / "pre" / "validation_filelist.psv"),
                     "logger": {"save_dir": str(tmp / "logs"), "name": "st2"}},
    }, mode="first", device="cpu")
    st2_ckpts = sorted(p.name for p in st2_trainer.ckpt_dir.iterdir())

    # StyleTTS2's pretrained components, read from their published formats
    # (a HuggingFace directory's model.safetensors too), and stage 2 trained
    # with all four
    import struct
    from everyvoice_tpu_torch.models.styletts2.slm import load_wavlm_params
    from everyvoice_tpu_torch.onchip import (pretrained_overrides, published_wavlm_state,
                                             write_pretrained_components)
    wavlm = {"hidden_size": 16, "num_layers": 1, "num_heads": 2, "intermediate_size": 32,
             "conv_dim": (8,) * 7, "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
             "conv_stride": (5, 2, 2, 2, 2, 2, 2), "num_buckets": 32, "max_distance": 80,
             "num_conv_pos_embeddings": 15, "num_conv_pos_embedding_groups": 4}
    paths = write_pretrained_components(
        tmp / "pretrained", torch.Generator().manual_seed(0), wavlm=wavlm,
        asr={"input_dim": 80, "hidden_dim": 16, "n_token": 178, "n_layers": 1,
             "token_embedding_dim": 8},
        plbert={"vocab_size": 178, "hidden_size": 16, "num_layers": 1, "num_heads": 2,
                "intermediate_size": 32, "embedding_size": 8, "max_position_embeddings": 64},
        jdc={"channels": (8, 8, 8, 8), "lstm_hidden": 8})
    safe = tmp / "wavlm-safetensors"
    safe.mkdir()
    (safe / "config.json").write_text((paths["wavlm"] / "config.json").read_text())
    tensors = {k: v.numpy().tobytes() for k, v in
               published_wavlm_state(torch.Generator().manual_seed(1), wavlm).items()}
    shapes = {k: list(v.shape) for k, v in
              published_wavlm_state(torch.Generator().manual_seed(1), wavlm).items()}
    header, offset = {}, 0
    for k, raw in tensors.items():
        header[k] = {"dtype": "F32", "shape": shapes[k], "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
    head = json.dumps(header).encode()
    (safe / "model.safetensors").write_bytes(struct.pack("<Q", len(head)) + head
                                             + b"".join(tensors.values()))
    safetensors_layers = load_wavlm_params(safe)[0]["num_layers"]
    regime2 = train_text_to_wav({
        **st2_raw,
        "model": {**st2_raw["model"], "decoder": {"mpd_layers": [2], "msd_layers": 1},
                  "slm": {"initial_channel": 4}},
        "preprocessing": {"save_dir": str(tmp / "pre")},
        "training": {"batch_size": 1, "max_steps": 1, "max_len": 16, "epochs_2nd": 1,
                     "training_filelist": str(tmp / "pre" / "training_filelist.psv"),
                     "validation_filelist": str(tmp / "pre" / "validation_filelist.psv"),
                     "logger": {"save_dir": str(tmp / "logs"), "name": "regime2"}},
    }, pretrained_overrides(paths), mode="second", device="cpu")
    regime2_ckpts = sorted(p.name for p in regime2.ckpt_dir.iterdir())
    regime2_slm = regime2.wavlm is not None and regime2.asr_geometry is not None

    # the aligner: a seeded wav2vec2-CTC directory, a two-line transcript
    from everyvoice_tpu_torch.models.aligner.segment import align_long_audio, extract_segments
    from everyvoice_tpu_torch.onchip import write_long_recording, write_wav2vec2_ctc
    w2v2 = write_wav2vec2_ctc(tmp / "w2v2", torch.Generator().manual_seed(0), {
        "hidden_size": 16, "num_layers": 1, "num_heads": 2, "intermediate_size": 32,
        "conv_dim": (8, 8), "conv_kernel": (10, 3), "conv_stride": (5, 2),
        "num_conv_pos_embeddings": 8, "num_conv_pos_embedding_groups": 2,
        "feat_extract_norm": "group", "do_stable_layer_norm": False, "conv_bias": False})
    long_wav, transcript = write_long_recording(tmp / "long", 2, 1.5)
    segments = align_long_audio(long_wav, transcript, tmp / "a.TextGrid",
                                acoustic_model=str(w2v2), device="cpu")
    extracted = len(extract_segments(long_wav, segments, tmp / "segments"))

    # the demo: one request over HTTP
    import threading, urllib.request
    from everyvoice_tpu_torch.demo.app import create_demo_app_auto
    server = create_demo_app_auto(f, vocoder_path=v, device="cpu").make_server()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    request = urllib.request.Request(
        "http://%s:%d/api/synthesize" % server.server_address,
        data=json.dumps({"text": "hello world"}).encode(), method="POST")
    with urllib.request.urlopen(request) as resp:
        demo_status = resp.status
        demo_wav = len(json.loads(resp.read())["wav_base64"])
    server.shutdown()

    # a project from nothing: the wizard with scripted answers, then its
    # project preprocessed with the audio step on the device path (the CPU)
    from everyvoice_tpu_torch.config_files import load_config_from_path
    from everyvoice_tpu_torch.wizard.main_tour import get_main_wizard_tour
    answers = iter(["Iso", "Isolation Test", "iso@example.org", str(tmp), str(filelist), "yes",
                    "psv", "characters", "none", "yes", "yes", "keep", str(wavs), "22050", "none",
                    "iso", "no", "validation", "yaml"])
    state = get_main_wizard_tour(ask=lambda *a, **k: next(answers)).run()
    project = state["project_dir"]
    wizard_files = len(list(project.rglob("*.yaml")))
    cfg = load_config_from_path("text-to-spec", project / "config" / "everyvoice-text-to-spec.yaml",
                                ["preprocessing.audio.output_sampling_rate=44100"])
    device_pre = Preprocessor(cfg, device="cpu")
    device_pre.preprocess(to_process=("audio", "text", "spec"), device_audio=True)
    device_audio_wavs = len(list((project / "preprocessed" / "audio").glob("*.wav")))
    from everyvoice_tpu_torch.dsp.dio import estimate_f0_dio
    from everyvoice_tpu_torch.dsp.segments import get_segments_batched
    dio_frames = estimate_f0_dio(torch.zeros(2, 2560), 22050, 256).shape[-1]
    segs = get_segments_batched(torch.ones(2, 100), torch.tensor([100, 40]), 50,
                                torch.Generator().manual_seed(0))[0].shape
roots = sorted({name.split(".")[0] for name in sys.modules})
print(json.dumps({"roots": roots, "written": len(written), "specs": specs, "pfs": pfs,
                  "samples": [len(r["wav"]) for r in results], "steps": steps,
                  "ckpts": ckpts, "meshed_steps": meshed_steps, "st2_samples": st2_samples, "st2_ckpts": st2_ckpts,
                  "safetensors_layers": safetensors_layers, "regime2_ckpts": regime2_ckpts,
                  "regime2_slm": regime2_slm, "segments": len(segments),
                  "extracted": extracted, "demo_status": demo_status, "demo_wav": demo_wav,
                  "wizard_files": wizard_files, "device_audio_wavs": device_audio_wavs,
                  "dio_frames": dio_frames, "segments_shape": list(segs)}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["written"] == 10  # two texts, five formats
    assert report["specs"] == report["pfs"] == 2
    assert all(n > 0 for n in report["samples"])
    assert report["steps"] == 2 and "last.ckpt" in report["ckpts"]
    assert report["meshed_steps"] == [1, "gloo", 1]
    assert 0 < report["st2_samples"] <= 16 * 256 and report["st2_samples"] % 256 == 0
    assert "stage-1-last.ckpt" in report["st2_ckpts"]
    assert report["safetensors_layers"] == 1
    assert "stage-2-last.ckpt" in report["regime2_ckpts"] and report["regime2_slm"]
    assert report["segments"] == report["extracted"] == 2
    assert report["demo_status"] == 200 and report["demo_wav"] > 100
    assert report["wizard_files"] == 5 and report["device_audio_wavs"] == 4  # 2 clips, 2 rates
    assert report["dio_frames"] == 11 and report["segments_shape"] == [2, 50]
    loaded = set(report["roots"])
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable here")
    from everyvoice_tpu_torch.device import resolve_device
    from everyvoice_tpu_torch.models.fs2.synthesize import (
        Synthesizer,
        load_fs2_from_checkpoint,
        load_vocoder_from_checkpoint,
    )
    from everyvoice_tpu_torch.models.styletts2.synthesize import load_styletts2_model
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec
    from everyvoice_tpu_torch.train.text_to_wav import train_text_to_wav

    missing = tmp_path / "never-read.ckpt"  # the device is resolved first
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_text_to_spec({"training": {"training_filelist": str(missing)}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_text_to_wav({"training": {"training_filelist": str(missing)}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StyleTTS2Trainer({"training": {}}, None, None, run_dir=tmp_path / "never-run")
    run_dir = tmp_path / "never-run"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastSpeech2Trainer({"training": {}}, None, None, {}, {}, run_dir=run_dir)
    assert not run_dir.exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(missing, missing)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Preprocessor({"preprocessing": {"save_dir": str(tmp_path / "never-made")}})
    assert not (tmp_path / "never-made").exists()
    for load in (load_fs2_from_checkpoint, load_vocoder_from_checkpoint, load_styletts2_model):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(missing)
    from everyvoice_tpu_torch.demo.app import create_demo_app_auto
    from everyvoice_tpu_torch.models.aligner.segment import (
        align_long_audio,
        load_wav2vec2_logprob_fn,
    )
    from everyvoice_tpu_torch.models.aligner.wav2vec2 import load_wav2vec2_ctc

    never = tmp_path / "never-written.TextGrid"
    for call in (lambda: load_wav2vec2_ctc(missing), lambda: load_wav2vec2_logprob_fn(missing),
                 lambda: align_long_audio(missing, missing, never, log_prob_fn=len, vocab={}),
                 lambda: create_demo_app_auto(missing, vocoder_path=missing)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not never.exists()
    with pytest.raises(FileNotFoundError):  # past the device, on the CPU
        load_wav2vec2_ctc(missing, device="cpu")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_imports_nothing_of_jax():
    source = (REPO / "chip_smoke.py").read_text()
    for name in FORBIDDEN:
        assert f"import {name}" not in source and f"from {name} " not in source
        assert f"from {name}." not in source

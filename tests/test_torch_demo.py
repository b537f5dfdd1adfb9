"""The port's demo server (everyvoice_tpu_torch/demo/app.py) against the JAX
package's (everyvoice_tpu/demo/app.py), on the CPU, through the real HTTP
surface: the FastSpeech2 app on the FastSpeech2 checkpoint and HiFiGAN
generator of tests/model_stubs.py, which both packages read, and a StyleTTS2 app on a
checkpoint of that file's StyleTTS2 recipe (``max_len`` 32) written by the
port in the JAX layout, which both packages read too.

What must agree, and how closely:
- ``normalize_text``, word lists, reference-speaker parsing, restrictions,
  refusals and dispatch errors: exactly (status codes and strings);
- the pages: byte for byte;
- a FastSpeech2 answer's wav: within 2 LSB of the JAX app's (the two
  float32 syntheses differ by about 1e-7, which can cross a rounding step);
- a StyleTTS2 answer: to 1 LSB of the port's own ``synthesize_text`` with
  the request's seed (the JAX app draws its noise from ``PRNGKey(seed)``,
  the port from a ``torch.Generator``, so the packages' wavs differ by
  design; tests/test_torch_styletts2.py holds the two syntheses to each
  other given the same noise);
- answers served concurrently: to 1 LSB of the same text served alone.
"""

import base64
import inspect
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from everyvoice_tpu.cli import main as jax_main
from everyvoice_tpu.demo import app as J
from everyvoice_tpu_torch import cli
from everyvoice_tpu_torch.config import styletts2_config
from everyvoice_tpu_torch.convert import torch_to_flax
from everyvoice_tpu_torch.demo import app as P
from everyvoice_tpu_torch.dsp import read_wav, write_wav
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.models.styletts2.synthesize import (
    load_reference_style,
    load_styletts2_model,
    synthesize_text,
)
from everyvoice_tpu_torch.onchip import seeded_init_, write_corpus
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint
from model_stubs import CONTACT, get_dummy_fs2_checkpoint, get_dummy_hifigan_checkpoint

REPO = Path(__file__).resolve().parents[1]
LETTERS = list("abcdefghijklmnopqrstuvwxyz")
# tests/model_stubs.py's StyleTTS2 model section, at max_len 32.
ST2_MODEL = {
    "hidden_dim": 64, "style_dim": 32, "max_dur": 20,
    "decoder": {"upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "mpd_layers": [2], "msd_layers": 1},
    "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2, "head_features": 16}},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread here, beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def serve_in_thread(app):
    server = app.make_server()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    return server, f"http://{host}:{port}"


def post_json(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url) -> tuple:
    with urllib.request.urlopen(url) as resp:
        return resp.status, resp.read()


def samples(body: dict) -> np.ndarray:
    blob = base64.b64decode(body["wav_base64"])
    assert blob[:4] == b"RIFF"
    with wave.open(io.BytesIO(blob)) as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2").astype(int)


@pytest.fixture(scope="module")
def stub_ckpts(tmp_path_factory):
    """The FastSpeech2 checkpoint and HiFiGAN generator of ``dummy_ckpts``,
    without its full GAN checkpoint, which no demo reads."""
    tmp = tmp_path_factory.mktemp("demo_stubs")
    return {"fs2": get_dummy_fs2_checkpoint(tmp),
            "generator": get_dummy_hifigan_checkpoint(tmp, generator_only=True)}


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    root = tmp_path_factory.mktemp("lists")
    (root / "deny.txt").write_text("forbidden\n\nBad  Word\n", encoding="utf8")
    (root / "allow.txt").write_text("hello\nworld\n", encoding="utf8")
    return {"denylist": root / "deny.txt", "allowlist": root / "allow.txt"}


@pytest.fixture(scope="module")
def fs2_apps(stub_ckpts, lists):
    """The two packages' FastSpeech2 apps with the denylist; the port's
    served on a thread."""
    jax_app = J.create_demo_app(stub_ckpts["fs2"], stub_ckpts["generator"],
                                denylist=lists["denylist"])
    port_app = P.create_demo_app(stub_ckpts["fs2"], stub_ckpts["generator"],
                                 denylist=lists["denylist"], device="cpu")
    server, url = serve_in_thread(port_app)
    yield jax_app, port_app, url
    server.shutdown()


@pytest.fixture(scope="module")
def st2(tmp_path_factory):
    """A StyleTTS2 checkpoint of seeded weights in the JAX layout, and a
    half-second reference wav."""
    root = tmp_path_factory.mktemp("st2demo")
    raw = {"contact": CONTACT, "model": ST2_MODEL, "training": {"max_len": 32},
           "text": {"symbols": {"letters": LETTERS}}}
    config = styletts2_config(raw)
    model = StyleTTS2.from_config(config, len(TextProcessor(config["text"]).symbols))
    seeded_init_(model, torch.Generator().manual_seed(5))
    with torch.no_grad():  # audio-sized wavs, as onchip.write_styletts2_checkpoint makes them
        model.decoder.conv_post.bias[: model.decoder.n_fft // 2 + 1] = -6.0
        model.decoder.conv_post.scale.mul_(0.2)
    ckpt = save_checkpoint(root / "styletts2.ckpt", "StyleTTS2Module", raw,
                           {"generator": torch_to_flax(model.state_dict(), model)},
                           lang2id={"default": 0},
                           extra={"pretrained_components": {"plbert": None, "asr": None}})
    _, wavs, _ = write_corpus(root / "corpus", 1, seed=3)
    audio, sr = read_wav(next(wavs.glob("*.wav")))
    write_wav(root / "eric.wav", audio[0, : sr // 2], sr)
    return {"ckpt": ckpt, "reference": root / "eric.wav"}


# ---------------------------------------------------------------------------
# text and option helpers


@pytest.mark.parametrize("text, want", [
    ("ＨＥＬＬＯ", "hello"), ("Héllo", "hello"), ("  a   b  ", "a b"),
    ("ﬁne DAY\t!", "fine day !"), ("hellо", "hellо"), ("Straße", "strasse"),
])
def test_normalize_text(text, want):
    assert P.normalize_text(text) == J.normalize_text(text) == want


def test_wordlists_and_ref_speakers(lists, tmp_path):
    for path in (None, lists["denylist"], lists["allowlist"]):
        assert P.load_wordlist(path) == J.load_wordlist(path)
    assert P.load_wordlist(lists["denylist"]) == {"forbidden", "bad word"}
    wav = tmp_path / "eric.wav"
    wav.write_bytes(b"RIFF")
    assert P.parse_ref_speakers([f" Eric = {wav}"]) == J.parse_ref_speakers([f" Eric = {wav}"])
    for entries in (["no-separator"], ["=x.wav"], [f"X={tmp_path}/missing.wav"],
                    [f"Eric={wav}", f"Eric={wav}"]):
        with pytest.raises(ValueError) as want:
            J.parse_ref_speakers(entries)
        with pytest.raises(ValueError) as got:
            P.parse_ref_speakers(entries)
        assert str(got.value) == str(want.value)
    assert P.OUTPUT_FORMAT_CHOICES == J.OUTPUT_FORMAT_CHOICES


@pytest.mark.parametrize("requested", [None, ["all"], ["b", "a"], ["a", "zz"]])
def test_restrict(requested):
    available = ["a", "b", "c"]
    try:
        want = J._restrict(requested, available, "speakers")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P._restrict(requested, available, "speakers")
        assert str(got.value) == str(e)
    else:
        assert P._restrict(requested, available, "speakers") == want


# ---------------------------------------------------------------------------
# the FastSpeech2 app


@pytest.mark.parametrize("options", [
    {}, {"output_formats": ["wav", "textgrid"]}, {"speakers": ["all"], "languages": ["default"]},
    {"ui_labels": {"title": "Ma Démo", "subtitle": "<b>Parlez</b>",
                   "speakers": {"default": "Narrator"}, "languages": {"default": "Undetermined"},
                   "ignored": 3}},
], ids=["defaults", "formats", "restrictions", "ui_labels"])
def test_fs2_page_is_the_jax_page(stub_ckpts, options):
    args = (stub_ckpts["fs2"], stub_ckpts["generator"])
    want = J.create_demo_app(*args, **options).render_page()
    assert P.create_demo_app(*args, device="cpu", **options).render_page() == want


def test_served_page_info_and_404(fs2_apps):
    jax_app, _, url = fs2_apps
    status, page = get(url + "/")
    assert status == 200 and page.decode("utf8") == jax_app.render_page()
    assert get(url + "/index.html")[1] == page
    status, info = get(url + "/api/info")
    assert status == 200
    assert json.loads(info) == {"languages": ["default"], "speakers": ["default"],
                                "model": "FastSpeech2"}
    with pytest.raises(urllib.error.HTTPError) as missing:
        get(url + "/nowhere")
    assert missing.value.code == 404
    req = urllib.request.Request(url + "/api/other", data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as missing:
        urllib.request.urlopen(req)
    assert missing.value.code == 404


def test_fs2_answer_matches_jax(fs2_apps):
    jax_app, _, url = fs2_apps
    for payload in ({"text": "hello world"},
                    {"text": "A longer text, with a comma.", "duration_control": 1.5,
                     "language": "default", "speaker": "default"}):
        want_code, want = jax_app.synthesize_api(payload)
        code, got = post_json(url + "/api/synthesize", payload)
        assert code == want_code == 200 and set(got) == set(want) == {"wav_base64"}
        a, b = samples(got), samples(want)
        assert a.shape == b.shape and a.shape[0] > 0
        assert np.abs(a - b).max() <= 2


@pytest.mark.parametrize("payload", [
    {"text": "  "}, {}, {"text": "this is Forbidden speech"}, {"text": "ｆｏｒｂｉｄｄｅｎ"},
    {"text": "a bad   word here"}, {"text": "hello", "language": "klingon"},
    {"text": "hello", "speaker": "nobody"}, {"text": "hello", "output_formats": ["spec", "mp3"]},
    {"text": "$$$"},
], ids=["blank", "missing", "denied", "homograph", "denied_phrase", "language", "speaker",
        "format", "no_symbols"])
def test_fs2_refusals_match_jax(fs2_apps, payload):
    jax_app, _, url = fs2_apps
    want = jax_app.synthesize_api(payload)
    assert want[0] == 400
    assert post_json(url + "/api/synthesize", payload) == want


def test_allowlist_refusals_match_jax(stub_ckpts, lists):
    args = (stub_ckpts["fs2"], stub_ckpts["generator"])
    jax_app = J.create_demo_app(*args, allowlist=lists["allowlist"])
    port_app = P.create_demo_app(*args, allowlist=lists["allowlist"], device="cpu")
    for text in ("hello stranger", "hellо", "HELLO, world"):
        want = jax_app.synthesize_api({"text": text})
        assert want[0] == 400 and port_app.synthesize_api({"text": text}) == want
    assert port_app.synthesize_api({"text": "Hello  WORLD"})[0] == 200


@pytest.mark.parametrize("options", [
    {"speakers": ["nobody"]}, {"languages": ["fr"]}, {"output_formats": ["mp3"]},
    {"ui_labels": {"speakers": {"nobody": "Nobody"}}}, {"ui_labels": {"languages": ["default"]}},
], ids=["speaker", "language", "format", "ui_speaker", "ui_not_a_map"])
def test_fs2_construction_errors_match_jax(stub_ckpts, options):
    args = (stub_ckpts["fs2"], stub_ckpts["generator"])
    with pytest.raises(ValueError) as want:
        J.create_demo_app(*args, **options)
    with pytest.raises(ValueError) as got:
        P.create_demo_app(*args, device="cpu", **options)
    assert str(got.value) == str(want.value)


def test_output_dir_files_match_jax(stub_ckpts, tmp_path):
    args = (stub_ckpts["fs2"], stub_ckpts["generator"])
    options = dict(output_formats=["wav", "textgrid", "readalong-xml", "spec"])
    jax_app = J.create_demo_app(*args, output_dir=tmp_path / "jax", **options)
    port_app = P.create_demo_app(*args, output_dir=tmp_path / "port", device="cpu", **options)
    payload = {"text": "hello world", "output_formats": ["wav", "textgrid", "readalong-xml"]}
    want, got = jax_app.synthesize_api(payload)[1], port_app.synthesize_api(payload)[1]
    names = [Path(f).relative_to(tmp_path / "port") for f in got["files"]]
    assert names == [Path(f).relative_to(tmp_path / "jax") for f in want["files"]]
    assert len(names) == 3
    for name in names:
        if name.suffix != ".wav":
            assert ((tmp_path / "port" / name).read_text()
                    == (tmp_path / "jax" / name).read_text())
    assert port_app.synthesize_api({"text": "hello", "output_formats": ["readalong-html"]}) \
        == jax_app.synthesize_api({"text": "hello", "output_formats": ["readalong-html"]})


def test_concurrent_requests_equal_requests_alone(fs2_apps):
    _, port_app, url = fs2_apps
    texts = ["hello world", "a second text here", "the quick brown fox", "short"]
    alone = [samples(port_app.synthesize_api({"text": t})[1]) for t in texts]
    with ThreadPoolExecutor(max_workers=4) as pool:
        answers = list(pool.map(lambda t: post_json(url + "/api/synthesize", {"text": t}), texts))
    for (code, body), want in zip(answers, alone):
        assert code == 200
        got = samples(body)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1


class TestPageContract:
    """What a browser would exercise, pinned statically as the JAX tests pin
    it: every element id the script reads exists, every slider reaches the
    script, every field the page posts is one the API reads."""

    @staticmethod
    def _contract(page: str, api_source: str):
        import re

        read_ids = set(re.findall(r"getElementById\(\s*['\"]([\w-]+)['\"]", page))
        declared_ids = set(re.findall(r"id=['\"]([\w-]+)['\"]", page))
        assert not read_ids - declared_ids
        sliders = set(re.findall(r"type=['\"]range['\"] id=['\"]([\w-]+)['\"]", page))
        assert sliders and not sliders - read_ids
        sent = set(re.findall(r"body\.(\w+)\s*=", page))
        sent |= set(re.findall(r"(\w+):\s*document\.getElementById", page))
        consumed = set(re.findall(r"payload\.get\(\s*['\"](\w+)['\"]", api_source))
        assert not sent - consumed, sent - consumed

    @pytest.mark.parametrize("kind", ["fs2", "styletts2"])
    def test_page_contract(self, fs2_apps, st2, kind):
        if kind == "fs2":
            app, cls = fs2_apps[1], P.DemoApp
        else:
            app, cls = P.create_demo_app_auto(st2["ckpt"], device="cpu"), P.StyleTTS2DemoApp
        source = inspect.getsource(P.DemoApp._check_request) + inspect.getsource(
            cls.synthesize_api)
        self._contract(app.render_page(), source)


# ---------------------------------------------------------------------------
# the StyleTTS2 app


@pytest.fixture(scope="module")
def st2_app(st2):
    app = P.create_demo_app_auto(st2["ckpt"], ref_speakers={"Eric": st2["reference"]},
                                 device="cpu")
    server, url = serve_in_thread(app)
    yield app, url
    server.shutdown()


@pytest.mark.parametrize("with_speaker", [False, True], ids=["no_reference", "named_reference"])
def test_styletts2_page_is_the_jax_page(st2, with_speaker):
    options = {"ref_speakers": {"Eric": st2["reference"]}} if with_speaker else {}
    want = J.create_demo_app_auto(st2["ckpt"], **options).render_page()
    assert P.create_demo_app_auto(st2["ckpt"], device="cpu", **options).render_page() == want


def test_styletts2_answer_is_synthesize_text_with_the_seed(st2, st2_app):
    app, url = st2_app
    status, info = get(url + "/api/info")
    assert json.loads(info) == {"languages": ["default"], "speakers": ["Eric"],
                                "model": "StyleTTS2"}
    model, config, tp, _ = load_styletts2_model(st2["ckpt"], device="cpu")
    styles = load_reference_style(model, st2["reference"], config)
    for got, want in zip(styles, app.ref_styles["Eric"]):
        np.testing.assert_array_equal(got, want)
    sr = config["preprocessing"]["audio"]["output_sampling_rate"]
    for payload, options in (
            ({"text": "hello there", "diffusion_steps": 5, "seed": 3}, dict(seed=3)),
            ({"text": "a quick fox", "speaker": "Eric", "diffusion_steps": 2,
              "embedding_scale": 1.5, "acoustic_blend": 0.2, "prosody_blend": 0.9},
             dict(diffusion_steps=2, embedding_scale=1.5, acoustic_blend=0.2,
                  prosody_blend=0.9))):
        code, body = post_json(url + "/api/synthesize", payload)
        assert code == 200, body
        wav = synthesize_text(model, config, tp, payload["text"], ref_styles=styles,
                              **{"diffusion_steps": 5, **options})
        write_wav(Path(st2["ckpt"]).parent / "direct.wav", wav, sr)
        with wave.open(str(Path(st2["ckpt"]).parent / "direct.wav")) as wf:
            want = np.frombuffer(wf.readframes(wf.getnframes()), "<i2").astype(int)
        got = samples(body)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_jax_app_names_styletts2_fastspeech2(st2):
    """The JAX app's /api/info says FastSpeech2 for any checkpoint; the
    port's names the model it serves."""
    jax_app = J.create_demo_app_auto(st2["ckpt"])
    server = jax_app.make_server()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        host, port = server.server_address
        info = json.loads(get(f"http://{host}:{port}/api/info")[1])
    finally:
        server.shutdown()
    assert info["model"] == "FastSpeech2"


@pytest.fixture(scope="module")
def st2_denying_apps(st2, lists):
    """The two packages' StyleTTS2 apps with the denylist."""
    return (J.create_demo_app_auto(st2["ckpt"], denylist=lists["denylist"]),
            P.create_demo_app_auto(st2["ckpt"], denylist=lists["denylist"], device="cpu"))


@pytest.mark.parametrize("payload", [
    {"text": ""}, {"text": "forbidden words"}, {"text": "hi", "speaker": "Nobody"},
    {"text": "hi", "language": "fr"}, {"text": "$$$"},
], ids=["blank", "denied", "speaker", "language", "no_symbols"])
def test_styletts2_refusals_match_jax(st2_denying_apps, payload):
    jax_app, port_app = st2_denying_apps
    want = jax_app.synthesize_api(payload)
    assert want[0] == 400 and port_app.synthesize_api(payload) == want


# ---------------------------------------------------------------------------
# dispatch and the command line


@pytest.mark.parametrize("case", ["bare_vocoder", "fs2_no_vocoder", "fs2_ref_audio_dir",
                                  "fs2_reference", "st2_vocoder", "st2_output_format"])
def test_dispatch_errors_match_jax(stub_ckpts, st2, tmp_path, case):
    fs2, gen = stub_ckpts["fs2"], stub_ckpts["generator"]
    args, options = {
        "bare_vocoder": ((gen,), {}),
        "fs2_no_vocoder": ((fs2,), {}),
        "fs2_ref_audio_dir": ((fs2,), {"vocoder_path": gen, "ref_audio_dir": tmp_path}),
        "fs2_reference": ((fs2,), {"vocoder_path": gen, "default_reference": st2["reference"]}),
        "st2_vocoder": ((st2["ckpt"],), {"vocoder_path": gen}),
        "st2_output_format": ((st2["ckpt"],), {"output_formats": ["wav"]}),
    }[case]
    with pytest.raises(ValueError) as want:
        J.create_demo_app_auto(*args, **options)
    with pytest.raises(ValueError) as got:
        P.create_demo_app_auto(*args, device="cpu", **options)
    assert str(got.value) == str(want.value)


@pytest.fixture
def port_cli(monkeypatch, capsys):
    monkeypatch.setenv("EVERYVOICE_DEVICE", "cpu")

    def run(*args):
        capsys.readouterr()
        rc = cli.main([str(a) for a in args])
        out = capsys.readouterr()
        return rc, out.out, out.err

    return run


@pytest.mark.parametrize("case", ["share", "both_lists", "ui_not_json", "ui_not_object",
                                  "no_vocoder", "bad_ref_speaker"])
def test_demo_verb_refusals_match_jax(stub_ckpts, tmp_path, port_cli, case):
    fs2, gen = stub_ckpts["fs2"], stub_ckpts["generator"]
    (tmp_path / "bad.json").write_text("{not json", encoding="utf8")
    (tmp_path / "list.json").write_text("[1, 2]", encoding="utf8")
    (tmp_path / "words.txt").write_text("hello\n", encoding="utf8")
    args = [fs2, "--vocoder-path", gen] + {
        "share": ["--share"],
        "both_lists": ["--allowlist", tmp_path / "words.txt", "--denylist", tmp_path / "words.txt"],
        "ui_not_json": ["--ui-config", tmp_path / "bad.json"],
        "ui_not_object": ["--ui-config", tmp_path / "list.json"],
        "no_vocoder": [],
        "bad_ref_speaker": ["--ref-speaker", "Eric"],
    }[case]
    if case == "no_vocoder":
        args = [fs2]
    result = CliRunner().invoke(jax_main, ["demo"] + [str(a) for a in args])
    assert result.exit_code == 1
    rc, out, err = port_cli("demo", *args)
    assert rc == 1 and not out
    assert err.strip().splitlines()[-1] == result.output.strip().splitlines()[-1]


def test_demo_verb_usage_errors_and_accelerator(stub_ckpts, tmp_path, port_cli, monkeypatch):
    fs2, gen = stub_ckpts["fs2"], stub_ckpts["generator"]
    for args in (["demo", tmp_path / "missing.ckpt", "--vocoder-path", gen],
                 ["demo", fs2, "--vocoder-path", tmp_path / "missing.ckpt"],
                 ["demo", fs2, "--ui-config", tmp_path / "missing.json"],
                 ["demo", fs2, "-O", "mp3"]):
        with pytest.raises(SystemExit) as usage:
            port_cli(*args)
        assert usage.value.code == 2
        assert CliRunner().invoke(jax_main, [str(a) for a in args]).exit_code == 2
    rc, _, err = port_cli("demo", fs2, "--vocoder-path", gen, "-a", "tpu")
    assert rc == 1 and "--accelerator tpu" in err
    if not torch.cuda.is_available():
        for accelerator in ("auto", "gpu"):
            if accelerator == "auto":
                monkeypatch.delenv("EVERYVOICE_DEVICE")
            rc, _, err = port_cli("demo", fs2, "--vocoder-path", gen, "-a", accelerator)
            assert rc == 1 and "runs on a CUDA card by default" in err


def test_demo_process_end_to_end(stub_ckpts, lists, tmp_path):
    """``python -m everyvoice_tpu_torch demo`` as a process on the CPU, over
    real HTTP: the empty and denied texts refused, "hello world" served."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "everyvoice_tpu_torch", "demo", str(stub_ckpts["fs2"]),
         "--vocoder-path", str(stub_ckpts["generator"]), "--port", str(port),
         "--server-name", "127.0.0.1", "--denylist", str(lists["denylist"]),
         "-o", str(tmp_path / "out")],
        cwd=tmp_path, env={**os.environ, "EVERYVOICE_DEVICE": "cpu", "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"demo exited early:\n{proc.stdout.read()[-3000:]}")
            try:
                assert get(base + "/")[0] == 200
                break
            except OSError:
                assert time.monotonic() < deadline, "the demo never came up"
                time.sleep(0.5)
        status, body = post_json(base + "/api/synthesize", {"text": " "})
        assert status == 400 and body["error"] == "Please enter some text to synthesize."
        status, body = post_json(base + "/api/synthesize", {"text": "totally forbidden words"})
        assert status == 400 and body["error"] == (
            "Oops, that word is not allowed to be synthesized.")
        status, body = post_json(base + "/api/synthesize", {"text": "hello world"})
        assert status == 200 and len(samples(body)) > 0
        assert sorted(p.name for p in (tmp_path / "out" / "wav").iterdir()) == [
            "hello-world--default--default.wav"]
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert "device: cpu" in out and f"Serving demo at http://127.0.0.1:{port}" in out

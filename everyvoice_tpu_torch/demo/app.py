"""Interactive synthesis demo server (counterpart of
everyvoice_tpu/demo/app.py): a stdlib ``ThreadingHTTPServer`` with the same
page, JSON API, status codes and error strings — text + duration control +
language/speaker selection + output formats for FastSpeech2, diffusion and
blend sliders with named reference speakers for StyleTTS2, allow/denylists
with homograph-resistant normalization, and UI-label overrides.

The models run on ``device``, the CUDA card by default. The server answers
each request on its own thread; the model calls are serialised by one lock,
since one model on one card serves them all (and the vocoder's folded
weights are cached per parameter version, which is not safe to race).

StyleTTS2 requests draw the style diffusion's noise from a
``torch.Generator`` seeded with the request's ``seed`` (the JAX package
draws from ``PRNGKey(seed)``), so the two packages' wavs for one seed
differ; a request equals ``synthesize_text`` called with that seed.
``/api/info`` names the model the app serves (the JAX app says
"FastSpeech2" for a StyleTTS2 checkpoint too).
"""

from __future__ import annotations

import base64
import json
import logging
import re
import tempfile
import threading
import unicodedata
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.audio_io import write_wav

logger = logging.getLogger(__name__)


def normalize_text(text: str) -> str:
    """Homograph-resistant normalization for allow/denylist comparison:
    NFKC fold + casefold + strip marks and whitespace so visually-identical
    strings compare equal."""
    text = unicodedata.normalize("NFKC", text)
    text = "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )
    text = text.casefold()
    return re.sub(r"\s+", " ", text).strip()


def load_wordlist(path: Optional[Path]) -> set:
    if path is None:
        return set()
    lines = Path(path).read_text(encoding="utf8").splitlines()
    return {normalize_text(line) for line in lines if line.strip()}


def parse_ref_speakers(entries) -> dict:
    """Parse repeated --ref-speaker 'Display Name=path/to/audio.wav' flags
    into {name: Path}."""
    out: dict = {}
    for entry in entries or ():
        name, sep, path = str(entry).partition("=")
        name, path = name.strip(), path.strip()
        if not sep or not name or not path:
            raise ValueError(
                f"--ref-speaker {entry!r} must look like "
                "'Display Name=path/to/audio.wav'"
            )
        if name in out:
            raise ValueError(f"--ref-speaker name {name!r} given twice")
        wav = Path(path)
        if not wav.exists():
            raise ValueError(f"--ref-speaker audio not found: {wav}")
        out[name] = wav
    return out


def _restrict(requested, available, what: str) -> list:
    """Validate a -s/--speaker or -l/--language restriction list against
    what the model actually serves."""
    if not requested or list(requested) == ["all"]:
        return list(available)
    unknown = sorted(set(requested) - set(available))
    if unknown:
        raise ValueError(
            f"Requested {what} not in the model: {unknown} "
            f"(model has {sorted(available)})"
        )
    return [v for v in available if v in set(requested)]


OUTPUT_FORMAT_CHOICES = ("wav", "spec", "textgrid", "readalong-xml",
                         "readalong-html")


PAGE_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>{title}</title>
<style>
 body {{ font-family: sans-serif; max-width: 48rem; margin: 2rem auto; }}
 textarea {{ width: 100%; height: 6rem; }}
 .row {{ margin: 0.75rem 0; }}
 #error {{ color: #b00020; }}
 button {{ padding: 0.5rem 1.5rem; }}
</style>
</head>
<body>
<h1>{title}</h1>
<p>{subtitle}</p>
<div class="row"><textarea id="text" placeholder="{text_placeholder}"></textarea></div>
<div class="row">Language:
  <select id="language">{language_options}</select>
  &nbsp; Speaker: <select id="speaker">{speaker_options}</select>
</div>
{control_rows}
<div class="row"><button id="synthesize" onclick="synthesize()">Synthesize</button></div>
<div class="row" id="error"></div>
<div class="row"><audio id="player" controls></audio></div>
<script>
async function synthesize() {{
  const error = document.getElementById('error');
  error.innerText = '';
  const body = {{
    text: document.getElementById('text').value,
    language: document.getElementById('language').value,
    speaker: document.getElementById('speaker').value,
  }};
{control_body_js}
  const resp = await fetch('/api/synthesize', {{
    method: 'POST', headers: {{'Content-Type': 'application/json'}},
    body: JSON.stringify(body),
  }});
  const data = await resp.json();
  if (!resp.ok) {{ error.innerText = data.error || 'Synthesis failed'; return; }}
  const player = document.getElementById('player');
  player.src = 'data:audio/wav;base64,' + data.wav_base64;
  player.play();
}}
</script>
</body>
</html>
"""


def _slider_row(label: str, input_id: str, mn, mx, step, value) -> str:
    """One labeled range input whose live value mirrors into a span."""
    return (
        f"{label}: <input type='range' id='{input_id}' min='{mn}' max='{mx}' "
        f"step='{step}' value='{value}' oninput=\"document.getElementById("
        f"'{input_id}val').innerText = this.value\"> "
        f"<span id='{input_id}val'>{value}</span>"
    )


def _wav_base64(wav: np.ndarray, sample_rate: int) -> str:
    """A float wav as the base64 of the 16-bit file ``write_wav`` writes."""
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        write_wav(tmp.name, np.asarray(wav), sample_rate)
        return base64.b64encode(Path(tmp.name).read_bytes()).decode("ascii")


class DemoApp:
    """Holds the loaded models and serves the UI + JSON API."""

    MODEL_NAME = "FastSpeech2"
    # Model-specific synthesis controls: HTML rows rendered above the
    # Synthesize button, and the JS that copies their values into the
    # /api/synthesize request body.
    CONTROL_ROWS = '<div class="row">' + _slider_row(
        "Duration multiplier", "duration", 0.5, 2.0, 0.05, 1.0
    ) + "</div>"
    CONTROL_BODY_JS = (
        "  body.duration_control = "
        "parseFloat(document.getElementById('duration').value);"
    )

    def __init__(
        self,
        fs2_checkpoint: Path | str,
        vocoder_checkpoint: Optional[Path | str] = None,
        allowlist: Optional[Path] = None,
        denylist: Optional[Path] = None,
        ui_labels: Optional[dict] = None,
        speakers: Optional[list] = None,
        languages: Optional[list] = None,
        output_formats: Optional[list] = None,
        output_dir: Optional[Path | str] = None,
        device=None,
    ):
        from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer

        self.synthesizer = Synthesizer(fs2_checkpoint, vocoder_checkpoint, device=device)
        if self.synthesizer.vocoder is None:
            raise ValueError("The demo requires a vocoder checkpoint for wav output")
        self.lock = threading.Lock()
        self.allowlist = load_wordlist(allowlist)
        self.denylist = load_wordlist(denylist)
        self.ui = {
            "title": "EveryVoice TPU Demo",
            "subtitle": "Type a sentence and press Synthesize.",
            "text_placeholder": "Hello world",
        }
        self.languages = _restrict(
            languages, sorted(self.synthesizer.lang2id) or ["default"],
            "languages",
        )
        self.speakers = _restrict(
            speakers, sorted(self.synthesizer.speaker2id) or ["default"],
            "speakers",
        )
        self.output_formats = _restrict(
            output_formats, OUTPUT_FORMAT_CHOICES, "output formats"
        )
        self.output_dir = Path(output_dir) if output_dir is not None else None
        # Display-name maps: keys are model values, values are what the
        # dropdown shows.
        self.language_labels = {v: v for v in self.languages}
        self.speaker_labels = {v: v for v in self.speakers}
        if ui_labels:
            self._apply_ui_config(ui_labels)

    def _apply_ui_config(self, ui_labels: dict) -> None:
        """Apply a UI-config dict: string entries override page labels;
        'speakers'/'languages' dicts restrict the selectable values to
        their keys and rename them to their values (unknown keys are
        rejected)."""
        for key, value in ui_labels.items():
            if key in ("speakers", "languages"):
                if not isinstance(value, dict):
                    raise ValueError(f"UI config '{key}' must map values to display names")
                known = self.speakers if key == "speakers" else self.languages
                unknown = set(value) - set(known)
                if unknown:
                    raise ValueError(
                        f"UI config lists {key} the model was not trained "
                        f"with: {sorted(unknown)} (model has {known})"
                    )
                if key == "speakers":
                    self.speakers = sorted(value)
                    self.speaker_labels = dict(value)
                else:
                    self.languages = sorted(value)
                    self.language_labels = dict(value)
            elif isinstance(value, str):
                self.ui[key] = value

    # -- request handling --------------------------------------------------
    def check_lists(self, text: str) -> Optional[str]:
        normalized = normalize_text(text)
        if self.denylist:
            for entry in self.denylist:
                if entry and entry in normalized:
                    return "Oops, that word is not allowed to be synthesized."
        if self.allowlist:
            words = set(normalized.split())
            if not words <= self.allowlist:
                return "Sorry, one or more words are not in the allowed list."
        return None

    def _check_request(self, payload: dict) -> tuple:
        """(text, language, speaker, None) for a request the app serves, or
        (None, None, None, (400, error)) for one it refuses."""
        text = (payload.get("text") or "").strip()
        if not text:
            return None, None, None, (400, {"error": "Please enter some text to synthesize."})
        refusal = self.check_lists(text)
        if refusal:
            return None, None, None, (400, {"error": refusal})
        language = payload.get("language") or self.languages[0]
        speaker = payload.get("speaker") or self.speakers[0]
        if language not in self.languages:
            return None, None, None, (400, {"error": f"Language '{language}' is not served here."})
        if speaker not in self.speakers:
            return None, None, None, (400, {"error": f"Speaker '{speaker}' is not served here."})
        return text, language, speaker, None

    def synthesize_api(self, payload: dict) -> tuple:
        text, language, speaker, refused = self._check_request(payload)
        if refused:
            return refused
        duration = float(payload.get("duration_control", 1.0))
        requested = payload.get("output_formats") or ["wav"]
        unknown = sorted(set(requested) - set(self.output_formats))
        if unknown:
            return 400, {
                "error": f"Output formats not served here: {unknown} "
                f"(available: {self.output_formats})"
            }
        with self.lock:
            results = self.synthesizer.synthesize(
                [text], language=language, speaker=speaker, duration_control=duration,
            )
        if not results or results[0]["wav"] is None:
            return 400, {"error": "No valid symbols found in the input text."}
        sr = self.synthesizer.config["preprocessing"]["audio"]["output_sampling_rate"]
        response = {"wav_base64": _wav_base64(results[0]["wav"], sr)}
        # Every selected format is also written to disk for download.
        if self.output_dir is not None:
            written = self.synthesizer.write_outputs(
                results, self.output_dir, output_types=requested,
                language=language, speaker=speaker,
            )
            response["files"] = [str(p) for p in written]
        return 200, response

    def _control_rows(self) -> str:
        boxes = " ".join(
            f"<label><input type='checkbox' class='fmt' value='{f}'"
            + (" checked" if f == "wav" else "")
            + f"> {f}</label>"
            for f in self.output_formats
        )
        return (
            self.CONTROL_ROWS
            + f'\n<div class="row">Outputs: {boxes}</div>'
        )

    def _control_body_js(self) -> str:
        return self.CONTROL_BODY_JS + (
            "\n  body.output_formats = Array.from(document.querySelectorAll("
            "'.fmt:checked')).map(e => e.value);"
        )

    def render_page(self) -> str:
        def options(values, labels):
            return "".join(
                f"<option value='{v}'>{labels.get(v, v)}</option>"
                for v in values
            )

        return PAGE_TEMPLATE.format(
            title=self.ui["title"],
            subtitle=self.ui["subtitle"],
            text_placeholder=self.ui["text_placeholder"],
            language_options=options(self.languages, self.language_labels),
            speaker_options=options(self.speakers, self.speaker_labels),
            control_rows=self._control_rows(),
            control_body_js=self._control_body_js(),
        )

    # -- server -------------------------------------------------------------
    def make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("demo: " + fmt % args)

            def _send(self, code: int, body: bytes, content_type: str):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(
                        200, app.render_page().encode("utf8"),
                        "text/html; charset=utf-8",
                    )
                elif self.path == "/api/info":
                    info = {
                        "languages": app.languages,
                        "speakers": app.speakers,
                        "model": app.MODEL_NAME,
                    }
                    self._send(200, json.dumps(info).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/api/synthesize":
                    self._send(404, b"not found", "text/plain")
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    code, body = app.synthesize_api(payload)
                except Exception as e:  # surface errors to the client
                    logger.error(f"demo synthesis error: {e}")
                    code, body = 500, {"error": str(e)}
                self._send(code, json.dumps(body).encode(), "application/json")

        return Handler

    def serve(self, host: str = "0.0.0.0", port: int = 7860):
        server = ThreadingHTTPServer((host, port), self.make_handler())
        server.serve_forever()

    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        """Non-blocking server; returns the server object (port 0: any free
        port, in ``server.server_address``)."""
        return ThreadingHTTPServer((host, port), self.make_handler())


def create_demo_app(
    fs2_checkpoint, vocoder_checkpoint=None, allowlist=None, denylist=None,
    ui_labels=None, speakers=None, languages=None, output_formats=None,
    output_dir=None, device=None,
) -> DemoApp:
    return DemoApp(
        fs2_checkpoint, vocoder_checkpoint, allowlist=allowlist,
        denylist=denylist, ui_labels=ui_labels, speakers=speakers,
        languages=languages, output_formats=output_formats,
        output_dir=output_dir, device=device,
    )


# ---------------------------------------------------------------------------
# StyleTTS2 demo: named reference speakers with precomputed style vectors,
# diffusion steps / embedding scale / blend sliders


class StyleTTS2DemoApp(DemoApp):
    """Serves a StyleTTS2 checkpoint: style comes from diffusion sampling,
    optionally blended with precomputed reference-speaker styles."""

    MODEL_NAME = "StyleTTS2"
    CONTROL_ROWS = (
        '<div class="row">'
        + _slider_row("Diffusion steps", "steps", 1, 20, 1, 5)
        + " &nbsp; "
        + _slider_row("Embedding scale", "escale", 0.5, 4.0, 0.1, 1.0)
        + '</div>\n<div class="row">'
        + _slider_row("Acoustic blend", "ablend", 0.0, 1.0, 0.05, 0.5)
        + " &nbsp; "
        + _slider_row("Prosody blend", "pblend", 0.0, 1.0, 0.05, 0.5)
        + "</div>"
    )
    CONTROL_BODY_JS = "\n".join(
        f"  body.{field} = parse{kind}(document.getElementById('{eid}').value);"
        for field, kind, eid in (
            ("diffusion_steps", "Int", "steps"),
            ("embedding_scale", "Float", "escale"),
            ("acoustic_blend", "Float", "ablend"),
            ("prosody_blend", "Float", "pblend"),
        )
    )

    # StyleTTS2 is wav-only end-to-end synthesis: no output-format boxes.
    def _control_rows(self) -> str:
        return self.CONTROL_ROWS

    def _control_body_js(self) -> str:
        return self.CONTROL_BODY_JS

    def __init__(
        self,
        checkpoint,
        ref_audio_dir=None,
        allowlist=None,
        denylist=None,
        ui_labels=None,
        ref_speakers: Optional[dict] = None,
        default_reference: Optional[Path | str] = None,
        speakers: Optional[list] = None,
        languages: Optional[list] = None,
        device=None,
    ):
        from everyvoice_tpu_torch.models.styletts2.synthesize import (
            load_reference_style,
            load_styletts2_model,
        )

        (self.model, self.config, self.text_processor,
         self.lang2id) = load_styletts2_model(checkpoint, device=device)
        self.lock = threading.Lock()
        self.allowlist = load_wordlist(allowlist)
        self.denylist = load_wordlist(denylist)
        self.ui = {
            "title": "EveryVoice TPU Demo (StyleTTS2)",
            "subtitle": "Type a sentence and press Synthesize.",
            "text_placeholder": "Hello world",
        }
        self.languages = _restrict(
            languages, sorted(self.lang2id) or ["default"], "languages"
        )
        # Precompute style vectors for named reference speakers: explicit
        # --ref-speaker Name=path entries plus every wav in --ref-audio-dir.
        ref_wavs: dict = {}
        if ref_audio_dir is not None:
            for wav in sorted(Path(ref_audio_dir).glob("*.wav")):
                ref_wavs[wav.stem] = wav
        ref_wavs.update(ref_speakers or {})
        if default_reference is not None:
            # Upload-mode default: the initial style.
            ref_wavs.setdefault("default", Path(default_reference))
        self.ref_styles = {
            name: load_reference_style(self.model, wav, self.config)
            for name, wav in ref_wavs.items()
        }
        self.speakers = _restrict(
            speakers, sorted(self.ref_styles) or ["default"], "speakers"
        )
        self.language_labels = {v: v for v in self.languages}
        self.speaker_labels = {v: v for v in self.speakers}
        if ui_labels:
            self._apply_ui_config(ui_labels)

    def synthesize_api(self, payload: dict) -> tuple:
        from everyvoice_tpu_torch.models.styletts2.synthesize import synthesize_text

        text, language, speaker, refused = self._check_request(payload)
        if refused:
            return refused
        try:
            with self.lock:
                wav = synthesize_text(
                    self.model, self.config, self.text_processor, text,
                    language=language,
                    ref_styles=self.ref_styles.get(speaker),
                    diffusion_steps=int(payload.get("diffusion_steps", 5)),
                    embedding_scale=float(payload.get("embedding_scale", 1.0)),
                    acoustic_blend=float(payload.get("acoustic_blend", 0.5)),
                    prosody_blend=float(payload.get("prosody_blend", 0.5)),
                    seed=int(payload.get("seed", 0)),
                )
        except ValueError as e:
            return 400, {"error": str(e)}
        sr = self.config["preprocessing"]["audio"]["output_sampling_rate"]
        return 200, {"wav_base64": _wav_base64(wav, sr)}


def create_demo_app_styletts2(
    checkpoint, ref_audio_dir=None, allowlist=None, denylist=None,
    ui_labels=None, ref_speakers=None, default_reference=None, speakers=None,
    languages=None, device=None,
) -> StyleTTS2DemoApp:
    return StyleTTS2DemoApp(
        checkpoint, ref_audio_dir=ref_audio_dir, allowlist=allowlist,
        denylist=denylist, ui_labels=ui_labels, ref_speakers=ref_speakers,
        default_reference=default_reference, speakers=speakers,
        languages=languages, device=device,
    )


def create_demo_app_auto(
    checkpoint, vocoder_path=None, ref_audio_dir=None, allowlist=None,
    denylist=None, ui_labels=None, speakers=None, languages=None,
    output_formats=None, output_dir=None, ref_speakers=None,
    default_reference=None, device=None,
):
    """Dispatch on the checkpoint's model_info.name; the app serves on
    ``device`` (the card by default)."""
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint_header

    device = resolve_device(device)
    name = load_checkpoint_header(checkpoint)["model_info"]["name"]
    if name == "StyleTTS2Module":
        if vocoder_path is not None:
            raise ValueError(
                "StyleTTS2 is an end-to-end text-to-wav model; it does not "
                "take a separate --vocoder-path."
            )
        if output_formats:
            raise ValueError(
                "--output-format selects FastSpeech2 synthesis outputs; the "
                "StyleTTS2 demo always returns wav audio."
            )
        return create_demo_app_styletts2(
            checkpoint, ref_audio_dir=ref_audio_dir, allowlist=allowlist,
            denylist=denylist, ui_labels=ui_labels, ref_speakers=ref_speakers,
            default_reference=default_reference, speakers=speakers,
            languages=languages, device=device,
        )
    if name == "FastSpeech2":
        if ref_audio_dir is not None or ref_speakers or default_reference:
            raise ValueError(
                "--ref-speaker/--reference/--ref-audio-dir provide StyleTTS2 "
                "reference-speaker styles; FastSpeech2 demos do not use them "
                "(pass a GST style reference per request instead)."
            )
        if vocoder_path is None:
            raise ValueError(
                "A FastSpeech2 demo needs --vocoder-path to produce audio."
            )
        return create_demo_app(
            checkpoint, vocoder_path, allowlist=allowlist, denylist=denylist,
            ui_labels=ui_labels, speakers=speakers, languages=languages,
            output_formats=output_formats, output_dir=output_dir, device=device,
        )
    raise ValueError(
        f"Cannot serve a demo for model type {name!r} — pass a FastSpeech2 "
        "or StyleTTS2Module checkpoint (a bare vocoder cannot be demoed)."
    )

"""Text→mel→wav synthesis (counterpart of
everyvoice_tpu/models/fs2/synthesize.py).

``Synthesizer`` encodes and chunks each text, buckets the chunks by token
count to powers of two (at least 16), pads each batch to a power of two (at
most ``batch_size``), runs FastSpeech2 and the HiFiGAN generator on the
padded batch and reassembles the results per text — the same padded shapes
as the JAX package, which its outputs depend on (GroupNorm statistics span
the padding). Entry points run on the CUDA card unless ``device`` names the
CPU. Below the characters level each chunk's phones come from the
language's G2P engine. With a GST checkpoint, ``style_reference`` (a wav)
conditions every chunk of the request. ``write_outputs`` writes wavs, specs,
TextGrids and read-along XML and HTML; the HTML page loads the public
ReadAlongs web component in a ``<script>`` tag, as the JAX package's does.
``synthesize_teacher_forced_specs`` writes the teacher-forced mels a vocoder
finetune reads from ``synthesized_spec/``. ``export_generator`` strips a
HiFiGAN training checkpoint to the generator that serving loads.

A ``phonological_features`` checkpoint raises ``ValueError``: the JAX
package's ``Synthesizer`` and ``FastSpeech2Dataset`` encode such text as ids
and hand them to ``pfs_proj``, which wants (B, N, 43) features, so that
level never ran end to end there.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from xml.sax.saxutils import escape
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from everyvoice_tpu_torch.config import PREPROCESSING, fs2_config, hifigan_config, merge_defaults
from everyvoice_tpu_torch.convert import flax_to_torch
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset, reject_phonological_features
from everyvoice_tpu_torch.dsp import read_wav, write_wav
from everyvoice_tpu_torch.dsp.resample import resample_host
from everyvoice_tpu_torch.dsp.spectral import dynamic_range_compression, get_spectral_transform
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.text import TextProcessor, chunk_text
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from everyvoice_tpu_torch.utils import slugify, truncate_basename
from everyvoice_tpu_torch.utils.precision import resolve_compute_dtype

logger = logging.getLogger(__name__)

OUTPUT_FORMATS = ("wav", "spec", "textgrid", "readalong-xml", "readalong-html")
READALONG_SCRIPT = ("https://unpkg.com/@readalongs/web-component@^1.4.0/dist/web-component/"
                    "web-component.esm.js")


def load_fs2_from_checkpoint(ckpt_path: Path | str, compute_dtype: str = "float32", device=None):
    """(model, config, text_processor, lang2id, speaker2id) from a
    FastSpeech2 checkpoint, the model in eval mode on ``device``."""
    device = resolve_device(device)
    compute_dtype = resolve_compute_dtype(compute_dtype, device)
    ckpt = load_checkpoint(ckpt_path)
    if ckpt["model_info"]["name"] != "FastSpeech2":
        raise ValueError(
            f"Expected a FastSpeech2 checkpoint, got {ckpt['model_info']['name']}"
        )
    hp = ckpt["hyper_parameters"]
    config = fs2_config(hp["config"])
    lang2id = hp.get("lang2id", {})
    speaker2id = hp.get("speaker2id", {})
    text_processor = TextProcessor(
        config["text"], config["model"]["target_text_representation_level"]
    )
    model = FastSpeech2.from_config(
        config, n_symbols=len(text_processor.symbols),
        n_speakers=max(len(speaker2id), 1), n_langs=max(len(lang2id), 1),
        compute_dtype=compute_dtype,
    )
    state, absent = flax_to_torch(ckpt["state_dict"], model)
    if absent:
        logger.info(f"The checkpoint lacks {len(absent)} optional parameters (alignment "
                    "encoder or style tokens, which its JAX init did not create); they keep "
                    "their initial values")
    model.load_state_dict(state)
    return model.to(device).eval(), config, text_processor, lang2id, speaker2id


def load_vocoder_from_checkpoint(ckpt_path: Path | str, compute_dtype: str = "auto", device=None):
    """(generator, config) from a HiFiGAN (full) or HiFiGANGenerator
    (exported) checkpoint, of either resblock and with or without the iSTFT
    head. 'auto' resolves to bfloat16 on a card and float32 on the CPU."""
    device = resolve_device(device)
    compute_dtype = resolve_compute_dtype(compute_dtype, device)
    ckpt = load_checkpoint(ckpt_path)
    name = ckpt["model_info"]["name"]
    state = ckpt["state_dict"]
    if name == "HiFiGAN":
        params = state["generator"]
    elif name == "HiFiGANGenerator":
        params = state
    else:
        raise ValueError(f"Expected a vocoder checkpoint, got {name}")
    config = hifigan_config(ckpt["hyper_parameters"]["config"])
    generator = HiFiGANGenerator.from_config(config, compute_dtype=compute_dtype)
    torch_state, _ = flax_to_torch(params, generator)
    generator.load_state_dict(torch_state)
    generator = generator.to(device).eval()
    if generator.resblock == "1":
        generator.prepare()  # the MRF kernel's weights, folded before the first request
    return generator, config


def reference_log_mel(wav_path: Path | str, audio_config: dict, device) -> torch.Tensor:
    """A style reference wav → its (1, T, n_mels) log-mel on ``device``:
    mixed to mono, resampled to the input rate, the config's spectral
    transform (the plain version, as the JAX package uses)."""
    a = audio_config
    audio, sr = read_wav(wav_path)
    mono = audio.mean(axis=0)
    if sr != a["input_sampling_rate"]:
        mono = resample_host(mono, sr, a["input_sampling_rate"])
    mel_fn = get_spectral_transform(
        a["spec_type"], a["n_fft"], a["fft_window_size"], a["fft_hop_size"],
        a["input_sampling_rate"], a["n_mels"], a["f_min"], a["f_max"],
    )
    with torch.no_grad():
        mel = dynamic_range_compression(mel_fn(torch.from_numpy(mono).to(device)))
    return mel.T[None]


def export_generator(full_ckpt: Path | str, out_path: Path | str) -> Path:
    """Strip a HiFiGAN training checkpoint's discriminators and optimizer
    state into a HiFiGANGenerator checkpoint (the JAX package's
    ``export_generator``; both packages load it)."""
    ckpt = load_checkpoint(full_ckpt)
    if ckpt["model_info"]["name"] != "HiFiGAN":
        raise ValueError("export expects a full HiFiGAN training checkpoint")
    hp = ckpt["hyper_parameters"]
    return save_checkpoint(
        out_path, "HiFiGANGenerator", hp["config"], ckpt["state_dict"]["generator"],
        step=ckpt.get("global_step", 0), lang2id=hp.get("lang2id"),
        speaker2id=hp.get("speaker2id"), stats=hp.get("stats"),
    )


class Synthesizer:
    """Batched text→wav synthesis with length bucketing."""

    def __init__(
        self,
        fs2_checkpoint: Path | str,
        vocoder_checkpoint: Optional[Path | str] = None,
        compute_dtype: str = "auto",
        device=None,
    ):
        self.device = resolve_device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        (
            self.model, self.config, self.text_processor,
            self.lang2id, self.speaker2id,
        ) = load_fs2_from_checkpoint(fs2_checkpoint, self.compute_dtype, self.device)
        reject_phonological_features(self.config, "Synthesizer")
        self.vocoder = None
        self.vocoder_config = None
        if vocoder_checkpoint is not None:
            self.vocoder, self.vocoder_config = load_vocoder_from_checkpoint(
                vocoder_checkpoint, self.compute_dtype, self.device
            )

    def encode(self, text: str, lang_id: Optional[str]) -> list:
        """Token ids of each chunk of ``text`` that has any; through G2P
        below the characters level."""
        apply_g2p = self.config["model"]["target_text_representation_level"] != "characters"
        chunks = [text]
        text_cfg = self.config["text"]
        if text_cfg["split_text"]:
            boundaries = text_cfg["boundaries"].get(lang_id or "")
            kwargs = {}
            if boundaries is not None:
                kwargs = dict(
                    strong_boundaries=boundaries.get("strong", "!?."),
                    weak_boundaries=boundaries.get("weak", ":;,"),
                )
            chunks = chunk_text(text, **kwargs) or [text]
        encoded = []
        for chunk in chunks:
            ids = self.text_processor.encode_text(chunk, apply_g2p=apply_g2p, lang_id=lang_id,
                                                  quiet=True)
            if len(ids):
                encoded.append(np.asarray(ids, np.int32))
        return encoded

    @torch.no_grad()
    def _forward(self, text, lengths, speaker_id, language_id, duration_control,
                 style_reference=None):
        out = self.model(
            text, lengths, speaker_id=speaker_id, language_id=language_id,
            style_reference=style_reference, duration_control=duration_control,
        )
        mel = out["postnet_mel"] if "postnet_mel" in out else out["mel"]
        wav = self.vocoder(mel) if self.vocoder is not None else None
        return mel, out["predicted_frame_lengths"], out["duration_used"], wav

    def load_style_reference(self, wav_path: Path | str) -> torch.Tensor:
        """A reference wav → its (1, T, n_mels) log-mel on the device for the
        GST module (``reference_log_mel``)."""
        return reference_log_mel(wav_path, self.config["preprocessing"]["audio"], self.device)

    def synthesize(
        self,
        texts: Sequence[str],
        language: Optional[str] = None,
        speaker: Optional[str] = None,
        duration_control: float = 1.0,
        style_reference: Optional[Path | str] = None,
        batch_size: int = 16,
    ) -> list:
        """One result dict per input text, in order: {text, mel (T, M) |
        None, wav | None, durations, tokens}. A text with no valid symbols
        yields mel=None, so results stay aligned with the caller's names.
        ``style_reference``, a wav, conditions every padded batch."""
        if speaker is not None and self.speaker2id and speaker not in self.speaker2id:
            raise ValueError(
                f"Unknown speaker '{speaker}'; valid speakers: {sorted(self.speaker2id)}"
            )
        if language is not None and self.lang2id and language not in self.lang2id:
            raise ValueError(
                f"Unknown language '{language}'; valid languages: {sorted(self.lang2id)}"
            )
        speaker_id = self.speaker2id.get(speaker or "default", 0)
        language_id = self.lang2id.get(language or "default", 0)
        style_mel = (self.load_style_reference(style_reference)
                     if style_reference is not None else None)

        chunk_entries: list = []  # (text_idx, chunk_idx, ids)
        n_chunks_per_text: list = []
        for ti, text in enumerate(texts):
            chunks = self.encode(text, language)
            if not chunks:
                logger.warning(f"No valid symbols found in '{text}'; skipping.")
            n_chunks_per_text.append(len(chunks))
            chunk_entries += [(ti, ci, ids) for ci, ids in enumerate(chunks)]

        buckets: dict = defaultdict(list)
        for entry in chunk_entries:
            buckets[int(2 ** np.ceil(np.log2(max(len(entry[2]), 16))))].append(entry)
        hop_total = self._samples_per_frame()
        chunk_out: dict = {}  # (text_idx, chunk_idx) -> (mel, durations, ids, wav)
        for n, group in sorted(buckets.items()):
            for off in range(0, len(group), batch_size):
                sl = group[off : off + batch_size]
                b = int(2 ** np.ceil(np.log2(len(sl))))
                b = max(min(b, batch_size), len(sl))
                padded = np.zeros((b, n), np.int32)
                lengths = np.ones((b,), np.int32)
                for j, (_, _, ids) in enumerate(sl):
                    padded[j, : len(ids)] = ids
                    lengths[j] = len(ids)
                mel, frames, durations, wav = self._forward(
                    torch.from_numpy(padded).to(self.device),
                    torch.from_numpy(lengths).to(self.device),
                    torch.full((b,), speaker_id, dtype=torch.int32, device=self.device),
                    torch.full((b,), language_id, dtype=torch.int32, device=self.device),
                    duration_control,
                    style_mel.expand(b, -1, -1) if style_mel is not None else None,
                )
                mel, frames, durations, wav = self._to_host(
                    mel.float(), frames, durations, wav.float() if wav is not None else None
                )
                for j, (ti, ci, ids) in enumerate(sl):
                    n_frames = max(min(int(frames[j]), mel.shape[1]), 1)
                    chunk_out[(ti, ci)] = (
                        mel[j, :n_frames],
                        durations[j, : len(ids)],
                        ids,
                        wav[j, : n_frames * hop_total] if wav is not None else None,
                    )

        results = []
        for ti, text in enumerate(texts):
            n_chunks = n_chunks_per_text[ti]
            if n_chunks == 0:
                results.append(
                    {"text": text, "mel": None, "wav": None, "durations": [], "tokens": []}
                )
                continue
            parts = [chunk_out[(ti, ci)] for ci in range(n_chunks)]
            wavs = [p[3] for p in parts if p[3] is not None]
            results.append({
                "text": text,
                "mel": np.concatenate([p[0] for p in parts], axis=0),
                "wav": np.concatenate(wavs) if wavs else None,
                "durations": [p[1] for p in parts],
                "tokens": [p[2] for p in parts],
            })
        return results

    def _to_host(self, *tensors) -> list:
        """Numpy copies of a batch's outputs (None stays None). On a card
        each copy goes without blocking into pinned host memory and the
        stream is synchronized once, so the copies are not paid one after
        another."""
        if self.device.type == "cpu":
            return [t.numpy() if t is not None else None for t in tensors]
        host = []
        for t in tensors:
            h = None
            if t is not None:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            host.append(h)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() if h is not None else None for h in host]

    def _samples_per_frame(self) -> int:
        a = self.config["preprocessing"]["audio"]
        return a["fft_hop_size"] * (a["output_sampling_rate"] // a["input_sampling_rate"])

    def write_outputs(
        self,
        results: list,
        output_dir: Path | str,
        output_types: Sequence[str] = ("wav",),
        language: Optional[str] = None,
        speaker: Optional[str] = None,
        basenames: Optional[Sequence[str]] = None,
    ) -> list:
        """Write each result as ``wav/<stem>.wav``,
        ``synthesized_spec/<stem>--spec-pred.npy``,
        ``textgrids/<stem>.TextGrid`` and ``readalongs/<stem>.readalong`` /
        ``.html``, as ``output_types`` asks; returns the paths."""
        output_dir = Path(output_dir)
        written = []
        sr = self.config["preprocessing"]["audio"]["output_sampling_rate"]
        hop_s = self._samples_per_frame() / sr
        for i, res in enumerate(results):
            if res["mel"] is None:
                continue
            if basenames is not None and i < len(basenames):
                base = basenames[i]
            else:
                base = truncate_basename(slugify(res["text"]))
            stem = f"{base}--{speaker or 'default'}--{language or 'default'}"
            if "wav" in output_types and res["wav"] is not None:
                path = output_dir / "wav" / f"{stem}.wav"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_wav(path, res["wav"], sr)
                written.append(path)
            if "spec" in output_types:
                path = output_dir / "synthesized_spec" / f"{stem}--spec-pred.npy"
                path.parent.mkdir(parents=True, exist_ok=True)
                np.save(path, res["mel"].T)  # (M, T) like preprocessed specs
                written.append(path)
            if "textgrid" in output_types:
                path = output_dir / "textgrids" / f"{stem}.TextGrid"
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(self._to_textgrid(res, hop_s), encoding="utf8")
                written.append(path)
            if "readalong-xml" in output_types or "readalong-html" in output_types:
                ras_dir = output_dir / "readalongs"
                ras_dir.mkdir(parents=True, exist_ok=True)
                xml = self._to_readalong(res, hop_s)
                if "readalong-xml" in output_types:
                    path = ras_dir / f"{stem}.readalong"
                    path.write_text(xml, encoding="utf8")
                    written.append(path)
                if "readalong-html" in output_types:
                    path = ras_dir / f"{stem}.html"
                    path.write_text(self._readalong_html(stem), encoding="utf8")
                    written.append(path)
        return written

    def _token_intervals(self, res: dict, hop_s: float):
        """(token, start s, end s) of every used token, chunk after chunk."""
        t = 0.0
        for ids, durations in zip(res["tokens"], res["durations"]):
            tokens = self.text_processor.token_sequence_to_text_sequence([int(x) for x in ids])
            for token, dur in zip(tokens, durations):
                start, end = t, t + float(dur) * hop_s
                yield token, start, end
                t = end

    def _to_textgrid(self, res: dict, hop_s: float) -> str:
        """A Praat TextGrid with one interval tier, ``tokens``."""
        intervals = list(self._token_intervals(res, hop_s))
        total = intervals[-1][2] if intervals else 0.0
        lines = [
            'File type = "ooTextFile"',
            'Object class = "TextGrid"',
            "",
            "xmin = 0",
            f"xmax = {total:.6f}",
            "tiers? <exists>",
            "size = 1",
            "item []:",
            "    item [1]:",
            '        class = "IntervalTier"',
            '        name = "tokens"',
            "        xmin = 0",
            f"        xmax = {total:.6f}",
            f"        intervals: size = {len(intervals)}",
        ]
        for i, (token, start, end) in enumerate(intervals, start=1):
            escaped = token.replace('"', '""')
            lines += [
                f"        intervals [{i}]:",
                f"            xmin = {start:.6f}",
                f"            xmax = {end:.6f}",
                f'            text = "{escaped}"',
            ]
        return "\n".join(lines) + "\n"

    def _to_readalong(self, res: dict, hop_s: float) -> str:
        """ReadAlongs XML: one ``<w>`` with its time and duration per token."""
        words = [
            f'      <w id="t{wi}" time="{start:.3f}" dur="{end - start:.3f}">{escape(token)}</w>'
            for wi, (token, start, end) in enumerate(self._token_intervals(res, hop_s))
        ]
        body = "\n".join(words)
        return (
            '<?xml version="1.0" encoding="utf-8"?>\n'
            '<read-along version="1.0">\n  <text>\n    <body>\n'
            f'      <div type="page">\n      <p>\n      <s>\n{body}\n'
            "      </s>\n      </p>\n      </div>\n"
            "    </body>\n  </text>\n</read-along>\n"
        )

    @staticmethod
    def _readalong_html(stem: str) -> str:
        """A page showing ``<stem>.readalong`` against ``../wav/<stem>.wav``."""
        return (
            "<!DOCTYPE html>\n<html>\n<head><meta charset='utf-8'>"
            f"<title>{escape(stem)}</title></head>\n<body>\n"
            f"<read-along href='{escape(stem)}.readalong' "
            f"audio='../wav/{escape(stem)}.wav'></read-along>\n"
            f"<script type='module' src='{READALONG_SCRIPT}'></script>\n</body>\n</html>\n"
        )


@torch.no_grad()
def synthesize_teacher_forced_specs(
    fs2_checkpoint: Path | str,
    filelist: list,
    config: Optional[dict] = None,
    output_dir: Optional[Path | str] = None,
    device=None,
) -> int:
    """Write the teacher-forced mel of every filelist row to
    ``<output_dir or save_dir>/synthesized_spec/{base}--{speaker}--{language}--spec-{sr}-{spec_type}.npy``,
    (M, frames), for a vocoder finetune. The checkpoint runs in float32 on
    batches of 8, in filelist order, with the target mel, pitch and energy
    (durations from the alignment, as in training); ``config`` (the
    checkpoint's by default) says where the artifacts are. Returns the
    number of files written."""
    device = resolve_device(device)
    model, ckpt_config, text_processor, lang2id, speaker2id = load_fs2_from_checkpoint(
        fs2_checkpoint, "float32", device)
    config = fs2_config(config) if config is not None else ckpt_config
    config = {**config, "preprocessing": merge_defaults(PREPROCESSING, config["preprocessing"])}
    dataset = FastSpeech2Dataset(filelist, config, lang2id, speaker2id, text_processor=text_processor)
    out_root = Path(output_dir or config["preprocessing"]["save_dir"]) / "synthesized_spec"
    out_root.mkdir(parents=True, exist_ok=True)
    a = config["preprocessing"]["audio"]
    suffix = f"spec-{a['input_sampling_rate']}-{a['spec_type']}.npy"
    count = 0
    for batch in dataset.batches(8, shuffle=False):
        basenames = batch.pop("basenames")
        t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        out = model(
            t["text"], t["text_lengths"], mel=t["mel"], mel_lengths=t["mel_lengths"],
            attn_prior=t.get("attn_prior"), pitch=t["pitch"], energy=t["energy"],
            speaker_id=t["speaker_id"], language_id=t["language_id"], teacher_forcing=True,
        )
        mel = out.get("postnet_mel", out["mel"]).cpu().numpy()
        for i, base in enumerate(basenames):
            # The last batch is padded by repeating its last row: stop at
            # the corpus size.
            if count >= len(dataset.items):
                break
            item = dataset.items[count]
            speaker = item.get("speaker") or "default"
            language = item.get("language") or "default"
            n = int(batch["mel_lengths"][i])
            np.save(out_root / f"{base}--{speaker}--{language}--{suffix}", mel[i, :n].T)
            count += 1
    return count

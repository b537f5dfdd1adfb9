"""Text→mel→wav synthesis (counterpart of
everyvoice_tpu/models/fs2/synthesize.py).

``Synthesizer`` encodes and chunks each text, buckets the chunks by token
count to powers of two (at least 16), pads each batch to a power of two (at
most ``batch_size``), runs FastSpeech2 and the HiFiGAN generator on the
padded batch and reassembles the results per text — the same padded shapes
as the JAX package, which its outputs depend on (GroupNorm statistics span
the padding). Entry points run on the CUDA card unless ``device`` names the
CPU. ``export_generator`` strips a HiFiGAN training checkpoint to the
generator that serving loads. Textgrid and read-along outputs, style
references and ``synthesize_teacher_forced_specs`` are a later slice of the
port.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from everyvoice_tpu_torch.config import fs2_config, hifigan_config
from everyvoice_tpu_torch.convert import flax_to_torch
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp import write_wav
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
from everyvoice_tpu_torch.text import TextProcessor, chunk_text
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from everyvoice_tpu_torch.utils import slugify, truncate_basename
from everyvoice_tpu_torch.utils.precision import resolve_compute_dtype

logger = logging.getLogger(__name__)

OUTPUT_FORMATS = ("wav", "spec")


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
        logger.info(f"The checkpoint has no alignment encoder ({len(absent)} parameters); "
                    "serving does not use it")
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
        self.vocoder = None
        self.vocoder_config = None
        if vocoder_checkpoint is not None:
            self.vocoder, self.vocoder_config = load_vocoder_from_checkpoint(
                vocoder_checkpoint, self.compute_dtype, self.device
            )

    def encode(self, text: str, lang_id: Optional[str]) -> list:
        """Token ids of each chunk of ``text`` that has any."""
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
            ids = self.text_processor.encode_text(chunk, lang_id=lang_id, quiet=True)
            if len(ids):
                encoded.append(np.asarray(ids, np.int32))
        return encoded

    @torch.no_grad()
    def _forward(self, text, lengths, speaker_id, language_id, duration_control):
        out = self.model(
            text, lengths, speaker_id=speaker_id, language_id=language_id,
            duration_control=duration_control,
        )
        mel = out["postnet_mel"] if "postnet_mel" in out else out["mel"]
        wav = self.vocoder(mel) if self.vocoder is not None else None
        return mel, out["predicted_frame_lengths"], out["duration_used"], wav

    def synthesize(
        self,
        texts: Sequence[str],
        language: Optional[str] = None,
        speaker: Optional[str] = None,
        duration_control: float = 1.0,
        batch_size: int = 16,
    ) -> list:
        """One result dict per input text, in order: {text, mel (T, M) |
        None, wav | None, durations, tokens}. A text with no valid symbols
        yields mel=None, so results stay aligned with the caller's names."""
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
        """Write each result as ``wav/<stem>.wav`` and/or
        ``synthesized_spec/<stem>--spec-pred.npy``; returns the paths."""
        unsupported = set(output_types) - set(OUTPUT_FORMATS)
        if unsupported:
            raise NotImplementedError(
                f"output types {sorted(unsupported)} are not ported yet; the "
                f"port writes {OUTPUT_FORMATS}"
            )
        output_dir = Path(output_dir)
        written = []
        sr = self.config["preprocessing"]["audio"]["output_sampling_rate"]
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
        return written

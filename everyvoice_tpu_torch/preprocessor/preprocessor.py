"""Preprocessing: wavs and filelists → the artifacts FastSpeech2 and HiFiGAN
training read (counterpart of everyvoice_tpu/preprocessor/preprocessor.py).

Steps, in order, as the JAX package runs them:

1. **audio** (host, thread pool): decode, reject files with more than two
   channels, too short, too long or quieter than −36 LUFS, apply the
   dataset's sox effects, resample, mix down, peak-normalize to 0.95, cut
   to a whole number of hops and write 16-bit wavs; write ``summary.txt``,
   the missing and multichannel reports and the processed filelist. With
   ``device_audio`` the loudness gate, the resampling and the peak
   normalization run on the device instead, over bucket-padded batches of
   each native rate (decoding, effects and writes stay on the host);
2. **text**: normalize and tokenize the characters and declared phones;
   an ``arpabet`` column becomes IPA phones, and a row with characters but
   no phones, in a language with a G2P engine, gets its phones from G2P;
   **pfs** does the same and writes each row's (N_phones, 43) phonological
   features;
3. **spec / energy / pitch** (the card): sort utterances by length, pad
   each batch of 16 to a power-of-two multiple of ``BUCKET_FRAMES`` hops,
   ship it as int16 PCM and compute the log-mel (the hand-written kernel
   ``ops/mel.py::log_mel`` for ``mel-librosa`` with hop | n_fft), the frame
   energy and the F0 track of the whole batch; write each item's artifacts
   cut to ``len(audio) // hop`` frames;
4. **attn**: beta-binomial alignment priors;
5. corpus stats (``stats.json``) and z-scoring of energy and pitch, once;
   then the seeded train/validation split and the config lock.

Artifact names and layout are the JAX package's:
``{save_dir}/{audio,spec,attn,energy,pitch,pfs}/basename--speaker--language--<name>``.
``preprocess_ood`` writes StyleTTS2's out-of-domain sentences under
``ood/``.
"""

from __future__ import annotations

import json
import logging
import random
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from everyvoice_tpu_torch.config import preprocessing_config
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.dsp.audio_io import read_wav, write_wav
from everyvoice_tpu_torch.dsp.loudness import batched_loudness, integrated_loudness_host
from everyvoice_tpu_torch.dsp.pitch import estimate_f0
from everyvoice_tpu_torch.dsp.prior import BetaBinomialInterpolator
from everyvoice_tpu_torch.dsp.resample import resample, resample_host
from everyvoice_tpu_torch.dsp.sox import apply_sox_effects
from everyvoice_tpu_torch.dsp.spectral import (
    compute_energy,
    dynamic_range_compression,
    get_spectral_transform,
)
from everyvoice_tpu_torch.ops.mel import log_mel
from everyvoice_tpu_torch.preprocessor.helpers import (
    Counters,
    Scaler,
    read_config_lock,
    write_config_lock,
)
from everyvoice_tpu_torch.text import CHARACTER_JOINER, JOINER_SUBSTITUTION, TextProcessor
from everyvoice_tpu_torch.text.arpabet import arpabet_to_ipa
from everyvoice_tpu_torch.text.phonemizer import AVAILABLE_G2P_ENGINES
from everyvoice_tpu_torch.utils import (
    generic_psv_filelist_reader,
    n_times,
    resolve_filelist_loader,
    write_filelist,
)

logger = logging.getLogger(__name__)

PROCESSING_ORDER = ("audio", "text", "pfs", "spec", "attn", "energy", "pitch")
FILENAME_SEP = "--"
# Batches are padded to a power-of-two multiple of this many hops, so a
# corpus runs a handful of batch shapes. The shapes are part of the numbers:
# the F0 voicing gate compares each frame with its row's peak energy.
BUCKET_FRAMES = 128
BATCH_SIZE = 16
# Columns of a source filelist that survive the audio step.
KEEP_COLUMNS = (
    "basename", "language", "speaker", "characters",
    "character_tokens", "phones", "phone_tokens", "arpabet", "label",
)


class Preprocessor:
    """Runs the preprocessing steps for a plain-dict config (the JAX
    package's config layout; defaults are filled in by
    ``config.preprocessing_config``). The feature step runs on ``device``:
    the CUDA card by default, ``"cpu"`` where the caller asks for it."""

    def __init__(self, config: dict, device=None):
        self.device = resolve_device(device)
        self.config = preprocessing_config(config)
        self.preprocessing_config = self.config["preprocessing"]
        self.audio_config = self.preprocessing_config["audio"]
        self.datasets = self.preprocessing_config["source_data"]
        self.save_dir = Path(self.preprocessing_config["save_dir"])
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.counters = Counters()
        self.missing_files_list: list = []
        self.multichannel_files_list: list = []
        self.overwrite = False
        # Energy/pitch files written this run, raw; files of earlier
        # completed runs are z-scored already.
        self._features_written: dict = {"energy": [], "pitch": []}
        a = self.audio_config
        self.input_sampling_rate = a["input_sampling_rate"]
        self.output_sampling_rate = a["output_sampling_rate"]
        self.sampling_rate_change = self.output_sampling_rate // self.input_sampling_rate
        self.output_hop_size = self.sampling_rate_change * a["fft_hop_size"]
        self.text_processor = TextProcessor(self.config["text"])

    # ------------------------------------------------------------------
    # paths

    def create_path(self, item: dict, folder: str, fn: str) -> Path:
        return self.save_dir / folder / FILENAME_SEP.join(
            [item["basename"], item["speaker"], item["language"], fn]
        )

    @staticmethod
    def get_speaker_and_language(item: dict) -> dict:
        out = dict(item)
        if not out.get("speaker"):
            out["speaker"] = "default"
        if not out.get("language"):
            out["language"] = "default"
        return out

    def load_filelist(self, path: Path) -> list:
        return generic_psv_filelist_reader(path)

    def _spec_type_str(self) -> str:
        return str(self.audio_config["spec_type"])

    def _spec_filename(self) -> str:
        """The spec artifact's file name, which every reader must agree on."""
        return f"spec-{self.input_sampling_rate}-{self._spec_type_str()}.npy"

    # ------------------------------------------------------------------
    # audio (host)

    def _load_conditioned_audio(
        self,
        wav_path: Path,
        sox_effects: Optional[list] = None,
        update_counters: bool = True,
        skip_loudness: bool = False,
    ):
        """Decode, validate and apply the effects once, at the native rate.
        Returns ((C, T) audio, sr), or None for a rejected file. With
        ``skip_loudness`` the caller gates the loudness, and counts the
        duration of the files that pass."""
        try:
            audio, sr = read_wav(wav_path)
        except FileNotFoundError:
            return None
        if audio.shape[0] > 2:
            logger.warning(
                f"Audio file '{wav_path}' has {audio.shape[0]} channels; only "
                "mono/stereo are supported — skipping."
            )
            if update_counters:
                self.counters.increment("multichannel")
            self.multichannel_files_list.append(str(wav_path))
            return None
        seconds = audio.shape[1] / sr
        if seconds > self.audio_config["max_audio_length"]:
            logger.warning(f"Audio too long: {wav_path} ({seconds:.2f} s) — skipping")
            if update_counters:
                self.counters.increment("audio_too_long")
            return None
        if seconds < self.audio_config["min_audio_length"]:
            logger.warning(f"Audio too short: {wav_path} ({seconds:.2f} s) — skipping")
            if update_counters:
                self.counters.increment("audio_too_short")
            return None
        if not skip_loudness:
            lufs = integrated_loudness_host(audio, sr)
            if np.isnan(lufs) or lufs < -36.0:
                logger.warning(f"Audio empty (loudness {lufs:.1f}): {wav_path} — skipping")
                if update_counters:
                    self.counters.increment("audio_empty")
                return None
        x = np.asarray(audio)
        if sox_effects:
            try:
                x, sr = apply_sox_effects(x, sr, sox_effects)
            except Exception as e:  # any failing effect rejects the file
                logger.warning(f"Audio-effect error on {wav_path}: {e}")
                if update_counters:
                    self.counters.increment("sox_error")
                return None
        if update_counters and not skip_loudness:
            self.counters.increment("duration", seconds)
        return x, sr

    def _finalize_audio(self, x, sr, resample_rate: Optional[int], hop_size: int,
                        normalize: bool = True):
        """Resample, mix down, peak-normalize ×0.95 and cut to a multiple of
        the hop. Returns (float32 (T,) audio, sr)."""
        x = np.asarray(x)
        if resample_rate is not None and resample_rate != sr:
            x = resample_host(x, sr, resample_rate)
            sr = resample_rate
        if x.shape[0] > 1:  # effects may not have mixed down
            x = np.mean(x, axis=0, keepdims=True)
        if normalize:
            x = x / max(np.max(np.abs(x)), 1e-9) * 0.95
        x = np.asarray(x[0], dtype=np.float32)
        return x[: (x.shape[0] // hop_size) * hop_size], sr

    def process_audio(
        self,
        wav_path: Path,
        normalize: bool = True,
        resample_rate: Optional[int] = None,
        sox_effects: Optional[list] = None,
        hop_size: Optional[int] = None,
        update_counters: bool = True,
    ):
        """Load, validate and condition one file. Returns (float32 (T,)
        audio, sr), or (None, None) for a rejected file."""
        if hop_size is None:
            raise ValueError("hop size required: sample counts must divide evenly")
        cond = self._load_conditioned_audio(
            wav_path, sox_effects=sox_effects, update_counters=update_counters
        )
        if cond is None:
            return None, None
        return self._finalize_audio(*cond, resample_rate, hop_size, normalize)

    def process_one_audio(
        self, item: dict, data_dir: Path, sox_effects: list, dataset_label: str
    ) -> Optional[dict]:
        extension = "" if item["basename"].endswith(".wav") else ".wav"
        audio_path = Path(data_dir) / (item["basename"] + extension)
        if not audio_path.exists():
            logger.warning(f"File '{audio_path}' is missing; not processed.")
            self.counters.increment("missing_files")
            self.missing_files_list.append(str(audio_path))
            return None
        item = self.get_speaker_and_language(item)
        item["label"] = dataset_label
        input_path = self.create_path(item, "audio", f"audio-{self.input_sampling_rate}.wav")
        output_path = self.create_path(item, "audio", f"audio-{self.output_sampling_rate}.wav")
        if input_path.exists() and output_path.exists() and not self.overwrite:
            self.counters.increment("previously_processed_files")
            return item
        need_input = not input_path.exists() or self.overwrite
        need_output = self.input_sampling_rate != self.output_sampling_rate and (
            not output_path.exists() or self.overwrite
        )
        cond = self._load_conditioned_audio(audio_path, sox_effects=sox_effects)
        if cond is None:
            return None
        x, native_sr = cond
        bit_depth = self.audio_config["target_bit_depth"]
        if need_input:
            audio, sr = self._finalize_audio(
                x, native_sr, self.input_sampling_rate, self.audio_config["fft_hop_size"]
            )
            write_wav(input_path, audio, sr, bit_depth)
        if need_output:
            audio, sr = self._finalize_audio(
                x, native_sr, self.output_sampling_rate, self.output_hop_size
            )
            write_wav(output_path, audio, sr, bit_depth)
        self.counters.increment("processed_files")
        return item

    def process_all_audio(self, cpus: int = 1, device_audio: Optional[bool] = None) -> list:
        """Validate and condition every audio file, on a thread pool of
        ``cpus`` workers (decoding, filtering and writing release the GIL in
        part); with ``device_audio``, the gate, resampling and peak
        normalization as batches on ``self.device``
        (``_process_all_audio_device``). Returns the processed filelist's
        rows."""
        (self.save_dir / "audio").mkdir(parents=True, exist_ok=True)
        jobs = []
        for dataset in self.datasets:
            loader = resolve_filelist_loader(dataset["filelist_loader"])
            for item in loader(dataset["filelist"]):
                jobs.append((item, dataset["data_dir"], dataset["sox_effects"], dataset["label"]))

        def one(job):
            return self.process_one_audio(*job)

        if device_audio:
            results = self._process_all_audio_device(jobs, cpus)
        elif cpus > 1:
            with ThreadPoolExecutor(max_workers=cpus) as pool:
                results = list(pool.map(one, jobs))
        else:
            results = [one(job) for job in jobs]
        return [
            {k: v for k, v in result.items() if k in KEEP_COLUMNS}
            for result in results
            if result is not None
        ]

    # ------------------------------------------------------------------
    # audio (the device)

    def _decode_for_device(self, item: dict, data_dir, sox_effects, dataset_label):
        """The host half of the device audio pass, one file: decode,
        validate, apply the effects and mix down. A file that still has two
        channels after its effects is gated here, before its mixdown, so its
        gate sees both channels' energy; a mono file is gated on the device.
        Returns None (rejected), ("done", item) (artifacts exist) or ("todo",
        item, (T,) float32 audio, native rate, gated already, {"input" |
        "output": (needed, path)}, the source's path)."""
        extension = "" if item["basename"].endswith(".wav") else ".wav"
        audio_path = Path(data_dir) / (item["basename"] + extension)
        if not audio_path.exists():
            logger.warning(f"File '{audio_path}' is missing; not processed.")
            self.counters.increment("missing_files")
            self.missing_files_list.append(str(audio_path))
            return None
        item = self.get_speaker_and_language(item)
        item["label"] = dataset_label
        input_path = self.create_path(item, "audio", f"audio-{self.input_sampling_rate}.wav")
        output_path = self.create_path(item, "audio", f"audio-{self.output_sampling_rate}.wav")
        if input_path.exists() and output_path.exists() and not self.overwrite:
            self.counters.increment("previously_processed_files")
            return ("done", item)
        cond = self._load_conditioned_audio(audio_path, sox_effects=sox_effects,
                                            skip_loudness=True)
        if cond is None:
            return None
        x, native_sr = cond
        x = np.asarray(x, dtype=np.float32)
        pre_gated = False
        if x.shape[0] > 1:
            lufs = integrated_loudness_host(x, native_sr)
            if np.isnan(lufs) or lufs < -36.0:
                logger.warning(f"Audio empty (loudness {lufs:.1f}): {audio_path} — skipping")
                self.counters.increment("audio_empty")
                return None
            pre_gated = True
            x = np.mean(x, axis=0, keepdims=True)
        need_input = not input_path.exists() or self.overwrite
        need_output = self.input_sampling_rate != self.output_sampling_rate and (
            not output_path.exists() or self.overwrite
        )
        return ("todo", item, x[0], int(native_sr), pre_gated,
                {"input": (need_input, input_path), "output": (need_output, output_path)},
                str(audio_path))

    def _audio_program(self, native_sr: int, targets: tuple, pcm16: bool = False):
        """A function of a (B, T) batch tensor of one native rate: the
        BS.1770 loudness of each row (float32, the whole padded row), then
        each row resampled to each target rate and peak-normalized to 0.95.
        With ``pcm16`` the batch is int16 PCM and each output is rounded to
        int16, the artifact's own grid. Returns (loudness (B,), *outputs)."""

        @torch.no_grad()
        def program(batch: torch.Tensor) -> tuple:
            if pcm16:
                batch = batch.to(torch.float32) / 32768.0
            lufs = batched_loudness(batch[:, None, :], native_sr)
            outs = []
            for target in targets:
                y = resample(batch, native_sr, target)
                peak = torch.amax(torch.abs(y), dim=-1, keepdim=True)
                y = y / torch.clamp(peak, min=1e-9) * 0.95
                if pcm16:
                    y = torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(torch.int16)
                outs.append(y)
            return (lufs, *outs)

        return program

    def _process_all_audio_device(self, jobs: list, cpus: int) -> list:
        """The device audio pass: decode on a pool of ``cpus`` threads, group
        the files by native rate, sort each group by length, pad batches of
        ``BATCH_SIZE`` to a power-of-two multiple of ``BUCKET_FRAMES`` hops
        and run ``_audio_program`` on each, batch i+1 dispatched before batch
        i's outputs are written (pinned copies and an event, as the feature
        step). A batch travels as int16 PCM where that is exact (16-bit
        artifacts, effects that keep the grid, every clip of the batch on
        it), else as float32: the JAX path quantizes a stereo source's mixdown to int16
        before the peak normalization, which takes it up to 2 LSB from the
        host path's artifact. The wavs are written on a pool of ``cpus``
        threads. The batches' shapes, the bytes each way and the device's
        peak memory are logged as one ``device audio:`` JSON line. Returns
        the rows in the jobs' order, None for a rejected file."""
        from math import gcd

        workers = max(cpus, 1)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            decoded = list(pool.map(lambda job: self._decode_for_device(*job), jobs))
        results: list = [None] * len(decoded)
        todo = []
        for i, entry in enumerate(decoded):
            if entry is None:
                continue
            if entry[0] == "done":
                results[i] = entry[1]
                continue
            todo.append((i,) + entry[1:])
        self.last_audio_transfer_bytes = {"up": 0, "down": 0}
        self.last_audio_batch_shapes: list = []
        if not todo:
            return results

        targets = (self.input_sampling_rate,)
        if self.output_sampling_rate != self.input_sampling_rate:
            targets = (self.input_sampling_rate, self.output_sampling_rate)
        hops = {self.input_sampling_rate: self.audio_config["fft_hop_size"],
                self.output_sampling_rate: self.output_hop_size}
        bit_depth = self.audio_config["target_bit_depth"]
        bucket_samples = BUCKET_FRAMES * self.audio_config["fft_hop_size"]

        def _grid_safe(effects) -> bool:
            """Effects that keep 16-bit sources on the 16-bit grid: none, or
            the mono mixdown alone."""
            if not effects:
                return True
            return [[str(part) for part in effect] for effect in effects] == [["channels", "1"]]

        def on_grid(x: np.ndarray) -> bool:
            """Whether a decoded clip is exactly on the 16-bit grid: a
            stereo source's mixdown falls between its steps."""
            scaled = x * 32768.0
            return bool(np.array_equal(scaled, np.round(scaled)))

        effects_keep_grid = bit_depth == 16 and all(_grid_safe(job[2]) for job in jobs)
        by_rate: dict = {}
        for entry in todo:
            by_rate.setdefault(entry[3], []).append(entry)

        write_pool = ThreadPoolExecutor(max_workers=workers)
        write_futures = []

        def finish_chunk(chunk, host, event, native_sr) -> None:
            if event is not None:
                event.synchronize()
            lufs, *outs = (h.numpy() for h in host)
            for row, (idx, item, x, _, pre_gated, needs, path_str) in enumerate(chunk):
                if not pre_gated and (np.isnan(lufs[row]) or lufs[row] < -36.0):
                    logger.warning(f"Audio empty (loudness {float(lufs[row]):.1f}): "
                                   f"{path_str} — skipping")
                    self.counters.increment("audio_empty")
                    continue
                self.counters.increment("duration", len(x) / native_sr)
                for t_i, target in enumerate(targets):
                    need, path = needs["input" if target == self.input_sampling_rate
                                       else "output"]
                    if not need:
                        continue
                    g = gcd(native_sr, target)
                    out_len = -(-len(x) * (target // g) // (native_sr // g))
                    y = outs[t_i][row][:out_len]
                    if y.dtype == np.int16:  # write_wav's rounding gives it back
                        y = y.astype(np.float32) / 32768.0
                    hop = hops[target]
                    write_futures.append(write_pool.submit(
                        write_wav, path, y[: (len(y) // hop) * hop], target, bit_depth))
                self.counters.increment("processed_files")
                results[idx] = item

        try:
            for native_sr, group in by_rate.items():
                programs = {pcm16: self._audio_program(native_sr, targets, pcm16=pcm16)
                            for pcm16 in (False, True)}
                group.sort(key=lambda e: len(e[2]))
                pending = None
                for i in range(0, len(group), BATCH_SIZE):
                    chunk = group[i : i + BATCH_SIZE]
                    # int16 both ways only where that is exact: the effects
                    # keep the grid and every clip of the batch is on it.
                    pcm16 = effects_keep_grid and all(on_grid(e[2]) for e in chunk)
                    n_buckets = max(-(-max(len(e[2]) for e in chunk) // bucket_samples), 1)
                    n_buckets = 1 << (n_buckets - 1).bit_length()  # next power of 2
                    batch = np.zeros((BATCH_SIZE, n_buckets * bucket_samples),
                                     np.int16 if pcm16 else np.float32)
                    for j, e in enumerate(chunk):
                        if pcm16:
                            batch[j, : len(e[2])] = np.clip(np.round(e[2] * 32768.0),
                                                            -32768, 32767)
                        else:
                            batch[j, : len(e[2])] = e[2]
                    host, event = self._dispatch(programs[pcm16], batch)
                    self.last_audio_batch_shapes.append((native_sr, tuple(batch.shape),
                                                        str(batch.dtype)))
                    self.last_audio_transfer_bytes["up"] += batch.nbytes
                    self.last_audio_transfer_bytes["down"] += sum(
                        h.numel() * h.element_size() for h in host)
                    if pending is not None:
                        finish_chunk(*pending)
                    pending = (chunk, host, event, native_sr)
                if pending is not None:
                    finish_chunk(*pending)
            for future in write_futures:
                future.result()
        finally:
            write_pool.shutdown()
        report = {"batches": self.last_audio_batch_shapes, **self.last_audio_transfer_bytes}
        if self.device.type == "cuda":
            report["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        logger.info(f"device audio: {json.dumps(report)}")
        return results

    # ------------------------------------------------------------------
    # text

    def process_text(self, item: dict, use_pfs: bool = False):
        """Tokenize the characters and the phones of one row: declared
        phones, else its ``arpabet`` converted to IPA, else G2P from the
        characters when the language has an engine. Returns
        (character_tokens | None, phone_tokens | None, (N, 43) features |
        None); the features only with ``use_pfs`` and phones."""
        characters = phones = pfs = None
        dataset_label = item.get("label")
        lang = item.get("language") or None

        def join(tokens):
            return CHARACTER_JOINER.join(
                t.replace(CHARACTER_JOINER, JOINER_SUBSTITUTION) for t in tokens
            )

        if item.get("arpabet"):
            item = {**item, "phones": arpabet_to_ipa(item["arpabet"])}
        if item.get("characters"):
            norm = self.text_processor.normalize_text(
                item["characters"], lang_id=lang, dataset_label=dataset_label
            )
            characters = join(self.text_processor.apply_tokenization(norm, quiet=True))
            # The registry at this moment: a config's plugins count too.
            if not item.get("phones") and lang is not None and lang in AVAILABLE_G2P_ENGINES:
                phones = join(self.text_processor.apply_g2p_and_tokenization(norm, lang, quiet=True))
        if item.get("phones"):
            norm = self.text_processor.normalize_text(
                item["phones"], lang_id=lang, dataset_label=dataset_label
            )
            phones = join(self.text_processor.apply_tokenization(norm, quiet=True))
        if use_pfs and phones:
            pfs = self.text_processor.calculate_phonological_features(
                self.text_processor.split_tokens(phones))
        return characters, phones, pfs

    # ------------------------------------------------------------------
    # batched features (the card)

    def _load_processed_audio(self, item: dict) -> Optional[np.ndarray]:
        path = self.create_path(item, "audio", f"audio-{self.input_sampling_rate}.wav")
        if not path.exists():
            return None
        return read_wav(path)[0][0]

    def _feature_program(self):
        """A function of a (B, T) batch tensor on ``self.device`` (int16 PCM
        for 16-bit artifacts, else float32) returning (log-mel (B, n_mels,
        F), energy (B, F), F0 (B, F)). The log-mel is the kernel for
        ``mel-librosa`` with hop | n_fft, as the JAX package picks its
        Pallas kernel, and the plain spectral transform otherwise."""
        a = self.audio_config
        spec_type = self._spec_type_str()
        if spec_type == "mel-librosa" and a["n_fft"] % a["fft_hop_size"] == 0:

            def spec_pipeline(batch):
                return log_mel(
                    batch, a["input_sampling_rate"], a["n_fft"], a["fft_window_size"],
                    a["fft_hop_size"], a["n_mels"], float(a["f_min"]), float(a["f_max"]),
                )
        else:
            spec_fn = get_spectral_transform(
                spec_type, a["n_fft"], a["fft_window_size"], a["fft_hop_size"],
                self.input_sampling_rate, a["n_mels"], a["f_min"], a["f_max"],
            )
            if spec_fn is None:
                raise ValueError(f"Unknown spec_type {spec_type!r}")

            def spec_pipeline(batch):
                return dynamic_range_compression(spec_fn(batch))

        pcm16 = a["target_bit_depth"] == 16

        @torch.no_grad()
        def program(batch: torch.Tensor):
            if pcm16:
                batch = batch.to(torch.float32) / 32768.0
            spec = spec_pipeline(batch)
            return spec, compute_energy(spec), estimate_f0(
                batch, self.input_sampling_rate, a["fft_hop_size"]
            )

        return program

    def feature_batches(self, filelist: list, want: Sequence[str], batch_size: int = BATCH_SIZE):
        """(chunk, batch) pairs of the feature step: the utterances that
        still lack a wanted artifact, sorted by length, in chunks of
        ``batch_size`` zero-padded to a (batch_size, 2^k · BUCKET_FRAMES ·
        hop) numpy batch. ``chunk`` holds (item, audio, artifact paths)."""
        hop = self.audio_config["fft_hop_size"]
        bucket_samples = BUCKET_FRAMES * hop
        names = {"spec": self._spec_filename(), "energy": "energy.npy", "pitch": "pitch.npy"}
        todo = []
        for item in filelist:
            item = self.get_speaker_and_language(item)
            paths = {w: self.create_path(item, w, names[w]) for w in want}
            if not self.overwrite and all(p.exists() for p in paths.values()):
                continue  # a rerun skips the read and the device pass too
            audio = self._load_processed_audio(item)
            if audio is None:
                self.counters.increment("missing_files")
                continue
            todo.append((item, audio, paths))
        todo.sort(key=lambda entry: len(entry[1]))
        pcm16 = self.audio_config["target_bit_depth"] == 16
        for i in range(0, len(todo), batch_size):
            chunk = todo[i : i + batch_size]
            n_buckets = max(-(-max(len(a) for _, a, _ in chunk) // bucket_samples), 1)
            n_buckets = 1 << (n_buckets - 1).bit_length()  # next power of 2
            batch = np.zeros(
                (batch_size, n_buckets * bucket_samples), np.int16 if pcm16 else np.float32
            )
            for j, (_, a, _) in enumerate(chunk):
                if pcm16:
                    batch[j, : len(a)] = np.clip(np.round(a * 32768.0), -32768, 32767)
                else:
                    batch[j, : len(a)] = a
            yield chunk, batch

    def _dispatch(self, program, batch: np.ndarray):
        """Run ``program`` on one batch. On a card the upload and the three
        copies back go without blocking (pinned host memory) and an event
        marks their end; returns (host tensors, event or None)."""
        x = torch.from_numpy(batch)
        if self.device.type == "cpu":
            return program(x), None
        outputs = program(x.pin_memory().to(self.device, non_blocking=True))
        host = []
        for out in outputs:
            h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            h.copy_(out, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def process_features_batched(
        self,
        filelist: list,
        want: Sequence[str] = ("spec", "energy", "pitch"),
        batch_size: int = BATCH_SIZE,
    ) -> None:
        """Bucket, pad, one program call per batch, then each item's
        artifacts cut to its true frame count. Batch i+1 is dispatched
        before batch i is written, so device work, the copies back and the
        host's writes overlap."""
        hop = self.audio_config["fft_hop_size"]
        program = self._feature_program()
        self.last_transfer_bytes = {"up": 0, "down": 0}
        self.last_batch_shapes: list = []

        def write_outputs(chunk, host, event) -> None:
            if event is not None:
                event.synchronize()
            spec, energy, f0 = (h.numpy() for h in host)
            for j, (item, a, paths) in enumerate(chunk):
                n_frames = len(a) // hop  # frames == samples // hop, as in training
                for name, value in (("spec", spec[j, :, :n_frames]),
                                    ("energy", energy[j, :n_frames]),
                                    ("pitch", f0[j, :n_frames])):
                    if name not in want:
                        continue
                    path = paths[name]
                    if self.overwrite or not path.exists():
                        np.save(path, value, allow_pickle=False)
                        if name != "spec":
                            self._features_written[name].append(path)

        pending = None
        for chunk, batch in self.feature_batches(filelist, want, batch_size):
            host, event = self._dispatch(program, batch)
            self.last_batch_shapes.append(tuple(batch.shape))
            self.last_transfer_bytes["up"] += batch.nbytes
            self.last_transfer_bytes["down"] += sum(h.numel() * h.element_size() for h in host)
            if pending is not None:
                write_outputs(*pending)
            pending = (chunk, host, event)
        if pending is not None:
            write_outputs(*pending)

    # ------------------------------------------------------------------
    # attention priors

    def process_attn_prior(self, item: dict) -> None:
        item = self.get_speaker_and_language(item)
        interp = BetaBinomialInterpolator()
        spec_path = self.create_path(item, "spec", self._spec_filename())
        if not spec_path.exists():
            return
        n_frames = np.load(spec_path, mmap_mode="r").shape[1]
        for column, rep in (("character_tokens", "characters"), ("phone_tokens", "phones")):
            tokens_joined = item.get(column)
            if not tokens_joined:
                continue
            n_tokens = len([t for t in self.text_processor.split_tokens(tokens_joined) if t])
            if not n_tokens:
                continue
            path = self.create_path(item, "attn", f"{rep}-attn-prior.npy")
            if path.exists() and not self.overwrite:
                continue
            np.save(path, interp(n_frames, n_tokens), allow_pickle=False)

    # ------------------------------------------------------------------
    # config lock

    def _config_summary(self) -> dict:
        """The audio config (it holds no paths) and the dataset name: the
        same JSON the JAX package's lock holds for the same config."""
        return {"audio": dict(self.audio_config), "dataset": self.preprocessing_config["dataset"]}

    def config_lock_has_conflicts(self) -> bool:
        lock = read_config_lock(self.save_dir)
        if lock is None:
            return False
        if lock.get("status") == "in progress":
            return True
        return lock.get("config") != self._config_summary()

    def save_config_lock(self, in_progress: bool) -> None:
        write_config_lock(
            self.save_dir, self._config_summary(),
            "in progress" if in_progress else "completed",
        )

    # ------------------------------------------------------------------
    # orchestration

    def _write_audio_reports(self) -> None:
        with open(self.save_dir / "summary.txt", "w", encoding="utf8") as f:
            json.dump(self.counters.as_dict(), f, indent=1)
        if self.missing_files_list:
            with open(self.save_dir / "missing_files.txt", "w", encoding="utf8") as f:
                f.write("\n".join(self.missing_files_list))
        if self.multichannel_files_list:
            with open(self.save_dir / "multichannel_files.txt", "w", encoding="utf8") as f:
                f.write(
                    "Multichannel audio files skipped "
                    f"({len(self.multichannel_files_list)} total):\n"
                )
                f.write("\n".join(self.multichannel_files_list))
                f.write("\n")

    def _process_text_step(self, processed_filelist: Path, use_pfs: bool = False) -> None:
        filelist = self.load_filelist(processed_filelist)
        before = Counter(self.text_processor.missing_symbols)
        for item in filelist:
            characters, phones, pfs = self.process_text(item, use_pfs=use_pfs)
            if characters is not None:
                item["character_tokens"] = characters
            if phones is not None:
                item["phone_tokens"] = phones
            if pfs is not None:
                path = self.create_path(self.get_speaker_and_language(item), "pfs", "pfs.npy")
                np.save(path, pfs, allow_pickle=False)
        write_filelist(filelist, processed_filelist)
        for symbol, count in (self.text_processor.missing_symbols - before).items():
            logger.warning(
                f"Symbol '{symbol}' occurs {n_times(count)} but was not "
                "declared in your configuration so it is being ignored."
            )

    def _normalize_features(self, to_process: Sequence[str]) -> None:
        """Corpus stats and z-scoring, idempotent across reruns: once
        ``stats.json`` records a kind's stats, its files on disk are
        z-scored already, and only the files written this run are scaled,
        with the recorded stats."""
        stats_path = self.save_dir / "stats.json"
        existing = json.loads(stats_path.read_text(encoding="utf8")) if stats_path.exists() else {}
        changed = False
        for kind in ("energy", "pitch"):
            if kind not in to_process:
                continue
            prior = existing.get(kind)
            if prior is not None and not self.overwrite:
                std = prior.get("std") or 1.0
                mean = prior.get("mean", 0.0)
                for path in self._features_written.get(kind, []):
                    np.save(path, (np.load(path) - mean) / std)
                continue
            scaler = Scaler()
            paths = sorted((self.save_dir / kind).glob(f"*{kind}*"))
            for path in paths:
                scaler.append(np.load(path))
            if not len(scaler):
                continue
            existing[kind] = scaler.calculate_stats()
            for path in paths:
                np.save(path, scaler.normalize(np.load(path)))
            changed = True
        if changed or not stats_path.exists():
            stats_path.write_text(json.dumps(existing, indent=1), encoding="utf8")

    def preprocess(
        self,
        output_path: str = "filelist.psv",
        cpus: int = 1,
        to_process: Sequence[str] = (),
        overwrite: bool = False,
        device_audio: bool = False,
    ) -> None:
        """Run the steps named in ``to_process``, then stats, split and
        lock; the audio step on the device with ``device_audio``.
        ``last_step_seconds`` holds each step's wall seconds."""
        self.overwrite = overwrite
        self._features_written = {"energy": [], "pitch": []}
        if not overwrite and self.config_lock_has_conflicts():
            raise RuntimeError(
                "Config lock mismatch: these files were preprocessed with a "
                "different configuration. Use overwrite to reprocess."
            )
        self.save_config_lock(in_progress=True)
        random.seed(self.preprocessing_config["dataset_split_seed"])
        processed_filelist = self.save_dir / Path(output_path).name
        features = tuple(p for p in ("spec", "energy", "pitch") if p in to_process)

        step_seconds: dict = {}
        for process in PROCESSING_ORDER:
            if process not in to_process:
                continue
            if process in features[1:]:
                continue  # one batched pass computes all three
            t0 = time.perf_counter()
            if process != "text":
                (self.save_dir / process).mkdir(parents=True, exist_ok=True)
            if process == "audio":
                filelist = self.process_all_audio(cpus=max(cpus, 1), device_audio=device_audio)
                self._write_audio_reports()
                if not filelist:
                    raise RuntimeError("Your filtered audio filelist is empty; nothing to process.")
                write_filelist(filelist, processed_filelist)
            elif process in ("text", "pfs"):
                self._process_text_step(processed_filelist, use_pfs=process == "pfs")
            elif process == "attn":
                for item in self.load_filelist(processed_filelist):
                    self.process_attn_prior(item)
            else:
                for w in features:
                    (self.save_dir / w).mkdir(parents=True, exist_ok=True)
                self.process_features_batched(self.load_filelist(processed_filelist), want=features)
            step_seconds[process] = time.perf_counter() - t0

        if "energy" in to_process or "pitch" in to_process:
            t0 = time.perf_counter()
            self._normalize_features(to_process)
            step_seconds["stats"] = time.perf_counter() - t0

        filelist = self.load_filelist(processed_filelist)
        random.shuffle(filelist)
        train_split = int(len(filelist) * self.preprocessing_config["train_split"])
        name = Path(output_path).name
        write_filelist(filelist[:train_split], self.save_dir / f"training_{name}")
        write_filelist(filelist[train_split:], self.save_dir / f"validation_{name}")
        self.save_config_lock(in_progress=False)
        self.last_step_seconds = step_seconds
        timing = ", ".join(f"{k} {v:.2f}s" for k, v in step_seconds.items())
        logger.info(
            f"Finished preprocessing: {', '.join(to_process)} ({timing}). "
            f"Files are at {self.save_dir.absolute()}."
        )

    def preprocess_ood(self, ood_texts_by_lang: dict) -> None:
        """StyleTTS2's out-of-domain text: ``{save_dir}/ood/<lang>.psv``, a
        ``text`` column of each language's non-blank sentences."""
        ood_dir = self.save_dir / "ood"
        ood_dir.mkdir(parents=True, exist_ok=True)
        for lang, lines in ood_texts_by_lang.items():
            write_filelist([{"text": line} for line in lines if line.strip()],
                           ood_dir / f"{lang}.psv")

"""Host-side data pipelines of FastSpeech2 and HiFiGAN training (counterpart
of everyvoice_tpu/dataloader/__init__.py).

FastSpeech2 batches are padded numpy arrays of one shape for the whole run:
text to the corpus's longest token sequence, frames to the model's
``max_length``. HiFiGAN batches are one random (mel, audio) segment an item,
drawn on the host as the JAX package draws them. The final ragged batch
repeats its last item. Artifacts are read with ``np.load`` (and wavs with
``dsp.audio_io.read_wav``) on a small thread pool; the JAX package's native
C reader is not copied.
"""

from __future__ import annotations

import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from everyvoice_tpu_torch.dsp.audio_io import read_wav
from everyvoice_tpu_torch.preprocessor.preprocessor import FILENAME_SEP
from everyvoice_tpu_torch.text import TextProcessor

logger = logging.getLogger(__name__)


def _parallel_load(load_fn, idxs: list, pool: Optional[ThreadPoolExecutor] = None) -> list:
    """A batch's items, loaded on ``pool``'s threads when given (file reads
    release the GIL), else one after another."""
    if pool is None or len(idxs) <= 1:
        return [load_fn(int(i)) for i in idxs]
    return list(pool.map(lambda i: load_fn(int(i)), idxs))


def _n_batches(n: int, batch_size: int, drop_last: bool) -> int:
    """Batches per epoch. Unlike torch's drop_last, a non-empty dataset
    smaller than one batch still yields one (duplicate-padded) batch."""
    if drop_last:
        return max(n // batch_size, 1 if n else 0)
    return math.ceil(n / batch_size)


def imbalanced_sample_weights(labels: Sequence[str]) -> np.ndarray:
    """Inverse-label-frequency weights for oversampling under-represented
    speakers and languages."""
    labels = list(labels)
    counts: dict = {}
    for label in labels:
        counts[label] = counts.get(label, 0) + 1
    weights = np.asarray([1.0 / counts[label] for label in labels], np.float64)
    return weights / weights.sum()


class FastSpeech2Dataset:
    """Loads preprocessed artifacts for the feature-prediction model from a
    FastSpeech2 config dict (``config.fs2_training_config``)."""

    def __init__(self, filelist: list, config: dict, lang2id: dict, speaker2id: dict,
                 text_processor: Optional[TextProcessor] = None):
        self.config = config
        self.save_dir = Path(config["preprocessing"]["save_dir"])
        self.audio_config = config["preprocessing"]["audio"]
        self.lang2id = lang2id
        self.speaker2id = speaker2id
        self.level = config["model"]["target_text_representation_level"]
        self.text_processor = text_processor or TextProcessor(config["text"], self.level)
        self.learn_alignment = config["model"]["learn_alignment"]
        self.max_frames = config["model"]["max_length"]
        self.items = [it for it in filelist if self._usable(it)]
        if len(self.items) < len(filelist):
            logger.warning(f"Dropped {len(filelist) - len(self.items)} filelist rows with "
                           "missing artifacts or tokens.")
        self.max_text_len = max((len(self._token_ids(it)) for it in self.items), default=1)
        # Artifacts are small (a few hundred KB an utterance): epochs after
        # the first read from memory.
        self._cache: dict = {}
        self.max_cache_items = 5000
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- helpers -------------------------------------------------------
    def _token_column(self) -> str:
        return "character_tokens" if self.level == "characters" else "phone_tokens"

    def _token_ids(self, item: dict) -> list:
        cached = item.get("_token_ids")
        if cached is None:
            joined = item.get(self._token_column()) or ""
            cached = self.text_processor.encode_escaped_string_sequence(joined)
            item["_token_ids"] = cached
        return cached

    def _path(self, item: dict, folder: str, fn: str) -> Path:
        speaker = item.get("speaker") or "default"
        language = item.get("language") or "default"
        return self.save_dir / folder / FILENAME_SEP.join([item["basename"], speaker, language, fn])

    def _spec_name(self) -> str:
        a = self.audio_config
        return f"spec-{a['input_sampling_rate']}-{a['spec_type']}.npy"

    def _usable(self, item: dict) -> bool:
        if not item.get(self._token_column()):
            return False
        return self._path(item, "spec", self._spec_name()).exists()

    def __len__(self) -> int:
        return len(self.items)

    # -- item assembly --------------------------------------------------
    def load_item(self, idx: int) -> dict:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        item = self.items[idx]
        out = {
            "basename": item["basename"],
            "text": np.asarray(self._token_ids(item), np.int32),
            "mel": np.load(self._path(item, "spec", self._spec_name())).T.astype(np.float32),
            "pitch": np.load(self._path(item, "pitch", "pitch.npy")).astype(np.float32),
            "energy": np.load(self._path(item, "energy", "energy.npy")).astype(np.float32),
            "speaker_id": self.speaker2id.get(item.get("speaker") or "default", 0),
            "language_id": self.lang2id.get(item.get("language") or "default", 0),
        }
        if self.learn_alignment:
            rep = "characters" if self.level == "characters" else "phones"
            prior_path = self._path(item, "attn", f"{rep}-attn-prior.npy")
            if prior_path.exists():
                out["attn_prior"] = np.load(prior_path).astype(np.float32)
        else:
            dur_path = self._path(item, "duration", "duration.npy")
            if dur_path.exists():
                out["durations"] = np.load(dur_path).astype(np.int32)
        if len(self._cache) < self.max_cache_items:
            self._cache[idx] = out
        return out

    # -- batching -------------------------------------------------------
    def pad_batch(self, items: list, max_text: int, max_frames: int) -> dict:
        b = len(items)
        batch = {
            "text": np.zeros((b, max_text), np.int32),
            "text_lengths": np.zeros((b,), np.int32),
            "mel": np.zeros((b, max_frames, items[0]["mel"].shape[1]), np.float32),
            "mel_lengths": np.zeros((b,), np.int32),
            "pitch": np.zeros((b, max_frames), np.float32),
            "energy": np.zeros((b, max_frames), np.float32),
            "speaker_id": np.zeros((b,), np.int32),
            "language_id": np.zeros((b,), np.int32),
            "basenames": [it["basename"] for it in items],
        }
        if self.learn_alignment:
            batch["attn_prior"] = np.zeros((b, max_frames, max_text), np.float32)
        else:
            batch["durations"] = np.zeros((b, max_text), np.int32)
        for i, it in enumerate(items):
            n = min(len(it["text"]), max_text)
            t = min(it["mel"].shape[0], max_frames)
            batch["text"][i, :n] = it["text"][:n]
            batch["text_lengths"][i] = n
            batch["mel"][i, :t] = it["mel"][:t]
            batch["mel_lengths"][i] = t
            batch["pitch"][i, :t] = it["pitch"][:t]
            batch["energy"][i, :t] = it["energy"][:t]
            batch["speaker_id"][i] = it["speaker_id"]
            batch["language_id"][i] = it["language_id"]
            if self.learn_alignment and "attn_prior" in it:
                batch["attn_prior"][i, :t, :n] = it["attn_prior"][:t, :n]
            elif not self.learn_alignment and "durations" in it:
                d = it["durations"][:n]
                batch["durations"][i, : len(d)] = d
        return batch

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False, weights: Optional[np.ndarray] = None) -> Iterator[dict]:
        """Padded batches, all of one shape: ``batch_size`` rows, the corpus's
        longest text and ``max_length`` frames."""
        n = len(self.items)
        rng = np.random.default_rng(seed)
        if weights is not None:
            order = rng.choice(n, size=n, replace=True, p=weights)
        elif shuffle:
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 4, 8),
                                            thread_name_prefix="fs2-io")
        for bi in range(_n_batches(n, batch_size, drop_last)):
            idxs = order[bi * batch_size : (bi + 1) * batch_size]
            items = _parallel_load(self.load_item, list(idxs), self._pool)
            while len(items) < batch_size:  # pad the ragged final batch
                items.append(items[-1])
            yield self.pad_batch(items, self.max_text_len, self.max_frames)


def it_mel_frames(dataset: FastSpeech2Dataset, idx: int) -> int:
    item = dataset.items[idx]
    return int(np.load(dataset._path(item, "spec", dataset._spec_name()), mmap_mode="r").shape[1])


class HiFiGANDataset:
    """Loads (mel, waveform) pairs for vocoder training from a HiFiGAN config
    dict (``config.hifigan_training_config``): the preprocessed spec, or
    under ``finetune`` the teacher-forced ``synthesized_spec``, and the
    output-rate audio."""

    def __init__(self, filelist: list, config: dict, finetune: bool = False):
        self.config = config
        self.save_dir = Path(config["preprocessing"]["save_dir"])
        self.audio_config = config["preprocessing"]["audio"]
        self.finetune = finetune
        self.output_sr = self.audio_config["output_sampling_rate"]
        self.input_sr = self.audio_config["input_sampling_rate"]
        self.items = [it for it in filelist if self._usable(it)]
        self._cache: dict = {}
        self.max_cache_items = 2000
        self._pool: Optional[ThreadPoolExecutor] = None

    def _path(self, item: dict, folder: str, fn: str) -> Path:
        speaker = item.get("speaker") or "default"
        language = item.get("language") or "default"
        return self.save_dir / folder / FILENAME_SEP.join([item["basename"], speaker, language, fn])

    def _spec_name(self) -> str:
        return f"spec-{self.input_sr}-{self.audio_config['spec_type']}.npy"

    def _spec_folder(self) -> str:
        return "synthesized_spec" if self.finetune else "spec"

    def _usable(self, item: dict) -> bool:
        return (self._path(item, self._spec_folder(), self._spec_name()).exists()
                and self._path(item, "audio", f"audio-{self.output_sr}.wav").exists())

    def __len__(self) -> int:
        return len(self.items)

    def load_item(self, idx: int) -> dict:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        item = self.items[idx]
        spec = np.load(self._path(item, self._spec_folder(), self._spec_name()))
        audio, _ = read_wav(self._path(item, "audio", f"audio-{self.output_sr}.wav"))
        out = {
            "basename": item["basename"],
            "mel": spec.T.astype(np.float32),  # (T, M)
            "audio": audio[0].astype(np.float32),
        }
        if len(self._cache) < self.max_cache_items:
            self._cache[idx] = out
        return out

    def _load(self, idxs) -> list:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 4, 8),
                                            thread_name_prefix="hifigan-io")
        return _parallel_load(self.load_item, list(idxs), self._pool)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False) -> Iterator[dict]:
        """Whole utterances, padded to the corpus's longest spec and its
        samples (frames · hop · output/input rate)."""
        n = len(self.items)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n) if shuffle else np.arange(n)
        max_frames = max((int(np.load(self._path(it, self._spec_folder(), self._spec_name()),
                                       mmap_mode="r").shape[1]) for it in self.items), default=0)
        max_samples = max_frames * self.audio_config["fft_hop_size"] * (self.output_sr // self.input_sr)
        for bi in range(_n_batches(n, batch_size, drop_last)):
            items = self._load(order[bi * batch_size : (bi + 1) * batch_size])
            while len(items) < batch_size:
                items.append(items[-1])
            b = len(items)
            batch = {
                "mel": np.zeros((b, max_frames, items[0]["mel"].shape[1]), np.float32),
                "mel_lengths": np.zeros((b,), np.int32),
                "audio": np.zeros((b, max_samples), np.float32),
                "audio_lengths": np.zeros((b,), np.int32),
                "basenames": [it["basename"] for it in items],
            }
            for i, it in enumerate(items):
                t = min(it["mel"].shape[0], max_frames)
                s = min(len(it["audio"]), max_samples)
                batch["mel"][i, :t] = it["mel"][:t]
                batch["mel_lengths"][i] = t
                batch["audio"][i, :s] = it["audio"][:s]
                batch["audio_lengths"][i] = s
            yield batch

    def segment_batches(self, batch_size: int, segment_size: int, shuffle: bool = True,
                        seed: int = 0, drop_last: bool = False) -> Iterator[dict]:
        """One random fixed-size (mel, audio) segment an item. The generator
        ``default_rng(seed)`` draws the permutation, then one start frame an
        item in batch order (the JAX package's order, so the batches are
        bit-equal); without ``shuffle`` every segment starts at 0."""
        n = len(self.items)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n) if shuffle else np.arange(n)
        hop = self.audio_config["fft_hop_size"] * (self.output_sr // self.input_sr)
        seg_frames = segment_size // hop
        for bi in range(_n_batches(n, batch_size, drop_last)):
            items = self._load(order[bi * batch_size : (bi + 1) * batch_size])
            while len(items) < batch_size:
                items.append(items[-1])
            b = len(items)
            batch = {
                "mel": np.zeros((b, seg_frames, items[0]["mel"].shape[1]), np.float32),
                "audio": np.zeros((b, segment_size), np.float32),
                "basenames": [it["basename"] for it in items],
            }
            for i, it in enumerate(items):
                max_start = max(it["mel"].shape[0] - seg_frames, 0)
                start = int(rng.integers(0, max_start + 1)) if shuffle else 0
                mel = it["mel"][start : start + seg_frames]
                batch["mel"][i, : mel.shape[0]] = mel
                audio = it["audio"][start * hop : start * hop + segment_size]
                batch["audio"][i, : len(audio)] = audio
            yield batch

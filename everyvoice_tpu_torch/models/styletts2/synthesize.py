"""StyleTTS2 text→wav serving (counterpart of
everyvoice_tpu/models/styletts2/synthesize.py): ``load_styletts2_model``,
``load_reference_style`` and ``synthesize_text``.

One text at a time, with the JAX package's padded shapes, which the numbers
depend on (the LSTMs and AdaIN see the pads): the text is padded to a
multiple of 16 tokens, its frames are regulated to the model's
``max_frames`` (800 at full width), every text is decoded over all of
them, and the wav is cut to the text's own frames × hop.

Noise: the style diffusion starts from a standard normal draw of a
``torch.Generator`` seeded with ``seed`` (the JAX package draws it from
``PRNGKey(seed)``, so the two packages' styles differ for one seed), and the
decoder's source noise is one fixed draw of a generator seeded with 0, as
the JAX package's is one fixed ``PRNGKey(0)`` draw. Both are drawn on the
CPU, so the card and the CPU serve the same noise for a seed; ``noise``
passes both in instead.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from everyvoice_tpu_torch.config import styletts2_config
from everyvoice_tpu_torch.convert import flax_to_torch
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.models.fs2.synthesize import reference_log_mel
from everyvoice_tpu_torch.models.layers import lengths_to_mask, regulate_length
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2, sample_style_diffusion
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
from everyvoice_tpu_torch.utils.precision import no_tf32, resolve_compute_dtype

TEXT_BUCKET = 16
SOURCE_NOISE_SEED = 0


def load_styletts2_model(ckpt_path: Path | str, compute_dtype: str = "auto", device=None):
    """(model, config, text_processor, lang2id) from a StyleTTS2 checkpoint,
    the model in eval mode on ``device``, built with the PL-BERT or ASR
    geometry the checkpoint records. 'auto' is bfloat16 on a card (the
    decoder's and the style encoders' convs) and float32 on the CPU."""
    device = resolve_device(device)
    compute_dtype = resolve_compute_dtype(compute_dtype, device)
    ckpt = load_checkpoint(ckpt_path)
    if ckpt["model_info"]["name"] != "StyleTTS2Module":
        raise ValueError(f"Expected a StyleTTS2 checkpoint, got {ckpt['model_info']['name']}")
    hp = ckpt["hyper_parameters"]
    config = styletts2_config(hp["config"])
    text_processor = TextProcessor(
        config["text"], config["model"]["target_text_representation_level"])
    lang2id = hp.get("lang2id", {})
    components = ckpt.get("pretrained_components") or {}
    model = StyleTTS2.from_config(
        config, n_symbols=len(text_processor.symbols), n_langs=max(len(lang2id), 1),
        plbert_geometry=components.get("plbert"), asr_geometry=components.get("asr"),
        compute_dtype=compute_dtype,
    )
    params = ckpt["state_dict"].get("generator", ckpt["state_dict"])
    model.load_state_dict(flax_to_torch(params, model)[0])
    return model.to(device).eval(), config, text_processor, lang2id


@torch.no_grad()
@no_tf32()
def load_reference_style(model: StyleTTS2, ref_wav_path: Path | str, config: dict) -> tuple:
    """A reference wav → (acoustic, prosodic) style vectors, float32 numpy."""
    device = next(model.parameters()).device
    mel = reference_log_mel(ref_wav_path, config["preprocessing"]["audio"], device)
    acoustic, prosodic = model.extract_styles(mel)
    return acoustic[0].cpu().numpy(), prosodic[0].cpu().numpy()


def draw_noise(model: StyleTTS2, seed: int = 0) -> tuple:
    """(diffusion noise (1, 2·style_dim), source noise (1, max_frames·hop)),
    standard normal, on the CPU: the first from ``seed``, the second from
    the fixed source seed."""
    diffusion = torch.randn((1, 2 * model.style_dim),
                            generator=torch.Generator().manual_seed(seed))
    source = torch.randn((1, model.max_frames * model.hop),
                         generator=torch.Generator().manual_seed(SOURCE_NOISE_SEED))
    return diffusion, source


def encode(model: StyleTTS2, config: dict, text_processor: TextProcessor, text: str,
           language: Optional[str] = None) -> tuple:
    """(tokens (1, N), mask (1, N)) on the model's device: the text's ids
    padded with zeros to a multiple of 16."""
    level = config["model"]["target_text_representation_level"]
    ids = text_processor.encode_text(text, apply_g2p=(level != "characters"), lang_id=language,
                                     quiet=True)
    if not ids:
        raise ValueError(f"No valid symbols found in {text!r}")
    device = next(model.parameters()).device
    n_text = -(-len(ids) // TEXT_BUCKET) * TEXT_BUCKET
    tokens = torch.zeros((1, n_text), dtype=torch.long)
    tokens[0, : len(ids)] = torch.as_tensor(ids)
    tokens = tokens.to(device)
    return tokens, lengths_to_mask(torch.tensor([len(ids)], device=device), n_text)


def prosody_frames(model: StyleTTS2, tokens, mask, prosodic) -> tuple:
    """The text side after the style: the text encoding, the predicted
    durations, F0 per token, both regulated to ``max_frames``. Returns
    (frames (B, max_frames, hidden) with F0 embedded, F0 frames (B,
    max_frames), the frame counts (B,))."""
    text_enc = model.encode_text(tokens, mask)
    pros_enc = model.prosody_encoding(tokens, mask, text_enc)
    dur_logits, f0_tok, _ = model.predict_prosody(pros_enc, prosodic, mask)
    durations = torch.clamp(torch.argmax(dur_logits, dim=-1), 1, model.max_dur)
    durations = torch.where(mask, durations, torch.zeros((), dtype=durations.dtype,
                                                         device=mask.device))
    frames, _, total = regulate_length(text_enc, durations, model.max_frames)
    f0_frames = regulate_length(f0_tok[..., None], durations, model.max_frames)[0][..., 0]
    return model.frame_proj(frames) + model.f0_embed(f0_frames[..., None]), f0_frames, total


@torch.no_grad()
@no_tf32()
def synthesize_text(
    model: StyleTTS2,
    config: dict,
    text_processor: TextProcessor,
    text: str,
    language: Optional[str] = None,
    ref_styles: Optional[tuple] = None,
    diffusion_steps: int = 5,
    embedding_scale: float = 1.0,
    acoustic_blend: float = 0.5,
    prosody_blend: float = 0.5,
    seed: int = 0,
    noise: Optional[tuple] = None,
) -> np.ndarray:
    """Text → float32 wav of the text's frames × hop samples. The style
    comes from diffusion sampling, blended with ``ref_styles`` (from
    ``load_reference_style``) where given: blend 1 is all sampled, 0 all
    reference. ``noise`` is (diffusion, source) as ``draw_noise`` gives
    them; by default ``draw_noise(model, seed)``."""
    tokens, mask = encode(model, config, text_processor, text, language)
    device = tokens.device
    diffusion_noise, source_noise = noise if noise is not None else draw_noise(model, seed)
    text_emb = model.text_context_embedding(tokens, mask)
    joint = sample_style_diffusion(
        model.denoise_style, diffusion_noise.to(device), text_emb, steps=int(diffusion_steps),
        embedding_scale=float(embedding_scale))
    acoustic, prosodic = joint[:, : model.style_dim], joint[:, model.style_dim :]
    if ref_styles is not None:
        ref_acoustic, ref_prosodic = (torch.tensor(np.array(s), device=device)[None]
                                      for s in ref_styles)
        acoustic = acoustic_blend * acoustic + (1 - acoustic_blend) * ref_acoustic
        prosodic = prosody_blend * prosodic + (1 - prosody_blend) * ref_prosodic
    frames, f0_frames, total = prosody_frames(model, tokens, mask, prosodic)
    wav = model.decode(frames, f0_frames, acoustic, source_noise.to(device))
    n_frames = max(int(total[0]), 1)
    return wav[0, : n_frames * model.hop].float().cpu().numpy()

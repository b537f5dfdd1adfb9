"""FastSpeech2 inference forward in PyTorch (counterpart of
everyvoice_tpu/models/fs2/model.py).

Serving runs the forward without a target mel: Conformer encoder →
(speaker/language embeddings) → duration, pitch and energy predictors →
length regulation to ``max_frames`` → Conformer decoder → mel head →
postnet. Durations come from the duration head unless ``teacher_forcing``
supplies them. The learned-alignment encoder is used only in training with a
mel, so a checkpoint's ``alignment`` subtree is not loaded here. Global style
tokens and phonological-feature input are a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from everyvoice_tpu_torch.models.layers import (
    ConformerStack,
    Postnet,
    VariancePredictor,
    lengths_to_mask,
    regulate_length,
)
from everyvoice_tpu_torch.utils.precision import no_tf32, torch_dtype


class FastSpeech2(nn.Module):
    def __init__(
        self,
        n_symbols: int,
        dim: int = 256,
        enc_layers: int = 4,
        enc_heads: int = 2,
        enc_ff_dim: int = 1024,
        enc_kernel: int = 9,
        dec_layers: int = 4,
        dec_heads: int = 2,
        dec_ff_dim: int = 1024,
        dec_kernel: int = 9,
        vp_layers: int = 5,
        vp_kernel: int = 3,
        vp_depthwise: bool = True,
        n_bins: int = 256,
        pitch_level: str = "phone",
        energy_level: str = "phone",
        n_mels: int = 80,
        use_postnet: bool = True,
        multispeaker: bool = False,
        multilingual: bool = False,
        n_speakers: int = 1,
        n_langs: int = 1,
        max_frames: int = 1000,
        variance_range: float = 6.0,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = torch_dtype(compute_dtype)
        self.dim = dim
        self.n_bins = n_bins
        self.pitch_level = pitch_level
        self.energy_level = energy_level
        self.max_frames = max_frames
        self.variance_range = variance_range
        self.symbol_embed = nn.Embedding(n_symbols, dim)
        self.encoder = ConformerStack(enc_layers, dim, enc_heads, enc_ff_dim, enc_kernel, dt)
        self.speaker_embed = nn.Embedding(n_speakers, dim) if multispeaker else None
        self.language_embed = nn.Embedding(n_langs, dim) if multilingual else None

        def predictor():
            return VariancePredictor(vp_layers, vp_kernel, dim, dim, vp_depthwise, dt)

        self.duration_predictor = predictor()
        self.pitch_predictor = predictor()
        self.pitch_embed = nn.Embedding(n_bins, dim)
        self.energy_predictor = predictor()
        self.energy_embed = nn.Embedding(n_bins, dim)
        self.decoder = ConformerStack(dec_layers, dim, dec_heads, dec_ff_dim, dec_kernel, dt)
        self.mel_head = nn.Linear(dim, n_mels)
        self.postnet = Postnet(n_mels, dtype=dt) if use_postnet else None

    @classmethod
    def from_config(cls, config: dict, n_symbols: int, n_speakers: int = 1,
                    n_langs: int = 1, compute_dtype: str = "float32") -> "FastSpeech2":
        """Build from a FastSpeech2 config dict (defaults filled in by
        ``everyvoice_tpu_torch.config.fs2_config``)."""
        m = config["model"]
        if m["target_text_representation_level"] == "phonological_features":
            raise NotImplementedError(
                "phonological-feature input is not ported yet; it comes with "
                "the port's text front-end slice"
            )
        if m["use_global_style_token_module"]:
            raise NotImplementedError(
                "global style tokens (GST) are not ported yet; they come with "
                "the port's style-reference slice"
            )
        enc, dec = m["encoder"], m["decoder"]
        vp = m["variance_predictors"]
        return cls(
            n_symbols=n_symbols,
            dim=enc["input_dim"], enc_layers=enc["layers"], enc_heads=enc["heads"],
            enc_ff_dim=enc["feedforward_dim"], enc_kernel=enc["conv_kernel_size"],
            dec_layers=dec["layers"], dec_heads=dec["heads"],
            dec_ff_dim=dec["feedforward_dim"], dec_kernel=dec["conv_kernel_size"],
            vp_layers=vp["pitch"]["n_layers"], vp_kernel=vp["pitch"]["kernel_size"],
            vp_depthwise=vp["pitch"]["depthwise"], n_bins=vp["pitch"]["n_bins"],
            pitch_level=vp["pitch"]["level"], energy_level=vp["energy"]["level"],
            n_mels=config["preprocessing"]["audio"]["n_mels"],
            use_postnet=m["use_postnet"],
            multispeaker=m["multispeaker"], multilingual=m["multilingual"],
            n_speakers=max(n_speakers, 1), n_langs=max(n_langs, 1),
            max_frames=m["max_length"],
            compute_dtype=compute_dtype,
        )

    def _bin_embed(self, values, mask, embed: nn.Embedding):
        """Quantize z-scored values into uniform bins (one affine + clip, as
        the JAX package does) and embed them."""
        half = self.variance_range
        scale = (self.n_bins - 1) / (2.0 * half)
        ids = torch.clamp(torch.floor((values + half) * scale + 0.5), 0, self.n_bins - 1)
        emb = embed(ids.long())
        return torch.where(mask[..., None], emb, torch.zeros((), device=emb.device))

    @no_tf32()
    def forward(
        self,
        text: torch.Tensor,                       # (B, N) int ids
        text_lengths: torch.Tensor,               # (B,)
        durations: Optional[torch.Tensor] = None,  # (B, N), with teacher_forcing
        speaker_id: Optional[torch.Tensor] = None,
        language_id: Optional[torch.Tensor] = None,
        duration_control: float = 1.0,
        teacher_forcing: bool = False,
    ) -> dict:
        n_text = text.shape[1]
        src_mask = lengths_to_mask(text_lengths, n_text)
        zero = torch.zeros((), device=text.device)

        x = torch.where(src_mask[..., None], self.symbol_embed(text.long()), zero)
        x = self.encoder(x, src_mask)
        if self.speaker_embed is not None:
            sid = speaker_id if speaker_id is not None else torch.zeros_like(text_lengths)
            x = x + self.speaker_embed(sid.long())[:, None, :]
        if self.language_embed is not None:
            lid = language_id if language_id is not None else torch.zeros_like(text_lengths)
            x = x + self.language_embed(lid.long())[:, None, :]
        x = torch.where(src_mask[..., None], x, zero)
        out: dict = {"encoder_output": x, "src_mask": src_mask}

        log_duration = self.duration_predictor(x, src_mask)
        out["log_duration_prediction"] = log_duration
        if durations is not None and teacher_forcing:
            dur = durations
        else:
            # Round half to even, as jnp.round does.
            dur = torch.round(
                torch.clamp(torch.expm1(log_duration), min=0.0) * duration_control
            ).to(torch.int32)
            dur = torch.where(src_mask, dur, torch.zeros_like(dur))
        out["duration_used"] = dur

        pitch_pred = energy_pred = None
        if self.pitch_level == "phone":
            pitch_pred = self.pitch_predictor(x, src_mask)
            x = x + self._bin_embed(pitch_pred, src_mask, self.pitch_embed)
        if self.energy_level == "phone":
            energy_pred = self.energy_predictor(x, src_mask)
            x = x + self._bin_embed(energy_pred, src_mask, self.energy_embed)

        frames, frame_mask, total = regulate_length(x, dur, self.max_frames)
        out["frame_mask"] = frame_mask
        out["predicted_frame_lengths"] = total
        if self.pitch_level == "frame":
            pitch_pred = self.pitch_predictor(frames, frame_mask)
            frames = frames + self._bin_embed(pitch_pred, frame_mask, self.pitch_embed)
        if self.energy_level == "frame":
            energy_pred = self.energy_predictor(frames, frame_mask)
            frames = frames + self._bin_embed(energy_pred, frame_mask, self.energy_embed)
        out["pitch_prediction"] = pitch_pred
        out["energy_prediction"] = energy_pred

        dec = self.decoder(frames, frame_mask)
        mel = torch.where(frame_mask[..., None], self.mel_head(dec), zero)
        out["mel"] = mel
        if self.postnet is not None:
            out["postnet_mel"] = self.postnet(mel, frame_mask)
        return out

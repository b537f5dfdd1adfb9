"""FastSpeech2 forward in PyTorch, for serving and training (counterpart of
everyvoice_tpu/models/fs2/model.py).

Serving runs the forward without a target mel: Conformer encoder →
(speaker/language embeddings) → duration, pitch and energy predictors →
length regulation to ``max_frames`` → Conformer decoder → mel head →
postnet. Durations come from the duration head unless ``teacher_forcing``
supplies them.

Training passes the target ``mel`` and ``mel_lengths``. With
``learn_alignment`` the alignment encoder (float32 under any compute dtype)
attends from the mel to the text; without given durations its Viterbi path,
with no gradient, gives the durations used and their targets. Pitch and
energy targets are averaged into phones (by the hard alignment, else by the
durations) at phone level, and embed in place of the predictions; the frame
mask comes from ``mel_lengths``. Dropout acts in training mode only.

With ``target_text_representation_level: phonological_features`` the text
is a (B, N, 43) float tensor projected by ``pfs_proj`` in place of the
symbol embedding. With ``use_global_style_token_module`` the GST module
conditions the encoder output on ``style_reference``, else on the target
``mel``, and is skipped when neither is given, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from everyvoice_tpu_torch.models.fs2.alignment import (
    AlignmentEncoder,
    durations_from_hard_attention,
    phone_average,
    phone_average_by_durations,
    viterbi_alignment,
)
from everyvoice_tpu_torch.models.layers import (
    ConformerStack,
    GlobalStyleTokens,
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
        enc_dropout: float = 0.2,
        dec_layers: int = 4,
        dec_heads: int = 2,
        dec_ff_dim: int = 1024,
        dec_kernel: int = 9,
        dec_dropout: float = 0.2,
        vp_layers: int = 5,
        vp_kernel: int = 3,
        vp_dropout: float = 0.5,
        vp_depthwise: bool = True,
        n_bins: int = 256,
        pitch_level: str = "phone",
        energy_level: str = "phone",
        n_mels: int = 80,
        use_postnet: bool = True,
        learn_alignment: bool = True,
        multispeaker: bool = False,
        multilingual: bool = False,
        n_speakers: int = 1,
        n_langs: int = 1,
        max_frames: int = 1000,
        variance_range: float = 6.0,
        compute_dtype: str = "float32",
        use_phonological_feats: bool = False,
        pfs_dim: int = 43,
        use_gst: bool = False,
    ):
        super().__init__()
        dt = torch_dtype(compute_dtype)
        self.dim = dim
        self.n_bins = n_bins
        self.pitch_level = pitch_level
        self.energy_level = energy_level
        self.max_frames = max_frames
        self.variance_range = variance_range
        self.symbol_embed = None if use_phonological_feats else nn.Embedding(n_symbols, dim)
        self.pfs_proj = nn.Linear(pfs_dim, dim) if use_phonological_feats else None
        self.encoder = ConformerStack(enc_layers, dim, enc_heads, enc_ff_dim, enc_kernel, dt,
                                      enc_dropout)
        self.speaker_embed = nn.Embedding(n_speakers, dim) if multispeaker else None
        self.language_embed = nn.Embedding(n_langs, dim) if multilingual else None
        self.gst = GlobalStyleTokens(n_mels, token_dim=dim, dtype=dt) if use_gst else None
        self.alignment = AlignmentEncoder(dim, n_mels) if learn_alignment else None

        def predictor():
            return VariancePredictor(vp_layers, vp_kernel, dim, dim, vp_depthwise, dt, vp_dropout)

        self.duration_predictor = predictor()
        self.pitch_predictor = predictor()
        self.pitch_embed = nn.Embedding(n_bins, dim)
        self.energy_predictor = predictor()
        self.energy_embed = nn.Embedding(n_bins, dim)
        self.decoder = ConformerStack(dec_layers, dim, dec_heads, dec_ff_dim, dec_kernel, dt,
                                      dec_dropout)
        self.mel_head = nn.Linear(dim, n_mels)
        self.postnet = Postnet(n_mels, dtype=dt) if use_postnet else None

    @classmethod
    def from_config(cls, config: dict, n_symbols: int, n_speakers: int = 1,
                    n_langs: int = 1, compute_dtype: str = "float32") -> "FastSpeech2":
        """Build from a FastSpeech2 config dict (defaults filled in by
        ``everyvoice_tpu_torch.config.fs2_config``)."""
        m = config["model"]
        enc, dec = m["encoder"], m["decoder"]
        vp = m["variance_predictors"]
        return cls(
            n_symbols=n_symbols,
            dim=enc["input_dim"], enc_layers=enc["layers"], enc_heads=enc["heads"],
            enc_ff_dim=enc["feedforward_dim"], enc_kernel=enc["conv_kernel_size"],
            enc_dropout=enc["dropout"],
            dec_layers=dec["layers"], dec_heads=dec["heads"],
            dec_ff_dim=dec["feedforward_dim"], dec_kernel=dec["conv_kernel_size"],
            dec_dropout=dec["dropout"],
            vp_layers=vp["pitch"]["n_layers"], vp_kernel=vp["pitch"]["kernel_size"],
            vp_dropout=vp["pitch"]["dropout"], vp_depthwise=vp["pitch"]["depthwise"],
            n_bins=vp["pitch"]["n_bins"],
            pitch_level=vp["pitch"]["level"], energy_level=vp["energy"]["level"],
            n_mels=config["preprocessing"]["audio"]["n_mels"],
            use_postnet=m["use_postnet"],
            learn_alignment=m["learn_alignment"],
            multispeaker=m["multispeaker"], multilingual=m["multilingual"],
            n_speakers=max(n_speakers, 1), n_langs=max(n_langs, 1),
            max_frames=m["max_length"],
            compute_dtype=compute_dtype,
            use_phonological_feats=m["target_text_representation_level"] == "phonological_features",
            use_gst=m["use_global_style_token_module"],
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
        text: torch.Tensor,                          # (B, N) int ids or (B, N, 43) pfs
        text_lengths: torch.Tensor,                  # (B,)
        mel: Optional[torch.Tensor] = None,          # (B, T, n_mels) target
        mel_lengths: Optional[torch.Tensor] = None,  # (B,)
        attn_prior: Optional[torch.Tensor] = None,   # (B, T, N)
        durations: Optional[torch.Tensor] = None,    # (B, N)
        pitch: Optional[torch.Tensor] = None,        # (B, T) or (B, N) targets
        energy: Optional[torch.Tensor] = None,
        speaker_id: Optional[torch.Tensor] = None,
        language_id: Optional[torch.Tensor] = None,
        style_reference: Optional[torch.Tensor] = None,  # (B, T, n_mels) for GST
        duration_control: float = 1.0,
        teacher_forcing: bool = False,
    ) -> dict:
        n_text = text.shape[1]
        src_mask = lengths_to_mask(text_lengths, n_text)
        zero = torch.zeros((), device=text.device)

        if self.pfs_proj is not None:
            emb = self.pfs_proj(text.float())
        else:
            emb = self.symbol_embed(text.long())
        x = torch.where(src_mask[..., None], emb, zero)
        x = self.encoder(x, src_mask)
        if self.speaker_embed is not None:
            sid = speaker_id if speaker_id is not None else torch.zeros_like(text_lengths)
            x = x + self.speaker_embed(sid.long())[:, None, :]
        if self.language_embed is not None:
            lid = language_id if language_id is not None else torch.zeros_like(text_lengths)
            x = x + self.language_embed(lid.long())[:, None, :]
        if self.gst is not None:
            ref = style_reference if style_reference is not None else mel
            if ref is not None:
                x = x + self.gst(ref)[:, None, :]
        x = torch.where(src_mask[..., None], x, zero)
        out: dict = {"encoder_output": x, "src_mask": src_mask}

        training_with_mel = mel is not None and mel_lengths is not None
        if self.alignment is not None and training_with_mel:
            attn_soft, attn_logprob = self.alignment(
                x, mel, src_mask, lengths_to_mask(mel_lengths, mel.shape[1]), attn_prior
            )
            out["attn_soft"] = attn_soft
            out["attn_logprob"] = attn_logprob
            if durations is None:
                attn_hard = viterbi_alignment(attn_logprob.detach(), text_lengths, mel_lengths)
                out["attn_hard"] = attn_hard
                durations = durations_from_hard_attention(attn_hard)
                out["duration_target"] = durations

        log_duration = self.duration_predictor(x, src_mask)
        out["log_duration_prediction"] = log_duration
        if durations is not None and (training_with_mel or teacher_forcing):
            dur = durations
        else:
            # Round half to even, as jnp.round does.
            dur = torch.round(
                torch.clamp(torch.expm1(log_duration), min=0.0) * duration_control
            ).to(torch.int32)
            dur = torch.where(src_mask, dur, torch.zeros_like(dur))
        out["duration_used"] = dur

        def to_phone_level(values):
            if values is None or values.shape[1] == n_text:
                return values
            if "attn_hard" in out:
                return phone_average(values, out["attn_hard"])
            return phone_average_by_durations(values, dur)

        def add_variance(feat, targets, mask, predictor, embed):
            pred = predictor(feat, mask)
            use = targets if (targets is not None and training_with_mel) else pred
            return pred, self._bin_embed(use, mask, embed)

        pitch_pred = energy_pred = None
        if self.pitch_level == "phone":
            pitch = to_phone_level(pitch)
            pitch_pred, emb = add_variance(x, pitch, src_mask, self.pitch_predictor, self.pitch_embed)
            out["pitch_target_used"] = pitch
            x = x + emb
        if self.energy_level == "phone":
            energy = to_phone_level(energy)
            energy_pred, emb = add_variance(x, energy, src_mask, self.energy_predictor,
                                            self.energy_embed)
            out["energy_target_used"] = energy
            x = x + emb

        frames, frame_mask, total = regulate_length(x, dur, self.max_frames)
        if training_with_mel:
            frame_mask = lengths_to_mask(mel_lengths, self.max_frames)
        out["frame_mask"] = frame_mask
        out["predicted_frame_lengths"] = total
        if self.pitch_level == "frame":
            pitch_pred, emb = add_variance(frames, pitch, frame_mask, self.pitch_predictor,
                                           self.pitch_embed)
            out["pitch_target_used"] = pitch
            frames = frames + emb
        if self.energy_level == "frame":
            energy_pred, emb = add_variance(frames, energy, frame_mask, self.energy_predictor,
                                            self.energy_embed)
            out["energy_target_used"] = energy
            frames = frames + emb
        out["pitch_prediction"] = pitch_pred
        out["energy_prediction"] = energy_pred

        dec = self.decoder(frames, frame_mask)
        mel_out = torch.where(frame_mask[..., None], self.mel_head(dec), zero)
        out["mel"] = mel_out
        if self.postnet is not None:
            out["postnet_mel"] = self.postnet(mel_out, frame_mask)
        return out

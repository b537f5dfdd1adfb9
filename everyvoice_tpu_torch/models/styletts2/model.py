"""StyleTTS2's generator stack for serving, in PyTorch (counterpart of
everyvoice_tpu/models/styletts2/model.py's ``StyleTTS2Module``, its
inference methods, and ``sample_style_diffusion``).

The module holds every submodule a checkpoint of the JAX package holds, so
its parameters load and write back unchanged: the text encoder; PL-BERT and
its projection when the checkpoint records a ``plbert`` geometry, else the
conv-and-BiLSTM context encoder standing in for it; the TMA aligner: the
pretrained ASR aligner (``asr.py``'s ``ASRCNN``, as ``text_aligner``) where
the checkpoint records an ``asr`` geometry, else the FastSpeech2 alignment
encoder; both style encoders; the prosody predictor; the decoder; the
denoiser; ``frame_proj`` and ``f0_embed``; and the language embedding of a
multilingual model.

As in the JAX package, ``from_config`` gives the decoder none of the
config's ``upsample_initial_channel``, ``resblock_kernel_sizes`` or
``resblock_dilation_sizes``: its stack is always 512 channels with kernels
3/7/11 and dilations 1/3/5, the shape every checkpoint has.

``forward`` is the training forward (the JAX module's ``__call__`` with
teacher durations and F0, or the predicted ones where none are given):
the TMA attention over the reference mel, the prosody prediction, frames
regulated to ``max_frames``, and the decode of one clip of
``segment_frames`` an utterance where the caller gives the clips' starts.
``align_text_mel`` is the aligner alone; with the ASR aligner it also
returns the decoder's logits, for the seq2seq loss. Dropout acts in
training mode; the caller draws the decoder's source noise and the ASR
decoder's masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from everyvoice_tpu_torch.models.fs2.alignment import AlignmentEncoder
from everyvoice_tpu_torch.models.layers import lengths_to_mask, regulate_length
from everyvoice_tpu_torch.models.styletts2.asr import ASRCNN, asr_attention_to_tma
from everyvoice_tpu_torch.models.styletts2.jdc import REFERENCE_MEL_MEAN, REFERENCE_MEL_STD
from everyvoice_tpu_torch.models.styletts2.layers import (
    DiffusionDenoiser,
    ProsodyPredictor,
    StyleDecoder,
    StyleEncoder,
    TextEncoder,
)
from everyvoice_tpu_torch.models.styletts2.plbert import PLBERT
from everyvoice_tpu_torch.utils.precision import torch_dtype


class StyleTTS2(nn.Module):
    def __init__(
        self,
        n_symbols: int,
        hidden_dim: int = 512,
        style_dim: int = 128,
        max_dur: int = 50,
        max_frames: int = 800,
        segment_frames: Optional[int] = None,
        n_mels: int = 80,
        sample_rate: int = 22050,
        hop: int = 256,
        multilingual: bool = False,
        n_langs: int = 1,
        language_embedding_dim: int = 64,
        upsample_rates=(8, 8),
        upsample_kernel_sizes=(16, 16),
        gen_istft_n_fft: int = 16,
        gen_istft_hop_size: int = 4,
        diff_layers: int = 3,
        diff_heads: int = 8,
        diff_head_features: int = 64,
        plbert_geometry: Optional[dict] = None,
        asr_geometry: Optional[dict] = None,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = torch_dtype(compute_dtype)
        self.style_dim = style_dim
        self.max_dur = max_dur
        self.max_frames = max_frames
        self.segment_frames = segment_frames
        self.hop = hop
        self.plbert_geometry = dict(plbert_geometry) if plbert_geometry else None
        self.asr_geometry = dict(asr_geometry) if asr_geometry else None
        self.text_encoder = TextEncoder(n_symbols, hidden_dim)
        if self.plbert_geometry is not None:
            self.plbert_encoder = PLBERT(**self.plbert_geometry)
            self.plbert_proj = nn.Linear(self.plbert_geometry["hidden_size"], hidden_dim)
        else:
            self.context_encoder = TextEncoder(n_symbols, hidden_dim, n_convs=2)
        if self.asr_geometry is None:
            self.tma_aligner = AlignmentEncoder(dim=hidden_dim // 2, n_mels=n_mels,
                                                text_dim=hidden_dim)
        else:
            self.text_aligner = ASRCNN(**self.asr_geometry)
        self.acoustic_style_encoder = StyleEncoder(style_dim, dtype=dt)
        self.prosodic_style_encoder = StyleEncoder(style_dim, dtype=dt)
        self.predictor = ProsodyPredictor(style_dim, hidden_dim, max_dur)
        self.decoder = StyleDecoder(
            hidden_dim, upsample_rates=upsample_rates,
            upsample_kernel_sizes=upsample_kernel_sizes, gen_istft_n_fft=gen_istft_n_fft,
            gen_istft_hop_size=gen_istft_hop_size, style_dim=style_dim,
            sample_rate=sample_rate, hop=hop, dtype=dt,
        )
        self.denoiser = DiffusionDenoiser(2 * style_dim, hidden_dim, diff_layers, diff_heads,
                                          diff_head_features)
        self.frame_proj = nn.Linear(hidden_dim, hidden_dim)
        self.f0_embed = nn.Linear(1, hidden_dim)
        self.multilingual = multilingual
        if multilingual:
            self.language_embed = nn.Embedding(n_langs, language_embedding_dim)
            self.language_proj = nn.Linear(language_embedding_dim, hidden_dim)

    @classmethod
    def from_config(cls, config: dict, n_symbols: int, n_langs: int = 1,
                    plbert_geometry: Optional[dict] = None, asr_geometry: Optional[dict] = None,
                    compute_dtype: str = "float32") -> "StyleTTS2":
        """From a config filled by ``config.styletts2_config``."""
        m = config["model"]
        audio = config["preprocessing"]["audio"]
        t = config["training"]
        # Decoder clips in training, unless they would cover max_len.
        segment = t["decoder_segment_frames"]
        return cls(
            n_symbols=n_symbols,
            hidden_dim=m["hidden_dim"],
            style_dim=m["style_dim"],
            max_dur=m["max_dur"],
            max_frames=t["max_len"],
            segment_frames=segment if (segment or 0) < t["max_len"] else None,
            n_mels=audio["n_mels"],
            sample_rate=audio["output_sampling_rate"],
            hop=audio["fft_hop_size"],
            multilingual=m["multilingual"],
            n_langs=max(n_langs, 1),
            language_embedding_dim=m["language_embedding_dim"],
            upsample_rates=tuple(m["decoder"]["upsample_rates"]),
            upsample_kernel_sizes=tuple(m["decoder"]["upsample_kernel_sizes"]),
            gen_istft_n_fft=m["decoder"]["gen_istft_n_fft"],
            gen_istft_hop_size=m["decoder"]["gen_istft_hop_size"],
            diff_layers=m["diffusion"]["transformer"]["num_layers"],
            diff_heads=m["diffusion"]["transformer"]["num_heads"],
            diff_head_features=m["diffusion"]["transformer"]["head_features"],
            plbert_geometry=plbert_geometry,
            asr_geometry=asr_geometry,
            compute_dtype=compute_dtype,
        )

    # -- the pieces serving runs ---------------------------------------------
    def encode_text(self, tokens, mask, language_id=None):
        """The acoustic text encoding, plus a multilingual model's language
        embedding where ``language_id`` is given. The JAX serving pipeline
        passes none, so serving adds no language embedding; training adds
        it where its batch carries language ids."""
        enc = self.text_encoder(tokens, mask)
        if self.multilingual and language_id is not None:
            enc = enc + self.language_proj(self.language_embed(language_id))[:, None, :]
        return enc

    def extract_styles(self, ref_mel):
        return self.acoustic_style_encoder(ref_mel), self.prosodic_style_encoder(ref_mel)

    def text_context_states(self, tokens, mask):
        """(B, N, hidden): PL-BERT projected, or its conv stand-in."""
        if self.plbert_geometry is not None:
            return self.plbert_proj(self.plbert_encoder(tokens, mask))
        return self.context_encoder(tokens, mask)

    def text_context_embedding(self, tokens, mask):
        ctx = self.text_context_states(tokens, mask)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        return (ctx * mask[..., None]).sum(dim=1) / denom

    def prosody_encoding(self, tokens, mask, text_enc):
        """The prosody predictor's input: PL-BERT's projected states when
        the model has PL-BERT, else the acoustic text encoding."""
        if self.plbert_geometry is not None:
            return self.text_context_states(tokens, mask)
        return text_enc

    def denoise_style(self, noisy, sigma, text_embedding):
        return self.denoiser(noisy, sigma, text_embedding)

    def predict_prosody(self, text_enc, prosodic_style, mask):
        return self.predictor(text_enc, prosodic_style, mask)

    def decode(self, frames, f0_frames, acoustic_style, noise):
        """Frames (B, T, hidden) and F0 (B, T) → wav (B, T·hop); ``noise``
        is the source's (B, T·hop) standard normal draw. The JAX decoder's
        energy argument is unused there, so it is absent here."""
        return self.decoder(frames, f0_frames, acoustic_style, noise)

    # -- training ----------------------------------------------------------
    def align_text_mel(self, tokens, text_lengths, mel, mel_lengths, language_id=None,
                       asr_draws=None):
        """The TMA attention between the text and the mel: (attn_soft,
        attn_logprob, aux), the first two (B, T_mel, N_text). With the ASR
        aligner, on the mel renormalised as the JDC's input is, aux holds
        its decoder's ``s2s_logits`` (B, N+1, n_token) and ``asr_draws``
        are its training masks (None: deterministic); with the stand-in,
        aux is empty."""
        mask = lengths_to_mask(text_lengths, tokens.shape[1])
        mel_mask = lengths_to_mask(mel_lengths, mel.shape[1])
        if self.asr_geometry is not None:
            normalized = (mel - REFERENCE_MEL_MEAN) / REFERENCE_MEL_STD
            _, s2s_logits, attn = self.text_aligner(normalized, mel_lengths, tokens, asr_draws)
            soft, logprob = asr_attention_to_tma(attn, mel.shape[1], mask, mel_mask)
            return soft, logprob, {"s2s_logits": s2s_logits}
        soft, logprob = self.tma_aligner(self.encode_text(tokens, mask, language_id), mel, mask,
                                         mel_mask)
        return soft, logprob, {}

    def forward(self, tokens, text_lengths, ref_mel, mel_lengths, durations, f0_frames,
                noise, segment_starts=None, language_id=None) -> dict:
        """The training forward: the text side and the TMA attention over
        the reference mel at full length, then the frames (and F0)
        regulated to ``max_frames`` and, where ``segment_starts`` (B,) is
        given and the model has ``segment_frames``, one clip an utterance
        decoded; the whole ``max_frames`` otherwise. ``durations`` and
        ``f0_frames`` are the teacher's, or None for the predicted ones
        (the argmax duration in [1, max_dur], the token F0 regulated), as
        the out-of-domain decode of SLM training uses. ``noise`` is the
        decoder source's standard normal draw, (B, decoded frames · hop).
        The JAX module's energy frames reach nothing the decoder reads, so
        there is no such argument here. With the ASR aligner, whose
        attention this forward's callers never read (the trainer aligns
        with ``align_text_mel``), no attention is computed and
        ``attn_soft``/``attn_logprob`` are None."""
        mask = lengths_to_mask(text_lengths, tokens.shape[1])
        text_enc = self.encode_text(tokens, mask, language_id)
        acoustic_style, prosodic_style = self.extract_styles(ref_mel)
        attn_soft = attn_logprob = None
        if self.asr_geometry is None:
            attn_soft, attn_logprob = self.tma_aligner(
                text_enc, ref_mel, mask, lengths_to_mask(mel_lengths, ref_mel.shape[1]))
        dur_logits, f0_pred, energy_pred = self.predict_prosody(
            self.prosody_encoding(tokens, mask, text_enc), prosodic_style, mask)
        if durations is None:
            durations = torch.clamp(torch.argmax(dur_logits, dim=-1), 1, self.max_dur) * mask
        if f0_frames is None:
            f0_frames = regulate_length(f0_pred[..., None], durations, self.max_frames)[0][..., 0]
        frames, frame_mask, total = regulate_length(text_enc, durations, self.max_frames)
        frames = self.frame_proj(frames) + self.f0_embed(f0_frames[..., None])
        if segment_starts is not None and self.segment_frames is not None:
            seg = self.segment_frames
            starts = torch.clamp(segment_starts.long(), 0, self.max_frames - seg)
            index = starts[:, None] + torch.arange(seg, device=starts.device)
            frames = torch.gather(frames, 1, index[..., None].expand(-1, -1, frames.shape[-1]))
            f0_frames = torch.gather(f0_frames, 1, index)
        return {
            "text_encoding": text_enc, "acoustic_style": acoustic_style,
            "prosodic_style": prosodic_style, "attn_soft": attn_soft,
            "attn_logprob": attn_logprob,
            "text_embedding": self.text_context_embedding(tokens, mask),
            "duration_logits": dur_logits, "f0_prediction": f0_pred,
            "energy_prediction": energy_pred,
            "wav": self.decode(frames, f0_frames, acoustic_style, noise),
            "frame_mask": frame_mask, "frame_lengths": total, "duration_used": durations,
        }


def sample_style_diffusion(denoiser, noise: torch.Tensor, text_embedding: torch.Tensor,
                           steps: int = 5, embedding_scale: float = 1.0,
                           sigma_min: float = 0.002, sigma_max: float = 3.0,
                           rho: float = 9.0) -> torch.Tensor:
    """Euler steps down the Karras schedule from ``noise`` (a (B, D)
    standard normal draw) × σ_max to a style conditioned on the text
    embedding. With ``embedding_scale`` ≠ 1 the denoiser also runs on a
    zero embedding each step and the two are mixed (classifier-free
    guidance)."""
    idx = torch.arange(steps, device=noise.device, dtype=torch.float32)
    sigmas = (sigma_max ** (1 / rho) + idx / max(steps - 1, 1)
              * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho  # Karras, float32
    b = text_embedding.shape[0]
    x = noise * sigmas[0]
    null_embedding = torch.zeros_like(text_embedding)
    for i in range(steps):
        sigma = sigmas[i].expand(b)
        denoised = denoiser(x, sigma, text_embedding)
        if embedding_scale != 1.0:
            denoised_null = denoiser(x, sigma, null_embedding)
            denoised = denoised_null + embedding_scale * (denoised - denoised_null)
        sigma_next = sigmas[i + 1] if i + 1 < steps else torch.zeros((), device=noise.device)
        d = (x - denoised) / torch.clamp(sigmas[i], min=1e-8)
        x = x + d * (sigma_next - sigmas[i])
    return x

"""StyleTTS2's training objectives (counterpart of
everyvoice_tpu/models/styletts2/loss.py): the stage-1 reconstruction and
prosody losses, the ASR seq2seq TMA loss, and the stage-2 style diffusion
(EDM) and style reconstruction losses. The schema's weights (λ mel 5 /
gen 1 / mono 1 / s2s 1 / F0 1 / norm 1 / dur 1 / ce 20 / sty 1 / diff 1)
are the trainer's.

Every draw is the caller's: ``diffusion_edm_loss`` takes the log-σ draw and
the noise, so a test can hand it the JAX package's."""

from __future__ import annotations

import torch

from everyvoice_tpu_torch.parallel.collectives import mean_denominator

# The JAX package draws the EDM loss's log σ as N(-3, 1), hard-coded
# (loss.py:66), whatever the config's ``diffusion.dist`` says.
LOG_SIGMA_MEAN = -3.0
LOG_SIGMA_STD = 1.0


def _masked_mean(per: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the mask's true entries, their count the global batch's
    inside ``parallel.data_parallel``."""
    mask = mask.to(per.dtype)
    return torch.sum(per * mask) / mean_denominator(torch.sum(mask))


def mel_reconstruction_loss(wav_fake, wav_real, mel_fn, compress_fn):
    return torch.mean(torch.abs(compress_fn(mel_fn(wav_fake)) - compress_fn(mel_fn(wav_real))))


def duration_ce_loss(dur_logits, dur_targets, mask, max_dur: int):
    """Cross-entropy over quantized durations, the targets clipped to
    ``max_dur - 1`` (λ_ce 20)."""
    targets = torch.clamp(dur_targets.long(), 0, max_dur - 1)
    logp = torch.log_softmax(dur_logits, dim=-1)
    picked = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -_masked_mean(picked, mask)


def duration_l1_loss(dur_logits, dur_targets, mask):
    """L1 of the expected duration under the softmax (λ_dur 1)."""
    probs = torch.softmax(dur_logits, dim=-1)
    support = torch.arange(dur_logits.shape[-1], dtype=probs.dtype, device=probs.device)
    expected = torch.sum(probs * support, dim=-1)
    return _masked_mean(torch.abs(expected - dur_targets.to(probs.dtype)), mask)


def f0_loss(f0_pred, f0_target, mask):
    return _masked_mean(torch.abs(f0_pred - f0_target), mask)


def norm_loss(energy_pred, energy_target, mask):
    return _masked_mean(torch.abs(energy_pred - energy_target), mask)


def asr_s2s_loss(s2s_logits, text, mask):
    """Cross-entropy of a pretrained ASR decoder's text predictions under
    teacher forcing: step i of its N+1 predicts token i, and the last
    step's EOS goes unsupervised."""
    logp = torch.log_softmax(s2s_logits[:, :-1], dim=-1)
    picked = torch.gather(logp, -1, text.long()[..., None])[..., 0]
    return -_masked_mean(picked, mask)


def style_reconstruction_loss(style_pred, style_target):
    """λ_sty: L1 between the denoised and the encoded styles."""
    return torch.mean(torch.abs(style_pred - style_target))


def diffusion_edm_loss(denoiser, log_sigma_draw, noise, clean_style, text_embedding,
                       sigma_data: float = 0.2):
    """The EDM denoising loss on style vectors (λ_diff): σ = exp(−3 +
    ``log_sigma_draw``) with ``log_sigma_draw`` a (B,) standard normal draw,
    ``noise`` a standard normal draw of the style's shape."""
    sigma = torch.exp(log_sigma_draw * LOG_SIGMA_STD + LOG_SIGMA_MEAN)
    denoised = denoiser(clean_style + sigma[:, None] * noise, sigma, text_embedding)
    weight = (sigma**2 + sigma_data**2) / ((sigma * sigma_data) ** 2 + 1e-12)
    per = torch.mean((denoised - clean_style) ** 2, dim=-1)
    return torch.mean(weight * per)

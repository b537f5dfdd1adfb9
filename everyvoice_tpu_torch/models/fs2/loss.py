"""FastSpeech2 training losses (counterpart of
everyvoice_tpu/models/fs2/loss.py): mel 1.0 / postnet 1.0 / pitch 0.1 /
energy 0.1 / duration 0.1 / attn_ctc 0.1 / attn_bin 0.1 by default, the
binarization term ramped in by ``bin_loss_ramp``."""

from __future__ import annotations

import torch

from everyvoice_tpu_torch.models.fs2.alignment import (
    binarization_loss,
    durations_from_hard_attention,
    forward_sum_loss,
    viterbi_alignment,
)
from everyvoice_tpu_torch.parallel.collectives import mean_denominator


def masked_loss(pred, target, mask, kind: str = "mse"):
    """Mean of the squared (or absolute) error over the mask's true entries
    (times the trailing feature size when the mask has fewer axes); their
    count is the global batch's inside ``parallel.data_parallel``."""
    diff = pred - target
    per = torch.abs(diff) if kind == "mae" else diff * diff
    if mask.dim() < per.dim():
        mask = mask[..., None]
    per = torch.where(mask, per, torch.zeros((), device=per.device))
    count = mask.sum() * (per.numel() // mask.numel())
    return per.sum() / mean_denominator(count).to(per.dtype)


def compute_fs2_losses(
    outputs: dict,
    batch: dict,
    weights: dict,
    mel_loss_kind: str = "mse",
    variance_loss_kind: str = "mse",
    learn_alignment: bool = True,
    bin_loss_ramp: float = 1.0,
) -> dict:
    """A dict of the individual losses plus 'total'. A batch that carries
    ``row_weights`` (0/1 per row, from ``pad_batch_for_eval``) has its pad
    rows masked out of every term."""
    losses = {}
    frame_mask = outputs["frame_mask"]
    src_mask = outputs["src_mask"]
    row_weights = batch.get("row_weights")
    if row_weights is not None:
        real = row_weights > 0.5
        frame_mask = frame_mask & real[:, None]
        src_mask = src_mask & real[:, None]
    mel_target = batch["mel"]

    losses["mel"] = masked_loss(outputs["mel"], mel_target, frame_mask, mel_loss_kind)
    if "postnet_mel" in outputs:
        losses["postnet"] = masked_loss(outputs["postnet_mel"], mel_target, frame_mask,
                                        mel_loss_kind)

    if learn_alignment and "attn_logprob" in outputs:
        attn_logprob = outputs["attn_logprob"]
        src_lengths = batch["text_lengths"]
        mel_lengths = batch["mel_lengths"]
        losses["attn_ctc"] = forward_sum_loss(attn_logprob, src_lengths, mel_lengths,
                                              row_weights=row_weights)
        if "attn_hard" in outputs:
            attn_hard = outputs["attn_hard"]
        else:
            attn_hard = viterbi_alignment(attn_logprob.detach(), src_lengths, mel_lengths)
        if row_weights is not None:
            # Zeroed hard paths drop pad rows from the binarization mean.
            attn_hard = attn_hard * row_weights[:, None, None]
        losses["attn_bin"] = bin_loss_ramp * binarization_loss(outputs["attn_soft"], attn_hard)
        duration_target = outputs.get("duration_target")
        if duration_target is None:
            duration_target = durations_from_hard_attention(attn_hard)
    else:
        duration_target = batch["durations"]

    losses["duration"] = masked_loss(
        outputs["log_duration_prediction"], torch.log1p(duration_target.float()),
        src_mask, variance_loss_kind,
    )

    # Pitch and energy against the (possibly phone-averaged) targets the
    # model consumed.
    pitch_target = outputs.get("pitch_target_used")
    if pitch_target is None:
        pitch_target = batch["pitch"]
    energy_target = outputs.get("energy_target_used")
    if energy_target is None:
        energy_target = batch["energy"]
    pitch_mask = src_mask if pitch_target.shape == src_mask.shape else frame_mask
    energy_mask = src_mask if energy_target.shape == src_mask.shape else frame_mask
    losses["pitch"] = masked_loss(outputs["pitch_prediction"], pitch_target.detach(),
                                  pitch_mask, variance_loss_kind)
    losses["energy"] = masked_loss(outputs["energy_prediction"], energy_target.detach(),
                                   energy_mask, variance_loss_kind)

    losses["total"] = (
        weights.get("mel", 1.0) * losses["mel"]
        + weights.get("postnet", 1.0) * losses.get("postnet", 0.0)
        + weights.get("duration", 0.1) * losses["duration"]
        + weights.get("pitch", 0.1) * losses["pitch"]
        + weights.get("energy", 0.1) * losses["energy"]
        + weights.get("attn_ctc", 0.1) * losses.get("attn_ctc", 0.0)
        + weights.get("attn_bin", 0.1) * losses.get("attn_bin", 0.0)
    )
    return losses

"""HiFi-GAN training objectives (counterpart of
everyvoice_tpu/models/hifigan/loss.py): LSGAN ("original") or wgan
adversarial losses, feature matching (weight 2) and the L1 mel loss
(weight 45). Scores and features may arrive in bfloat16; every loss reduces
in float32."""

from __future__ import annotations

import torch

MEL_LOSS_WEIGHT = 45.0
FEATURE_MATCHING_WEIGHT = 2.0


def discriminator_loss(real_scores, fake_scores, gan_type: str = "original") -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        dr, dg = dr.float(), dg.float()
        if gan_type == "wgan":
            loss = loss - dr.mean() + dg.mean()
        else:
            loss = loss + ((1.0 - dr) ** 2).mean() + (dg**2).mean()
    return loss


def generator_adversarial_loss(fake_scores, gan_type: str = "original") -> torch.Tensor:
    loss = 0.0
    for dg in fake_scores:
        dg = dg.float()
        loss = loss - dg.mean() if gan_type == "wgan" else loss + ((1.0 - dg) ** 2).mean()
    return loss


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    loss = 0.0
    for dr_layers, dg_layers in zip(real_feats, fake_feats):
        for fr, fg in zip(dr_layers, dg_layers):
            loss = loss + (fr.float() - fg.float()).abs().mean()
    return loss


def mel_l1_loss(mel_real: torch.Tensor, mel_fake: torch.Tensor) -> torch.Tensor:
    return (mel_real - mel_fake).abs().mean()

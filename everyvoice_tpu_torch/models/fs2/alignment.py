"""Unsupervised text↔mel alignment (counterpart of
everyvoice_tpu/models/fs2/alignment.py).

A soft attention between text keys and mel queries, shaped by the
beta-binomial prior, is trained with a forward-sum (CTC-like) loss; the
Viterbi path of the same log-attention gives the hard alignment whose
per-phone sums are the duration targets, and a binarization loss pulls the
soft attention toward it.

The JAX package runs both dynamic programmes as fixed-shape ``lax.scan``s
over the mel axis, a TPU design choice. Here the forward-sum is a loop of
torch ops over the mel axis (autograd differentiates it), and the Viterbi,
which needs no gradient, runs in numpy on the host. Both keep the JAX
package's masking, its ``NEG_INF`` and its tie rule (a tie stays on the
same phone), so they give the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.models.layers import conv1d_same

NEG_INF = -1e9


class AlignmentEncoder(nn.Module):
    """Projects text encodings (keys) and target mels (queries) into a shared
    space and returns (attn_soft, attn_logprob), each (B, T_mel, N_text).
    Always float32, whatever the model's compute dtype."""

    def __init__(self, dim: int = 256, n_mels: int = 80, temperature: float = 0.0005):
        super().__init__()
        self.temperature = temperature
        self.key_in = nn.Conv1d(dim, 2 * dim, 3)
        self.key_out = nn.Conv1d(2 * dim, dim, 1)
        self.query_in = nn.Conv1d(n_mels, 2 * dim, 3)
        self.query_mid = nn.Conv1d(2 * dim, dim, 1)
        self.query_out = nn.Conv1d(dim, dim, 1)

    def forward(self, text_enc, mel, src_mask, mel_mask, prior=None):
        f32 = torch.float32
        k = conv1d_same(F.relu(conv1d_same(text_enc, self.key_in, f32)), self.key_out, f32)
        q = F.relu(conv1d_same(mel, self.query_in, f32))
        q = F.relu(conv1d_same(q, self.query_mid, f32))
        q = conv1d_same(q, self.query_out, f32)
        # Negative squared L2 distance, scaled: (B, T, N)
        dist = (
            torch.sum(q * q, dim=-1)[:, :, None]
            - 2.0 * torch.bmm(q, k.transpose(1, 2))
            + torch.sum(k * k, dim=-1)[:, None, :]
        )
        attn_logprob = -self.temperature * dist
        if prior is not None:
            attn_logprob = attn_logprob + torch.log(prior + 1e-8)
        attn_logprob = torch.where(src_mask[:, None, :], attn_logprob,
                                   torch.full((), NEG_INF, device=dist.device))
        attn_soft = torch.softmax(attn_logprob, dim=-1)
        attn_soft = torch.where(mel_mask[:, :, None], attn_soft, torch.zeros((), device=dist.device))
        return attn_soft, attn_logprob


def _masked_log_softmax(attn_logprob: torch.Tensor, src_lengths: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the text axis restricted to each row's valid tokens."""
    n_max = attn_logprob.shape[-1]
    text_mask = torch.arange(n_max, device=attn_logprob.device)[None, :] < src_lengths[:, None]
    logits = torch.where(text_mask[:, None, :], attn_logprob,
                         torch.full((), NEG_INF, device=attn_logprob.device))
    return torch.log_softmax(logits, dim=-1)


def forward_sum_loss(attn_logprob, src_lengths, mel_lengths, row_weights=None):
    """Monotonic forward-sum (CTC-like, no blank) alignment loss.

    α[t, n] = logp̂[t, n] + logaddexp(α[t−1, n], α[t−1, n−1]); the loss is
    −α[T−1, N−1] normalized by mel length, averaged over the batch
    (optionally weighted by 0/1 ``row_weights`` to drop pad rows)."""
    b, t_max, n_max = attn_logprob.shape
    logp = _masked_log_softmax(attn_logprob, src_lengths)
    first = torch.arange(n_max, device=logp.device)[None, :] == 0
    alpha = torch.where(first, logp[:, 0, :], torch.full((), NEG_INF, device=logp.device))
    t_idx = torch.clamp(mel_lengths.long() - 1, 0, t_max - 1)
    n_idx = torch.clamp(src_lengths.long() - 1, 0, n_max - 1)
    # Frames past the longest mel are never read, so the loop stops there.
    alphas = [alpha]
    for t in range(1, int(t_idx.max()) + 1):
        shifted = F.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        alpha = logp[:, t, :] + torch.logaddexp(alpha, shifted)
        alphas.append(alpha)
    final = torch.stack(alphas)[t_idx, torch.arange(b, device=logp.device), n_idx]
    per_row = -final / torch.clamp(mel_lengths, min=1).to(final.dtype)
    if row_weights is None:
        return per_row.mean()
    return torch.sum(per_row * row_weights) / torch.clamp(torch.sum(row_weights), min=1.0)


def viterbi_alignment(attn_logprob, src_lengths, mel_lengths) -> torch.Tensor:
    """Monotonic alignment search: the binary (B, T, N) path maximizing the
    summed log-probability, monotonic with no phone skipped, as a float32
    tensor on ``attn_logprob``'s device. Computed on the host in float32
    numpy (no gradient flows through it); a tie stays on the same phone."""
    b, t_max, n_max = attn_logprob.shape
    with torch.no_grad():
        logp = _masked_log_softmax(attn_logprob.float(), src_lengths).cpu().numpy()
    mel_len = mel_lengths.cpu().numpy().astype(np.int64)
    src_len = src_lengths.cpu().numpy().astype(np.int64)
    path = viterbi_path_host(logp, src_len, mel_len)
    hard = np.zeros((b, t_max, n_max), np.float32)
    bi, ti = np.nonzero((path >= 0) & (np.arange(t_max)[None, :] < mel_len[:, None]))
    hard[bi, ti, path[bi, ti]] = 1.0
    return torch.from_numpy(hard).to(attn_logprob.device)


def viterbi_path_host(logp: np.ndarray, src_len: np.ndarray, mel_len: np.ndarray) -> np.ndarray:
    """(B, T) phone index of each frame on the Viterbi path of the (B, T, N)
    float32 log-probabilities, −1 past each row's mel length."""
    b, t_max, n_max = logp.shape
    neg = np.float32(NEG_INF)
    q = np.where(np.arange(n_max)[None, :] == 0, logp[:, 0, :], neg).astype(np.float32)
    t_idx = np.clip(mel_len - 1, 0, t_max - 1)
    t_last = int(t_idx.max()) if b else 0
    stays = np.ones((t_last + 1, b, n_max), bool)  # frame 0 trivially "stays"
    shifted = np.empty_like(q)
    for t in range(1, t_last + 1):
        shifted[:, 0] = neg
        shifted[:, 1:] = q[:, :-1]
        stays[t] = q >= shifted
        q = logp[:, t, :] + np.maximum(q, shifted)
    n_end = np.clip(src_len - 1, 0, n_max - 1)
    path = np.full((b, t_max), -1, np.int64)
    rows = np.arange(b)
    n_cur = n_end.copy()
    for t in range(t_last, -1, -1):
        active = t <= t_idx
        path[active, t] = n_cur[active]
        stay = stays[t, rows, np.clip(n_cur, 0, n_max - 1)]
        step_back = active & (t > 0) & ~stay
        n_cur = np.where(step_back, n_cur - 1, n_cur)
    return path


def binarization_loss(attn_soft, attn_hard):
    """KL between the hard path and the soft attention: −log p_soft along the
    hard path, averaged over valid frames."""
    per_frame = -torch.log(torch.sum(attn_soft * attn_hard, dim=-1) + 1e-8)
    valid = torch.sum(attn_hard, dim=-1) > 0
    return torch.sum(torch.where(valid, per_frame, torch.zeros((), device=per_frame.device))) / (
        torch.clamp(valid.sum(), min=1).to(per_frame.dtype)
    )


def durations_from_hard_attention(attn_hard):
    """(B, T, N) binary alignment → (B, N) int32 durations."""
    return torch.sum(attn_hard, dim=1).to(torch.int32)


def phone_average_by_durations(frame_values, durations):
    """Average frame-level values (B, T) into phones (B, N) using explicit
    durations: cumulative-sum segment means (the learn_alignment=False
    path)."""
    t = frame_values.shape[1]
    durations = durations.long()
    cum = torch.cumsum(durations, dim=1)
    csum = torch.cat([torch.zeros_like(frame_values[:, :1]),
                      torch.cumsum(frame_values, dim=1)], dim=1)
    ends = torch.clamp(cum, 0, t)
    starts = torch.clamp(cum - durations, 0, t)
    sums = torch.gather(csum, 1, ends) - torch.gather(csum, 1, starts)
    return torch.where(durations > 0, sums / torch.clamp(durations, min=1).to(sums.dtype),
                       torch.full((), 1e-7, device=sums.device))


def phone_average(frame_values, attn_hard):
    """Average frame-level values (B, T) into phone-level values (B, N)
    using the hard alignment."""
    counts = torch.sum(attn_hard, dim=1)
    sums = torch.einsum("btn,bt->bn", attn_hard, frame_values)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.full((), 1e-7, device=sums.device))

"""Shared building blocks of FastSpeech2 in PyTorch: Conformer, variance
predictors, length regulation, postnet (counterpart of
everyvoice_tpu/models/layers.py).

Activations are (B, T, C), as in the JAX package. Numerics follow flax:
LayerNorm and GroupNorm use eps 1e-6 and take their statistics in float32;
masked attention logits are filled with the dtype's most negative finite
value (not -inf), so fully masked (padded) query rows stay finite;
``GroupNorm(num_groups=1)`` takes its statistics over the whole padded
(T, C) of each item, so callers keep the JAX package's padded lengths.
``dtype`` is the compute dtype of matmuls and convolutions; parameters stay
float32.

Dropout sits at every site where the JAX package has it. It acts only in
training mode (``module.train()``), so serving (``.eval()``) is unchanged,
and it draws its masks from the ``torch.Generator`` that
``set_dropout_generator`` gives it, never from the global RNG.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-6


def sinusoidal_positional_encoding(length: int, dim: int) -> np.ndarray:
    """Standard transformer sinusoidal table (length, dim), host-computed."""
    position = np.arange(length)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term)
    return table


def lengths_to_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths → (B, T) boolean validity mask."""
    return torch.arange(max_length, device=lengths.device)[None, :] < lengths[:, None]


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode, keep each element with
    probability 1 - p and scale the kept ones by 1/(1 - p); the identity in
    eval mode. ``shared_dims`` leading axes share one mask (flax's
    ``broadcast_dropout`` of attention weights over batch and heads)."""

    def __init__(self, p: float, shared_dims: int = 0):
        super().__init__()
        self.p = float(p)
        self.shared_dims = shared_dims
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "dropout in training mode needs a torch.Generator; call "
                "set_dropout_generator(model, generator) first"
            )
        keep = 1.0 - self.p
        shape = (1,) * self.shared_dims + tuple(x.shape[self.shared_dims:])
        mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Draw every dropout mask of ``model`` from ``generator``."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer computed in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv1d_same(x: torch.Tensor, layer: nn.Conv1d, dtype: torch.dtype, dilation: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` on (B, T, C): the left pad is the
    smaller half of (k-1)·dilation."""
    k = layer.kernel_size[0]
    total = (k - 1) * dilation
    v = F.pad(x.to(dtype).transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(
        v, layer.weight.to(dtype), layer.bias.to(dtype),
        dilation=dilation, groups=layer.groups,
    )
    return y.transpose(1, 2)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """Statistics in float32, output in ``dtype``."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, NORM_EPS)
    return y.to(dtype)


def group_norm_1(x: torch.Tensor, norm: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """``GroupNorm(num_groups=1)`` on (B, T, C): one mean and variance per
    item over all of its (T, C), padded rows included."""
    y = F.group_norm(x.float().transpose(1, 2), 1, norm.weight, norm.bias, NORM_EPS)
    return y.transpose(1, 2).to(dtype)


class FeedForwardModule(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(dim, eps=NORM_EPS)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop_hidden = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def forward(self, x):
        x = layer_norm(x, self.norm, self.dtype)
        x = self.drop_hidden(F.silu(linear(x, self.fc1, self.dtype)))
        return self.drop_out(linear(x, self.fc2, self.dtype))


class ConformerConvModule(nn.Module):
    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop = Dropout(dropout)
        self.norm = nn.LayerNorm(dim, eps=NORM_EPS)
        self.pointwise_in = nn.Linear(dim, 2 * dim)
        self.depthwise = nn.Conv1d(dim, dim, kernel_size, groups=dim)
        self.group_norm = nn.GroupNorm(1, dim, eps=NORM_EPS)
        self.pointwise_out = nn.Linear(dim, dim)

    def forward(self, x, mask):
        x = layer_norm(x, self.norm, self.dtype)
        x = F.glu(linear(x, self.pointwise_in, self.dtype), dim=-1)
        x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = conv1d_same(x, self.depthwise, self.dtype)
        x = F.silu(group_norm_1(x, self.group_norm, self.dtype))
        return self.drop(linear(x, self.pointwise_out, self.dtype))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` self-attention: per-head query,
    key and value projections (flax kernels (dim, heads, head_dim)), an
    output projection (flax kernel (heads, head_dim, dim)), queries scaled by
    1/sqrt(head_dim) before the product, softmax taken in float32, and the
    attention weights' dropout mask shared over batch and heads."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop = Dropout(dropout, shared_dims=2)
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, t, dim = x.shape
        h = self.heads
        q, k, v = (
            linear(x, layer, self.dtype).view(b, t, h, dim // h).transpose(1, 2)
            for layer in (self.query, self.key, self.value)
        )
        q = q / torch.sqrt(torch.tensor(dim // h, dtype=q.dtype))
        logits = q @ k.transpose(-1, -2)  # (B, H, T, T)
        pair = mask[:, None, None, :] & mask[:, None, :, None]
        logits = logits.masked_fill(~pair, torch.finfo(logits.dtype).min)
        weights = self.drop(torch.softmax(logits.float(), dim=-1).to(self.dtype))
        y = (weights @ v).transpose(1, 2).reshape(b, t, dim)
        return linear(y, self.out, self.dtype)


class ConformerBlock(nn.Module):
    def __init__(self, dim, heads, ff_dim, conv_kernel_size, dtype=torch.float32, dropout=0.0):
        super().__init__()
        self.dtype = dtype
        self.ff1 = FeedForwardModule(dim, ff_dim, dtype, dropout)
        self.attn_norm = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = MultiHeadAttention(dim, heads, dtype, dropout)
        self.attn_drop = Dropout(dropout)
        self.conv = ConformerConvModule(dim, conv_kernel_size, dtype, dropout)
        self.ff2 = FeedForwardModule(dim, ff_dim, dtype, dropout)
        self.final_norm = nn.LayerNorm(dim, eps=NORM_EPS)

    def forward(self, x, mask):
        x = x + 0.5 * self.ff1(x)
        x = x + self.attn_drop(self.attn(layer_norm(x, self.attn_norm, self.dtype), mask))
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ff2(x)
        x = layer_norm(x, self.final_norm, self.dtype)
        return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class ConformerStack(nn.Module):
    """Positional encoding, then ``layers`` Conformer blocks; the residual
    stream runs in the compute dtype and the output is float32."""

    def __init__(self, layers, dim, heads, ff_dim, conv_kernel_size, dtype=torch.float32,
                 dropout=0.0):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            ConformerBlock(dim, heads, ff_dim, conv_kernel_size, dtype, dropout)
            for _ in range(layers)
        )

    def forward(self, x, mask):
        pos = torch.from_numpy(sinusoidal_positional_encoding(x.shape[1], self.dim))
        x = self.drop((x + pos.to(x.device)[None]).to(self.dtype))
        for block in self.blocks:
            x = block(x, mask)
        return x.float()


class VariancePredictor(nn.Module):
    """Conv stack predicting one float32 scalar per position; depthwise-
    separable convs (a depthwise conv, then a 1x1 conv) by default."""

    def __init__(self, n_layers, kernel_size, in_dim, hidden_dim, depthwise=True,
                 dtype=torch.float32, dropout=0.0):
        super().__init__()
        self.dtype = dtype
        self.depthwise = depthwise
        self.drop = Dropout(dropout)
        self.dw_convs = nn.ModuleList()
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        dim = in_dim
        for _ in range(n_layers):
            if depthwise:
                self.dw_convs.append(nn.Conv1d(dim, dim, kernel_size, groups=dim))
                self.convs.append(nn.Conv1d(dim, hidden_dim, 1))
            else:
                self.convs.append(nn.Conv1d(dim, hidden_dim, kernel_size))
            self.norms.append(nn.LayerNorm(hidden_dim, eps=NORM_EPS))
            dim = hidden_dim
        self.head = nn.Linear(hidden_dim, 1)

    def forward(self, x, mask):
        for i, conv in enumerate(self.convs):
            if self.depthwise:
                x = conv1d_same(x, self.dw_convs[i], self.dtype)
            x = F.relu(conv1d_same(x, conv, self.dtype))
            x = self.drop(layer_norm(x, self.norms[i], self.dtype))
        out = F.linear(x.float(), self.head.weight, self.head.bias)[..., 0]
        return torch.where(mask, out, torch.zeros((), device=out.device))


def regulate_length(encodings: torch.Tensor, durations: torch.Tensor, max_frames: int) -> tuple:
    """Repeat each of the (B, N, C) encodings ``durations`` times into
    (B, max_frames, C) frames. Returns (frames, frame_mask, total_lengths)."""
    cum = torch.cumsum(durations, dim=1)
    total = cum[:, -1]
    t = torch.arange(max_frames, device=encodings.device, dtype=cum.dtype)
    # Frame t belongs to the first token whose cumulative duration exceeds t.
    idx = torch.searchsorted(cum, t[None, :].expand(cum.shape[0], -1).contiguous(), right=True)
    idx = idx.clamp(max=encodings.shape[1] - 1)
    frames = torch.gather(encodings, 1, idx[..., None].expand(-1, -1, encodings.shape[2]))
    frame_mask = t[None, :] < total[:, None]
    frames = torch.where(frame_mask[..., None], frames, torch.zeros((), dtype=frames.dtype, device=frames.device))
    return frames, frame_mask, total


class Postnet(nn.Module):
    """5-layer conv postnet refining the float32 mel."""

    def __init__(self, n_mels, channels=512, kernel_size=5, n_layers=5, dtype=torch.float32,
                 dropout=0.5):
        super().__init__()
        self.dtype = dtype
        self.drop = Dropout(dropout)
        dims = [n_mels] + [channels] * (n_layers - 1) + [n_mels]
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], kernel_size) for i in range(n_layers)
        )
        self.norms = nn.ModuleList(
            nn.GroupNorm(1, channels, eps=NORM_EPS) for _ in range(n_layers - 1)
        )

    def forward(self, mel, mask):
        x = mel.to(self.dtype)
        for conv, norm in zip(self.convs[:-1], self.norms):
            x = self.drop(torch.tanh(group_norm_1(conv1d_same(x, conv, self.dtype), norm, self.dtype)))
        x = self.drop(conv1d_same(x, self.convs[-1], self.dtype))
        out = mel + x.float()
        return torch.where(mask[..., None], out, torch.zeros((), device=out.device))

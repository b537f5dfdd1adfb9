"""The speech language model of StyleTTS2's SLM-adversarial training, in
PyTorch (counterpart of everyvoice_tpu/models/styletts2/slm.py): the
frozen WavLM encoder (microsoft/wavlm-base-plus at 16 kHz) whose 13 hidden
states a small trainable head scores as real or generated.

``WavLM`` is the inference path of ``transformers.WavLMModel``: a 7-layer
conv feature extractor (GroupNorm on the first layer, exact-erf GELU), a
feature projection, the weight-normed grouped positional conv, and
post-norm transformer layers whose attention adds a relative position bias
that layer 0's table gives for every layer, gated per layer and head from
that layer's input. It returns the input of the first layer and each
layer's output. The module keeps the JAX package's parameter names; it runs
in the dtype of its parameters (the trainer holds a bfloat16 copy for its
bfloat16 steps).

``SLMDiscriminator`` is the head over the stacked states (``pre`` 1×1, two
3-wide convs with leaky ReLU 0.1, ``post``), with the LSGAN losses.

``convert_torch_wavlm_state`` turns a HuggingFace state dict (either
weight-norm key style) into the JAX package's flax tree, fusing the
positional conv's weight norm; ``load_wavlm_params`` reads a HuggingFace
model directory without ``transformers`` (``config.json`` with ``json``,
the weights with ``utils/hf_weights.read_hf_state_dict``) or a bare
state-dict file, which takes the base-plus geometry; both load tensors only
(``weights_only=True``).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.utils.hf_weights import read_hf_state_dict, to_numpy

# wavlm-base-plus (HF WavLMConfig defaults).
BASE_PLUS = dict(
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
    conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
    num_buckets=320, max_distance=800, num_conv_pos_embeddings=128,
    num_conv_pos_embedding_groups=16,
)
HF_CONFIG_NAMES = {"hidden_size": "hidden_size", "num_hidden_layers": "num_layers",
                   "num_attention_heads": "num_heads", "intermediate_size": "intermediate_size",
                   "conv_dim": "conv_dim", "conv_kernel": "conv_kernel",
                   "conv_stride": "conv_stride", "num_buckets": "num_buckets",
                   "max_bucket_distance": "max_distance",
                   "num_conv_pos_embeddings": "num_conv_pos_embeddings",
                   "num_conv_pos_embedding_groups": "num_conv_pos_embedding_groups"}
NORM_EPS = 1e-5
HEAD_SLOPE = 0.1


def relative_position_buckets(length: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """WavLM's bidirectional log-bucketing of relative positions, (T, T)."""
    half = num_buckets // 2
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / np.log(max_distance / max_exact)
    large = np.minimum((max_exact + large * (half - max_exact)).astype(np.int64), half - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


@lru_cache(maxsize=16)
def _buckets(length: int, num_buckets: int, max_distance: int, device: str) -> torch.Tensor:
    return torch.from_numpy(relative_position_buckets(length, num_buckets, max_distance)).long() \
        .to(device)


class WavLMAttention(nn.Module):
    """Self-attention plus the shared position bias, gated per head from
    the layer's input."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.gru_rel_pos_linear = nn.Linear(hidden_size // num_heads, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, num_heads, 1, 1))

    def forward(self, x, position_bias):
        b, t, dim = x.shape
        h = self.num_heads
        hd = dim // h

        def heads(y):
            return y.view(b, t, h, hd).transpose(1, 2)  # (B, H, T, hd)

        proj = self.gru_rel_pos_linear(heads(x)).view(b, h, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0  # (B, H, T, 1)
        q = heads(self.q_proj(x)) * hd ** -0.5
        logits = q @ heads(self.k_proj(x)).transpose(-1, -2) + gate * position_bias[None]
        out = torch.softmax(logits, dim=-1) @ heads(self.v_proj(x))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, dim))


class WavLMLayer(nn.Module):
    """A post-norm transformer layer."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int):
        super().__init__()
        self.attention = WavLMAttention(hidden_size, num_heads)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        self.intermediate_dense = nn.Linear(hidden_size, intermediate_size)
        self.output_dense = nn.Linear(intermediate_size, hidden_size)
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)

    def forward(self, x, position_bias):
        x = self.layer_norm(x + self.attention(x, position_bias))
        x = x + self.output_dense(F.gelu(self.intermediate_dense(x)))
        return self.final_layer_norm(x)


class WavLM(nn.Module):
    """16 kHz wav (B, S) → num_layers + 1 hidden states (B, T, hidden) at
    50 Hz."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2), num_buckets: int = 320,
                 max_distance: int = 800, num_conv_pos_embeddings: int = 128,
                 num_conv_pos_embedding_groups: int = 16):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.conv_stride = tuple(conv_stride)
        chans = (1,) + tuple(conv_dim)
        for i, (k, s) in enumerate(zip(conv_kernel, conv_stride)):
            setattr(self, f"conv{i}", nn.Conv1d(chans[i], chans[i + 1], k, stride=s, bias=False))
        self.n_convs = len(conv_dim)
        self.conv0_norm = nn.GroupNorm(conv_dim[0], conv_dim[0], eps=NORM_EPS)
        self.fp_norm = nn.LayerNorm(conv_dim[-1], eps=NORM_EPS)
        self.fp_proj = nn.Linear(conv_dim[-1], hidden_size)
        kp = num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(hidden_size, hidden_size, kp, padding=kp // 2,
                                  groups=num_conv_pos_embedding_groups)
        self.enc_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        self.rel_attn_embed = nn.Parameter(torch.zeros(num_buckets, num_heads))
        for i in range(num_layers):
            setattr(self, f"layer{i}", WavLMLayer(hidden_size, num_heads, intermediate_size))

    def forward(self, wav) -> tuple:
        x = wav[:, None, :]
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
            if i == 0:
                x = self.conv0_norm(x)
            x = F.gelu(x)
        x = self.fp_proj(self.fp_norm(x.transpose(1, 2)))  # (B, T, hidden)
        pos = self.pos_conv(x.transpose(1, 2))
        if self.pos_conv.kernel_size[0] % 2 == 0:
            pos = pos[..., :-1]
        x = self.enc_norm(x + F.gelu(pos).transpose(1, 2))
        buckets = _buckets(x.shape[1], self.num_buckets, self.max_distance, str(x.device))
        position_bias = self.rel_attn_embed[buckets].permute(2, 0, 1)  # (H, T, T)
        states = [x]
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, position_bias)
            states.append(x)
        return tuple(states)


class SLMDiscriminator(nn.Module):
    """Stacked hidden states (B, T, layers·hidden) → a score a frame (B, T)."""

    def __init__(self, in_features: int, initial_channel: int = 64):
        super().__init__()
        ch = initial_channel
        self.pre = nn.Conv1d(in_features, ch, 1)
        self.conv0 = nn.Conv1d(ch, 2 * ch, 3, padding=1)
        self.conv1 = nn.Conv1d(2 * ch, 4 * ch, 3, padding=1)
        self.post = nn.Conv1d(4 * ch, 1, 3, padding=1)

    def forward(self, feats):
        x = self.pre(feats.transpose(1, 2))
        x = F.leaky_relu(self.conv0(x), HEAD_SLOPE)
        x = F.leaky_relu(self.conv1(x), HEAD_SLOPE)
        return self.post(x)[:, 0]


def stack_hidden_states(hidden_states) -> torch.Tensor:
    """(layers + 1) × (B, T, H) → (B, T, (layers + 1)·H)."""
    return torch.cat(list(hidden_states), dim=-1)


def slm_generator_loss(fake_scores):
    return torch.mean((fake_scores - 1.0) ** 2)


def slm_discriminator_loss(real_scores, fake_scores):
    return torch.mean((real_scores - 1.0) ** 2) + torch.mean(fake_scores ** 2)


# ---------------------------------------------------------------------------
# HuggingFace checkpoints


def convert_torch_wavlm_state(state_dict: dict, num_layers: int) -> dict:
    """A HuggingFace ``WavLMModel`` state dict → the JAX package's flax
    tree (``{"params": ...}``): dense kernels (in, out), conv kernels
    (K, in, out), and the positional conv's weight norm (g · v / ‖v‖, the
    norm over every axis but the kernel's) fused into one kernel."""
    sd = {(k[len("wavlm."):] if k.startswith("wavlm.") else k): to_numpy(v)
          for k, v in state_dict.items()}
    p: dict = {}
    n_convs = len([k for k in sd if k.startswith("feature_extractor") and k.endswith(".conv.weight")])
    for i in range(n_convs):
        p[f"conv{i}"] = {"kernel": sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
                         .transpose(2, 1, 0)}
    p["conv0_norm"] = {"scale": sd["feature_extractor.conv_layers.0.layer_norm.weight"],
                       "bias": sd["feature_extractor.conv_layers.0.layer_norm.bias"]}

    def dense(key):
        return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}

    def norm(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    p["fp_norm"] = norm("feature_projection.layer_norm")
    p["fp_proj"] = dense("feature_projection.projection")
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.parametrizations.weight.original0" in sd:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    else:
        g, v = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    w = g * v / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))  # (out, in/groups, K)
    p["pos_conv"] = {"kernel": w.transpose(2, 1, 0), "bias": sd[f"{pc}.bias"]}
    p["enc_norm"] = norm("encoder.layer_norm")
    p["rel_attn_embed"] = sd["encoder.layers.0.attention.rel_attn_embed.weight"]
    for i in range(num_layers):
        pre = f"encoder.layers.{i}"
        attn = {name: dense(f"{pre}.attention.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear")}
        attn["gru_rel_pos_const"] = sd[f"{pre}.attention.gru_rel_pos_const"]
        p[f"layer{i}"] = {
            "attention": attn, "layer_norm": norm(f"{pre}.layer_norm"),
            "intermediate_dense": dense(f"{pre}.feed_forward.intermediate_dense"),
            "output_dense": dense(f"{pre}.feed_forward.output_dense"),
            "final_layer_norm": norm(f"{pre}.final_layer_norm"),
        }
    return {"params": p}


def geometry_from_hf_config(config: dict) -> dict:
    """WavLM's geometry from a HuggingFace ``config.json`` (base plus's
    value for a field it lacks)."""
    geometry = dict(BASE_PLUS)
    for theirs, ours in HF_CONFIG_NAMES.items():
        if theirs in config:
            value = config[theirs]
            geometry[ours] = tuple(value) if isinstance(value, list) else int(value)
    return geometry


def wavlm_from_flax(geometry: dict, params: dict) -> WavLM:
    """A frozen ``WavLM`` (eval mode, no gradient) holding a flax tree's
    weights."""
    from everyvoice_tpu_torch.convert import flax_to_torch

    model = WavLM(**geometry)
    model.load_state_dict(flax_to_torch(params, model)[0])
    return model.eval().requires_grad_(False)


def load_wavlm_params(model_path) -> tuple:
    """(geometry, flax tree) of a WavLM on disk: a HuggingFace model
    directory (``config.json`` and ``pytorch_model.bin`` or
    ``model.safetensors``) or a bare state-dict file (base plus)."""
    path = Path(model_path)
    if not path.exists():
        raise FileNotFoundError(
            f"WavLM weights not found at {model_path}. Stage microsoft/wavlm-base-plus on a "
            "machine with network access and point model.slm.model at the local directory.")
    if path.is_dir():
        geometry = geometry_from_hf_config(json.loads((path / "config.json").read_text("utf8")))
        state = read_hf_state_dict(path)
    else:
        state = torch.load(str(path), map_location="cpu", weights_only=True)
        geometry = dict(BASE_PLUS)
    return geometry, convert_torch_wavlm_state(state, geometry["num_layers"])

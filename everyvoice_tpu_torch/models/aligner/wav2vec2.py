"""The wav2vec2-CTC acoustic model of long-audio segmentation, in PyTorch
(counterpart of everyvoice_tpu/models/aligner/wav2vec2.py).

``Wav2Vec2CTC`` is the inference path of ``transformers.Wav2Vec2ForCTC``: a
conv feature extractor (GroupNorm on the first layer, or LayerNorm on every
layer), exact-erf GELU, a feature projection, the weight-normed grouped
positional conv, and transformer layers, post-norm (``do_stable_layer_norm
= False``, e.g. facebook/wav2vec2-base-960h) or pre-norm with the encoder's
norm after them (``True``, the large alignment models), then the CTC head
and a log-softmax. Attention is plain matmul, softmax, matmul, in the JAX
package's order. The module keeps the flax tree's parameter names, so
``convert.flax_to_torch`` carries the JAX package's parameters across.

``convert_torch_wav2vec2_state`` turns a HuggingFace state dict into that
flax tree (either weight-norm key style, the positional conv's norm fused);
``load_wav2vec2_ctc`` reads a HuggingFace model directory without
``transformers``: ``config.json`` for the geometry, ``vocab.json`` (plus
``added_tokens.json`` and the tokenizer config's added tokens, as the
tokenizer's ``get_vocab`` includes them), ``preprocessor_config.json`` for
``do_normalize``, and ``pytorch_model.bin`` (tensors only) or
``model.safetensors`` through ``utils/hf_weights.read_hf_state_dict``.

``windowed_log_probs`` scores audio of any length in 20 s windows that
overlap by 2 s, each frame taken from the window where it lies farthest
from an edge, with the JAX package's frame bookkeeping; audio that fits
one window is scored unpadded in one forward; ``window_plan`` gives the
windows. Everything runs in float32 with TF32 off.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.utils.hf_weights import read_hf_state_dict, to_numpy
from everyvoice_tpu_torch.utils.precision import no_tf32

NORM_EPS = 1e-5
# facebook/wav2vec2-base-960h's geometry (post-norm, GroupNorm feature
# extractor) and wav2vec2-large's stable-layer-norm one, under the
# ``Wav2Vec2CTC`` argument names; the vocabulary is 32 characters.
WAV2VEC2_BASE = dict(
    vocab_size=32, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
    conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16, feat_extract_norm="group",
    do_stable_layer_norm=False, conv_bias=False,
)
WAV2VEC2_LARGE = dict(WAV2VEC2_BASE, hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, feat_extract_norm="layer",
                      do_stable_layer_norm=True, conv_bias=True)
# The HuggingFace config.json names of the arguments that it names otherwise.
HF_CONFIG_NAMES = {"num_layers": "num_hidden_layers", "num_heads": "num_attention_heads"}


class Wav2Vec2Attention(nn.Module):
    """Plain multi-head self-attention (HF ``Wav2Vec2Attention``)."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x):
        b, t, dim = x.shape
        h = self.num_heads
        hd = dim // h

        def heads(y):
            return y.view(b, t, h, hd).transpose(1, 2)  # (B, H, T, hd)

        q = heads(self.q_proj(x)) * hd ** -0.5
        attn = torch.softmax(torch.matmul(q, heads(self.k_proj(x)).transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, heads(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, dim))


class Wav2Vec2Layer(nn.Module):
    """One transformer layer, post-norm or pre-norm ("stable layer norm")."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 stable_layer_norm: bool):
        super().__init__()
        self.stable_layer_norm = stable_layer_norm
        self.attention = Wav2Vec2Attention(hidden_size, num_heads)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        self.intermediate_dense = nn.Linear(hidden_size, intermediate_size)
        self.output_dense = nn.Linear(intermediate_size, hidden_size)
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)

    def feed_forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))

    def forward(self, x):
        if self.stable_layer_norm:
            x = x + self.attention(self.layer_norm(x))
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Wav2Vec2CTC(nn.Module):
    """16 kHz waveform (B, S) → per-frame CTC log-probabilities (B, T, V)."""

    def __init__(self, vocab_size: int, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 num_conv_pos_embeddings: int = 128, num_conv_pos_embedding_groups: int = 16,
                 feat_extract_norm: str = "group", do_stable_layer_norm: bool = False,
                 conv_bias: bool = False):
        super().__init__()
        if feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {feat_extract_norm!r}: expected group or layer")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.conv_kernel = tuple(conv_kernel)
        self.conv_stride = tuple(conv_stride)
        self.feat_extract_norm = feat_extract_norm
        self.do_stable_layer_norm = do_stable_layer_norm
        self.conv_bias = conv_bias
        self.n_convs = len(conv_dim)
        chans = (1,) + tuple(conv_dim)
        for i, (k, s) in enumerate(zip(conv_kernel, conv_stride)):
            setattr(self, f"conv{i}", nn.Conv1d(chans[i], chans[i + 1], k, stride=s,
                                                bias=conv_bias))
            if feat_extract_norm == "layer":
                setattr(self, f"conv{i}_norm", nn.LayerNorm(chans[i + 1], eps=NORM_EPS))
        if feat_extract_norm == "group":
            self.conv0_norm = nn.GroupNorm(conv_dim[0], conv_dim[0], eps=NORM_EPS)
        self.fp_norm = nn.LayerNorm(conv_dim[-1], eps=NORM_EPS)
        self.fp_proj = nn.Linear(conv_dim[-1], hidden_size)
        kp = num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(hidden_size, hidden_size, kp, padding=kp // 2,
                                  groups=num_conv_pos_embedding_groups)
        self.enc_norm = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        for i in range(num_layers):
            setattr(self, f"layer{i}", Wav2Vec2Layer(hidden_size, num_heads, intermediate_size,
                                                     do_stable_layer_norm))
        self.lm_head = nn.Linear(hidden_size, vocab_size)

    def forward(self, wav):
        x = wav[:, None, :]
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
            if self.feat_extract_norm == "group" and i == 0:
                x = self.conv0_norm(x)
            elif self.feat_extract_norm == "layer":
                x = getattr(self, f"conv{i}_norm")(x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x)
        x = self.fp_proj(self.fp_norm(x.transpose(1, 2)))  # (B, T, hidden)
        pos = self.pos_conv(x.transpose(1, 2))
        if self.pos_conv.kernel_size[0] % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        if not self.do_stable_layer_norm:
            x = self.enc_norm(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        if self.do_stable_layer_norm:
            x = self.enc_norm(x)
        return torch.log_softmax(self.lm_head(x), dim=-1)

    def output_frames(self, n_samples: int) -> int:
        """Number of encoder frames produced for an input of n_samples."""
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t

    @property
    def total_stride(self) -> int:
        stride = 1
        for s in self.conv_stride:
            stride *= s
        return stride


# ---------------------------------------------------------------------------
# HuggingFace checkpoints


def convert_torch_wav2vec2_state(
    state_dict: dict,
    num_layers: int,
    feat_extract_norm: str = "group",
    do_stable_layer_norm: bool = False,
) -> dict:
    """Convert a HuggingFace ``Wav2Vec2ForCTC.state_dict()`` into the JAX
    package's flax parameter tree. Dense kernels transpose (out,in)->(in,out);
    conv kernels (out,in,K)->(K,in,out); the weight-normed positional conv is
    fused into a plain kernel."""
    sd = {k: to_numpy(v) for k, v in state_dict.items()}
    p: dict = {}

    fe = "wav2vec2.feature_extractor.conv_layers"
    n_convs = len({k.split(".")[3] for k in sd if k.startswith(fe)})
    for i in range(n_convs):
        w = sd[f"{fe}.{i}.conv.weight"]
        p[f"conv{i}"] = {"kernel": w.transpose(2, 1, 0)}
        if f"{fe}.{i}.conv.bias" in sd:
            p[f"conv{i}"]["bias"] = sd[f"{fe}.{i}.conv.bias"]
        if feat_extract_norm == "layer":
            p[f"conv{i}_norm"] = {
                "scale": sd[f"{fe}.{i}.layer_norm.weight"],
                "bias": sd[f"{fe}.{i}.layer_norm.bias"],
            }
    if feat_extract_norm == "group":
        p["conv0_norm"] = {
            "scale": sd[f"{fe}.0.layer_norm.weight"],
            "bias": sd[f"{fe}.0.layer_norm.bias"],
        }
    p["fp_norm"] = {
        "scale": sd["wav2vec2.feature_projection.layer_norm.weight"],
        "bias": sd["wav2vec2.feature_projection.layer_norm.bias"],
    }
    p["fp_proj"] = {
        "kernel": sd["wav2vec2.feature_projection.projection.weight"].T,
        "bias": sd["wav2vec2.feature_projection.projection.bias"],
    }

    # Weight-normed positional conv: w = g * v / ||v|| with the norm over
    # all dims except the kernel axis (torch weight_norm dim=2).
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    if f"{pc}.parametrizations.weight.original0" in sd:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    else:  # older torch: weight_g / weight_v
        g = sd[f"{pc}.weight_g"]
        v = sd[f"{pc}.weight_v"]
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / norm  # (out, in/groups, K)
    p["pos_conv"] = {"kernel": w.transpose(2, 1, 0), "bias": sd[f"{pc}.bias"]}

    p["enc_norm"] = {
        "scale": sd["wav2vec2.encoder.layer_norm.weight"],
        "bias": sd["wav2vec2.encoder.layer_norm.bias"],
    }

    for i in range(num_layers):
        pre = f"wav2vec2.encoder.layers.{i}"
        p[f"layer{i}"] = {
            "attention": {
                name: {"kernel": sd[f"{pre}.attention.{name}.weight"].T,
                       "bias": sd[f"{pre}.attention.{name}.bias"]}
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "layer_norm": {"scale": sd[f"{pre}.layer_norm.weight"],
                           "bias": sd[f"{pre}.layer_norm.bias"]},
            "intermediate_dense": {
                "kernel": sd[f"{pre}.feed_forward.intermediate_dense.weight"].T,
                "bias": sd[f"{pre}.feed_forward.intermediate_dense.bias"],
            },
            "output_dense": {
                "kernel": sd[f"{pre}.feed_forward.output_dense.weight"].T,
                "bias": sd[f"{pre}.feed_forward.output_dense.bias"],
            },
            "final_layer_norm": {
                "scale": sd[f"{pre}.final_layer_norm.weight"],
                "bias": sd[f"{pre}.final_layer_norm.bias"],
            },
        }
    p["lm_head"] = {
        "kernel": sd["lm_head.weight"].T,
        "bias": sd["lm_head.bias"],
    }
    return {"params": p}


def geometry_from_hf_config(config: dict) -> dict:
    """``Wav2Vec2CTC``'s keyword arguments from a HuggingFace ``config.json``
    (``Wav2Vec2Config``'s default, wav2vec2-base's, for a field it lacks)."""
    geometry = {}
    for ours, default in WAV2VEC2_BASE.items():
        value = config.get(HF_CONFIG_NAMES.get(ours, ours), default)
        geometry[ours] = tuple(value) if isinstance(value, (list, tuple)) else value
    return geometry


def hf_config(geometry: dict) -> dict:
    """The HuggingFace ``config.json`` of a ``Wav2Vec2ForCTC`` of
    ``geometry``."""
    config = {"model_type": "wav2vec2", "architectures": ["Wav2Vec2ForCTC"], "pad_token_id": 0}
    for ours, value in geometry.items():
        config[HF_CONFIG_NAMES.get(ours, ours)] = list(value) if isinstance(value, tuple) else value
    return config


def wav2vec2_from_flax(geometry: dict, params: dict) -> Wav2Vec2CTC:
    """A ``Wav2Vec2CTC`` in eval mode holding a flax tree's weights."""
    from everyvoice_tpu_torch.convert import flax_to_torch

    model = Wav2Vec2CTC(**geometry)
    model.load_state_dict(flax_to_torch(params, model)[0])
    return model.eval().requires_grad_(False)


def read_vocab(path: Path) -> dict:
    """The tokenizer's vocabulary as ``get_vocab`` gives it: ``vocab.json``
    plus the added tokens of ``added_tokens.json`` and of
    ``tokenizer_config.json``'s ``added_tokens_decoder``."""
    vocab = json.loads((path / "vocab.json").read_text("utf8"))
    added = path / "added_tokens.json"
    if added.is_file():
        vocab.update(json.loads(added.read_text("utf8")))
    tokenizer_config = path / "tokenizer_config.json"
    if tokenizer_config.is_file():
        decoder = json.loads(tokenizer_config.read_text("utf8")).get("added_tokens_decoder") or {}
        for index, token in decoder.items():
            vocab.setdefault(token["content"], int(index))
    return vocab


def load_wav2vec2_ctc(model_path, device=None) -> tuple:
    """Load a locally staged HuggingFace wav2vec2-CTC model directory and
    return (model on ``device`` (the card by default), vocab,
    do_normalize). ``do_normalize`` mirrors the model's feature extractor:
    when set, the caller must zero-mean/unit-variance normalize each
    utterance before scoring (as ``Wav2Vec2Processor`` does)."""
    device = resolve_device(device)
    path = Path(model_path)
    if not path.is_dir():
        raise FileNotFoundError(
            f"wav2vec2 model directory not found at {model_path}. Stage a "
            "CTC checkpoint (e.g. facebook/wav2vec2-base-960h) locally on a "
            "machine with network access.")
    for name in ("config.json", "vocab.json", "preprocessor_config.json"):
        if not (path / name).is_file():
            raise FileNotFoundError(f"{path} has no {name}: not a wav2vec2-CTC model directory")
    geometry = geometry_from_hf_config(json.loads((path / "config.json").read_text("utf8")))
    params = convert_torch_wav2vec2_state(read_hf_state_dict(path), geometry["num_layers"],
                                          geometry["feat_extract_norm"],
                                          geometry["do_stable_layer_norm"])
    model = wav2vec2_from_flax(geometry, params).to(device)
    features = json.loads((path / "preprocessor_config.json").read_text("utf8"))
    return model, read_vocab(path), bool(features.get("do_normalize", True))


def window_plan(model: Wav2Vec2CTC, n_samples: int, window_s: float = 20.0,
                overlap_s: float = 2.0, sample_rate: int = 16000) -> tuple:
    """(window length in samples, the windows' first samples) with which
    ``windowed_log_probs`` scores ``n_samples`` of audio: one window when the
    audio fits in it, else windows of ``window_s`` (a whole number of frames)
    stepping by their frames less ``overlap_s``, the last reaching the end."""
    stride = model.total_stride
    win = int(window_s * sample_rate) // stride * stride
    hop_frames = model.output_frames(win) - int(overlap_s * sample_rate / stride)
    if hop_frames <= 0:
        raise ValueError(f"the overlap ({overlap_s} s) must be smaller than the window "
                         f"({window_s} s)")
    starts = [0]
    while starts[-1] + win < n_samples:
        starts.append(starts[-1] + hop_frames * stride)
    return win, starts


@torch.no_grad()
@no_tf32()
def windowed_log_probs(
    model: Wav2Vec2CTC,
    audio_16k: np.ndarray,
    window_s: float = 20.0,
    overlap_s: float = 2.0,
    sample_rate: int = 16000,
) -> np.ndarray:
    """Score arbitrarily long audio on the model's device in fixed windows.

    The audio is cut into `window_s`-second windows that overlap by
    `overlap_s` (``window_plan``); each output frame is taken from the window
    in which it lies farthest from a window edge (so every emitted frame has
    at least overlap/2 of real attention context on each side, except at the
    audio's own boundaries). Returns (T, V) float32 with T = the frame count
    the model would produce for the full audio in one pass.
    """
    device = next(model.parameters()).device
    stride = model.total_stride
    audio_16k = np.asarray(audio_16k, np.float32)
    win, starts = window_plan(model, len(audio_16k), window_s, overlap_s, sample_rate)
    total_frames = max(model.output_frames(len(audio_16k)), 1)
    frames_per_win = model.output_frames(win)

    def score(chunk: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(chunk)[None].to(device))[0].float().cpu().numpy()

    if len(starts) == 1:
        # Fits in one window: score the unpadded audio directly (zero-pad
        # would perturb the tail frames for no benefit).
        return score(audio_16k)
    out = np.zeros((total_frames, model.vocab_size), np.float32)
    filled = np.full(total_frames, -1.0)  # edge distance of current value

    for start in starts:
        chunk = audio_16k[start : start + win]
        pad = win - len(chunk)
        if pad:
            chunk = np.pad(chunk, (0, pad))
        lp = score(chunk)
        first_global = start // stride
        last = start == starts[-1]

        # Per-frame distance from the nearer window edge; the audio's own
        # boundaries don't count as edges (there is no deeper context there),
        # and frames past the real-audio end count distance to that end.
        f = np.arange(frames_per_win)
        real_frames = min(frames_per_win, model.output_frames(len(audio_16k) - start))
        right = np.maximum(real_frames - 1 - f, 0)
        if start == 0:
            edge_dist = right.astype(float)
        elif last:
            edge_dist = f.astype(float)
        else:
            edge_dist = np.minimum(f, right).astype(float)

        g = first_global + f
        valid = g < total_frames
        g, edge_dist, lp = g[valid], edge_dist[valid], lp[valid]
        better = edge_dist > filled[g]
        out[g[better]] = lp[better]
        filled[g[better]] = edge_dist[better]
    return out

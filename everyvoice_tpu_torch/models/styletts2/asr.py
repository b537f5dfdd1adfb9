"""The ASR text aligner of StyleTTS2, in PyTorch (counterpart of
everyvoice_tpu/models/styletts2/asr.py).

``ASRCNN`` is the published aligner (everyvoice/styletts2-asr-aligner's
``epoch_00080.pth`` with its ``config.yml``): an MFCC front end (an
orthonormal DCT over the mel bins), a stride-2 conv stem, dilated residual
conv blocks, a CTC head, and ``ASRS2S``, a teacher-forced LSTM decoder with
location-sensitive attention over the 2× downsampled frames that runs N+1
steps (a start step, then one a token). Its attention, stripped of the start
step and repeated back to mel frames (``asr_attention_to_tma``), is the TMA
attention StyleTTS2 aligns with once the aligner is staged.

The module keeps the JAX package's parameter names and, for the decoder,
its flax shapes (kernels (in, out), the location conv (K, 2, filters)), so
``convert.py`` maps a checkpoint's ``text_aligner`` subtree without a
layout change there. In training the decoder takes two draws: a (B, N)
mask of the teacher tokens swapped for the start embedding (probability
0.1) and an (N+1, B, hidden) keep mask (probability 0.5) of the hidden
state before the symbol head; a caller passes both (``draws``), the
deterministic pass none.

``convert_torch_asr_state`` turns the published state dict into the flax
tree, remapping the token table and both symbol heads onto the project's
symbols and keeping the pretrained table's start row as the start
embedding; ``load_asr_params`` reads the checkpoint and its geometry.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.models.layers import lengths_to_mask
from everyvoice_tpu_torch.models.styletts2.plbert import (
    load_torch_or_npz_state,
    read_model_params,
    remap_rows,
    symbol_row_map,
)
from everyvoice_tpu_torch.utils.hf_weights import to_numpy

# everyvoice/styletts2-asr-aligner config.yml model_params.
ASR_GEOMETRY = dict(input_dim=80, hidden_dim=256, n_token=178, n_layers=6,
                    token_embedding_dim=512)
GROUP_NORM_EPS = 1e-5
LOCATION_FILTERS = 32
LOCATION_KERNEL = 63
UNK_RATE = 0.1   # teacher tokens swapped for the start embedding in training
KEEP_RATE = 0.5  # the decoder's hidden dropout keep probability in training
MASKED = -1e9


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_mels, n_mfcc), as torchaudio's
    ``create_dct`` makes it."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    basis = np.cos(math.pi / n_mels * (n + 0.5) * k)
    basis *= np.where(k == 0, math.sqrt(1.0 / n_mels), math.sqrt(2.0 / n_mels))
    return basis.astype(np.float32)


class ASRConvBlock(nn.Module):
    """Three residual stages (a conv of dilation 3**i, ReLU, GroupNorm(8), a
    conv, ReLU) and a GroupNorm(1), on (B, C, L)."""

    def __init__(self, hidden: int, n_inner: int = 3):
        super().__init__()
        self.n_inner = n_inner
        for i in range(n_inner):
            d = 3 ** i
            setattr(self, f"dilated{i}", nn.Conv1d(hidden, hidden, 3, dilation=d, padding=d))
            setattr(self, f"norm{i}", nn.GroupNorm(8, hidden, eps=GROUP_NORM_EPS))
            setattr(self, f"pointwise{i}", nn.Conv1d(hidden, hidden, 3, padding=1))
        self.out_norm = nn.GroupNorm(1, hidden, eps=GROUP_NORM_EPS)

    def forward(self, x):
        for i in range(self.n_inner):
            y = getattr(self, f"norm{i}")(F.relu(getattr(self, f"dilated{i}")(x)))
            x = x + F.relu(getattr(self, f"pointwise{i}")(y))
        return self.out_norm(x)


class ASRS2S(nn.Module):
    """The location-sensitive-attention LSTM decoder, teacher forced.
    Returns (hidden (B, N+1, H), logits (B, N+1, n_token), attention
    (B, N+1, L)); step 0 is the start step."""

    def __init__(self, n_token: int, embedding_dim: int = 512, hidden_dim: int = 128):
        super().__init__()
        h, e = hidden_dim, embedding_dim
        self.hidden_dim = h
        self.embedding = nn.Parameter(torch.zeros(n_token, e))
        self.sos_embedding = nn.Parameter(torch.zeros(e))
        self.w_ih = nn.Parameter(torch.zeros(e + h, 4 * h))
        self.w_hh = nn.Parameter(torch.zeros(h, 4 * h))
        self.b_lstm = nn.Parameter(torch.zeros(4 * h))
        self.query_kernel = nn.Parameter(torch.zeros(h, h))
        self.memory_kernel = nn.Parameter(torch.zeros(h, h))
        self.v_kernel = nn.Parameter(torch.zeros(h, 1))
        self.loc_conv = nn.Parameter(torch.zeros(LOCATION_KERNEL, 2, LOCATION_FILTERS))
        self.loc_dense = nn.Parameter(torch.zeros(LOCATION_FILTERS, h))
        self.proj_hidden_kernel = nn.Parameter(torch.zeros(2 * h, h))
        self.proj_hidden_bias = nn.Parameter(torch.zeros(h))
        self.proj_symbols_kernel = nn.Parameter(torch.zeros(h, n_token))
        self.proj_symbols_bias = nn.Parameter(torch.zeros(n_token))

    def forward(self, memory, memory_valid, text, draws: Optional[tuple] = None):
        b, length, _ = memory.shape
        n, h, e = text.shape[1], self.hidden_dim, self.embedding.shape[1]
        processed = memory @ self.memory_kernel  # (B, L, H)
        inputs = self.embedding[text]  # (B, N, E)
        if draws is not None:
            unk, keep = draws
            inputs = torch.where(unk[..., None], self.sos_embedding, inputs)
            drop = keep.to(memory.dtype) / KEEP_RATE  # (N+1, B, H)
        inputs = torch.cat([self.sos_embedding.expand(b, 1, e), inputs], dim=1)
        # The embedding's share of every step's gates at once; the rest
        # (the context and the hidden state) step by step.
        emb_gates = inputs @ self.w_ih[:e] + self.b_lstm  # (B, N+1, 4H)
        w_ctx = self.w_ih[e:]
        loc_weight = self.loc_conv.permute(2, 1, 0)  # (filters, 2, K)
        h_t = c_t = memory.new_zeros(b, h)
        w_prev = w_cum = memory.new_zeros(b, length)
        ctx = memory.new_zeros(b, memory.shape[-1])
        hiddens, logits, attns = [], [], []
        for step in range(n + 1):
            gates = emb_gates[:, step] + ctx @ w_ctx + h_t @ self.w_hh
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c_t = torch.sigmoid(gf) * c_t + torch.sigmoid(gi) * torch.tanh(gg)
            h_t = torch.sigmoid(go) * torch.tanh(c_t)
            loc = F.conv1d(torch.stack([w_prev, w_cum], dim=1), loc_weight,
                           padding=LOCATION_KERNEL // 2)  # (B, filters, L)
            loc = loc.transpose(1, 2) @ self.loc_dense  # (B, L, H)
            q = (h_t @ self.query_kernel)[:, None, :]
            energies = (torch.tanh(q + loc + processed) @ self.v_kernel)[..., 0]
            w = torch.softmax(energies.masked_fill(~memory_valid, MASKED), dim=-1)
            ctx = torch.einsum("bl,blh->bh", w, memory)
            hidden = torch.tanh(torch.cat([h_t, ctx], dim=-1) @ self.proj_hidden_kernel
                                + self.proj_hidden_bias)
            dropped = hidden * drop[step] if draws is not None else hidden
            logits.append(dropped @ self.proj_symbols_kernel + self.proj_symbols_bias)
            hiddens.append(hidden)
            attns.append(w)
            w_prev, w_cum = w, w_cum + w
        return torch.stack(hiddens, 1), torch.stack(logits, 1), torch.stack(attns, 1)


class ASRCNN(nn.Module):
    """Mel (B, T, n_mels) and text (B, N) → (CTC logits (B, ceil(T/2),
    n_token), decoder logits (B, N+1, n_token), attention (B, N+1,
    ceil(T/2)))."""

    def __init__(self, n_token: int, input_dim: int = 80, hidden_dim: int = 256,
                 n_layers: int = 6, token_embedding_dim: int = 512):
        super().__init__()
        self.n_layers = n_layers
        self.register_buffer("dct", torch.from_numpy(dct_matrix(input_dim // 2, input_dim)),
                             persistent=False)
        self.init_cnn = nn.Conv1d(input_dim // 2, hidden_dim, 7, stride=2, padding=3)
        for i in range(n_layers):
            setattr(self, f"block{i}", ASRConvBlock(hidden_dim))
        self.projection = nn.Conv1d(hidden_dim, hidden_dim // 2, 1)
        self.ctc_dense1 = nn.Linear(hidden_dim // 2, hidden_dim)
        self.ctc_dense2 = nn.Linear(hidden_dim, n_token)
        self.s2s = ASRS2S(n_token, token_embedding_dim, hidden_dim // 2)

    def encode(self, mel):
        x = self.init_cnn((mel @ self.dct).transpose(1, 2))  # MFCCs, (B, H, ceil(T/2))
        for i in range(self.n_layers):
            x = getattr(self, f"block{i}")(x)
        return self.projection(x).transpose(1, 2)  # (B, ceil(T/2), H/2)

    def forward(self, mel, mel_lengths, text, draws: Optional[tuple] = None):
        memory = self.encode(mel)
        ctc = self.ctc_dense2(F.relu(self.ctc_dense1(memory)))
        valid = lengths_to_mask((mel_lengths + 1) // 2, memory.shape[1])
        _, s2s_logits, attn = self.s2s(memory, valid, text, draws)
        return ctc, s2s_logits, attn


def draw_asr_masks(b: int, n: int, hidden: int, generator: torch.Generator, device) -> tuple:
    """The decoder's training draws: the (B, N) start-embedding swap mask
    and the (N+1, B, hidden) keep mask."""
    unk = torch.rand((b, n), generator=generator, device=device) < UNK_RATE
    keep = torch.rand((n + 1, b, hidden), generator=generator, device=device) < KEEP_RATE
    return unk, keep


def asr_attention_to_tma(attn, t_mel: int, src_mask, mel_mask) -> tuple:
    """Decoder attention (B, N+1, L) → (attn_soft, attn_logprob), each
    (B, T_mel, N): the start step dropped, each frame repeated twice (the
    stem's stride), cut or zero-padded to ``t_mel``, log with 1e-8, padded
    tokens at -1e9 in the log and padded frames or tokens at 0 in the soft
    attention."""
    attn = torch.repeat_interleave(attn[:, 1:, :].transpose(1, 2), 2, dim=1)  # (B, 2L, N)
    if attn.shape[1] < t_mel:
        attn = F.pad(attn, (0, 0, 0, t_mel - attn.shape[1]))
    else:
        attn = attn[:, :t_mel]
    logprob = torch.log(attn + 1e-8).masked_fill(~src_mask[:, None, :], MASKED)
    soft = attn * (mel_mask[:, :, None] & src_mask[:, None, :]).to(attn.dtype)
    return soft, logprob


# ---------------------------------------------------------------------------
# the published checkpoint


def _conv1d(w, b=None) -> dict:
    out = {"kernel": w.transpose(2, 1, 0)}  # (O, I, K) → (K, I, O)
    if b is not None:
        out["bias"] = b
    return out


def convert_torch_asr_state(state_dict: dict, n_layers: int = 6,
                            symbol_rows: Optional[np.ndarray] = None,
                            vocab_size: Optional[int] = None, sos_index: int = 1) -> dict:
    """The published ``ASRCNN`` state dict → the JAX package's flax tree
    (no ``params`` wrapper). With ``symbol_rows`` the token table and both
    symbol heads are remapped onto the project's symbols (zero rows where a
    symbol is absent), and the table's ``sos_index`` row becomes the start
    embedding."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): to_numpy(v)
          for k, v in state_dict.items()}

    def rows(mat):
        return remap_rows(mat, symbol_rows, vocab_size)

    p: dict = {
        "init_cnn": _conv1d(sd["init_cnn.conv.weight"], sd["init_cnn.conv.bias"]),
        "projection": _conv1d(sd["projection.conv.weight"], sd["projection.conv.bias"]),
        "ctc_dense1": {"kernel": sd["ctc_linear.0.linear_layer.weight"].T,
                       "bias": sd["ctc_linear.0.linear_layer.bias"]},
        "ctc_dense2": {"kernel": rows(sd["ctc_linear.2.linear_layer.weight"]).T,
                       "bias": rows(sd["ctc_linear.2.linear_layer.bias"])},
    }
    for i in range(n_layers):
        block: dict = {}
        for j in range(3):
            inner = f"cnns.{i}.0.blocks.{j}"
            block[f"dilated{j}"] = _conv1d(sd[f"{inner}.0.conv.weight"], sd[f"{inner}.0.conv.bias"])
            block[f"norm{j}"] = {"scale": sd[f"{inner}.2.weight"], "bias": sd[f"{inner}.2.bias"]}
            block[f"pointwise{j}"] = _conv1d(sd[f"{inner}.4.conv.weight"],
                                             sd[f"{inner}.4.conv.bias"])
        block["out_norm"] = {"scale": sd[f"cnns.{i}.1.weight"], "bias": sd[f"cnns.{i}.1.bias"]}
        p[f"block{i}"] = block
    a = "asr_s2s.attention_layer"
    emb = sd["asr_s2s.embedding.weight"]
    p["s2s"] = {
        "embedding": rows(emb),
        "sos_embedding": emb[sos_index],
        "w_ih": sd["asr_s2s.decoder_rnn.weight_ih"].T,
        "w_hh": sd["asr_s2s.decoder_rnn.weight_hh"].T,
        "b_lstm": sd["asr_s2s.decoder_rnn.bias_ih"] + sd["asr_s2s.decoder_rnn.bias_hh"],
        "query_kernel": sd[f"{a}.query_layer.linear_layer.weight"].T,
        "memory_kernel": sd[f"{a}.memory_layer.linear_layer.weight"].T,
        "v_kernel": sd[f"{a}.v.linear_layer.weight"].T,
        "loc_conv": sd[f"{a}.location_layer.location_conv.conv.weight"].transpose(2, 1, 0),
        "loc_dense": sd[f"{a}.location_layer.location_dense.linear_layer.weight"].T,
        "proj_hidden_kernel": sd["asr_s2s.project_to_hidden.0.linear_layer.weight"].T,
        "proj_hidden_bias": sd["asr_s2s.project_to_hidden.0.linear_layer.bias"],
        "proj_symbols_kernel": rows(sd["asr_s2s.project_to_n_symbols.weight"]).T,
        "proj_symbols_bias": rows(sd["asr_s2s.project_to_n_symbols.bias"]),
    }
    return p


def geometry_from_config_yml(config_path) -> dict:
    """The aligner's geometry from its ``config.yml`` ``model_params``."""
    mp = read_model_params(config_path)
    return {key: int(mp.get(key, value)) for key, value in ASR_GEOMETRY.items()}


def load_asr_params(checkpoint_path, config_path=None,
                    project_symbols: Optional[Sequence[str]] = None,
                    pretrained_symbols: Optional[Sequence[str]] = None) -> tuple:
    """(geometry, flax tree) of ``pretrained.asr.local_checkpoint`` (a
    ``{'model': state}`` payload or a bare state dict) and its
    ``config.yml``; with the project's symbols, ``n_token`` becomes their
    count and the token rows are remapped."""
    state = load_torch_or_npz_state(checkpoint_path)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    geometry = (geometry_from_config_yml(config_path) if config_path is not None
                else dict(ASR_GEOMETRY))
    rows = None
    if project_symbols is not None:
        rows = symbol_row_map(project_symbols, pretrained_symbols or [])
        geometry["n_token"] = len(rows)
    params = convert_torch_asr_state(state, geometry["n_layers"], rows, geometry["n_token"])
    return geometry, params

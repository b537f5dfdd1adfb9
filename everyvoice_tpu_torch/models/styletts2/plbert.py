"""PL-BERT, the phoneme-level ALBERT text encoder of StyleTTS2, in PyTorch
(counterpart of everyvoice_tpu/models/styletts2/plbert.py's ``AlbertLayer``
and ``PLBERT``): token ids → (B, N, hidden) contextual states, matching
``transformers.AlbertModel``'s ``last_hidden_state``. One post-norm layer
(LayerNorm eps 1e-12, ``gelu_new``) is shared by all ``num_layers``
passes; padded keys are masked with -1e9. Float32.

Serving builds the module from the geometry a StyleTTS2 checkpoint records
and loads its weights from the checkpoint. Training loads the published
checkpoint (``step_*.t7`` with ``config.yml``) through ``load_plbert_params``:
the torch state dict is converted to the JAX package's flax layout (the
layout every StyleTTS2 checkpoint holds) and from there into the module,
its 178-row embedding table remapped onto the project's symbols.
``load_torch_or_npz_state`` and ``symbol_row_map`` are shared with the other
pretrained components' loaders (``jdc.py``, ``asr.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.utils.hf_weights import to_numpy

logger = logging.getLogger(__name__)

PLBERT_NORM_EPS = 1e-12
MASKED = -1e9

# papercup-ai/multilingual-pl-bert's model_params (its config.yml).
MULTILINGUAL_PLBERT = dict(
    vocab_size=178,
    hidden_size=768,
    num_layers=12,
    num_heads=12,
    intermediate_size=2048,
    embedding_size=128,
    max_position_embeddings=512,
)


class AlbertLayer(nn.Module):
    """Post-norm self-attention, then a post-norm feed-forward block."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.attn_out = nn.Linear(hidden_size, hidden_size)
        self.attn_norm = nn.LayerNorm(hidden_size, eps=PLBERT_NORM_EPS)
        self.ffn = nn.Linear(hidden_size, intermediate_size)
        self.ffn_output = nn.Linear(intermediate_size, hidden_size)
        self.full_norm = nn.LayerNorm(hidden_size, eps=PLBERT_NORM_EPS)

    def forward(self, x, mask):
        b, t, dim = x.shape
        h = self.num_heads

        def heads(layer):
            return layer(x).view(b, t, h, dim // h).transpose(1, 2)

        q = heads(self.query) * (dim // h) ** -0.5
        logits = q @ heads(self.key).transpose(-1, -2)
        logits = logits.masked_fill(~mask[:, None, None, :], MASKED)
        ctx = torch.softmax(logits, dim=-1) @ heads(self.value)
        ctx = self.attn_out(ctx.transpose(1, 2).reshape(b, t, dim))
        x = self.attn_norm(x + ctx)
        ff = self.ffn_output(F.gelu(self.ffn(x), approximate="tanh"))
        return self.full_norm(x + ff)


class PLBERT(nn.Module):
    """ALBERT: factorized embeddings (word + position + token type 0, a
    LayerNorm, a projection to ``hidden_size``), then ``shared_layer``
    ``num_layers`` times."""

    def __init__(self, vocab_size: int, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 2048, embedding_size: int = 128,
                 max_position_embeddings: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.word_embeddings = nn.Parameter(torch.zeros(vocab_size, embedding_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(max_position_embeddings, embedding_size))
        self.token_type_embeddings = nn.Parameter(torch.zeros(2, embedding_size))
        self.embed_norm = nn.LayerNorm(embedding_size, eps=PLBERT_NORM_EPS)
        self.embedding_hidden_mapping_in = nn.Linear(embedding_size, hidden_size)
        self.shared_layer = AlbertLayer(hidden_size, num_heads, intermediate_size)

    def forward(self, tokens, mask):
        t = tokens.shape[1]
        x = (self.word_embeddings[tokens] + self.position_embeddings[None, :t]
             + self.token_type_embeddings[0][None, None])
        x = self.embedding_hidden_mapping_in(self.embed_norm(x))
        for _ in range(self.num_layers):
            x = self.shared_layer(x, mask)
        return x


# ---------------------------------------------------------------------------
# published checkpoints


def load_torch_or_npz_state(path) -> dict:
    """The payload of a torch checkpoint (``torch.load`` with
    ``weights_only=False``, as the published ``.t7``/``.pth`` files pickle
    more than tensors), or ``{key: array}`` of an ``.npz`` archive with the
    same keys."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(str(path)) as archive:
            return {key: archive[key] for key in archive.files}
    return torch.load(str(path), map_location="cpu", weights_only=False)


def strip_plbert_training_prefixes(state_dict: dict) -> dict:
    """A PL-BERT ``step_*.t7`` holds ``{'net': state}`` keyed
    ``module.encoder.<AlbertModel key>``; reduce it to the AlbertModel's
    own keys (a plain AlbertModel state dict passes through)."""
    if "net" in state_dict and isinstance(state_dict["net"], dict):
        state_dict = state_dict["net"]
    out = {(k[len("module."):] if k.startswith("module.") else k): v
           for k, v in state_dict.items()}
    if any(k.startswith("encoder.embeddings.") for k in out):
        out = {k[len("encoder."):]: v for k, v in out.items() if k.startswith("encoder.")}
    return out


def remap_rows(mat: np.ndarray, symbol_rows: Optional[np.ndarray],
               n_rows: Optional[int] = None) -> np.ndarray:
    """Rows of ``mat`` picked by ``symbol_rows`` (entry i: the pretrained
    row of project symbol i, -1 for a zero row), ``n_rows`` long."""
    if symbol_rows is None:
        return mat
    rows = np.asarray(symbol_rows)
    out = np.zeros((n_rows if n_rows is not None else len(rows),) + mat.shape[1:], mat.dtype)
    valid = rows >= 0
    out[np.nonzero(valid)[0]] = mat[rows[valid]]
    return out


def convert_torch_plbert_state(state_dict: dict, symbol_rows: Optional[np.ndarray] = None,
                               vocab_size: Optional[int] = None) -> dict:
    """A ``transformers.AlbertModel`` state dict (one hidden group, one
    inner layer) → the ``PLBERT`` flax tree (``{"params": ...}``), dense
    kernels (in, out); the word embeddings remapped by ``symbol_rows``."""
    sd = {k: to_numpy(v) for k, v in strip_plbert_training_prefixes(state_dict).items()}
    lp = "encoder.albert_layer_groups.0.albert_layers.0"

    def dense(key):
        return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}

    def norm(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    return {"params": {
        "word_embeddings": remap_rows(sd["embeddings.word_embeddings.weight"], symbol_rows,
                                      vocab_size),
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd["embeddings.token_type_embeddings.weight"],
        "embed_norm": norm("embeddings.LayerNorm"),
        "embedding_hidden_mapping_in": dense("encoder.embedding_hidden_mapping_in"),
        "shared_layer": {
            "query": dense(f"{lp}.attention.query"), "key": dense(f"{lp}.attention.key"),
            "value": dense(f"{lp}.attention.value"), "attn_out": dense(f"{lp}.attention.dense"),
            "attn_norm": norm(f"{lp}.attention.LayerNorm"), "ffn": dense(f"{lp}.ffn"),
            "ffn_output": dense(f"{lp}.ffn_output"),
            "full_norm": norm(f"{lp}.full_layer_layer_norm"),
        },
    }}


def symbol_row_map(project_symbols: Sequence[str], pretrained_symbols: Sequence[str]) -> np.ndarray:
    """Row i: the index of project symbol i in the pretrained symbol table,
    or -1 where it is absent (a zero row; ``check pretrained-symbols``
    suggests substitutions)."""
    index = {s: i for i, s in enumerate(pretrained_symbols)}
    rows = np.asarray([index.get(s, -1) for s in project_symbols], dtype=np.int64)
    missing = [s for s in project_symbols if s not in index]
    if missing and pretrained_symbols:
        logger.warning(
            f"{len(missing)} project symbols are not in the pretrained symbol table (first "
            f"few: {missing[:8]}); their embedding rows start at zero. Run "
            "`everyvoice-tpu-torch check pretrained-symbols` for suggested substitutions.")
    return rows


def read_model_params(config_path) -> dict:
    """The ``model_params`` section of a published ``config.yml`` (the whole
    document where it has none)."""
    from everyvoice_tpu_torch.utils import yaml_lite

    raw = yaml_lite.load(Path(config_path).read_text(encoding="utf8")) or {}
    return raw.get("model_params", raw)


PLBERT_CONFIG_NAMES = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
                       "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
                       "intermediate_size": "intermediate_size",
                       "embedding_size": "embedding_size",
                       "max_position_embeddings": "max_position_embeddings"}


def geometry_from_config_yml(config_path) -> dict:
    """PL-BERT's geometry from its ``config.yml`` (AlbertConfig names)."""
    mp = read_model_params(config_path)
    geometry = dict(MULTILINGUAL_PLBERT)
    for theirs, ours in PLBERT_CONFIG_NAMES.items():
        if theirs in mp:
            geometry[ours] = int(mp[theirs])
    return geometry


def load_plbert_params(checkpoint_path, config_path=None,
                       project_symbols: Optional[Sequence[str]] = None,
                       pretrained_symbols: Optional[Sequence[str]] = None) -> tuple:
    """(geometry, flax tree) of a published PL-BERT checkpoint; with the
    project's symbols, the vocabulary becomes theirs and the embedding rows
    are remapped from the pretrained table."""
    state = load_torch_or_npz_state(checkpoint_path)
    geometry = (geometry_from_config_yml(config_path) if config_path is not None
                else dict(MULTILINGUAL_PLBERT))
    rows = None
    if project_symbols is not None:
        rows = symbol_row_map(project_symbols, pretrained_symbols or [])
        geometry["vocab_size"] = len(rows)
    return geometry, convert_torch_plbert_state(state, rows, geometry["vocab_size"])

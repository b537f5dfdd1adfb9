"""PL-BERT, the phoneme-level ALBERT text encoder of StyleTTS2, in PyTorch
(counterpart of everyvoice_tpu/models/styletts2/plbert.py's ``AlbertLayer``
and ``PLBERT``): token ids → (B, N, hidden) contextual states, matching
``transformers.AlbertModel``'s ``last_hidden_state``. One post-norm layer
(LayerNorm eps 1e-12, ``gelu_new``) is shared by all ``num_layers``
passes; padded keys are masked with -1e9. Float32.

The torch checkpoint loaders of the JAX module (PL-BERT's ``step_*.t7``)
are training's and come with the training slice; serving builds the module
from the geometry a StyleTTS2 checkpoint records and loads its weights from
the checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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

"""Parameter conversion between the JAX package's flax trees and the port's
torch modules, both ways.

A flax tree is the nested dict a checkpoint's ``state_dict`` holds
(``{"params": {...}}``, numpy leaves). Module names there are flax's
automatic ones (``ConformerBlock_0/FeedForwardModule_1/Dense_0``,
``WeightNorm_{i}/Conv_0/kernel/scale``, ``ResBlock1_{stage·chains+chain}``);
the tables below pair each leaf with a torch parameter and a layout change:

- Dense kernel (in, out) ↔ Linear weight (out, in);
- Conv kernel (k, in/groups, out) ↔ Conv1d weight (out, in/groups, k);
- ConvTranspose kernel (k, in, out) ↔ torch's (in, out, k) with the taps
  reversed (flax does not flip the kernel; torch's transposed conv does);
- the MPD's 2-D Conv kernel (k, 1, in, out) ↔ Conv2d weight (out, in, k, 1);
- attention query/key/value kernels (dim, heads, head_dim) and biases
  (heads, head_dim) ↔ Linear (heads·head_dim, dim) and (heads·head_dim,);
  the out kernel (heads, head_dim, dim) ↔ Linear (dim, heads·head_dim).

``flax_to_torch`` consumes every leaf and raises on a leaf it did not use or
a torch parameter it did not fill. FastSpeech2's ``alignment`` subtree (the
alignment encoder, trained with the model) maps both ways like the rest. A
tree that has no ``alignment`` subtree at all (the JAX package initialises
one only when its ``init`` sees a mel) leaves the model's own alignment
weights in place, and ``flax_to_torch`` reports the flax paths it lacked.
``torch_to_flax`` is the inverse; it lets a machine without JAX write
checkpoints in the JAX package's layout. Both also map an optimizer's
moments, which have the parameters' shapes.

HiFiGAN's generator maps to ``{"params": ...}`` (``ResBlock1_j`` or
``ResBlock2_j``; the post conv or the iSTFT head as ``Conv_1``), its
``HiFiGANDiscriminators`` to ``{"mpd": {"params": ...}, "msd": {"params":
...}}`` (weight-normed ``PeriodDiscriminator_i`` and ``ScaleDiscriminator_i``
convs, and ``SpectralNormConv_u``'s plain kernel and bias), and
``hifigan_tree`` joins the two into the JAX trainer's ``{"generator": ...,
"discriminators": ...}`` checkpoint tree.
"""

from __future__ import annotations

import numpy as np
import torch

from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import (
    HiFiGANDiscriminators,
    HiFiGANGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    SpectralNormConv1d,
)
from everyvoice_tpu_torch.models.layers import ConformerStack, VariancePredictor

OPTIONAL_SUBTREES = ("alignment",)


# Each kind: (flax → torch, torch → flax given the flax shape's head count).
def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(2, 1, 0)
    if kind == "conv_transpose":
        return arr.transpose(1, 2, 0)[..., ::-1]
    if kind == "conv2d":
        return arr.transpose(3, 2, 0, 1)
    if kind == "mha_in":
        return arr.reshape(arr.shape[0], -1).T
    if kind == "mha_in_bias":
        return arr.reshape(-1)
    if kind == "mha_out":
        return arr.reshape(-1, arr.shape[-1]).T
    return arr


def _to_flax(arr: np.ndarray, kind: str, heads: int) -> np.ndarray:
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(2, 1, 0)
    if kind == "conv_transpose":
        return arr[..., ::-1].transpose(2, 0, 1)
    if kind == "conv2d":
        return arr.transpose(2, 3, 1, 0)
    if kind == "mha_in":
        return arr.T.reshape(arr.shape[1], heads, -1)
    if kind == "mha_in_bias":
        return arr.reshape(heads, -1)
    if kind == "mha_out":
        return arr.T.reshape(heads, -1, arr.shape[0])
    return arr


def _dense(fpath, tkey):
    return [(fpath + ("kernel",), f"{tkey}.weight", "dense"),
            (fpath + ("bias",), f"{tkey}.bias", "plain")]


def _conv(fpath, tkey):
    return [(fpath + ("kernel",), f"{tkey}.weight", "conv"),
            (fpath + ("bias",), f"{tkey}.bias", "plain")]


def _norm(fpath, tkey):
    return [(fpath + ("scale",), f"{tkey}.weight", "plain"),
            (fpath + ("bias",), f"{tkey}.bias", "plain")]


def _embed(fpath, tkey):
    return [(fpath + ("embedding",), f"{tkey}.weight", "plain")]


def _conformer(fpath, tkey, stack: ConformerStack):
    out = []
    for i in range(len(stack.blocks)):
        f, t = fpath + (f"ConformerBlock_{i}",), f"{tkey}.blocks.{i}"
        for j, ff in ((0, "ff1"), (1, "ff2")):
            g = f + (f"FeedForwardModule_{j}",)
            out += _norm(g + ("LayerNorm_0",), f"{t}.{ff}.norm")
            out += _dense(g + ("Dense_0",), f"{t}.{ff}.fc1")
            out += _dense(g + ("Dense_1",), f"{t}.{ff}.fc2")
        out += _norm(f + ("LayerNorm_0",), f"{t}.attn_norm")
        out += _norm(f + ("LayerNorm_1",), f"{t}.final_norm")
        a = f + ("MultiHeadDotProductAttention_0",)
        for name in ("query", "key", "value"):
            out += [(a + (name, "kernel"), f"{t}.attn.{name}.weight", "mha_in"),
                    (a + (name, "bias"), f"{t}.attn.{name}.bias", "mha_in_bias")]
        out += [(a + ("out", "kernel"), f"{t}.attn.out.weight", "mha_out"),
                (a + ("out", "bias"), f"{t}.attn.out.bias", "plain")]
        c = f + ("ConformerConvModule_0",)
        out += _norm(c + ("LayerNorm_0",), f"{t}.conv.norm")
        out += _dense(c + ("Dense_0",), f"{t}.conv.pointwise_in")
        out += _conv(c + ("Conv_0",), f"{t}.conv.depthwise")
        out += _norm(c + ("GroupNorm_0",), f"{t}.conv.group_norm")
        out += _dense(c + ("Dense_1",), f"{t}.conv.pointwise_out")
    return out


def _predictor(fpath, tkey, vp: VariancePredictor):
    out = []
    for i in range(len(vp.convs)):
        if vp.depthwise:
            out += _conv(fpath + (f"Conv_{2 * i}",), f"{tkey}.dw_convs.{i}")
            out += _conv(fpath + (f"Conv_{2 * i + 1}",), f"{tkey}.convs.{i}")
        else:
            out += _conv(fpath + (f"Conv_{i}",), f"{tkey}.convs.{i}")
        out += _norm(fpath + (f"LayerNorm_{i}",), f"{tkey}.norms.{i}")
    return out + _dense(fpath + ("Dense_0",), f"{tkey}.head")


def _fs2_table(model: FastSpeech2) -> list:
    p = ("params",)
    out = _embed(p + ("symbol_embed",), "symbol_embed")
    out += _conformer(p + ("encoder",), "encoder", model.encoder)
    out += _conformer(p + ("decoder",), "decoder", model.decoder)
    if model.speaker_embed is not None:
        out += _embed(p + ("speaker_embed",), "speaker_embed")
    if model.language_embed is not None:
        out += _embed(p + ("language_embed",), "language_embed")
    for name in ("duration", "pitch", "energy"):
        out += _predictor(p + (f"{name}_predictor",), f"{name}_predictor",
                          getattr(model, f"{name}_predictor"))
    out += _embed(p + ("pitch_embed",), "pitch_embed")
    out += _embed(p + ("energy_embed",), "energy_embed")
    out += _dense(p + ("mel_head",), "mel_head")
    if model.alignment is not None:
        a = p + ("alignment",)
        for i, name in enumerate(("key_in", "key_out", "query_in", "query_mid", "query_out")):
            out += _conv(a + (f"Conv_{i}",), f"alignment.{name}")
    if model.postnet is not None:
        for i in range(len(model.postnet.convs)):
            out += _conv(p + ("postnet", f"Conv_{i}"), f"postnet.convs.{i}")
        for i in range(len(model.postnet.norms)):
            out += _norm(p + ("postnet", f"GroupNorm_{i}"), f"postnet.norms.{i}")
    return out


def _wn(conv_path, scale_path, tkey, kind="conv"):
    return [(conv_path + ("kernel",), f"{tkey}.weight", kind),
            (conv_path + ("bias",), f"{tkey}.bias", "plain"),
            (scale_path, f"{tkey}.scale", "plain")]


def _generator_table(model: HiFiGANGenerator) -> list:
    p = ("params",)
    n_stages = len(model.ups)
    out = _wn(p + ("Conv_0",), p + ("WeightNorm_0", "Conv_0/kernel/scale"), "conv_pre")
    for i in range(n_stages):
        name = f"ConvTranspose_{i}"
        out += _wn(p + (name,), p + (f"WeightNorm_{1 + i}", f"{name}/kernel/scale"),
                   f"ups.{i}", "conv_transpose")
    for j, chain in enumerate(model.resblocks):
        block = p + (f"ResBlock{model.resblock}_{j}",)
        for u in range(len(chain.convs)):
            out += _wn(block + (f"Conv_{u}",),
                       block + (f"WeightNorm_{u}", f"Conv_{u}/kernel/scale"),
                       f"resblocks.{j}.convs.{u}")
    out += _wn(p + ("Conv_1",), p + (f"WeightNorm_{1 + n_stages}", "Conv_1/kernel/scale"),
               "conv_post")
    return out


def _disc_convs(fpath, tkey, disc, kind="conv") -> list:
    """A discriminator's convs in flax's order (``convs``, then
    ``conv_post``): weight-normed ``Conv_u``, or ``SpectralNormConv_u``."""
    out = []
    for u, conv in enumerate([*disc.convs, disc.conv_post]):
        t = f"{tkey}.convs.{u}" if u < len(disc.convs) else f"{tkey}.conv_post"
        if isinstance(conv, SpectralNormConv1d):
            out += _conv(fpath + (f"SpectralNormConv_{u}",), t)
        else:
            out += _wn(fpath + (f"Conv_{u}",), fpath + (f"WeightNorm_{u}", f"Conv_{u}/kernel/scale"),
                       t, kind)
    return out


def _mpd_table(model: MultiPeriodDiscriminator, p=("params",), t="") -> list:
    return [row for i, disc in enumerate(model.discriminators)
            for row in _disc_convs(p + (f"PeriodDiscriminator_{i}",),
                                   f"{t}discriminators.{i}", disc, "conv2d")]


def _msd_table(model: MultiScaleDiscriminator, p=("params",), t="") -> list:
    return [row for i, disc in enumerate(model.discriminators)
            for row in _disc_convs(p + (f"ScaleDiscriminator_{i}",), f"{t}discriminators.{i}", disc)]


def _table(model) -> list:
    if isinstance(model, FastSpeech2):
        return _fs2_table(model)
    if isinstance(model, HiFiGANGenerator):
        return _generator_table(model)
    if isinstance(model, MultiPeriodDiscriminator):
        return _mpd_table(model)
    if isinstance(model, MultiScaleDiscriminator):
        return _msd_table(model)
    if isinstance(model, HiFiGANDiscriminators):
        return (_mpd_table(model.mpd, ("mpd", "params"), "mpd.")
                + _msd_table(model.msd, ("msd", "params"), "msd."))
    raise TypeError(f"no flax layout is known for {type(model).__name__}")


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flatten(value, prefix + (key,)))
        return out
    return {prefix: tree}


def flax_to_torch(params_tree: dict, model) -> tuple:
    """(state_dict for ``model``, absent flax paths) from a flax tree. The
    absent paths are those of an optional subtree the tree does not have at
    all; their state_dict entries are the model's current values."""
    leaves = _flatten(params_tree)
    present = {p[:2] for p in leaves}
    current = model.state_dict()
    state, used, absent = {}, set(), []
    for fpath, tkey, kind in _table(model):
        if fpath not in leaves:
            if fpath[1] in OPTIONAL_SUBTREES and fpath[:2] not in present:
                state[tkey] = current[tkey].detach().cpu().clone()
                absent.append("/".join(fpath))
                continue
            raise KeyError(f"flax tree has no {'/'.join(fpath)} for {tkey}")
        arr = np.array(leaves[fpath], dtype=np.float32)
        state[tkey] = torch.from_numpy(np.ascontiguousarray(_to_torch(arr, kind)))
        used.add(fpath)
    unused = sorted("/".join(p) for p in leaves if p not in used)
    if unused:
        raise ValueError(f"flax leaves with no torch counterpart: {unused}")
    unfilled = sorted(set(model.state_dict()) - set(state))
    if unfilled:
        raise ValueError(f"torch parameters with no flax leaf: {unfilled}")
    return state, sorted(absent)


def torch_to_flax(state_dict: dict, model) -> dict:
    """The flax tree (``{"params": ...}``, float32 numpy leaves) for a
    ``model``'s state dict."""
    heads = {}
    if isinstance(model, FastSpeech2):
        for stack in ("encoder", "decoder"):
            for i, block in enumerate(getattr(model, stack).blocks):
                heads[f"{stack}.blocks.{i}."] = block.attn.heads
    tree: dict = {}
    table = _table(model)
    missing = sorted(set(state_dict) - {t for _, t, _ in table})
    if missing:
        raise ValueError(f"torch parameters with no flax leaf: {missing}")
    for fpath, tkey, kind in table:
        h = next((n for prefix, n in heads.items() if tkey.startswith(prefix)), 1)
        # A copy: a live CPU parameter must not change under a checkpoint
        # that a writer thread is still serializing.
        arr = state_dict[tkey].detach().to("cpu", torch.float32, copy=True).numpy()
        node = tree
        for key in fpath[:-1]:
            node = node.setdefault(key, {})
        node[fpath[-1]] = np.ascontiguousarray(_to_flax(arr, kind, h))
    return tree


def hifigan_tree(generator_state: dict, disc_state: dict, generator: HiFiGANGenerator,
                 discriminators: HiFiGANDiscriminators) -> dict:
    """The JAX HiFiGAN trainer's checkpoint tree ``{"generator": {"params":
    ...}, "discriminators": {"mpd": {"params": ...}, "msd": {"params":
    ...}}}`` from the two modules' state dicts (or moments)."""
    return {"generator": torch_to_flax(generator_state, generator),
            "discriminators": torch_to_flax(disc_state, discriminators)}


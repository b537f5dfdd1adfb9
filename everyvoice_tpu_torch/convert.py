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
- a 2-D Conv kernel (kh, kw, in, out) ↔ Conv2d weight (out, in, kh, kw) (the
  MPD's (k, 1) kernels, GST's 3x3 ones);
- attention query/key/value kernels (dim, heads, head_dim) and biases
  (heads, head_dim) ↔ Linear (heads·head_dim, dim) and (heads·head_dim,);
  the out kernel (heads, head_dim, dim) ↔ Linear (dim, heads·head_dim);
- an ``OptimizedLSTMCell``'s per-gate denses (``ii/if/ig/io`` kernels with
  no bias, ``hi/hf/hg/ho`` kernels and biases) ↔ ``nn.LSTM``'s packed
  ``weight_ih_l0``/``weight_hh_l0``/``bias_hh_l0`` in gate order i, f, g,
  o; ``bias_ih_l0`` is zero from flax and added into the hidden biases
  back to it;
- a snake's ``alpha`` (1, 1, C) ↔ (1, C, 1).

``flax_to_torch`` consumes every leaf and raises on a leaf it did not use or
a torch parameter it did not fill. FastSpeech2's ``alignment`` subtree (the
alignment encoder, trained with the model) and ``gst`` subtree (the global
style tokens) map both ways like the rest, as does ``pfs_proj``, the
phonological-feature projection that replaces ``symbol_embed``. A tree that
has no ``alignment`` or ``gst`` subtree at all (the JAX package initialises
them only when its ``init`` sees a mel) leaves the model's own weights of
that subtree in place, and ``flax_to_torch`` reports the flax paths it
lacked.
``torch_to_flax`` is the inverse; it lets a machine without JAX write
checkpoints in the JAX package's layout. Both also map an optimizer's
moments, which have the parameters' shapes.

StyleTTS2's generator stack (``models/styletts2``) maps to the JAX
``StyleTTS2Module``'s ``{"params": ...}``: text and context encoders (or
PL-BERT and its projection), the TMA aligner (or, with an ``asr`` geometry,
the ASR aligner ``text_aligner``, whose decoder keeps flax's shapes), both
style encoders, the prosody predictor, the AdaIN decoder, the denoiser and
the projections. The StyleTTS2 trainer's checkpoint tree is HiFiGAN's
(``hifigan_tree``), its generator the StyleTTS2 stack, plus the SLM head's
``slm`` subtree beside ``mpd`` and ``msd`` when SLM-adversarial training is
on; the optimizer moments map through the same tables. The frozen
pretrained networks, which no checkpoint holds, map too: the JDC pitch
network (its BiLSTM's one flax bias per direction is torch's input bias,
the hidden bias zero) and WavLM, each from the flax tree its loader
converts the published file into, and the aligner's wav2vec2-CTC from the
tree ``convert_torch_wav2vec2_state`` makes of a HuggingFace directory.

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

from everyvoice_tpu_torch.models.aligner.wav2vec2 import Wav2Vec2CTC
from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
from everyvoice_tpu_torch.models.hifigan.model import (
    HiFiGANDiscriminators,
    HiFiGANGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    SpectralNormConv1d,
)
from everyvoice_tpu_torch.models.layers import (
    ConformerStack,
    GlobalStyleTokens,
    MultiHeadAttention,
    VariancePredictor,
)
from everyvoice_tpu_torch.models.styletts2.asr import ASRCNN
from everyvoice_tpu_torch.models.styletts2.jdc import JDCNet
from everyvoice_tpu_torch.models.styletts2.layers import (
    AdaIN1d,
    AdaINResBlock1,
    DiffusionDenoiser,
    ProsodyPredictor,
    StyleDecoder,
    StyleEncoder,
    TextEncoder,
)
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.models.styletts2.plbert import PLBERT
from everyvoice_tpu_torch.models.styletts2.slm import SLMDiscriminator, WavLM

OPTIONAL_SUBTREES = ("alignment", "gst")
OPTIONAL_ROOTS = ("slm",)  # the SLM head of the discriminators, stage 2's alone
LSTM_GATES = ("i", "f", "g", "o")  # nn.LSTM's packing order


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
    if kind == "alpha":
        return arr.transpose(0, 2, 1)
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
    if kind == "alpha":
        return arr.transpose(0, 2, 1)
    return arr


def _leaf_paths(fpath: tuple, kind: str) -> list:
    """The flax leaves one torch tensor holds: its own, or an LSTM gate's
    four (none for the input bias, which flax does not have)."""
    if kind == "lstm_ih":
        return [fpath + (f"i{g}", "kernel") for g in LSTM_GATES]
    if kind == "lstm_hh":
        return [fpath + (f"h{g}", "kernel") for g in LSTM_GATES]
    if kind == "lstm_bias":
        return [fpath + (f"h{g}", "bias") for g in LSTM_GATES]
    if kind == "lstm_bias_ih":
        return []
    return [fpath]


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


def _lstm(fpath, tkey):
    return [(fpath, f"{tkey}.weight_ih_l0", "lstm_ih"),
            (fpath, f"{tkey}.weight_hh_l0", "lstm_hh"),
            (fpath, f"{tkey}.bias_hh_l0", "lstm_bias"),
            (fpath, f"{tkey}.bias_ih_l0", "lstm_bias_ih")]


def _mha(fpath, tkey):
    out = []
    for name in ("query", "key", "value"):
        out += [(fpath + (name, "kernel"), f"{tkey}.{name}.weight", "mha_in"),
                (fpath + (name, "bias"), f"{tkey}.{name}.bias", "mha_in_bias")]
    return out + [(fpath + ("out", "kernel"), f"{tkey}.out.weight", "mha_out"),
                  (fpath + ("out", "bias"), f"{tkey}.out.bias", "plain")]


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
        out += _mha(f + ("MultiHeadDotProductAttention_0",), f"{t}.attn")
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


def _gst(fpath, tkey, gst: GlobalStyleTokens):
    out = []
    for i in range(len(gst.convs)):
        out += [(fpath + (f"Conv_{i}", "kernel"), f"{tkey}.convs.{i}.weight", "conv2d"),
                (fpath + (f"Conv_{i}", "bias"), f"{tkey}.convs.{i}.bias", "plain")]
        out += _norm(fpath + (f"GroupNorm_{i}",), f"{tkey}.norms.{i}")
    out += _dense(fpath + ("Dense_0",), f"{tkey}.proj")
    out += _dense(fpath + ("Dense_1",), f"{tkey}.query")
    out += [(fpath + ("style_tokens",), f"{tkey}.style_tokens", "plain")]
    return out + _mha(fpath + ("MultiHeadDotProductAttention_0",), f"{tkey}.attn")


def _fs2_table(model: FastSpeech2) -> list:
    p = ("params",)
    if model.pfs_proj is not None:
        out = _dense(p + ("pfs_proj",), "pfs_proj")
    else:
        out = _embed(p + ("symbol_embed",), "symbol_embed")
    out += _conformer(p + ("encoder",), "encoder", model.encoder)
    out += _conformer(p + ("decoder",), "decoder", model.decoder)
    if model.speaker_embed is not None:
        out += _embed(p + ("speaker_embed",), "speaker_embed")
    if model.language_embed is not None:
        out += _embed(p + ("language_embed",), "language_embed")
    if model.gst is not None:
        out += _gst(p + ("gst",), "gst", model.gst)
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


# StyleTTS2. Each helper takes the flax path of its module and the torch
# prefix of its parameters ("" or "name.").
def _st2_text_encoder(fpath, t, enc: TextEncoder) -> list:
    out = _embed(fpath + ("Embed_0",), f"{t}embed")
    for i in range(len(enc.convs)):
        out += _wn(fpath + (f"Conv_{i}",), fpath + (f"WeightNorm_{i}", f"Conv_{i}/kernel/scale"),
                   f"{t}convs.{i}")
        out += _norm(fpath + (f"LayerNorm_{i}",), f"{t}norms.{i}")
    return (out + _lstm(fpath + ("OptimizedLSTMCell_0",), f"{t}lstm_fwd")
            + _lstm(fpath + ("OptimizedLSTMCell_1",), f"{t}lstm_bwd"))


def _st2_style_encoder(fpath, t, enc: StyleEncoder) -> list:
    out = []
    for i in range(len(enc.convs)):
        out += [(fpath + (f"Conv_{i}", "kernel"), f"{t}convs.{i}.weight", "conv2d"),
                (fpath + (f"Conv_{i}", "bias"), f"{t}convs.{i}.bias", "plain")]
    return out + _dense(fpath + ("Dense_0",), f"{t}head")


def _st2_predictor(fpath, t) -> list:
    out = _lstm(fpath + ("OptimizedLSTMCell_0",), f"{t}lstm_fwd")
    out += _lstm(fpath + ("OptimizedLSTMCell_1",), f"{t}lstm_bwd")
    out += _dense(fpath + ("AdaIN1d_0", "Dense_0"), f"{t}adain.fc")
    # Dense_1 is f0's output layer: flax names the outer Dense of
    # Dense(1)(leaky_relu(Dense(hidden)(y))) first.
    for i, name in enumerate(("duration", "f0_out", "f0_hidden", "energy_out", "energy_hidden")):
        out += _dense(fpath + (f"Dense_{i}",), f"{t}{name}")
    return out


def _st2_resblock(fpath, t, block: AdaINResBlock1) -> list:
    out = []
    for u, d in enumerate(block.dilations):
        out += _dense(fpath + (f"AdaIN1d_{2 * u}", "Dense_0"), f"{t}adain1.{u}.fc")
        out += _dense(fpath + (f"AdaIN1d_{2 * u + 1}", "Dense_0"), f"{t}adain2.{u}.fc")
        for k, convs in ((2 * u, "convs1"), (2 * u + 1, "convs2")):
            out += _wn(fpath + (f"Conv_{k}",), fpath + (f"WeightNorm_{k}", f"Conv_{k}/kernel/scale"),
                       f"{t}{convs}.{u}")
        out += [(fpath + (f"alpha1_{d}",), f"{t}alpha1.{u}", "alpha"),
                (fpath + (f"alpha2_{d}",), f"{t}alpha2.{u}", "alpha")]
    return out


def _st2_decoder(fpath, t, dec: StyleDecoder) -> list:
    n = len(dec.ups)
    out = _wn(fpath + ("Conv_0",), fpath + ("WeightNorm_0", "Conv_0/kernel/scale"),
              f"{t}conv_pre")
    for i in range(n):
        name = f"ConvTranspose_{i}"
        out += _wn(fpath + (name,), fpath + (f"WeightNorm_{1 + i}", f"{name}/kernel/scale"),
                   f"{t}ups.{i}", "conv_transpose")
        out += _conv(fpath + (f"Conv_{1 + i}",), f"{t}source_convs.{i}")
    out += _wn(fpath + (f"Conv_{1 + n}",),
               fpath + (f"WeightNorm_{1 + n}", f"Conv_{1 + n}/kernel/scale"), f"{t}conv_post")
    for j, block in enumerate(dec.resblocks):
        out += _st2_resblock(fpath + (f"AdaINResBlock1_{j}",), f"{t}resblocks.{j}.", block)
    return out


def _st2_denoiser(fpath, t, den: DiffusionDenoiser) -> list:
    out = []
    for i, name in enumerate(("style_in", "sigma_in", "text_in")):
        out += _dense(fpath + (f"Dense_{i}",), f"{t}{name}")
    for i in range(len(den.attns)):
        out += _norm(fpath + (f"LayerNorm_{2 * i}",), f"{t}norms1.{i}")
        out += _mha(fpath + (f"MultiHeadDotProductAttention_{i}",), f"{t}attns.{i}")
        out += _norm(fpath + (f"LayerNorm_{2 * i + 1}",), f"{t}norms2.{i}")
        out += _dense(fpath + (f"Dense_{3 + 2 * i}",), f"{t}ff1.{i}")
        out += _dense(fpath + (f"Dense_{4 + 2 * i}",), f"{t}ff2.{i}")
    return out + _dense(fpath + (f"Dense_{3 + 2 * len(den.attns)}",), f"{t}out")


def _plbert(fpath, t) -> list:
    out = [(fpath + (name,), f"{t}{name}", "plain")
           for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    out += _norm(fpath + ("embed_norm",), f"{t}embed_norm")
    out += _dense(fpath + ("embedding_hidden_mapping_in",), f"{t}embedding_hidden_mapping_in")
    for name in ("query", "key", "value", "attn_out", "ffn", "ffn_output"):
        out += _dense(fpath + ("shared_layer", name), f"{t}shared_layer.{name}")
    for name in ("attn_norm", "full_norm"):
        out += _norm(fpath + ("shared_layer", name), f"{t}shared_layer.{name}")
    return out


ASR_S2S_PARAMS = ("embedding", "sos_embedding", "w_ih", "w_hh", "b_lstm", "query_kernel",
                  "memory_kernel", "v_kernel", "loc_conv", "loc_dense", "proj_hidden_kernel",
                  "proj_hidden_bias", "proj_symbols_kernel", "proj_symbols_bias")


def _asr(fpath, t, asr: ASRCNN) -> list:
    out = _conv(fpath + ("init_cnn",), f"{t}init_cnn")
    for i in range(asr.n_layers):
        f, b = fpath + (f"block{i}",), f"{t}block{i}"
        for j in range(getattr(asr, f"block{i}").n_inner):
            out += _conv(f + (f"dilated{j}",), f"{b}.dilated{j}")
            out += _norm(f + (f"norm{j}",), f"{b}.norm{j}")
            out += _conv(f + (f"pointwise{j}",), f"{b}.pointwise{j}")
        out += _norm(f + ("out_norm",), f"{b}.out_norm")
    out += _conv(fpath + ("projection",), f"{t}projection")
    out += _dense(fpath + ("ctc_dense1",), f"{t}ctc_dense1")
    out += _dense(fpath + ("ctc_dense2",), f"{t}ctc_dense2")
    return out + [(fpath + ("s2s", name), f"{t}s2s.{name}", "plain") for name in ASR_S2S_PARAMS]


def _wavlm(fpath, t, wavlm: WavLM) -> list:
    out = [(fpath + (f"conv{i}", "kernel"), f"{t}conv{i}.weight", "conv")
           for i in range(wavlm.n_convs)]
    out += _norm(fpath + ("conv0_norm",), f"{t}conv0_norm")
    out += _norm(fpath + ("fp_norm",), f"{t}fp_norm")
    out += _dense(fpath + ("fp_proj",), f"{t}fp_proj")
    out += _conv(fpath + ("pos_conv",), f"{t}pos_conv")
    out += _norm(fpath + ("enc_norm",), f"{t}enc_norm")
    out += [(fpath + ("rel_attn_embed",), f"{t}rel_attn_embed", "plain")]
    for i in range(wavlm.num_layers):
        f, layer = fpath + (f"layer{i}",), f"{t}layer{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"):
            out += _dense(f + ("attention", name), f"{layer}.attention.{name}")
        out += [(f + ("attention", "gru_rel_pos_const"), f"{layer}.attention.gru_rel_pos_const",
                 "plain")]
        out += _norm(f + ("layer_norm",), f"{layer}.layer_norm")
        out += _dense(f + ("intermediate_dense",), f"{layer}.intermediate_dense")
        out += _dense(f + ("output_dense",), f"{layer}.output_dense")
        out += _norm(f + ("final_layer_norm",), f"{layer}.final_layer_norm")
    return out


def _wav2vec2(fpath, model: Wav2Vec2CTC) -> list:
    out = []
    for i in range(model.n_convs):
        conv = _conv(fpath + (f"conv{i}",), f"conv{i}")
        out += conv if model.conv_bias else conv[:1]  # the kernel alone without conv_bias
        if model.feat_extract_norm == "layer":
            out += _norm(fpath + (f"conv{i}_norm",), f"conv{i}_norm")
    if model.feat_extract_norm == "group":
        out += _norm(fpath + ("conv0_norm",), "conv0_norm")
    out += _norm(fpath + ("fp_norm",), "fp_norm") + _dense(fpath + ("fp_proj",), "fp_proj")
    out += _conv(fpath + ("pos_conv",), "pos_conv") + _norm(fpath + ("enc_norm",), "enc_norm")
    for i in range(model.num_layers):
        f, layer = fpath + (f"layer{i}",), f"layer{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _dense(f + ("attention", name), f"{layer}.attention.{name}")
        out += _norm(f + ("layer_norm",), f"{layer}.layer_norm")
        out += _dense(f + ("intermediate_dense",), f"{layer}.intermediate_dense")
        out += _dense(f + ("output_dense",), f"{layer}.output_dense")
        out += _norm(f + ("final_layer_norm",), f"{layer}.final_layer_norm")
    return out + _dense(fpath + ("lm_head",), "lm_head")


def _slm_head(fpath, t) -> list:
    return [row for name in ("pre", "conv0", "conv1", "post")
            for row in _conv(fpath + (name,), f"{t}{name}")]


def _jdc(fpath) -> list:
    def conv(name, tkey):
        return [(fpath + name + ("kernel",), f"{tkey}.weight", "conv2d")]

    def bn(name, tkey):
        return [(fpath + name + (leaf,), f"{tkey}.{leaf}", "plain")
                for leaf in ("scale", "bias", "mean", "var")]

    out = conv(("stem_conv1",), "stem_conv1") + bn(("stem_bn",), "stem_bn")
    out += conv(("stem_conv2",), "stem_conv2")
    for res in ("res1", "res2", "res3"):
        out += bn((res, "pre_bn"), f"{res}.pre_bn") + conv((res, "conv1"), f"{res}.conv1")
        out += bn((res, "mid_bn"), f"{res}.mid_bn") + conv((res, "conv2"), f"{res}.conv2")
        out += conv((res, "shortcut"), f"{res}.shortcut")
    out += bn(("pool_bn",), "pool_bn")
    for way, suffix in (("fwd", ""), ("bwd", "_reverse")):
        lstm = fpath + ("bilstm",)
        out += [(lstm + (f"w_ih_{way}",), f"bilstm.weight_ih_l0{suffix}", "dense"),
                (lstm + (f"w_hh_{way}",), f"bilstm.weight_hh_l0{suffix}", "dense"),
                (lstm + (f"b_{way}",), f"bilstm.bias_ih_l0{suffix}", "plain"),
                (lstm, f"bilstm.bias_hh_l0{suffix}", "lstm_bias_ih")]
    return out + _dense(fpath + ("classifier",), "classifier")


def _st2_table(model: StyleTTS2) -> list:
    p = ("params",)
    out = _st2_text_encoder(p + ("text_encoder",), "text_encoder.", model.text_encoder)
    if model.plbert_geometry is not None:
        out += _plbert(p + ("plbert_encoder",), "plbert_encoder.")
        out += _dense(p + ("plbert_proj",), "plbert_proj")
    else:
        out += _st2_text_encoder(p + ("context_encoder",), "context_encoder.",
                                 model.context_encoder)
    if model.asr_geometry is None:
        for i, name in enumerate(("key_in", "key_out", "query_in", "query_mid", "query_out")):
            out += _conv(p + ("tma_aligner", f"Conv_{i}"), f"tma_aligner.{name}")
    else:
        out += _asr(p + ("text_aligner",), "text_aligner.", model.text_aligner)
    for name in ("acoustic_style_encoder", "prosodic_style_encoder"):
        out += _st2_style_encoder(p + (name,), f"{name}.", getattr(model, name))
    out += _st2_predictor(p + ("predictor",), "predictor.")
    out += _st2_decoder(p + ("decoder",), "decoder.", model.decoder)
    out += _st2_denoiser(p + ("denoiser",), "denoiser.", model.denoiser)
    out += _dense(p + ("frame_proj",), "frame_proj")
    out += _dense(p + ("f0_embed",), "f0_embed")
    if model.multilingual:
        out += _embed(p + ("language_embed",), "language_embed")
        out += _dense(p + ("language_proj",), "language_proj")
    return out


def _table(model) -> list:
    if isinstance(model, FastSpeech2):
        return _fs2_table(model)
    if isinstance(model, StyleTTS2):
        return _st2_table(model)
    # StyleTTS2's modules alone, each as its flax module's {"params": ...}.
    p = ("params",)
    if isinstance(model, TextEncoder):
        return _st2_text_encoder(p, "", model)
    if isinstance(model, StyleEncoder):
        return _st2_style_encoder(p, "", model)
    if isinstance(model, ProsodyPredictor):
        return _st2_predictor(p, "")
    if isinstance(model, StyleDecoder):
        return _st2_decoder(p, "", model)
    if isinstance(model, AdaINResBlock1):
        return _st2_resblock(p, "", model)
    if isinstance(model, AdaIN1d):
        return _dense(p + ("Dense_0",), "fc")
    if isinstance(model, DiffusionDenoiser):
        return _st2_denoiser(p, "", model)
    if isinstance(model, PLBERT):
        return _plbert(p, "")
    if isinstance(model, ASRCNN):
        return _asr(p, "", model)
    if isinstance(model, WavLM):
        return _wavlm(p, "", model)
    if isinstance(model, SLMDiscriminator):
        return _slm_head(p, "")
    if isinstance(model, Wav2Vec2CTC):
        return _wav2vec2(p, model)
    if isinstance(model, JDCNet):
        return _jdc(p)
    if isinstance(model, HiFiGANGenerator):
        return _generator_table(model)
    if isinstance(model, MultiPeriodDiscriminator):
        return _mpd_table(model)
    if isinstance(model, MultiScaleDiscriminator):
        return _msd_table(model)
    if isinstance(model, HiFiGANDiscriminators):
        out = (_mpd_table(model.mpd, ("mpd", "params"), "mpd.")
               + _msd_table(model.msd, ("msd", "params"), "msd."))
        if hasattr(model, "slm"):
            out += _slm_head(("slm", "params"), "slm.")
        return out
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
    roots = {p[0] for p in leaves}
    current = model.state_dict()
    state, used, absent = {}, set(), []
    for fpath, tkey, kind in _table(model):
        paths = _leaf_paths(fpath, kind)
        if not paths:  # an LSTM's input bias: flax's gates have none
            state[tkey] = torch.zeros(current[tkey].shape)
            continue
        if any(p not in leaves for p in paths):
            if ((fpath[1] in OPTIONAL_SUBTREES and fpath[:2] not in present)
                    or (fpath[0] in OPTIONAL_ROOTS and fpath[0] not in roots)):
                state[tkey] = current[tkey].detach().cpu().clone()
                absent += ["/".join(p) for p in paths]
                continue
            missing = next(p for p in paths if p not in leaves)
            raise KeyError(f"flax tree has no {'/'.join(missing)} for {tkey}")
        arrs = [np.array(leaves[p], dtype=np.float32) for p in paths]
        if kind in ("lstm_ih", "lstm_hh"):
            arr = np.concatenate([a.T for a in arrs])
        elif kind == "lstm_bias":
            arr = np.concatenate(arrs)
        else:
            arr = _to_torch(arrs[0], kind)
        state[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
        used.update(paths)
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
    heads = {f"{name}.": m.heads for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)}
    tree: dict = {}
    table = _table(model)
    missing = sorted(set(state_dict) - {t for _, t, _ in table})
    if missing:
        raise ValueError(f"torch parameters with no flax leaf: {missing}")

    def host(tkey):
        # A copy: a live CPU parameter must not change under a checkpoint
        # that a writer thread is still serializing.
        return state_dict[tkey].detach().to("cpu", torch.float32, copy=True).numpy()

    for fpath, tkey, kind in table:
        paths = _leaf_paths(fpath, kind)
        if not paths:
            continue
        arr = host(tkey)
        if kind == "lstm_bias":
            parts = np.split(arr + host(tkey.replace("bias_hh", "bias_ih")), 4)
        elif kind in ("lstm_ih", "lstm_hh"):
            parts = [a.T for a in np.split(arr, 4)]
        else:
            h = next((n for prefix, n in heads.items() if tkey.startswith(prefix)), 1)
            parts = [_to_flax(arr, kind, h)]
        for path, part in zip(paths, parts):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.ascontiguousarray(part)
    return tree


def hifigan_tree(generator_state: dict, disc_state: dict, generator,
                 discriminators: HiFiGANDiscriminators) -> dict:
    """The JAX GAN trainers' checkpoint tree ``{"generator": {"params":
    ...}, "discriminators": {"mpd": {"params": ...}, "msd": {"params":
    ...}}}`` from the two modules' state dicts (or moments); the generator
    is HiFiGAN's or StyleTTS2's stack."""
    return {"generator": torch_to_flax(generator_state, generator),
            "discriminators": torch_to_flax(disc_state, discriminators)}


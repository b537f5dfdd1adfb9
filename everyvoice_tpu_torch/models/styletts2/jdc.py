"""The JDC pitch network, StyleTTS2's frozen F0 extractor, in PyTorch
(counterpart of everyvoice_tpu/models/styletts2/jdc.py).

``JDCNet`` is the classifier path of the published network (everyvoice/
styletts2-jdc-f0's ``bst.t7``): a 3×3 conv stem, three pooling residual
blocks, a BiLSTM over frames and a linear F0 head; the voicing detector's
branch, unused by StyleTTS2, is left out. Its batch norms are frozen: they
use the checkpoint's running statistics, as the reference calls the
network under ``no_grad`` in eval mode. The tensors run (B, C, T, bins);
the last pool leaves 2 bins, flattened channel-major as torch's
``view`` does, so the BiLSTM sees 2·256 features at the published
geometry. The BiLSTM is ``nn.LSTM``, whose gate order (i, f, g, o) the
published weights already have.

``convert_torch_jdc_state`` turns the published ``{'net': state}`` payload
into the JAX package's flax tree; ``load_jdc_params`` loads that tree into
the module (``convert.flax_to_torch``), so both packages read one file the
same way and the committed golden (in the flax layout) loads as it is.
``jdc_f0`` renormalises a framework log-mel to the statistics the network
was trained on. Float32, parameters without gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from everyvoice_tpu_torch.models.styletts2.plbert import load_torch_or_npz_state
from everyvoice_tpu_torch.utils.hf_weights import to_numpy

JDC_CHANNELS = (64, 128, 192, 256)
JDC_LSTM_HIDDEN = 256
JDC_BINS = 2  # the published 80 mel bins after the pools: 80 → 40 → 20 → 10 → 2
JDC_SLOPE = 0.01
BN_EPS = 1e-5
# StyleTTS2's mel normalization (meldataset: (log_mel - mean) / std).
REFERENCE_MEL_MEAN = -4.0
REFERENCE_MEL_STD = 4.0


class FrozenBatchNorm(nn.Module):
    """scale · (x - mean) / sqrt(var + eps) + bias over the channel axis
    (dim 1), with the checkpoint's running statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.var + BN_EPS) * self.scale
        return (x - self.mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class JDCResBlock(nn.Module):
    """BN, leaky ReLU and a (1, 2) max pool over bins; two 3×3 convs with a
    frozen BN between, plus a 1×1 shortcut of the pooled input."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pre_bn = FrozenBatchNorm(cin)
        self.conv1 = _conv3(cin, cout)
        self.mid_bn = FrozenBatchNorm(cout)
        self.conv2 = _conv3(cout, cout)
        self.shortcut = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        x = F.max_pool2d(F.leaky_relu(self.pre_bn(x), JDC_SLOPE), (1, 2))
        y = self.conv2(F.leaky_relu(self.mid_bn(self.conv1(x)), JDC_SLOPE))
        return y + self.shortcut(x)


class JDCNet(nn.Module):
    """Mel (B, T, 80) → F0 (B, T), the classifier path."""

    def __init__(self, channels=JDC_CHANNELS, lstm_hidden: int = JDC_LSTM_HIDDEN):
        super().__init__()
        c0, c1, c2, c3 = channels
        self.stem_conv1 = _conv3(1, c0)
        self.stem_bn = FrozenBatchNorm(c0)
        self.stem_conv2 = _conv3(c0, c0)
        self.res1 = JDCResBlock(c0, c1)
        self.res2 = JDCResBlock(c1, c2)
        self.res3 = JDCResBlock(c2, c3)
        self.pool_bn = FrozenBatchNorm(c3)
        self.bilstm = nn.LSTM(c3 * JDC_BINS, lstm_hidden, batch_first=True, bidirectional=True)
        self.classifier = nn.Linear(2 * lstm_hidden, 1)

    def forward(self, mel):
        b, t, _ = mel.shape
        x = self.stem_conv1(mel[:, None])
        x = self.stem_conv2(F.leaky_relu(self.stem_bn(x), JDC_SLOPE))
        x = self.res3(self.res2(self.res1(x)))
        x = F.max_pool2d(F.leaky_relu(self.pool_bn(x), JDC_SLOPE), (1, 4))
        x = x.permute(0, 2, 1, 3).reshape(b, t, -1)  # (B, T, C·bins), channel-major
        x, _ = self.bilstm(x)
        return torch.abs(self.classifier(x)[..., 0])


# ---------------------------------------------------------------------------
# the published checkpoint


def _conv(w) -> dict:
    return {"kernel": w.transpose(2, 3, 1, 0)}  # (O, I, kh, kw) → (kh, kw, I, O)


def _bn(sd: dict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}


def _res(sd: dict, prefix: str) -> dict:
    # conv1by1 is a bare Conv2d in the published model, a one-element
    # Sequential in some forks.
    short = (f"{prefix}.conv1by1.weight" if f"{prefix}.conv1by1.weight" in sd
             else f"{prefix}.conv1by1.0.weight")
    return {"pre_bn": _bn(sd, f"{prefix}.pre_conv.0"), "conv1": _conv(sd[f"{prefix}.conv.0.weight"]),
            "mid_bn": _bn(sd, f"{prefix}.conv.1"), "conv2": _conv(sd[f"{prefix}.conv.3.weight"]),
            "shortcut": _conv(sd[short])}


def convert_torch_jdc_state(state_dict: dict) -> dict:
    """The published JDCNet state dict (or its ``{'net': ...}`` payload) →
    the JAX package's flax tree (no ``params`` wrapper); the detector
    branch's keys are ignored."""
    if "net" in state_dict and isinstance(state_dict["net"], dict):
        state_dict = state_dict["net"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): to_numpy(v)
          for k, v in state_dict.items()}
    lstm = "bilstm_classifier"
    return {
        "stem_conv1": _conv(sd["conv_block.0.weight"]), "stem_bn": _bn(sd, "conv_block.1"),
        "stem_conv2": _conv(sd["conv_block.3.weight"]),
        "res1": _res(sd, "res_block1"), "res2": _res(sd, "res_block2"),
        "res3": _res(sd, "res_block3"), "pool_bn": _bn(sd, "pool_block.0"),
        "bilstm": {
            "w_ih_fwd": sd[f"{lstm}.weight_ih_l0"].T, "w_hh_fwd": sd[f"{lstm}.weight_hh_l0"].T,
            "b_fwd": sd[f"{lstm}.bias_ih_l0"] + sd[f"{lstm}.bias_hh_l0"],
            "w_ih_bwd": sd[f"{lstm}.weight_ih_l0_reverse"].T,
            "w_hh_bwd": sd[f"{lstm}.weight_hh_l0_reverse"].T,
            "b_bwd": sd[f"{lstm}.bias_ih_l0_reverse"] + sd[f"{lstm}.bias_hh_l0_reverse"],
        },
        "classifier": {"kernel": sd["classifier.weight"].T, "bias": sd["classifier.bias"]},
    }


def jdc_from_flax(params: dict) -> JDCNet:
    """A frozen ``JDCNet`` (eval mode, no gradient) holding a flax tree's
    weights, its channels and BiLSTM width read off the tree."""
    from everyvoice_tpu_torch.convert import flax_to_torch

    channels = tuple(int(params[k]["conv2"]["kernel"].shape[-1]) for k in ("res1", "res2", "res3"))
    channels = (int(params["stem_conv1"]["kernel"].shape[-1]),) + channels
    hidden = int(params["bilstm"]["w_hh_fwd"].shape[0])
    model = JDCNet(channels, hidden)
    model.load_state_dict(flax_to_torch({"params": params}, model)[0])
    return model.eval().requires_grad_(False)


def load_jdc_params(path) -> tuple:
    """(frozen ``JDCNet``, flax tree) of ``pretrained.f0.local_path``: the
    published ``bst.t7``, or an ``.npz`` with its keys."""
    params = convert_torch_jdc_state(load_torch_or_npz_state(path))
    return jdc_from_flax(params), params


def jdc_f0(model: JDCNet, mel: torch.Tensor) -> torch.Tensor:
    """Per-frame F0 (Hz) of a framework log-mel (B, T, n_mels), normalised
    to the statistics the network was trained with."""
    return model((mel - REFERENCE_MEL_MEAN) / REFERENCE_MEL_STD)

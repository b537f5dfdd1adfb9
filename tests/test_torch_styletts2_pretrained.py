"""StyleTTS2's pretrained components in the port (everyvoice_tpu_torch/
models/styletts2/{plbert,jdc,asr}.py and the trainer's regime 2) against the
JAX package's, on the CPU, in float32, at small widths, on seeded files in
the published formats (``onchip.write_pretrained_components``): the JDC at
its published geometry (the JAX loader knows no other), the ASR aligner
(hidden 32, 2 layers, embedding 24) and PL-BERT (hidden 32, 2 layers) from
their ``config.yml``; the 178-row published tables remapped onto the
project's symbols.

Tolerances, with their reasons:
- against the committed goldens (torch-computed outputs), those of
  ``tests/test_styletts2_goldens.py``: PL-BERT atol 2e-4 / rtol 2e-3; the
  ASR aligner and the JDC 5e-4 / 5e-3;
- against the JAX module on the same converted weights: 1e-4 of the
  output's largest magnitude, float32 sums in another order;
- the loaders' converted trees against the JAX loaders': exact;
- one stage-1 step's gradients against ``jax.grad`` of the JAX trainer's
  loss closures with the same draws (the ASR decoder's masks handed to
  both: the JAX module's ``jax.random.bernoulli`` replaced by one that
  returns them while this file's JAX steps trace): those of
  ``test_torch_styletts2_train.py``, the generator's 1e-4 of each leaf's
  largest magnitude, the discriminators' 5e-4, the losses 1e-4 relative;
  PL-BERT's attention key bias, whose gradient is 0 in exact arithmetic,
  1e-4 of its key kernel's gradient's peak; the targets (durations
  exact in effect, F0 and energy averages) rtol 1e-4, atol 1e-3 Hz;
- ``optax.multi_transform`` of three ``adamw``s over three updates: 1e-6
  absolute on parameters and moments;
- regime-2 checkpoints resumed across the packages: parameters and
  optimizer states after a load, exact.
"""

import logging
import shutil

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp
import optax
from flax import serialization

from everyvoice_tpu.models.hifigan.model import MultiPeriodDiscriminator, MultiScaleDiscriminator
from everyvoice_tpu.models.styletts2 import asr as jax_asr
from everyvoice_tpu.models.styletts2 import jdc as jax_jdc
from everyvoice_tpu.models.styletts2 import plbert as jax_plbert
from everyvoice_tpu.models.styletts2.config import StyleTTS2Config
from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu_torch import onchip
from everyvoice_tpu_torch.config import PRETRAINED_SYMBOL_TABLE, styletts2_config
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.models.layers import Dropout
from everyvoice_tpu_torch.models.styletts2 import asr as port_asr
from everyvoice_tpu_torch.models.styletts2 import jdc as port_jdc
from everyvoice_tpu_torch.models.styletts2 import plbert as port_plbert
from everyvoice_tpu_torch.models.styletts2.train import GroupedAdamW, StyleTTS2Trainer
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, load_checkpoint_header
from test_styletts2_goldens import load_fixture
from test_torch_styletts2_ckpt import _assert_trees_equal, _seeded_like
from test_torch_styletts2_train import (
    _IdentityDropout,
    _assert_grads_close,
    _np,
    _t,
    audio_sized,
    jax_step_draws,
    make_batch,
    seeded_tree,
    source_noise,
)
from test_torch_styletts2_train import MODEL, B, N_TEXT, SEGMENT, HOP

REF_TOL = 1e-4
ASR_GEOMETRY = dict(input_dim=80, hidden_dim=32, n_token=178, n_layers=2, token_embedding_dim=24)
PLBERT_GEOMETRY = dict(vocab_size=178, hidden_size=32, num_layers=2, num_heads=2,
                       intermediate_size=64, embedding_size=16, max_position_embeddings=64)
WAVLM_GEOMETRY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                      conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                      conv_stride=(5, 2, 2, 2, 2, 2, 2), num_buckets=32, max_distance=80,
                      num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=4)
SMALL = {"asr": ASR_GEOMETRY, "plbert": PLBERT_GEOMETRY, "wavlm": WAVLM_GEOMETRY}


@pytest.fixture(autouse=True, scope="module")
def no_dropout_one_thread():
    """flax's dropout is the identity in this file (the port's runs at rate
    0 instead); torch on one thread beside the other test workers."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen, "Dropout", _IdentityDropout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    patch.undo()


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A test's checkpoints (about 0.6 GB each, the discriminators being
    full width) are deleted when it ends, not with the session's temporary
    directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


class AsrMasks:
    """The ASR decoder's training draws, made with numpy, for both packages:
    ``patch`` makes the JAX module's ``jax.random.bernoulli`` return them
    (by shape; the decoder's calls are the only ones, flax's dropout being
    the identity here)."""

    def __init__(self, b: int, n: int, hidden: int, seed: int = 11):
        rng = np.random.default_rng(seed)
        self.unk = rng.random((b, n)) < port_asr.UNK_RATE
        self.keep = rng.random((n + 1, b, hidden)) < port_asr.KEEP_RATE

    def bernoulli(self, key, p=0.5, shape=None):
        for mask in (self.unk, self.keep):
            if tuple(shape) == mask.shape:
                return jnp.asarray(mask)
        return jnp.ones(shape, bool)

    def patch(self, monkeypatch):
        monkeypatch.setattr(jax.random, "bernoulli", self.bernoulli)

    def port(self) -> tuple:
        return torch.from_numpy(self.unk), torch.from_numpy(self.keep)


def np_state(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def assert_grads_close(got: dict, want: dict, what: str, tol: float = 1e-4) -> None:
    """``test_torch_styletts2_train``'s check, and for an attention's key
    bias, whose gradient is 0 in exact arithmetic (the softmax over keys
    does not see a constant added to each query's logits), within ``tol``
    of its key kernel's gradient's peak."""
    key_biases = {n for n in got if n.endswith(".key.bias")}
    for name in key_biases:
        w = np.asarray(want[name])
        g = np.zeros_like(w) if got[name] is None else got[name].numpy()
        err = float(np.abs(g - w).max())
        peak = float(np.abs(np.asarray(want[name[: -len("bias")] + "weight"])).max())
        assert err <= tol * peak, (what, name, err, peak)
    _assert_grads_close({n: g for n, g in got.items() if n not in key_biases}, want, what, tol)


def close_to_peak(got, want, tol=REF_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# the components


@pytest.mark.parametrize("name", ["plbert", "asr", "jdc"])
def test_components_match_their_goldens(name):
    """Each port module on a golden's flax weights and inputs gives the
    outputs the torch implementation gave (``tests/data/golden_pretrained``)."""
    variables, geometry, inputs, expected = load_fixture(name)
    if name == "plbert":
        model = port_plbert.PLBERT(**geometry)
        model.load_state_dict(flax_to_torch(variables, model)[0])
        with torch.no_grad():
            out = model(_t(inputs["tokens"]).long(), _t(inputs["mask"]).bool())
        np.testing.assert_allclose(out.numpy(), expected["hidden"], atol=2e-4, rtol=2e-3)
    elif name == "asr":
        model = port_asr.ASRCNN(**geometry)
        model.load_state_dict(flax_to_torch(variables, model)[0])
        with torch.no_grad():
            ctc, s2s, attn = model(_t(inputs["mel"]), _t(inputs["mel_lengths"]).long(),
                                   _t(inputs["text"]).long())
        for got, key in ((ctc, "ctc"), (attn, "attn"), (s2s, "s2s_logits")):
            np.testing.assert_allclose(got.numpy(), expected[key], atol=5e-4, rtol=5e-3,
                                       err_msg=key)
    else:
        model = port_jdc.jdc_from_flax(variables["params"])
        assert [m.out_channels for m in (model.stem_conv1, model.res3.conv2)] == [
            geometry["channels"][0], geometry["channels"][-1]]
        with torch.no_grad():
            out = model(_t(inputs["mel"]))
        np.testing.assert_allclose(out.numpy(), expected["f0"], atol=5e-4, rtol=5e-3)


def _staged(tmp_path, **options):
    gen = torch.Generator().manual_seed(3)
    return onchip.write_pretrained_components(tmp_path / "pre", gen, **{**SMALL, **options})


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Seeded components in the published formats at small widths (the
    JDC at its published one, with running statistics and an F0 bias)."""
    return _staged(tmp_path_factory.mktemp("components"))


def test_loaders_read_each_published_payload_as_jax_does(staged, tmp_path):
    """``{'net': state}``, ``{'model': state}``, ``{'net':
    {'module.encoder.…'}}``, a plain AlbertModel state dict and an ``.npz``
    of the same keys each convert to the JAX loaders' trees; the geometry
    comes from ``config.yml`` through the port's YAML reader."""
    project = TextProcessor(styletts2_config({"contact": {}, "text": {
        "symbols": {"letters": list("abcdefghijklmnopqrstuvwxyzé")}}})["text"]).symbols
    table = list(PRETRAINED_SYMBOL_TABLE)
    geometry, tree = port_plbert.load_plbert_params(staged["plbert"], staged["plbert_config"],
                                                    project, table)
    jmod, jparams = jax_plbert.load_plbert_params(staged["plbert"], staged["plbert_config"],
                                                  project, table)
    assert geometry == {f: getattr(jmod, f) for f in geometry}
    assert geometry == dict(PLBERT_GEOMETRY, vocab_size=len(project))
    assert jax.tree.structure(tree["params"]) == jax.tree.structure(_np(jparams))
    for a, b in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(a, b)
    plain = port_plbert.strip_plbert_training_prefixes(
        port_plbert.load_torch_or_npz_state(staged["plbert"]))
    np.savez(tmp_path / "albert.npz", **np_state(plain))
    for source in (plain, port_plbert.load_torch_or_npz_state(tmp_path / "albert.npz")):
        again = port_plbert.convert_torch_plbert_state(source)["params"]
        np.testing.assert_array_equal(again["word_embeddings"],
                                      np.asarray(plain["embeddings.word_embeddings.weight"]))

    geometry, tree = port_asr.load_asr_params(staged["asr"], staged["asr_config"], project, table)
    jmod, jparams = jax_asr.load_asr_params(staged["asr"], staged["asr_config"], project, table)
    assert geometry == {f: getattr(jmod, f) for f in geometry}
    assert geometry == dict(ASR_GEOMETRY, n_token=len(project))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(a, b)

    state = torch.load(staged["f0"], weights_only=False)
    np.savez(tmp_path / "bst.npz", **np_state(state["net"]))
    for path in (staged["f0"], tmp_path / "bst.npz"):
        model, tree = port_jdc.load_jdc_params(path)
        _, jparams = jax_jdc.load_jdc_params(path)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(_np(jparams))):
            np.testing.assert_array_equal(a, b)
        assert not any(p.requires_grad for p in model.parameters()) and not model.training


def test_symbol_remap_and_sos():
    """Project symbol i takes the pretrained row of its symbol; an absent
    one a zero row; the ASR's start embedding is the table's row 1."""
    gen = torch.Generator().manual_seed(4)
    state = np_state(onchip.published_asr_state(gen, dict(ASR_GEOMETRY, n_token=10)))
    rows = np.asarray([2, -1, 5])
    tree = port_asr.convert_torch_asr_state(state, 2, rows, sos_index=1)
    emb = state["asr_s2s.embedding.weight"]
    np.testing.assert_array_equal(tree["s2s"]["embedding"][0], emb[2])
    np.testing.assert_array_equal(tree["s2s"]["embedding"][1], np.zeros_like(emb[0]))
    np.testing.assert_array_equal(tree["s2s"]["sos_embedding"], emb[1])
    assert tree["s2s"]["proj_symbols_kernel"].shape == (16, 3)
    np.testing.assert_array_equal(
        port_plbert.symbol_row_map(["b", "zz", "a"], ["a", "b", "c"]), [1, -1, 0])


@pytest.mark.parametrize("draws", [False, True], ids=["deterministic", "training-draws"])
def test_components_match_jax_on_converted_weights(staged, monkeypatch, draws):
    """PL-BERT, the ASR aligner (with and without the decoder's training
    draws) and the JDC, each against the JAX module on the trees both
    loaders convert from one file, and the TMA adapter of the attention."""
    rng = np.random.default_rng(0)
    mel = rng.normal(-4.0, 2.0, (2, 24, 80)).astype(np.float32)
    mel_lengths = np.asarray([24, 17], np.int32)
    text = rng.integers(1, 30, (2, 5)).astype(np.int32)
    geometry, tree = port_asr.load_asr_params(staged["asr"], staged["asr_config"])
    jmod, jparams = jax_asr.load_asr_params(staged["asr"], staged["asr_config"])
    model = port_asr.ASRCNN(**geometry)
    model.load_state_dict(flax_to_torch({"params": tree}, model)[0])
    masks = AsrMasks(2, 5, geometry["hidden_dim"] // 2)
    masks.patch(monkeypatch)
    want = jax.jit(lambda p: jmod.apply({"params": p}, mel, mel_lengths, text,
                                        deterministic=not draws,
                                        rngs={"dropout": jax.random.PRNGKey(0)}))(jparams)
    with torch.no_grad():
        got = model(_t(mel), _t(mel_lengths).long(), _t(text).long(),
                    masks.port() if draws else None)
    for g, w in zip(got, want):
        close_to_peak(g.numpy(), w)
    src = np.arange(5)[None] < np.asarray([5, 3])[:, None]
    frames = np.arange(24)[None] < mel_lengths[:, None]
    soft, logprob = port_asr.asr_attention_to_tma(got[2], 24, _t(src), _t(frames))
    jsoft, jlog = jax_asr.asr_attention_to_tma(want[2], 24, src, frames)
    close_to_peak(soft.numpy(), jsoft)
    np.testing.assert_allclose(logprob.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    if draws:
        return

    geometry, tree = port_plbert.load_plbert_params(staged["plbert"], staged["plbert_config"])
    jmod, jparams = jax_plbert.load_plbert_params(staged["plbert"], staged["plbert_config"])
    model = port_plbert.PLBERT(**geometry)
    model.load_state_dict(flax_to_torch(tree, model)[0])
    mask = np.arange(5)[None] < np.asarray([5, 3])[:, None]
    with torch.no_grad():
        got = model(_t(text).long(), _t(mask))
    close_to_peak(got.numpy(), jmod.apply({"params": jparams}, text, mask))

    model, _ = port_jdc.load_jdc_params(staged["f0"])
    jmod, jparams = jax_jdc.load_jdc_params(staged["f0"])
    with torch.no_grad():
        got = port_jdc.jdc_f0(model, _t(mel))
    want = jax.jit(lambda p: jax_jdc.jdc_f0(jmod, p, mel))(jparams)
    assert np.asarray(want).std() > 1.0  # the F0 varies over frames
    close_to_peak(got.numpy(), want)


# ---------------------------------------------------------------------------
# the trainer


class _Data:
    """What the trainers read of a dataset before ``fit``."""

    def __init__(self, text_processor, level):
        self.text_processor = text_processor
        self.n_symbols = len(text_processor.symbols)
        self.level = level
        self.max_text_len = N_TEXT
        self.items: list = []


def regime2_raw(tmp, paths: dict, name: str = "regime2", slm: bool = False, **losses) -> dict:
    model = dict(MODEL)
    if slm:
        model["slm"] = {"model": str(paths["wavlm"]), "hidden": 32, "nlayers": 3,
                        "initial_channel": 8}
    return {
        "contact": {"contact_name": "Test Runner", "contact_email": "info@everyvoice.ca"},
        "model": model,
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "preprocessing": {"save_dir": str(tmp / "pre")},
        "pretrained": {"f0": {"local_path": str(paths["f0"])},
                       "asr": {"local_checkpoint": str(paths["asr"]),
                               "local_config": str(paths["asr_config"])},
                       "plbert": {"local_checkpoint": str(paths["plbert"]),
                                  "local_config": str(paths["plbert_config"])}},
        "training": {"batch_size": B, "max_len": 48, "decoder_segment_frames": SEGMENT,
                     "save_top_k_ckpts": 0, "OOD_min_length": 10,
                     "losses": {"tma_epoch": 1, "diff_epoch": 1, "joint_epoch": 1, **losses},
                     "logger": {"save_dir": str(tmp / "logs"), "name": name}},
    }


def port_trainer(raw, run_dir, mode) -> StyleTTS2Trainer:
    config = styletts2_config(raw)
    data = _Data(TextProcessor(config["text"]), "characters")
    trainer = StyleTTS2Trainer(config, data, data, {"default": 0}, run_dir=run_dir, mode=mode,
                               compute_dtype="float32", device="cpu")
    for module in trainer.model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    return trainer


def jax_trainer(raw, run_dir, mode) -> JaxTrainer:
    from everyvoice_tpu.config.type_definitions import TargetTrainingTextRepresentationLevel

    config = StyleTTS2Config(**raw)
    data = _Data(JaxTextProcessor(config.text), TargetTrainingTextRepresentationLevel.characters)
    return JaxTrainer(config, data, data, lang2id={"default": 0},
                      mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=run_dir, mode=mode,
                      compute_dtype="float32")


@pytest.mark.parametrize("component", ["f0", "plbert", "asr", "slm"])
def test_the_trainer_loads_pretrained_components(staged, tmp_path, caplog, component):
    """Each staged component loads as the JAX trainer loads it (PL-BERT and
    the ASR aligner grafted over the fresh weights, the JDC frozen beside
    the model, WavLM and the SLM head in stage 2 only); a configured path
    that does not exist warns and leaves the stand-in."""
    full = regime2_raw(tmp_path, staged, slm=True)
    section = {"f0": ("f0", "local_path"), "plbert": ("plbert", "local_checkpoint"),
               "asr": ("asr", "local_checkpoint"), "slm": None}[component]
    raw = {**full, "pretrained": {}}
    if section:
        raw["pretrained"] = {section[0]: full["pretrained"][section[0]]}
    trainer = port_trainer(raw, tmp_path / "run", "second")
    trainer.init_params()
    symbols = trainer.dataset.text_processor.symbols
    if component == "f0":
        assert trainer.jdc is not None and not any(p.requires_grad for p in trainer.jdc.parameters())
        state = torch.load(staged["f0"], weights_only=False)["net"]
        assert torch.equal(trainer.jdc.stem_conv1.weight, state["conv_block.0.weight"])
    elif component == "plbert":
        assert trainer.plbert_geometry == dict(PLBERT_GEOMETRY, vocab_size=len(symbols))
        source = torch.load(staged["plbert"], weights_only=False)["net"][
            "module.encoder.embeddings.word_embeddings.weight"]
        row = PRETRAINED_SYMBOL_TABLE.index("a")
        assert torch.equal(trainer.model.plbert_encoder.word_embeddings[symbols.index("a")],
                           source[row])
        assert isinstance(trainer.gen_opt, GroupedAdamW)
    elif component == "asr":
        assert trainer.asr_geometry == dict(ASR_GEOMETRY, n_token=len(symbols))
        source = torch.load(staged["asr"], weights_only=False)["model"]["init_cnn.conv.weight"]
        assert torch.equal(trainer.model.text_aligner.init_cnn.weight, source)
        assert not hasattr(trainer.model, "tma_aligner")
    else:
        assert trainer.wavlm is not None and hasattr(trainer.discriminators, "slm")
        assert not any(p.requires_grad for p in trainer.wavlm.parameters())
        first = port_trainer(raw, tmp_path / "first", "first")
        assert first.wavlm is None and not hasattr(first.discriminators, "slm")

    caplog.clear()
    missing = {**full, "model": MODEL}
    if section:
        missing["pretrained"] = {section[0]: {section[1]: str(tmp_path / "none.t7")}}
    else:
        missing = {**full, "pretrained": {},
                   "model": {**MODEL, "slm": {"model": str(tmp_path / "none")}}}
    with caplog.at_level(logging.WARNING):
        trainer = port_trainer(missing, tmp_path / "missing", "second")
    assert (trainer.jdc, trainer.plbert_geometry, trainer.asr_geometry, trainer.wavlm) == (
        None, None, None, None)
    assert hasattr(trainer.model, "tma_aligner") and hasattr(trainer.model, "context_encoder")
    if section:
        assert "no such file exists" in caplog.text


@pytest.mark.parametrize("clip", [None, 0.5])
def test_grouped_adamw_matches_optax_multi_transform(clip):
    """Three ``adamw``s at their rates over the ``base``, ``bert`` and
    ``ft`` groups, after one global-norm clip, over three updates; the state
    converts to ``multi_transform``'s layout (masked leaves ``{}``) and
    back."""
    rng = np.random.default_rng(6)
    params = {"params": {"enc": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
                         "plbert_encoder": {"x": rng.standard_normal((5,)).astype(np.float32)},
                         "text_aligner": {"y": rng.standard_normal((2, 2)).astype(np.float32)}}}
    names = {"enc.w": ("enc", "w"), "plbert_encoder.x": ("plbert_encoder", "x"),
             "text_aligner.y": ("text_aligner", "y")}
    grads = [jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
             for _ in range(3)]
    labels = {"plbert_encoder": "bert", "text_aligner": "ft"}

    def label_tree(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: next((labels[e.key] for e in path if getattr(e, "key", None) in labels),
                                 "base"), tree)

    base = optax.multi_transform({"base": optax.adamw(1e-3), "bert": optax.adamw(1e-5),
                                  "ft": optax.adamw(3e-4)}, label_tree)
    opt = optax.chain(optax.clip_by_global_norm(clip), base) if clip else base
    state = opt.init(params)
    want = params
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)

    def named(tree):
        return {n: _t(tree["params"][a][b]) for n, (a, b) in names.items()}

    def to_flax(named_tensors):
        out: dict = {"params": {}}
        for n, (a, b) in names.items():
            out["params"].setdefault(a, {})[b] = named_tensors[n].numpy()
        return out

    port = GroupedAdamW({"base": 1e-3, "bert": 1e-5, "ft": 3e-4}, clip)
    got = named(params)
    port_state = port.init(got)
    for g in grads:
        port.step(got, named(g), port_state)
    for n, (a, b) in names.items():
        np.testing.assert_allclose(got[n].numpy(), want["params"][a][b], atol=1e-6)
    layout = port.to_optax(port_state, to_flax)
    restored = serialization.from_state_dict(opt.init(params), layout)
    for got_leaf, want_leaf in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_allclose(np.asarray(got_leaf), np.asarray(want_leaf), atol=1e-6)
    back = port.from_optax(serialization.to_state_dict(state), named)
    assert {g: s["count"] for g, s in back.items()} == {"base": 3, "bert": 3, "ft": 3}
    for group in back:
        for n, v in back[group]["nu"].items():
            np.testing.assert_allclose(v.numpy(), port_state[group]["nu"][n].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# a regime-2 step


def regime2_setup(tmp, paths, mode: str, slm: bool = False, **losses) -> dict:
    """Both packages' regime-2 trainers of ``mode``, seeded parameters in
    flax's shapes with the staged components grafted in, and one batch."""
    raw = regime2_raw(tmp, paths, slm=slm, **losses)
    jt = jax_trainer(raw, tmp / f"jax-{mode}", mode)
    jt.build_steps()
    batch = make_batch()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: jt.model.init({"params": key, "dropout": key, "noise": key}, batch["text"],
                              batch["text_lengths"], batch["mel"], durations=batch["durations"],
                              f0_frames=batch["f0_frames"], energy_frames=batch["energy_frames"],
                              deterministic=False))
    gen_params = audio_sized(seeded_tree(shapes, 1))
    gen_params["params"]["plbert_encoder"] = _np(jt._plbert_pretrained)
    gen_params["params"]["text_aligner"] = _np(jt._asr_pretrained)
    wav = jnp.zeros((2, 4096))
    disc_shapes = {
        "mpd": jax.eval_shape(MultiPeriodDiscriminator(periods=(2,)).init, key, wav),
        "msd": jax.eval_shape(MultiScaleDiscriminator(n_scales=1).init, key, wav)}
    if slm:
        n_feat = (jt.slm_module.num_layers + 1) * jt.slm_module.hidden_size
        disc_shapes["slm"] = jax.eval_shape(jt.slm_head.init, key, jnp.zeros((2, 16, n_feat)))
    return {"raw": raw, "jax": jt, "batch": batch, "gen_params": gen_params,
            "disc_params": seeded_tree(disc_shapes, 2)}


_JITTED: dict = {}


def _jitted(trainer, name: str, static: tuple):
    key = (id(trainer), name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.value_and_grad(trainer._step_closures[name], has_aux=True),
                               static_argnums=static)
    return _JITTED[key]


def regime2_step_against_jax(setup: dict, tmp, mode: str, epoch: int, monkeypatch,
                             ood: bool = False) -> dict:
    """One port ``train_step`` against ``jax.grad`` of the JAX trainer's
    closures with the same draws; returns the port's losses."""
    jt, batch = setup["jax"], setup["batch"]
    gen_params, disc_params = setup["gen_params"], setup["disc_params"]
    closures = jt._step_closures
    tma = mode == "second" or epoch >= 1
    phase = jt.phase_weights(epoch)
    _, keys, draws = jax_step_draws(jax.random.PRNGKey(epoch + 7), batch, 16)
    hidden = jt.asr_geometry["hidden_dim"] // 2
    masks = AsrMasks(B, N_TEXT, hidden)
    masks.patch(monkeypatch)
    draws.asr_unk, draws.asr_keep = masks.port()
    slm_params = jt.slm_params
    if ood:
        n_bank = jt._load_ood_bank()["tokens"].shape[0]
        for side, rng, parts in (("disc", keys["rng_d"], 3), ("gen", keys["rng_g"], 4)):
            pick, noise_key, _ = jax.random.split(jax.random.split(rng, parts)[-1], 3)
            setattr(draws, f"ood_index_{side}",
                    _t(jax.random.randint(pick, (B,), 0, n_bank)).long())
            setattr(draws, f"ood_noise_{side}", _t(source_noise(noise_key, SEGMENT * HOP)))
    jbatch = jax.tree.map(jnp.asarray, batch)
    targets = jax.jit(closures["alignment_targets"], static_argnums=2)(gen_params, jbatch, tma)
    targets["segment_starts"] = keys["starts"]

    port = port_trainer(setup["raw"], tmp / f"port-{mode}-{epoch}", mode)
    port.load_params({"generator": gen_params, "discriminators": disc_params})
    port.gen_opt_state = port.gen_opt.init(port.gen_params)
    port.disc_opt_state = port.disc_opt.init(port.disc_params)
    seen = {}

    def spy(name, opt):
        step = opt.step

        def recorded(params, grads, state):
            seen[name] = {n: None if g is None else g.detach().clone() for n, g in grads.items()}
            return step(params, grads, state)
        return recorded

    port.gen_opt.step = spy("gen", port.gen_opt)
    port.disc_opt.step = spy("disc", port.disc_opt)
    tbatch = {k: _t(v).long() if k == "text" else _t(v) for k, v in batch.items()}
    port_targets = port.alignment_targets(tbatch, tma)
    for key in ("durations", "f0_frames", "f0_tokens", "energy_tokens"):
        np.testing.assert_allclose(port_targets[key].numpy(), np.asarray(targets[key]),
                                   rtol=1e-4, atol=1e-3, err_msg=key)
    losses = port.train_step(tbatch, draws, epoch=epoch)
    updated_disc = torch_to_flax(port.discriminators.state_dict(), port.discriminators)

    (d_loss, d_metrics), d_grads = _jitted(jt, "disc_loss_fn", (7,))(
        disc_params, gen_params, jbatch, keys["rng_d"], slm_params, phase, targets, ood)
    (g_loss, g_losses), g_grads = _jitted(jt, "gen_loss_fn", (7, 8))(
        gen_params, updated_disc, jbatch, keys["rng_g"], slm_params, phase, targets, ood, tma)
    assert set(d_metrics) | {f"gen/{k}" for k in g_losses} == set(losses)
    for k, v in d_metrics.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    for k, v in g_losses.items():
        np.testing.assert_allclose(losses[f"gen/{k}"].item(), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert_grads_close(seen["disc"], flax_to_torch(_np(d_grads), port.discriminators)[0],
                       "disc", 5e-4)
    assert_grads_close(seen["gen"], flax_to_torch(_np(g_grads), port.model)[0], "gen")
    return losses


@pytest.fixture(scope="module")
def stage1(staged, tmp_path_factory):
    return regime2_setup(tmp_path_factory.mktemp("regime2_stage1"), staged, "first")


@pytest.mark.parametrize("epoch", [0, 1], ids=["asr-targets", "tma"])
def test_regime2_stage1_step_gradients_match_jax_grad(stage1, tmp_path, monkeypatch, epoch):
    """Stage 1 with the three components: the JDC's F0 and the ASR
    aligner's durations as targets from epoch 0, the ``s2s`` loss the ASR
    decoder's cross-entropy from the TMA epoch, PL-BERT's gradient at its
    own group's rate."""
    losses = regime2_step_against_jax(stage1, tmp_path, "first", epoch, monkeypatch)
    assert (losses["gen/s2s"].item() == 0.0) == (epoch == 0)


# ---------------------------------------------------------------------------
# regime-2 checkpoints between the packages


@pytest.fixture(scope="module")
def regime2_ckpt(staged, tmp_path_factory):
    """A stage-2 checkpoint the port's regime-2 trainer wrote, of its
    initial parameters (PL-BERT and the ASR aligner grafted, the SLM head
    in the discriminators, the iSTFT head lowered to audio-sized wavs) and
    its optimizer states."""
    tmp = tmp_path_factory.mktemp("regime2_ckpt")
    trainer = port_trainer(regime2_raw(tmp, staged, "port", slm=True), tmp / "port-stage2",
                           "second")
    trainer.init_params()
    with torch.no_grad():
        trainer.model.decoder.conv_post.bias[:33] = -2.0
        trainer.model.decoder.conv_post.scale.mul_(0.02)
    trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
    trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)
    trainer.maybe_checkpoint(1.0, *trainer.host_state())
    trainer.wait_for_checkpoints()
    path = trainer.ckpt_dir / "stage-2-last.ckpt"
    yield path, load_checkpoint(path)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("mode", ["first", "second"])
def test_regime2_checkpoints_resume_across_packages(staged, regime2_ckpt, tmp_path, mode):
    """A regime-2 stage checkpoint the JAX trainer writes after an update
    of its ``multi_transform`` optimizer resumes in the port's trainer
    (parameters, both optimizer states, the counters), and the port's,
    after an update of its own, through the JAX trainer's load path; the
    headers carry both geometries."""
    last = f"stage-{1 if mode == 'first' else 2}-last.ckpt"
    _, ckpt = regime2_ckpt
    raw = regime2_raw(tmp_path, staged, "jax", slm=mode == "second")
    jt = jax_trainer(raw, tmp_path / "jax-run", mode)
    params, opt = {}, {}
    for key, name in (("generator", "gen"), ("discriminators", "disc")):
        tx = jt.gen_opt if name == "gen" else jt.disc_opt
        tree = ckpt["state_dict"][key]
        if mode == "first" and key == "discriminators":
            tree = {k: v for k, v in tree.items() if k != "slm"}

        @jax.jit  # eager optax compiles each leaf's ops one by one
        def update(grads, tree):
            updates, state = tx.update(grads, tx.init(tree), tree)
            return optax.apply_updates(tree, updates), state

        new, state = update(_seeded_like(tree, 1), tree)
        params[key] = jax.tree.map(np.asarray, new)
        opt[name] = serialization.to_state_dict(state)
    assert set(opt["gen"]["inner_states"]) == {"base", "bert", "ft"}
    jt.global_step, jt.epoch = 1, 1
    jt.maybe_checkpoint(1.0, params, opt, extra=jt._ckpt_extra())
    jt.wait_for_checkpoints()
    port_raw = regime2_raw(tmp_path, staged, "port", slm=mode == "second")
    port_raw["training"]["finetune_checkpoint"] = str(jt.ckpt_dir / last)
    port = port_trainer(port_raw, tmp_path / "port-resume", mode)
    tree, opt_tree = port.load_finetune_checkpoint()
    port.load_params(tree)
    port.gen_opt_state = port.gen_opt.from_optax(
        opt_tree["gen"], port._from_flax_for(port.model, port.gen_params))
    port.disc_opt_state = port.disc_opt.from_optax(
        opt_tree["disc"], port._from_flax_for(port.discriminators, port.disc_params))
    assert {g: s["count"] for g, s in port.gen_opt_state.items()} == {"base": 1, "bert": 1,
                                                                       "ft": 1}
    got_params, got_opt = port.host_state()
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_opt, opt)

    grads = {n: torch.from_numpy(_seeded_like(np.zeros(tuple(p.shape)), 2))
             for n, p in port.gen_params.items()}
    port.gen_opt.step(port.gen_params, grads, port.gen_opt_state)
    port.global_step = 2
    want_params, want_opt = port.host_state()
    port.maybe_checkpoint(1.0, want_params, want_opt)
    port.wait_for_checkpoints()
    header = load_checkpoint_header(port.ckpt_dir / last)
    assert header["pretrained_components"] == {"plbert": port.plbert_geometry,
                                               "asr": port.asr_geometry}
    assert header["pretrained_components"] == jt._ckpt_extra()["pretrained_components"]
    resume = regime2_raw(tmp_path, staged, "jax2", slm=mode == "second")
    resume["training"]["finetune_checkpoint"] = str(port.ckpt_dir / last)
    jt = jax_trainer(resume, tmp_path / "jax-resume", mode)
    state, restore = jt.load_finetune_checkpoint(None)
    gen_state = serialization.from_state_dict(jax.jit(jt.gen_opt.init)(state["generator"]),
                                              restore["gen"])
    disc_state = serialization.from_state_dict(jax.jit(jt.disc_opt.init)(state["discriminators"]),
                                               restore["disc"])
    assert int(gen_state.inner_states["bert"].inner_state[0].count) == 2
    _assert_trees_equal(state, want_params)
    _assert_trees_equal({"gen": serialization.to_state_dict(gen_state),
                         "disc": serialization.to_state_dict(disc_state)}, want_opt)

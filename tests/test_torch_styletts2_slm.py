"""StyleTTS2's SLM-adversarial training in the port (everyvoice_tpu_torch/
models/styletts2/slm.py, utils/safetensors_lite.py, dsp/resample.py's
gradient and the trainer's stage 2 with the SLM) against the JAX package's,
on the CPU, in float32, at small widths (WavLM 32 wide, 2 layers; the other
components as ``test_torch_styletts2_pretrained.py`` stages them), and
regime-2 checkpoints served by both packages.

Tolerances, with their reasons:
- WavLM against its committed golden (transformers' outputs): atol 5e-4 /
  rtol 5e-3, those of ``tests/test_styletts2_goldens.py``;
- WavLM, the SLM head and the resampler's gradient against the JAX
  functions on the same inputs: 1e-4 of the output's largest magnitude,
  float32 sums in another order; the LSGAN losses 1e-6 relative;
- the safetensors reader against the ``safetensors`` package, and the
  HuggingFace-directory loader against the JAX loader (which goes through
  ``transformers``): exact but for the fused weight norm of the positional
  conv, 1e-6 of its peak (numpy against torch arithmetic);
- one stage-2 step with the out-of-domain terms against ``jax.grad``:
  ``test_torch_styletts2_pretrained.py``'s;
- parameters after a checkpoint load, exact; the JAX serving against the
  port's from one checkpoint and one set of draws,
  wavs 2e-4 of max|ref| (the decoder's tolerance in
  ``test_torch_styletts2.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from everyvoice_tpu.dsp.resample import resample as jax_resample
from everyvoice_tpu.models.styletts2 import slm as jax_slm
from everyvoice_tpu.models.styletts2 import synthesize as jax_synth
from everyvoice_tpu.utils import write_filelist
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
from everyvoice_tpu_torch.dsp.resample import resample
from everyvoice_tpu_torch.models.styletts2 import slm as port_slm
from everyvoice_tpu_torch.models.styletts2 import synthesize as port_synth
from everyvoice_tpu_torch.utils import safetensors_lite
from test_styletts2_goldens import load_fixture
from test_torch_styletts2_ckpt import _assert_trees_equal
from test_torch_styletts2_pretrained import (  # noqa: F401
    WAVLM_GEOMETRY,
    _staged,
    close_to_peak,
    drop_checkpoints,
    jax_trainer,
    port_trainer,
    regime2_ckpt,
    regime2_raw,
    regime2_setup,
    regime2_step_against_jax,
)
from test_torch_styletts2_train import _np, _t, no_dropout_one_thread  # noqa: F401

HOP = 256


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    return _staged(tmp_path_factory.mktemp("slm_components"))


# ---------------------------------------------------------------------------
# WavLM and the head


def test_wavlm_matches_its_golden():
    variables, geometry, inputs, expected = load_fixture("wavlm")
    model = port_slm.wavlm_from_flax(geometry, variables)
    with torch.no_grad():
        got = port_slm.stack_hidden_states(model(_t(inputs["wav"])))
    np.testing.assert_allclose(got.numpy(), expected["stacked_hidden"], atol=5e-4, rtol=5e-3)


def test_wavlm_head_and_losses_match_jax(staged):
    """WavLM from the staged HuggingFace directory, the SLM head on its
    stacked states, and both LSGAN losses, each against the JAX function;
    the relative position buckets exactly."""
    geometry, tree = port_slm.load_wavlm_params(staged["wavlm"])
    jmod, jparams = jax_slm.load_wavlm_params(str(staged["wavlm"]))
    assert geometry == {**WAVLM_GEOMETRY, "conv_dim": tuple(WAVLM_GEOMETRY["conv_dim"])}
    model = port_slm.wavlm_from_flax(geometry, tree)
    wav = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32) * 0.3
    with torch.no_grad():
        states = model(_t(wav))
    want = jax.jit(jmod.apply)(jparams, wav)
    assert len(states) == len(want) == geometry["num_layers"] + 1
    for got, ref in zip(states, want):
        close_to_peak(got.numpy(), ref)
    np.testing.assert_array_equal(port_slm.relative_position_buckets(300, 320, 800),
                                  jax_slm.relative_position_buckets(300, 320, 800))

    feats = port_slm.stack_hidden_states(states)
    head = port_slm.SLMDiscriminator(feats.shape[-1], 8)
    jhead = jax_slm.SLMDiscriminator(8)
    hparams = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(1), feats.numpy()))
    hparams = jax.tree.map(lambda x: x + 0.05, hparams)  # nonzero biases
    head.load_state_dict(flax_to_torch(hparams, head)[0])
    with torch.no_grad():
        scores = head(feats)
    want_scores = jhead.apply(hparams, feats.numpy())
    close_to_peak(scores.numpy(), want_scores)
    fake = scores.numpy()[::-1].copy()
    np.testing.assert_allclose(port_slm.slm_generator_loss(scores).item(),
                               float(jax_slm.slm_generator_loss(want_scores)), rtol=1e-6)
    np.testing.assert_allclose(
        port_slm.slm_discriminator_loss(scores, _t(fake)).item(),
        float(jax_slm.slm_discriminator_loss(want_scores, fake)), rtol=1e-6)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(2)
    arrays = {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float16),
              "steps": np.arange(6, dtype=np.int64).reshape(2, 3),
              "flag": np.asarray([True, False])}
    save_file(arrays, str(tmp_path / "x.safetensors"), metadata={"format": "np"})
    got = safetensors_lite.load_file(tmp_path / "x.safetensors")
    assert set(got) == set(arrays)
    for key, value in arrays.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape
        np.testing.assert_array_equal(got[key], value)
    bf16 = torch.from_numpy(arrays["a.weight"]).bfloat16()
    save_torch({"w": bf16}, str(tmp_path / "bf16.safetensors"))
    np.testing.assert_array_equal(safetensors_lite.load_file(tmp_path / "bf16.safetensors")["w"],
                                  bf16.float().numpy())


@pytest.mark.parametrize("safe", [True, False], ids=["model.safetensors", "pytorch_model.bin"])
def test_huggingface_directory_loads_as_jax_loads_it(tmp_path, safe):
    """A directory ``transformers`` writes (either weights file; weight
    norm under whichever keys this ``transformers`` writes) loads without
    ``transformers`` into the tree the JAX loader makes through it."""
    from transformers import WavLMConfig, WavLMModel

    cfg = WavLMConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=64, conv_dim=(16,) * 7, num_buckets=32,
                      max_bucket_distance=80, num_conv_pos_embeddings=15,
                      num_conv_pos_embedding_groups=4, layerdrop=0.0)
    torch.manual_seed(0)
    WavLMModel(cfg).eval().save_pretrained(tmp_path / "wavlm", safe_serialization=safe)
    assert (tmp_path / "wavlm" / ("model.safetensors" if safe else "pytorch_model.bin")).is_file()
    geometry, tree = port_slm.load_wavlm_params(tmp_path / "wavlm")
    jmod, jparams = jax_slm.load_wavlm_params(str(tmp_path / "wavlm"))
    assert geometry == {f: getattr(jmod, f) for f in geometry}
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, value in jax.tree_util.tree_leaves_with_path(_np(jparams)):
        if "pos_conv" in jax.tree_util.keystr(path):
            close_to_peak(flat_got[path], value, 1e-6)
        else:
            np.testing.assert_array_equal(flat_got[path], value)


def test_resample_gradient_matches_jax_grad():
    """The trainer resamples the decoded wav to WavLM's 16 kHz with a
    gradient: values and the gradient of a weighted sum against JAX's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    n_out = -(-4096 * 16000 // 22050)
    w = rng.standard_normal((2, n_out)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = resample(xt, 22050, 16000)
    (y * _t(w)).sum().backward()
    want = jax_resample(jnp.asarray(x), 22050, 16000)
    grad = jax.grad(lambda a: jnp.sum(jax_resample(a, 22050, 16000) * w))(jnp.asarray(x))
    close_to_peak(y.detach().numpy(), want)
    close_to_peak(xt.grad.numpy(), grad)


# ---------------------------------------------------------------------------
# a stage-2 step with the SLM


def write_ood(save_dir, texts) -> None:
    (save_dir / "ood").mkdir(parents=True, exist_ok=True)
    write_filelist([{"text": t} for t in texts], save_dir / "ood" / "default.psv")


OOD_TEXTS = ["the quick brown fox jumps over", "a lazy dog near my big red house",
             "and sings of the sea"]


@pytest.fixture(scope="module")
def stage2(staged, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regime2_stage2")
    write_ood(tmp / "pre", OOD_TEXTS)
    # The diffusion is weighted in at epoch 2, after this step's epoch, as
    # in test_torch_styletts2_train.py's stage-2 step: with it weighted in,
    # the EDM loss's 1/σ² weights make the denoiser's gradients thousands
    # large, and float32 rounding alone (either package against a float64
    # reference) reaches 1e-4 of their peak.
    return regime2_setup(tmp, staged, "second", slm=True, diff_epoch=2)


def test_regime2_stage2_step_with_ood_matches_jax_grad(stage2, tmp_path, monkeypatch):
    """Stage 2 at the joint epoch: the SLM's generator and discriminator
    terms on the decodes (``slm``, ``disc/slm``) and on an out-of-domain
    decode (``slm_ood``, ``disc/slm_ood``), the diffusion computed (and
    weighted 0), the head in the discriminators' tree; WavLM frozen, the
    generator's gradient through it."""
    losses = regime2_step_against_jax(stage2, tmp_path, "second", 1, monkeypatch, ood=True)
    assert {"gen/slm", "gen/slm_ood", "disc/slm", "disc/slm_ood"} <= set(losses)
    assert all(np.isfinite(v.item()) for v in losses.values())


# ---------------------------------------------------------------------------
# regime-2 checkpoints between the packages


def test_stage_two_picks_up_the_other_packages_regime2_stage_one(staged, regime2_ckpt,
                                                                tmp_path):
    """A regime-2 stage-1 checkpoint (no SLM head in its discriminators)
    that the JAX trainer writes in a sibling run is the one the port's
    stage 2 with the SLM resolves and loads: every weight it holds, the
    head left as initialised. The port's regime-2 stage-1 checkpoint is the
    one the JAX stage 2 resolves and loads (without the SLM: the JAX
    trainer with it swaps in the stage-1 discriminators tree whole and then
    finds no head)."""
    from everyvoice_tpu.train import load_checkpoint as jax_load

    _, ckpt = regime2_ckpt
    stage1 = {**ckpt["state_dict"], "discriminators": {
        k: v for k, v in ckpt["state_dict"]["discriminators"].items() if k != "slm"}}
    runs = tmp_path / "logs" / "x" / "base"
    jt = jax_trainer(regime2_raw(tmp_path, staged, "x"), runs / "jax-stage1", "first")
    jt.global_step = 5
    jt.maybe_checkpoint(1.0, stage1, None, extra=jt._ckpt_extra())
    jt.wait_for_checkpoints()
    port = port_trainer(regime2_raw(tmp_path, staged, "x", slm=True), runs / "port-stage2",
                        "second")
    found = port.resolve_first_stage_path(port.training_config["first_stage_path"])
    assert found == jt.ckpt_dir / "stage-1-last.ckpt"
    assert load_checkpoint(found)["pretrained_components"] == {
        "plbert": port.plbert_geometry, "asr": port.asr_geometry}
    port.init_params()
    head = {n: p.detach().clone() for n, p in port.discriminators.slm.named_parameters()}
    port.load_params(load_checkpoint(found)["state_dict"])
    tree = torch_to_flax(port.discriminators.state_dict(), port.discriminators)
    _assert_trees_equal({k: v for k, v in tree.items() if k != "slm"},
                        stage1["discriminators"])
    _assert_trees_equal(torch_to_flax(port.model.state_dict(), port.model),
                        stage1["generator"])
    for n, p in port.discriminators.slm.named_parameters():
        assert torch.equal(p, head[n])

    runs = tmp_path / "logs" / "y" / "base"
    first = port_trainer(regime2_raw(tmp_path, staged, "y"), runs / "port-stage1", "first")
    first.load_params(stage1)
    first.gen_opt_state = first.gen_opt.init(first.gen_params)
    first.disc_opt_state = first.disc_opt.init(first.disc_params)
    first.maybe_checkpoint(1.0, *first.host_state())
    first.wait_for_checkpoints()
    second = jax_trainer(regime2_raw(tmp_path, staged, "y"), runs / "jax-stage2", "second")
    found = second._resolve_first_stage_path(second.config.training.first_stage_path)
    assert found == first.ckpt_dir / "stage-1-last.ckpt"
    _assert_trees_equal(jax_load(found)["state_dict"], stage1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_regime2_checkpoints_serve_in_both_packages(regime2_ckpt, tmp_path, writer):
    """A regime-2 stage-2 checkpoint (PL-BERT and the ASR aligner in its
    generator) serves in the JAX package and in the port alike, whichever
    package wrote it."""
    path, ckpt = regime2_ckpt
    if writer == "jax":
        from everyvoice_tpu.train.checkpoint import save_checkpoint as jax_save

        path = jax_save(tmp_path / "jax.ckpt", "StyleTTS2Module",
                        ckpt["hyper_parameters"]["config"], ckpt["state_dict"],
                        lang2id=ckpt["hyper_parameters"]["lang2id"],
                        extra={"pretrained_components": ckpt["pretrained_components"]})
    jm, params, jcfg, jtp, _ = jax_synth.load_styletts2_model(path, "float32")
    pm, pcfg, ptp, _ = port_synth.load_styletts2_model(path, device="cpu")
    assert pm.asr_geometry == dict(jm.asr_geometry) and pm.plbert_geometry == dict(
        jm.plbert_geometry)
    back = torch_to_flax(pm.state_dict(), pm)
    _assert_trees_equal(back, ckpt["state_dict"]["generator"])
    key = jax.random.PRNGKey(3)
    diffusion = jax.random.normal(key, (1, 2 * pm.style_dim))
    source = jax.random.normal(jax.random.PRNGKey(0), (1, pm.max_frames * pm.hop, 1))[..., 0]
    noise = (torch.from_numpy(np.array(diffusion)), torch.from_numpy(np.array(source)))
    text = "the quick brown fox"
    want = np.asarray(jax_synth.synthesize_text(jm, params, jcfg, jtp, text, rng=key))
    got = port_synth.synthesize_text(pm, pcfg, ptp, text, noise=noise)
    assert got.shape == want.shape and len(got) % HOP == 0
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()

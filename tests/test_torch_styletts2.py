"""The port's StyleTTS2 serving (everyvoice_tpu_torch/models/styletts2)
against the JAX package's, on the CPU, in float32, at small widths, on
inputs made from seeded numpy: each module with a converted copy of the JAX
module's parameters, PL-BERT against the committed transformers golden,
and the whole slice from checkpoints either package wrote, through
``synthesize_text`` and both command lines. Noise is the JAX package's own
draws, passed to the port.

Tolerances, with their reasons:
- the text side (text, context and style encoders, the prosody predictor,
  AdaIN, the denoiser and the sampled style): rtol 1e-4, atol 1e-5, float32
  sums in another order through convs and LSTM steps;
- the decoder, its ResBlocks and the resize: 2e-4 of max|ref|, the
  generator tolerance of the JAX package's own tests (``tests/test_ops.py``);
- the harmonic source: 1e-5 of max|ref| against its float64-phase numpy
  version, and 5e-4 against JAX's, whose float32 running sum of the phase
  is itself 3.5e-4 of the peak off over 8,192 samples (the port sums in
  float64: 204,800 samples at full width);
- PL-BERT: the JAX golden test's atol 2e-4, rtol 2e-3 against transformers
  (``tests/test_styletts2_goldens.py``), and 1e-4 against the JAX module;
- whole syntheses: durations exactly, wavs 2e-4 of max|ref|;
- configs and file names: exact.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp
from everyvoice_tpu.cli import _load_config as jax_load_config
from everyvoice_tpu.cli import main as jax_main
from everyvoice_tpu.config import PreprocessingConfig, TextConfig
from everyvoice_tpu.models.styletts2 import layers as J
from everyvoice_tpu.models.styletts2 import synthesize as jax_synth
from everyvoice_tpu.models.styletts2.config import StyleTTS2Config
from everyvoice_tpu.models.styletts2.model import StyleTTS2Module
from everyvoice_tpu.models.styletts2.model import sample_style_diffusion as jax_sample
from everyvoice_tpu.models.styletts2.plbert import PLBERT as JaxPLBERT
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from everyvoice_tpu_torch import cli, config_files
from everyvoice_tpu_torch.config import styletts2_config
from everyvoice_tpu_torch.config_files import load_config_from_path
from everyvoice_tpu_torch.convert import flax_to_torch, torch_to_flax
from everyvoice_tpu_torch.dsp import read_wav, write_wav
from everyvoice_tpu_torch.models.styletts2 import layers as P
from everyvoice_tpu_torch.models.styletts2 import synthesize as port_synth
from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
from everyvoice_tpu_torch.models.styletts2.model import sample_style_diffusion as port_sample
from everyvoice_tpu_torch.models.styletts2.plbert import PLBERT
from everyvoice_tpu_torch.onchip import seeded_init_, write_corpus, write_project
from everyvoice_tpu_torch.train.checkpoint import save_checkpoint
from everyvoice_tpu_torch.utils import load_config_file, write_config_file
from model_stubs import CONTACT

GOLDEN = Path(__file__).parent / "data" / "golden_pretrained" / "plbert.npz"
TEXT_TOL = dict(rtol=1e-4, atol=1e-5)
LETTERS = list("abcdefghijklmnopqrstuvwxyz")
# One padded length (32 tokens): one compilation of the JAX pipeline.
TEXTS = ["hello there world", "a quick brown fox by the rivers."]
# The tests/model_stubs.py recipe at max_len 32; its decoder is 512 channels
# wide whatever the config says.
TINY_MODEL = {
    "hidden_dim": 64, "style_dim": 32, "max_dur": 20,
    "decoder": {"upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "mpd_layers": [2], "msd_layers": 1},
    "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2, "head_features": 16}},
}
MAX_LEN = 32
TINY_PLBERT = dict(vocab_size=0, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, embedding_size=16, max_position_embeddings=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread here: beside other test workers,
    torch's default of one thread a core oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port(module: torch.nn.Module, params) -> torch.nn.Module:
    """``module`` with the flax ``params`` converted into it."""
    state, absent = flax_to_torch(params, module)
    assert not absent
    module.load_state_dict(state)
    return module.eval()


def seeded_tree(shapes, seed: int):
    """Seeded numpy values in a flax parameter tree's shapes: kernels of
    variance 1/fan-in, embeddings of unit variance, biases about 0 and
    scales (norms, weight norms, snake alphas) about 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(shape.shape).astype(np.float32)
        if "kernel" in name and "scale" not in name:
            return noise / np.sqrt(np.prod(shape.shape[:-1]))
        if "scale" in name or "alpha" in name:
            return 1.0 + 0.1 * noise
        return noise if len(shape.shape) > 1 else 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init(module, seed: int, *args):
    """Seeded parameters of a flax ``module`` for ``args`` (shapes from
    ``jax.eval_shape``: nothing is compiled)."""
    return seeded_tree(jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args), seed)


def close_to_peak(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("m,n", [(8192, 256), (8192, 2048), (1000, 300), (40, 100)])
def test_linear_resize_matches_jax_image_resize(m, n):
    x = np.random.default_rng(m + n).standard_normal((2, m)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n), method="linear")
    close_to_peak(P.linear_resize(_t(x), n), want, 1e-5)


def test_adain_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32) * 3 + 1
    style = rng.standard_normal((2, 8)).astype(np.float32)
    params = init(J.AdaIN1d(16), 0, x, style)
    want = J.AdaIN1d(16).apply(params, x, style)
    got = port(P.AdaIN1d(8, 16), params)(_t(x).transpose(1, 2), _t(style)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, **TEXT_TOL)


def test_adain_resblock_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    style = rng.standard_normal((2, 8)).astype(np.float32)
    block = J.AdaINResBlock1(16, 5, (1, 3))
    params = init(block, 1, x, style)
    want = block.apply(params, x, style)
    got = port(P.AdaINResBlock1(16, 5, (1, 3), 8), params)(
        _t(x).transpose(1, 2), _t(style), torch.float32).transpose(1, 2)
    close_to_peak(got.detach().numpy(), want)


def test_text_encoder_matches_with_pads():
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, 30, (2, 16)).astype(np.int32)
    mask = np.arange(16)[None] < np.array([[11], [16]])
    tokens = np.where(mask, tokens, 0)
    enc = J.TextEncoder(30, 32)
    params = init(enc, 2, tokens, mask)
    want = np.asarray(jax.jit(enc.apply)(params, tokens, mask))
    got = port(P.TextEncoder(30, 32), params)(_t(tokens).long(), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TEXT_TOL)
    # The backward half is in reversed time order: position 0's state has
    # read the whole sequence, pads first.
    assert not np.allclose(want[0, :11, 16:], 0) and np.allclose(want[0, 11:], 0)


def test_style_encoder_matches():
    mel = np.random.default_rng(3).standard_normal((2, 37, 20)).astype(np.float32)
    enc = J.StyleEncoder(16, base_channels=8, max_channels=32)
    params = init(enc, 3, mel)
    want = enc.apply(params, mel)
    got = port(P.StyleEncoder(16, base_channels=8, max_channels=32), params)(_t(mel))
    np.testing.assert_allclose(got.detach().numpy(), want, **TEXT_TOL)


def test_prosody_predictor_matches():
    rng = np.random.default_rng(4)
    text_enc = rng.standard_normal((2, 16, 32)).astype(np.float32)
    style = rng.standard_normal((2, 8)).astype(np.float32)
    mask = np.arange(16)[None] < np.array([[9], [16]])
    pred = J.ProsodyPredictor(8, 32, 12)
    params = init(pred, 4, text_enc, style, mask)
    want = jax.jit(pred.apply)(params, text_enc, style, mask)
    got = port(P.ProsodyPredictor(8, 32, 12), params)(_t(text_enc), _t(style), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TEXT_TOL)


def test_harmonic_noise_source_matches():
    f0 = np.random.default_rng(5).uniform(0, 300, (2, 32)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = J.harmonic_noise_source(jnp.asarray(f0), 256, 22050, key=key)[..., 0]
    noise = np.asarray(jax.random.normal(key, (2, 32 * 256, 1)))[..., 0]
    got = P.harmonic_noise_source(_t(f0), 256, 22050, _t(noise))
    # The phase summed in float64, then as the JAX package rounds it.
    f0_up = np.repeat(f0, 256, axis=1)
    cycles = np.cumsum((f0_up / np.float32(22050)).astype(np.float64), axis=1)
    phase = np.float32(2 * np.pi) * cycles.astype(np.float32)
    harmonics = np.sin(phase[..., None] * np.arange(1, 9, dtype=np.float32))
    exact = (harmonics * (0.1 * (f0_up > 10))[..., None] / 8).sum(-1) + 0.003 * noise
    close_to_peak(got, exact, 1e-5)
    # JAX sums the phase in float32, which alone misses 2e-4 of the peak
    # at 8,192 samples (3.5e-4).
    assert np.abs(np.asarray(want) - exact).max() > 2e-4 * np.abs(exact).max()
    close_to_peak(got, want, 5e-4)


def test_style_decoder_matches():
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, 6, 24)).astype(np.float32)
    f0 = rng.uniform(60, 250, (2, 6)).astype(np.float32)
    style = rng.standard_normal((2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 3)), style_dim=8)
    dec = J.StyleDecoder(**kw)
    params = init(dec, 7, frames, f0, f0, style, key)
    want = jax.jit(dec.apply)(params, frames, f0, f0, style, key)
    noise = np.asarray(jax.random.normal(key, (2, 6 * 256, 1)))[..., 0]
    got = port(P.StyleDecoder(24, **kw), params)(_t(frames), _t(f0), _t(style), _t(noise))
    close_to_peak(got.detach().numpy(), want)


@pytest.fixture(scope="module")
def denoiser():
    rng = np.random.default_rng(8)
    noisy = rng.standard_normal((2, 16)).astype(np.float32)
    emb = rng.standard_normal((2, 24)).astype(np.float32)
    den = J.DiffusionDenoiser(16, 2, 2, 8)
    params = init(den, 8, noisy, jnp.ones((2,)), emb)
    torch_den = port(P.DiffusionDenoiser(16, 24, 2, 2, 8), params)
    return den, params, torch_den, noisy, emb


def test_denoiser_matches(denoiser):
    den, params, torch_den, noisy, emb = denoiser
    sigma = np.array([0.3, 2.5], np.float32)
    want = den.apply(params, noisy, sigma, emb)
    got = torch_den(_t(noisy), _t(sigma), _t(emb))
    np.testing.assert_allclose(got.detach().numpy(), want, **TEXT_TOL)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_sample_style_diffusion_matches(denoiser, scale):
    den, params, torch_den, _, emb = denoiser
    key = jax.random.PRNGKey(9)
    want = jax_sample(lambda x, s, e: den.apply(params, x, s, e), key, jnp.asarray(emb), 16,
                      steps=5, embedding_scale=scale)
    noise = np.asarray(jax.random.normal(key, (2, 16)))
    with torch.no_grad():
        got = port_sample(torch_den, _t(noise), _t(emb), steps=5, embedding_scale=scale)
    np.testing.assert_allclose(got.numpy(), want, **TEXT_TOL)


def test_plbert_matches_the_transformers_golden_and_jax():
    with np.load(GOLDEN) as archive:
        flat = {k: archive[k] for k in archive.files}
    geometry = json.loads(str(flat.pop("geometry")))
    tree: dict = {}
    for key, value in flat.items():
        if key.startswith("params/"):
            node = tree.setdefault("params", {})
            *parents, leaf = key.split("/")[1:]
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = value
    tokens, mask = flat["input/tokens"], flat["input/mask"].astype(bool)
    with torch.no_grad():
        got = port(PLBERT(**geometry), tree)(_t(tokens).long(), _t(mask)).numpy()
    np.testing.assert_allclose(got, flat["expected/hidden"], atol=2e-4, rtol=2e-3)
    want = JaxPLBERT(**geometry).apply(tree, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints and the whole slice


def jax_config(tmp: Path) -> StyleTTS2Config:
    config = StyleTTS2Config(
        contact=CONTACT, model=TINY_MODEL,
        preprocessing=PreprocessingConfig(save_dir=tmp / "preprocessed"),
        text=TextConfig(symbols={"letters": LETTERS}),
    )
    config.training.max_len = MAX_LEN
    return config


def shape_sane(params: dict) -> dict:
    """Durations of 1 or 2 frames (random logits pick up to 20), so that
    in the JAX-written checkpoint a short text fits the 32 frames and a
    longer one does not; a quiet
    iSTFT head, so the wavs stay inside [-1, 1] for the 16-bit files."""
    p = params["params"]
    p["predictor"]["Dense_0"]["bias"][1:3] = (3.5, 3.0)
    p["decoder"]["Conv_3"]["bias"][:9] -= 4.0
    p["decoder"]["WeightNorm_3"]["Conv_3/kernel/scale"] *= 0.2
    return params


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A checkpoint the JAX package wrote (the tests/model_stubs.py recipe,
    seeded values in its parameter tree) and a PL-BERT one the port wrote
    from seeded weights, the same model section."""
    root = tmp_path_factory.mktemp("st2")
    config = jax_config(root)
    n_symbols = len(JaxTextProcessor(config.text).symbols)
    module = StyleTTS2Module.from_config(config, n_symbols=n_symbols)
    shapes = jax.eval_shape(lambda r: module.init(
        {"params": r, "dropout": r, "noise": r},
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32), jnp.zeros((1, MAX_LEN, 80)),
        durations=jnp.full((1, 8), 4, jnp.int32), f0_frames=jnp.full((1, MAX_LEN), 150.0),
        energy_frames=jnp.zeros((1, MAX_LEN))), jax.random.PRNGKey(7))
    plain = jax_save_checkpoint(
        root / "st2.ckpt", "StyleTTS2Module", config,
        {"generator": shape_sane(seeded_tree(shapes, 7))}, lang2id={"default": 0},
        extra={"pretrained_components": {"plbert": None, "asr": None}})

    plbert = {**TINY_PLBERT, "vocab_size": n_symbols}
    raw = {"contact": CONTACT, "model": TINY_MODEL, "training": {"max_len": MAX_LEN},
           "text": {"symbols": {"letters": LETTERS}}}
    model = StyleTTS2.from_config(styletts2_config(raw), n_symbols, plbert_geometry=plbert)
    seeded_init_(model, torch.Generator().manual_seed(11))
    written = save_checkpoint(
        root / "st2-plbert.ckpt", "StyleTTS2Module", raw,
        {"generator": shape_sane(torch_to_flax(model.state_dict(), model))},
        lang2id={"default": 0}, extra={"pretrained_components": {"plbert": plbert, "asr": None}})
    _, wavs, _ = write_corpus(root / "corpus", 1, seed=3)
    audio, sr = read_wav(next(wavs.glob("*.wav")))
    write_wav(root / "reference.wav", audio[0, : sr // 2], sr)  # half a second
    return {"root": root, "jax-written": plain, "port-written-plbert": written,
            "reference": root / "reference.wav"}


def jax_noise(model, seed: int = 0) -> tuple:
    """The JAX pipeline's draws: the diffusion's from PRNGKey(seed), the
    source's from PRNGKey(0)."""
    diffusion = jax.random.normal(jax.random.PRNGKey(seed), (1, 2 * model.style_dim))
    source = jax.random.normal(jax.random.PRNGKey(0), (1, model.max_frames * model.hop, 1))
    return _t(diffusion), _t(source[..., 0])


def port_durations(model, config, tp, text: str, noise, ref_prosodic, blend) -> np.ndarray:
    tokens, mask = port_synth.encode(model, config, tp, text)
    with torch.no_grad():
        emb = model.text_context_embedding(tokens, mask)
        joint = port_sample(model.denoise_style, noise[0], emb)
        prosodic = blend * joint[:, model.style_dim:] + (1 - blend) * _t(ref_prosodic)
        enc = model.encode_text(tokens, mask)
        pros = model.prosody_encoding(tokens, mask, enc)
        logits, _, _ = model.predict_prosody(pros, prosodic, mask)
    return torch.where(mask, torch.clamp(logits.argmax(-1), 1, model.max_dur), 0).numpy()


def jax_durations(model):
    """The JAX serving pipeline's durations (its steps up to the duration
    head, jitted), the prosodic style blended with a reference's."""

    @jax.jit
    def durations(params, tokens, mask, key, ref_prosodic, blend):
        emb = model.apply(params, tokens, mask, method="text_context_embedding")
        joint = jax_sample(lambda x, s, e: model.apply(params, x, s, e, method="denoise_style"),
                           key, emb, 2 * model.style_dim)
        enc = model.apply(params, tokens, mask, method="encode_text")
        pros = model.apply(params, tokens, mask, enc, method="prosody_encoding")
        prosodic = blend * joint[:, model.style_dim:] + (1 - blend) * ref_prosodic
        logits, _, _ = model.apply(params, pros, prosodic, mask, method="predict_prosody")
        return jnp.where(mask, jnp.clip(jnp.argmax(logits, -1), 1, model.max_dur), 0)

    def run(params, tp, text: str, key, ref_prosodic, blend) -> np.ndarray:
        ids = tp.encode_text(text, apply_g2p=False, quiet=True)
        n = -(-len(ids) // 16) * 16
        tokens = jnp.zeros((1, n), jnp.int32).at[0, : len(ids)].set(jnp.asarray(ids))
        mask = jnp.arange(n)[None] < len(ids)
        return np.asarray(durations(params, tokens, mask, key, ref_prosodic, blend))

    return run


@pytest.mark.parametrize("kind", ["jax-written", "port-written-plbert"])
def test_synthesis_matches_jax(ckpts, kind):
    jm, params, jcfg, jtp, _ = jax_synth.load_styletts2_model(ckpts[kind], "float32")
    pm, pcfg, ptp, _ = port_synth.load_styletts2_model(ckpts[kind], device="cpu")
    assert (pm.plbert_geometry is not None) == (kind == "port-written-plbert")
    assert pm.decoder.conv_pre.weight.shape[0] == 512  # the config's 32 is not read
    ref = port_synth.load_reference_style(pm, ckpts["reference"], pcfg)
    if kind == "jax-written":  # the style encoders do not depend on the kind
        want_ref = jax_synth.load_reference_style(jm, params, ckpts["reference"], jcfg)
        for g, w in zip(ref, want_ref):
            np.testing.assert_allclose(g, w, **TEXT_TOL)
    frames = []
    durations_of = jax_durations(jm)
    for i, text in enumerate(TEXTS):
        key = jax.random.PRNGKey(i)
        noise = jax_noise(pm, i)
        # Both texts blend with the reference (one compilation of the JAX
        # pipeline); the CLI's from-text serves without one.
        blend = (0.3, 0.6) if i else (0.8, 0.5)
        durations = durations_of(params, jtp, text, key, ref[1], blend[1])
        np.testing.assert_array_equal(
            port_durations(pm, pcfg, ptp, text, noise, ref[1], blend[1]), durations)
        frames.append(durations.sum())
        options = dict(ref_styles=ref, acoustic_blend=blend[0], prosody_blend=blend[1])
        want = np.asarray(jax_synth.synthesize_text(jm, params, jcfg, jtp, text, rng=key,
                                                    **options))
        got = port_synth.synthesize_text(pm, pcfg, ptp, text, noise=noise, **options)
        assert got.dtype == np.float32
        assert len(got) == min(durations.sum(), MAX_LEN) * 256
        close_to_peak(got, want)
    if kind == "jax-written":
        assert min(frames) < MAX_LEN < max(frames)  # one text fits, one is cut


def test_checkpoint_round_trips(ckpts):
    from everyvoice_tpu.train.checkpoint import load_checkpoint

    for kind in ("jax-written", "port-written-plbert"):
        tree = load_checkpoint(ckpts[kind])["state_dict"]["generator"]
        pm, _, _, _ = port_synth.load_styletts2_model(ckpts[kind], device="cpu")
        back = torch_to_flax(pm.state_dict(), pm)
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for path, value in jax.tree_util.tree_leaves_with_path(back):
            np.testing.assert_allclose(value, flat[path], rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


def test_an_asr_checkpoint_keeps_its_text_aligner(ckpts, tmp_path):
    """The ASR aligner is training's: an ``asr`` checkpoint's
    ``text_aligner`` subtree loads into the model's ``ASRCNN``, untouched,
    and ``torch_to_flax`` writes it back; serving does not need it, nor the
    TMA aligner it replaces."""
    from everyvoice_tpu.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.models.styletts2.asr import ASRCNN, convert_torch_asr_state
    from everyvoice_tpu_torch.onchip import published_asr_state

    ckpt = load_checkpoint(ckpts["jax-written"])
    params = ckpt["state_dict"]["generator"]
    geometry = {"input_dim": 80, "hidden_dim": 16, "n_token": 30, "n_layers": 1,
                "token_embedding_dim": 8}
    state = published_asr_state(torch.Generator().manual_seed(2), geometry)
    aligner = convert_torch_asr_state({k: v.numpy() for k, v in state.items()}, n_layers=1)
    del params["params"]["tma_aligner"]
    params["params"]["text_aligner"] = aligner
    path = jax_save_checkpoint(tmp_path / "asr.ckpt", "StyleTTS2Module",
                               ckpt["hyper_parameters"]["config"], {"generator": params},
                               extra={"pretrained_components": {"plbert": None,
                                                                "asr": geometry}})
    pm, pcfg, ptp, _ = port_synth.load_styletts2_model(path, device="cpu")
    assert not hasattr(pm, "tma_aligner") and isinstance(pm.text_aligner, ASRCNN)
    back = torch_to_flax(pm.state_dict(), pm)["params"]
    assert "tma_aligner" not in back
    flat = dict(jax.tree_util.tree_leaves_with_path(aligner))
    for key, value in jax.tree_util.tree_leaves_with_path(back["text_aligner"]):
        np.testing.assert_array_equal(value, flat[key], err_msg=str(key))
    assert len(flat) == len(jax.tree.leaves(back["text_aligner"]))
    plain = port_synth.load_styletts2_model(ckpts["jax-written"], device="cpu")
    want = port_synth.synthesize_text(*plain[:3], TEXTS[0])
    np.testing.assert_array_equal(port_synth.synthesize_text(pm, pcfg, ptp, TEXTS[0]), want)


# ---------------------------------------------------------------------------
# the command line


@pytest.mark.parametrize("verb", ["text-to-wav", "from-text"])
def test_cli_matches_jax(ckpts, tmp_path, monkeypatch, verb):
    monkeypatch.setattr(port_synth, "draw_noise", lambda model, seed=0: jax_noise(model, seed))
    filelist = tmp_path / "texts.psv"
    filelist.write_text(f"basename|characters\nfirst|{TEXTS[1]}\n", encoding="utf8")
    args = ["synthesize", verb, str(ckpts["jax-written"]), "-t", TEXTS[0], "-f", str(filelist)]
    if verb == "text-to-wav":
        args += ["-r", str(ckpts["reference"]), "--seed", "3", "--diffusion-steps", "4",
                 "--embedding-scale", "1.5", "--acoustic-blend", "0.4", "--prosody-blend", "0.7"]
    else:
        args += ["-s", "narrator"]
    saved = os.environ.pop("EVERYVOICE_DEVICE", None)
    try:
        result = CliRunner().invoke(jax_main, args + ["-o", str(tmp_path / "jax")])
    finally:
        if saved is not None:
            os.environ["EVERYVOICE_DEVICE"] = saved
    assert result.exit_code == 0, result.output
    monkeypatch.setenv("EVERYVOICE_DEVICE", "cpu")
    assert cli.main(args + ["-o", str(tmp_path / "port")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax" / "wav").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "wav").iterdir())
    speaker = "narrator" if verb == "from-text" else "default"
    assert f"first--{speaker}--default.wav" in names and len(names) == 2
    for name in names:
        want, sr = read_wav(tmp_path / "jax" / "wav" / name)
        got, _ = read_wav(tmp_path / "port" / "wav" / name)
        assert sr == 22050 and got.shape == want.shape
        peak = np.abs(want).max()
        assert 0 < peak < 1  # not clipped: the files hold the float wavs
        assert np.abs(got - want).max() <= 2e-4 * peak + 1.0 / 32767  # and one 16-bit step


def test_cli_text_to_wav_refuses_other_checkpoints(tmp_path, monkeypatch, capsys):
    fs2 = save_checkpoint(tmp_path / "fs2.ckpt", "FastSpeech2", {}, {})
    monkeypatch.setenv("EVERYVOICE_DEVICE", "cpu")
    assert cli.main(["synthesize", "text-to-wav", str(fs2), "-t", "hi"]) == 1
    assert "takes a StyleTTS2 checkpoint, not FastSpeech2" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# config


def test_defaults_match_pydantic():
    assert styletts2_config({"contact": CONTACT}) == StyleTTS2Config(
        contact=CONTACT).model_dump(mode="json")
    with pytest.raises(ValueError, match="contact"):
        styletts2_config({})


def _st2_sections():
    from everyvoice_tpu.models.styletts2 import config as c

    schema = config_files.SCHEMA["text-to-wav"]
    return {
        (): c.StyleTTS2Config, ("model",): c.StyleTTS2ModelConfig,
        ("model", "decoder"): c.StyleTTS2DecoderConfig, ("model", "slm"): c.StyleTTS2SLMConfig,
        ("model", "diffusion"): c.StyleTTS2DiffusionConfig,
        ("model", "diffusion", "transformer"): c.StyleTTS2DiffusionTransformerConfig,
        ("model", "diffusion", "dist"): c.StyleTTS2DiffusionDistConfig,
        ("training",): c.StyleTTS2TrainingConfig,
        ("training", "optimizer"): c.StyleTTS2OptimizerConfig,
        ("training", "losses"): c.StyleTTS2LossConfig,
        ("training", "slmadv"): c.StyleTTS2SLMAdvConfig,
        ("training", "ood_raw_data", "*"): c.OODDataSource,
        ("training", "ood_raw_data", "*", "hf"): c.OODDataHFSource,
        ("pretrained",): c.StyleTTS2PretrainedConfig, ("pretrained", "f0"): c.StyleTTS2JDCConfig,
        ("pretrained", "asr"): c.StyleTTS2ASRConfig,
        ("pretrained", "plbert"): c.StyleTTS2PLBERTConfig,
    }, schema


def test_key_sets_equal_the_pydantic_fields():
    sections, schema = _st2_sections()
    for path, cls in sections.items():
        assert set(schema[path]) == set(cls.model_fields), path


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_project_file_loads_as_the_jax_package_loads_it(tmp_path, monkeypatch, fmt):
    filelist, wavs, _ = write_corpus(tmp_path / "corpus", 1)
    config_dir = write_project(tmp_path, filelist, wavs, symbols={"characters": LETTERS},
                               fmt=fmt)
    monkeypatch.chdir(tmp_path)
    path = config_dir / f"everyvoice-text-to-wav.{fmt}"
    overrides = ["model.hidden_dim=64", "training.optimizer.bert_lr=0.5",
                 "training.ood_raw_data.extra.hf.repo_id=someone/texts"]
    for extra in ([], overrides):
        assert load_config_from_path("text-to-wav", path, extra) == jax_load_config(
            "text-to-wav", path, extra).model_dump(mode="json")
    bad = load_config_file(path)
    bad["training"]["losses"] = {"lambda_typo": 1.0}
    write_config_file(config_dir / f"bad.{fmt}", bad)
    with pytest.raises(config_files.ConfigError, match="lambda_typo"):
        load_config_from_path("text-to-wav", config_dir / f"bad.{fmt}")

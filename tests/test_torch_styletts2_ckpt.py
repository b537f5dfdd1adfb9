"""StyleTTS2 checkpoints between the packages, on the CPU, at small widths
(hidden 32, style 16, one upsampling stage; the decoder's convs are 512
channels whatever the config says): each package's trainer resumes the
other's last checkpoint of either stage (parameters and both optax
states, after an update), the stage-1 checkpoint one package writes is the one the other's
stage 2 starts from, and the JAX serving synthesizes from a stage-2
checkpoint the port's trainer wrote. The same with the pretrained
components is ``test_torch_styletts2_pretrained.py``'s and
``test_torch_styletts2_slm.py``'s.

Tolerances: parameters and optimizer states after a load, exact; the JAX
serving against the port's from the same checkpoint and draws, wavs 2e-4
of max|ref| (the decoder's tolerance in ``test_torch_styletts2.py``).
"""

import numpy as np
import pytest
import torch

import jax
import optax
from flax import serialization

from everyvoice_tpu.models.styletts2 import synthesize as jax_synth
from everyvoice_tpu.models.styletts2.config import StyleTTS2Config
from everyvoice_tpu.models.styletts2.train import StyleTTS2Trainer as JaxTrainer
from everyvoice_tpu.parallel import make_mesh
from everyvoice_tpu.text import TextProcessor as JaxTextProcessor
from everyvoice_tpu.train import load_checkpoint as jax_load
from everyvoice_tpu_torch.config import styletts2_config
from everyvoice_tpu_torch.convert import hifigan_tree
from everyvoice_tpu_torch.models.styletts2 import synthesize as port_synth
from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
from everyvoice_tpu_torch.text import TextProcessor
from everyvoice_tpu_torch.train.checkpoint import load_checkpoint, load_checkpoint_header
from test_torch_styletts2_train import MODEL, N_FFT, _Data

HOP = 256


def _raw(tmp, name: str) -> dict:
    return {
        "contact": {"contact_name": "Test Runner", "contact_email": "info@everyvoice.ca"},
        "model": MODEL,
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "preprocessing": {"save_dir": str(tmp / "pre")},
        "training": {"batch_size": 2, "max_len": 48, "decoder_segment_frames": 16,
                     "save_top_k_ckpts": 0,
                     "logger": {"save_dir": str(tmp / "logs"), "name": name}},
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(raw, run_dir, mode):
    config = styletts2_config(raw)
    data = _Data(TextProcessor(config["text"]))
    return StyleTTS2Trainer(config, data, data, {"default": 0}, run_dir=run_dir, mode=mode,
                            compute_dtype="float32", device="cpu")


def _jax(raw, run_dir, mode):
    config = StyleTTS2Config(**raw)
    data = _Data(JaxTextProcessor(config.text))
    return JaxTrainer(config, data, data, lang2id={"default": 0},
                      mesh=make_mesh(jax.devices("cpu")[:1]), run_dir=run_dir, mode=mode,
                      compute_dtype="float32")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], prefix + (key,)).items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg="/".join(key))


@pytest.fixture(scope="module")
def stage2_ckpt(tmp_path_factory):
    """A stage-2 checkpoint the port's trainer wrote, of its initial
    parameters (the iSTFT head lowered to audio-sized wavs) and optimizer
    states, as its fit writes one."""
    tmp = tmp_path_factory.mktemp("st2_ckpt")
    trainer = _port(_raw(tmp, "port"), tmp / "port-stage2", "second")
    trainer.init_params()
    with torch.no_grad():
        trainer.model.decoder.conv_post.bias[: N_FFT // 2 + 1] = -2.0
        trainer.model.decoder.conv_post.scale.mul_(0.02)
    trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
    trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)
    trainer.maybe_checkpoint(1.0, *trainer.host_state())
    trainer.wait_for_checkpoints()
    path = trainer.ckpt_dir / "stage-2-last.ckpt"
    return path, load_checkpoint(path)


def _seeded_like(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@pytest.mark.parametrize("mode", ["first", "second"])
def test_checkpoints_resume_across_packages(stage2_ckpt, tmp_path, mode):
    """A stage's last checkpoint the JAX trainer writes after an optax
    update resumes in the port's trainer of that stage
    (``finetune_checkpoint``): parameters, both optimizer states and the
    counters as written; and the port's, after one update of its own
    optimizers, through the JAX trainer's load path
    (``load_finetune_checkpoint`` and ``from_state_dict`` onto
    ``optax.adamw``'s state)."""
    last = f"stage-{1 if mode == 'first' else 2}-last.ckpt"
    _, ckpt = stage2_ckpt
    jt = _jax(_raw(tmp_path, "jax"), tmp_path / "jax-run", mode)
    params, opt = {}, {}
    for key, name in (("generator", "gen"), ("discriminators", "disc")):
        tx = jt.gen_opt if name == "gen" else jt.disc_opt
        tree = ckpt["state_dict"][key]

        @jax.jit  # eager optax compiles each leaf's ops one by one
        def update(grads, tree):
            updates, state = tx.update(grads, tx.init(tree), tree)
            return optax.apply_updates(tree, updates), state

        new, state = update(_seeded_like(tree, 1), tree)
        params[key] = jax.tree.map(np.asarray, new)
        opt[name] = serialization.to_state_dict(state)
    jt.global_step, jt.epoch = 1, 1
    jt.maybe_checkpoint(1.0, params, opt, extra=jt._ckpt_extra())
    jt.wait_for_checkpoints()
    jax_ckpt = jt.ckpt_dir / last
    raw = _raw(tmp_path, "port")
    raw["training"]["finetune_checkpoint"] = str(jax_ckpt)
    port = _port(raw, tmp_path / "port-resume", mode)
    tree, opt_tree = port.load_finetune_checkpoint()
    port.load_params(tree)
    port.gen_opt_state = port.gen_opt.from_optax(
        opt_tree["gen"], port._from_flax_for(port.model, port.gen_params))
    port.disc_opt_state = port.disc_opt.from_optax(
        opt_tree["disc"], port._from_flax_for(port.discriminators, port.disc_params))
    assert (port.global_step, port.epoch, port.gen_opt_state["count"]) == (1, 1, 1)
    got_params, got_opt = port.host_state()
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_opt, opt)

    grads = {n: torch.from_numpy(_seeded_like(np.zeros(tuple(p.shape)), 2)) for n, p in
             port.gen_params.items()}
    port.gen_opt.step(port.gen_params, grads, port.gen_opt_state)
    port.global_step = 2
    want_params, want_opt = port.host_state()
    port.maybe_checkpoint(1.0, want_params, want_opt)
    port.wait_for_checkpoints()
    port_ckpt = port.ckpt_dir / last
    resume = _raw(tmp_path, "jax")
    resume["training"]["finetune_checkpoint"] = str(port_ckpt)
    jt = _jax(resume, tmp_path / "jax-resume", mode)
    state, restore = jt.load_finetune_checkpoint(None)
    gen_state = serialization.from_state_dict(jax.jit(jt.gen_opt.init)(state["generator"]),
                                              restore["gen"])
    disc_state = serialization.from_state_dict(jax.jit(jt.disc_opt.init)(state["discriminators"]),
                                               restore["disc"])
    header = load_checkpoint_header(port_ckpt)
    assert header["stage"] == mode
    assert header["pretrained_components"] == {"plbert": None, "asr": None}
    assert (jt.global_step, int(gen_state[0].count), int(disc_state[0].count)) == (2, 2, 1)
    _assert_trees_equal(state, want_params)
    _assert_trees_equal({"gen": serialization.to_state_dict(gen_state),
                         "disc": serialization.to_state_dict(disc_state)}, want_opt)


def test_stage_two_picks_up_the_other_packages_stage_one(stage2_ckpt, tmp_path):
    """A stage-1 checkpoint written by one package's trainer, in a sibling
    run of the experiment, is the one the other package's stage 2 resolves
    and loads."""
    _, ckpt = stage2_ckpt
    jt = _jax(_raw(tmp_path, "x"), tmp_path / "logs" / "x" / "base" / "jax-stage1", "first")
    jt.global_step = 5
    jt.maybe_checkpoint(1.0, ckpt["state_dict"], ckpt["optimizer_states"], extra=jt._ckpt_extra())
    jt.wait_for_checkpoints()
    port = _port(_raw(tmp_path, "x"), tmp_path / "logs" / "x" / "base" / "port-stage2", "second")
    found = port.resolve_first_stage_path(port.training_config["first_stage_path"])
    assert found == jt.ckpt_dir / "stage-1-last.ckpt"
    assert load_checkpoint(found)["stage"] == "first"
    port.load_params(load_checkpoint(found)["state_dict"])
    _assert_trees_equal(hifigan_tree(port.model.state_dict(), port.discriminators.state_dict(),
                                     port.model, port.discriminators), ckpt["state_dict"])

    first = _port(_raw(tmp_path, "y"), tmp_path / "logs" / "y" / "base" / "port-stage1", "first")
    first.load_params(ckpt["state_dict"])
    first.gen_opt_state = first.gen_opt.init(first.gen_params)
    first.disc_opt_state = first.disc_opt.init(first.disc_params)
    first.maybe_checkpoint(1.0, *first.host_state())
    first.wait_for_checkpoints()
    second = _jax(_raw(tmp_path, "y"), tmp_path / "logs" / "y" / "base" / "jax-stage2", "second")
    found = second._resolve_first_stage_path(second.config.training.first_stage_path)
    assert found == first.ckpt_dir / "stage-1-last.ckpt"
    assert jax_load(found)["stage"] == "first"
    _assert_trees_equal(jax_load(found)["state_dict"], ckpt["state_dict"])


def test_jax_serving_synthesizes_from_the_ports_checkpoint(stage2_ckpt):
    stage2_ckpt, _ = stage2_ckpt
    jm, params, jcfg, jtp, _ = jax_synth.load_styletts2_model(stage2_ckpt, "float32")
    pm, pcfg, ptp, _ = port_synth.load_styletts2_model(stage2_ckpt, device="cpu")
    text = "the quick brown fox"
    key = jax.random.PRNGKey(3)
    diffusion = jax.random.normal(key, (1, 2 * pm.style_dim))
    source = jax.random.normal(jax.random.PRNGKey(0), (1, pm.max_frames * pm.hop, 1))[..., 0]
    noise = (torch.from_numpy(np.array(diffusion)), torch.from_numpy(np.array(source)))
    want = np.asarray(jax_synth.synthesize_text(jm, params, jcfg, jtp, text, rng=key))
    got = port_synth.synthesize_text(pm, pcfg, ptp, text, noise=noise)
    assert got.shape == want.shape and len(got) % HOP == 0
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()

"""Multi-device GAN training in the port on the CPU: a HiFiGAN step and
a StyleTTS2 stage-1 step (before its TMA phase) and stage-2 step (the TMA
on, the diffusion weighted in)
on two gloo ranks under ddp, fsdp and tp2 (``torch_parallel_workers``),
against the port's own one-process step on the global batch, which
``test_torch_hifigan_train.py`` and ``test_torch_styletts2_train.py`` hold
to ``jax.grad``. Global batches of two rows, one a rank under ddp and
fsdp; the StyleTTS2 rows have unequal text and frame lengths, and each
rank draws the global batch's ``StepDraws`` and keeps its row.

Tolerances (those of the one-process tests): losses 1e-4 relative (atol
1e-7); each network's reduced gradients 1e-4 of each leaf's peak, the
discriminators' 5e-4; the gradients that are 0 in exact arithmetic (the
scale and bias of a conv an AdaIN follows, an attention key bias) against
their conv kernel's peak and 1e-6 of the largest. Dropout is 0, Adam's
epsilon 1e-3 (``torch_parallel_workers.ADAM_EPS``), and the seeded
StyleTTS2 decoder's wavs of an audio's size (as
``test_torch_styletts2_train.py``'s ``audio_sized``).
"""

import pytest
import torch

from everyvoice_tpu_torch.config import hifigan_training_config, styletts2_config
import torch_parallel_workers as workers

CONTACT = {"contact_name": "Parallel", "contact_email": "parallel@example.org"}
HIFIGAN = {"contact": CONTACT,
           "model": {"upsample_rates": [8, 2], "upsample_kernel_sizes": [16, 4],
                     "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 5],
                     "resblock_dilation_sizes": [[1, 3], [1, 2]], "mpd_layers": [3],
                     "msd_layers": 0},
           "preprocessing": {"audio": {"n_fft": 128, "fft_window_size": 128, "fft_hop_size": 16,
                                       "n_mels": 20, "vocoder_segment_size": 256}},
           "training": {"logger": {"name": "parallel"}}}
STYLETTS2 = {"contact": CONTACT,
             "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 20,
                       # one upsampling stage and an iSTFT of hop 32, as in
                       # test_torch_styletts2_train.py
                       # one MPD period and no MSD (HiFiGAN's too): the
                       # discriminators' fixed widths are most of the step
                       "decoder": {"mpd_layers": [2], "msd_layers": 0, "upsample_rates": [8],
                                   "upsample_kernel_sizes": [16], "gen_istft_n_fft": 64,
                                   "gen_istft_hop_size": 32},
                       "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                     "head_features": 8}}},
             "training": {"max_len": 32, "decoder_segment_frames": 8,
                          "losses": {"tma_epoch": 1, "diff_epoch": 1},
                          "logger": {"name": "parallel"}},
             "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
RUNS = ("hifigan", "st2_first", "st2_second")
GRAD_TOL = {"gen": 1e-4, "disc": 5e-4}


def _configs(root):
    hifigan = {**HIFIGAN, "training": {**HIFIGAN["training"],
                                       "logger": {"save_dir": str(root), "name": "parallel"}}}
    st2 = {**STYLETTS2, "training": {**STYLETTS2["training"],
                                     "logger": {"save_dir": str(root), "name": "parallel"}}}
    return hifigan_training_config(hifigan), styletts2_config(st2)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_gan")
    hifigan, st2 = _configs(root)

    def one_process() -> dict:
        want = {}
        trainer = workers.hifigan_trainer(hifigan, root / "one_hifigan")
        want["hifigan"] = workers.gan_steps(
            trainer, [workers.hifigan_batch()], lambda b: trainer.train_step(b, gan_on=True))
        for mode, epoch in workers.STYLETTS2_STEPS:
            st2_trainer = workers.styletts2_trainer(st2, mode, root / f"one_st2_{mode}")
            want[f"st2_{mode}"] = workers.gan_steps(
                st2_trainer, [workers.styletts2_batch()],
                lambda b, t=st2_trainer, e=epoch: t.train_step(b, epoch=e))
        return want

    want = workers.spawn(workers.gan_suite, (hifigan, st2, str(root / "ranks")), timeout=600,
                         meanwhile=one_process)
    got = {name: torch.load(root / "ranks" / f"gan_{name}.pt") for name in workers.STRATEGIES}
    return got, want


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("strategy", sorted(workers.STRATEGIES))
def test_two_rank_gan_step_is_the_one_process_step(steps, strategy, run):
    got_all, want_all = steps
    got, want = got_all[strategy][run], want_all[run]
    assert len(got["losses"]) == len(want["losses"])
    for g_losses, w_losses in zip(got["losses"], want["losses"]):
        assert set(g_losses) == set(w_losses)
        for key, value in w_losses.items():
            assert g_losses[key] == pytest.approx(value, rel=1e-4, abs=1e-7), (key, strategy)
    assert set(got["grads"]) == set(want["grads"]) == {"gen", "disc"}
    for net, tol in GRAD_TOL.items():
        assert len(got["grads"][net]) == len(want["grads"][net])
        for g_step, w_step in zip(got["grads"][net], want["grads"][net]):
            assert set(g_step) == set(w_step)
            largest = max(float(w.abs().max()) for w in w_step.values())
            for name, w in w_step.items():
                peak = max(float(w.abs().max()), 1e-12)
                if ".convs1." in name and not name.endswith(".weight"):
                    # An AdaIN normalizes this conv's output per channel
                    # next: the gradient of its scale and bias is 0 in
                    # exact arithmetic (test_torch_styletts2_train.py).
                    peak = float(w_step[name.rsplit(".", 1)[0] + ".weight"].abs().max())
                if name.endswith(".key.bias"):
                    # Softmax ignores a constant added to a row of logits:
                    # 0 in exact arithmetic (test_torch_fs2_train.py).
                    peak = 1e-2 * largest
                err = float((g_step[name] - w).abs().max())
                assert err <= tol * peak, (strategy, run, net, name, err, peak)


def test_fsdp_shards_the_gan_networks(steps):
    got, _ = steps
    assert got["fsdp"]["hifigan_sharded"] > 0
    assert got["ddp"]["hifigan_sharded"] == got["tp2"]["hifigan_sharded"] == 0

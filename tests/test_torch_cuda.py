"""Tests that need a CUDA card: the port's hand-written kernels against their
plain PyTorch versions, the wrappers' refusals, one FastSpeech2 training
step and one HiFiGAN GAN step in bfloat16 and in float32, the vocoder's
re-fold after an optimizer step and a ResBlock2 generator. Without a card
they skip.

This file imports nothing of JAX, so it also runs on a machine that has no
JAX, without the repository's conftest (which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: for the MRF stage, 1e-4 of max|ref| in float32 with TF32 off
(sums in another order), 2e-2 of max|ref| in bfloat16 (conv operands
rounded to bf16 in both versions; the order of the float32 sums still
differs); for the log-mel, 1e-4 absolute, the JAX package's own
kernel-vs-XLA tolerance; for the float32 training steps, losses and gradient
norms within 1e-3 relative of the CPU's from the same parameters (TF32 off);
for float32 generator forwards on the card against the CPU's or against the
torch-conv forward, 1e-4 of max|ref|.
"""

import numpy as np
import pytest
import torch

from everyvoice_tpu_torch.ops.mel import log_mel, log_mel_reference
from everyvoice_tpu_torch.ops.mrf import mrf_stage, mrf_stage_reference, pack_mrf_weights

pytestmark = pytest.mark.cuda

V1 = ((3, 7, 11), ((1, 3, 5),) * 3)
CASES = {
    # (B, T, C), kernels, dilations
    "v1_c64_odd_length": ((2, 3001, 64), *V1),
    # 1000 frames of the last V1 stage at a served batch: on an H100's 132
    # SMs the wrapper plans the largest time tile, 2048 rows
    "v1_c32_tile_2048": ((4, 256000, 32), *V1),
    "v1_c256_shorter_than_halo": ((1, 5, 256), *V1),
    "two_chains_c32": ((1, 1000, 32), (3, 7), ((1, 3), (1, 3))),
    "one_chain_c96": ((3, 77, 96), (3,), ((1,),)),
    # the served extremes of the first V1 stage (1000 frames, B = 1 and 8)
    "v1_c256_served_b1": ((1, 8000, 256), *V1),
    "v1_c256_served_b8": ((8, 8000, 256), *V1),
    # T not a multiple of the bf16 kernel's 256-row tile
    "v1_c128_ragged_tiles": ((2, 6433, 128), *V1),
    "uneven_dilation_counts_c64": ((2, 2000, 64), (11, 3), ((1, 3, 5), (2,))),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, kernels, dils, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, t, c = shape
    x = torch.randn(b, t, c, generator=gen)
    weights, biases = [], []
    for k, ds in zip(kernels, dils):
        for _ in range(2 * len(ds)):
            weights.append(torch.randn(k * c, c, generator=gen) / (k * c) ** 0.5)
            biases.append(0.1 * torch.randn(c, generator=gen))
    w, bias = pack_mrf_weights(weights, biases, dtype)
    return x.to(dtype).to(device), w.to(device), bias.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mrf_kernel_matches_plain_version(card, case, dtype):
    shape, kernels, dils = CASES[case]
    x, w, bias = _inputs(shape, kernels, dils, dtype, card)
    before = mrf_stage.launches
    kernels_before = mrf_stage.kernel_launches
    got = mrf_stage(x, w, bias, kernels, dils)
    ref = mrf_stage_reference(x, w, bias, kernels, dils)
    torch.cuda.synchronize()
    assert mrf_stage.launches == before + 1
    # bf16: prologue, two convs per dilation step, finish; float32: one launch
    issued = 2 + 2 * max(len(ds) for ds in dils) if dtype == torch.bfloat16 else 1
    assert mrf_stage.kernel_launches == kernels_before + issued
    assert got.shape == x.shape and got.dtype == dtype and got.is_cuda
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item()


def test_mrf_kernel_refuses_what_it_does_not_take(card):
    """A CUDA tensor goes to the kernel or raises; nothing falls back to the
    plain version."""
    kernels, dils = (3,), ((1,),)
    x, w, bias = _inputs((1, 50, 48), kernels, dils, torch.float32, card)
    before = mrf_stage.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        mrf_stage(x, w, bias, kernels, dils)
    x, w, bias = _inputs((1, 50, 64), kernels, dils, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stage(x[:, ::2], w, bias, kernels, dils)
    with pytest.raises(ValueError):
        mrf_stage(x, w.cpu(), bias.cpu(), kernels, dils)
    assert mrf_stage.launches == before


MEL_CASES = {
    # (B, S), n_fft, win, hop, the kernel log_mel must take
    "served_bucket_16x131072": ((16, 131072), 1024, 1024, 256, "fft"),
    "odd_length_3x8193": ((3, 8193), 1024, 1024, 256, "fft"),
    "win_800": ((2, 25677), 1024, 800, 256, "fft"),
    "n_fft_2048_hop_512": ((2, 51211), 2048, 2048, 512, "fft"),
    "hop_128_k8": ((2, 25605), 1024, 1024, 128, "fft"),
    # fewer frames a block, so the staged audio fits in shared memory
    "n_fft_2048_hop_2048": ((2, 40961), 2048, 2048, 2048, "fft"),
    # not a power of two: the DFT kernel (and n_fft not a multiple of its
    # 32-sample chunk)
    "n_fft_1000_hop_250": ((2, 25031), 1000, 1000, 250, "dft"),
}


@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_log_mel_kernel_matches_plain_version(card, case):
    (b, s), n_fft, win, hop, route = MEL_CASES[case]
    gen = torch.Generator().manual_seed(0)
    x = (0.3 * torch.randn(b, s, generator=gen)).to(card)
    before, fft_before = log_mel.launches, log_mel.fft_launches
    got = log_mel(x, 22050, n_fft, win, hop)
    ref = log_mel_reference(x, 22050, n_fft, win, hop)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    assert log_mel.fft_launches == fft_before + (route == "fft")
    assert got.shape == (b, 80, s // hop + 1) and got.is_cuda
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4


def test_log_mel_kernel_refuses_what_it_does_not_take(card):
    """A CUDA tensor goes to the kernel or raises; nothing falls back to the
    plain version."""
    x = torch.zeros(2, 8192, device=card)
    before, fft_before = log_mel.launches, log_mel.fft_launches
    with pytest.raises(ValueError, match="contiguous"):
        log_mel(x.t().contiguous().t())
    with pytest.raises(ValueError, match="mels"):
        log_mel(x, n_mels=256)
    with pytest.raises(TypeError):
        log_mel(x.half())
    assert (log_mel.launches, log_mel.fft_launches) == (before, fft_before)


def _small_trainer(tmp_path, compute_dtype, device):
    """A small FastSpeech2 trainer with every dropout at 0, seeded
    parameters and a fresh optimizer, and one synthetic batch on its
    device (mel and prior rounded to float16, as the trainer sends them)."""
    from everyvoice_tpu_torch.config import fs2_training_config
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer

    conformer = {"layers": 1, "input_dim": 64, "feedforward_dim": 128, "conv_kernel_size": 3,
                 "dropout": 0.0}
    vp = {"n_layers": 1, "input_dim": 64, "dropout": 0.0}
    config = fs2_training_config({
        "contact": {"contact_name": "Card Test", "contact_email": "card@example.org"},
        "model": {"encoder": conformer, "decoder": conformer, "max_length": 128,
                  "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
    })

    class Data:
        text_processor = TextProcessor(config["text"])
        items: list = []

    trainer = FastSpeech2Trainer(config, Data(), Data(), {}, {}, run_dir=tmp_path / compute_dtype,
                                 compute_dtype=compute_dtype, device=device)
    trainer.model.postnet.drop.p = 0.0
    trainer.init_params()
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    rng = np.random.default_rng(0)
    b, n, t = 4, 16, 128
    text_lengths = np.asarray([16, 11, 7, 3], np.int32)
    mel_lengths = np.asarray([120, 80, 50, 20], np.int32)
    batch = {"text": np.zeros((b, n), np.int32), "text_lengths": text_lengths,
             "mel": np.zeros((b, t, 80), np.float32), "mel_lengths": mel_lengths,
             "pitch": np.zeros((b, t), np.float32), "energy": np.zeros((b, t), np.float32),
             "attn_prior": np.zeros((b, t, n), np.float32),
             "speaker_id": np.zeros(b, np.int32), "language_id": np.zeros(b, np.int32)}
    for i in range(b):
        k, m = text_lengths[i], mel_lengths[i]
        batch["text"][i, :k] = rng.integers(2, 28, k)
        batch["mel"][i, :m] = rng.standard_normal((m, 80)) - 4.0
        batch["pitch"][i, :m] = rng.standard_normal(m)
        batch["energy"][i, :m] = rng.standard_normal(m)
        batch["attn_prior"][i, :m, :k] = rng.uniform(0.01, 1.0, (m, k))
    return trainer, to_device(compress_for_transfer(batch, ("mel", "attn_prior")), trainer.device)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_fs2_training_step_on_the_card(card, tmp_path, compute_dtype):
    trainer, batch = _small_trainer(tmp_path, compute_dtype, card)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    losses = trainer.train_step(batch, 1.0)
    torch.cuda.synchronize()
    assert trainer.device.type == "cuda" and trainer.compute_dtype == compute_dtype
    assert all(torch.isfinite(v) for v in losses.values()) and torch.isfinite(trainer.grad_norm)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in trainer.params.values())
    # AdamW decays every parameter, so every one moves.
    assert all(not torch.equal(before[n], p) for n, p in trainer.params.items())
    if compute_dtype == "float32":
        cpu, cpu_batch = _small_trainer(tmp_path / "cpu", "float32", "cpu")
        want = cpu.train_step(cpu_batch, 1.0)
        for key, value in want.items():
            assert losses[key].item() == pytest.approx(value.item(), rel=1e-3), key
        assert trainer.grad_norm.item() == pytest.approx(cpu.grad_norm.item(), rel=1e-3)


GAN_MODEL = {"upsample_rates": [8, 2], "upsample_kernel_sizes": [16, 4],
             "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 5],
             "resblock_dilation_sizes": [[1, 3], [1, 2]], "mpd_layers": [2, 3], "msd_layers": 2}
GAN_AUDIO = {"n_fft": 128, "fft_window_size": 128, "fft_hop_size": 16, "n_mels": 20,
             "vocoder_segment_size": 512}


def _gan_trainer(tmp_path, compute_dtype, device, model=GAN_MODEL):
    """A small HiFiGAN trainer with seeded parameters and fresh optimizers,
    and one synthetic batch of 4 segments on its device (mel rounded to
    float16, as the trainer sends it)."""
    from everyvoice_tpu_torch.config import hifigan_training_config
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.train.loop import HiFiGANTrainer

    config = hifigan_training_config({
        "contact": {"contact_name": "Card Test", "contact_email": "card@example.org"},
        "model": model, "preprocessing": {"audio": GAN_AUDIO},
    })

    class Data:
        items: list = []

    trainer = HiFiGANTrainer(config, Data(), Data(), run_dir=tmp_path / f"gan-{compute_dtype}",
                             compute_dtype=compute_dtype, device=device)
    trainer.init_params()
    trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
    trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)
    rng = np.random.default_rng(0)
    t = np.arange(GAN_AUDIO["vocoder_segment_size"]) / 22050
    batch = {"mel": (rng.standard_normal((4, 32, 20)) - 4.0).astype(np.float32),
             "audio": (0.5 * np.sin(2 * np.pi * rng.uniform(100, 400, (4, 1)) * t)).astype(np.float32)}
    return trainer, to_device(compress_for_transfer(batch, ("mel",)), trainer.device)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_hifigan_gan_step_on_the_card(card, tmp_path, compute_dtype):
    trainer, batch = _gan_trainer(tmp_path, compute_dtype, card)
    params = {**trainer.gen_params, **{f"disc.{n}": p for n, p in trainer.disc_params.items()}}
    before = {n: p.detach().clone() for n, p in params.items()}
    launches = mrf_stage.launches
    losses = trainer.train_step(batch, gan_on=True)
    torch.cuda.synchronize()
    assert mrf_stage.launches == launches  # the training step runs torch convs
    assert trainer.device.type == "cuda" and trainer.compute_dtype == compute_dtype
    assert all(torch.isfinite(v) for v in losses.values())
    assert torch.isfinite(trainer.grad_norm) and torch.isfinite(trainer.disc_grad_norm)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in params.values())
    # AdamW decays every parameter, so every one of both networks moves.
    assert all(not torch.equal(before[n], p) for n, p in params.items())
    if compute_dtype == "float32":
        cpu, cpu_batch = _gan_trainer(tmp_path / "cpu", "float32", "cpu")
        want = cpu.train_step(cpu_batch, gan_on=True)
        for key, value in want.items():
            assert losses[key].item() == pytest.approx(value.item(), rel=1e-3), key
        assert trainer.grad_norm.item() == pytest.approx(cpu.grad_norm.item(), rel=1e-3)
        assert trainer.disc_grad_norm.item() == pytest.approx(cpu.disc_grad_norm.item(), rel=1e-3)


def test_vocoder_refolds_after_an_optimizer_step(card, tmp_path):
    """The inference forward (the MRF kernel, folded weights cached) follows
    the optimizer's in-place update: it agrees with the torch-conv forward
    of the updated parameters."""
    from everyvoice_tpu_torch.utils.precision import no_tf32

    trainer, batch = _gan_trainer(tmp_path, "float32", card)
    mel = batch["mel"].float()
    launches = mrf_stage.launches
    before = trainer.generator(mel)
    trainer.train_step(batch, gan_on=True)
    after = trainer.generator(mel)
    with torch.no_grad(), no_tf32():
        want = trainer.generator.train_forward(mel)
    torch.cuda.synchronize()
    assert mrf_stage.launches == launches + 2 * len(GAN_MODEL["upsample_rates"])
    assert not torch.equal(before, after)
    assert (after - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("istft", [False, True], ids=["tanh", "istft"])
def test_resblock2_generator_on_the_card(card, istft):
    """A ResBlock2 generator's forward (torch convs) on the card in float32
    matches the CPU's; in bfloat16 it is finite and as long."""
    from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
    from everyvoice_tpu_torch.train.loop import init_hifigan_parameters

    kwargs = dict(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4), upsample_initial_channel=128,
                  resblock="2", resblock_kernel_sizes=(3, 7, 11),
                  resblock_dilation_sizes=((1, 3, 5),) * 3, istft_layer=istft)
    mel = torch.randn(2, 40, 80, generator=torch.Generator().manual_seed(1))
    out = {}
    for device, dtype in (("cpu", "float32"), ("cuda", "float32"), ("cuda", "bfloat16")):
        gen = HiFiGANGenerator(**kwargs, compute_dtype=dtype)
        init_hifigan_parameters(gen, torch.Generator().manual_seed(0))
        launches = mrf_stage.launches
        out[device, dtype] = gen.to(device)(mel.to(device)).float().cpu()
        assert mrf_stage.launches == launches
    want = out["cpu", "float32"]
    hop = 16 * (4 if istft else 1)
    assert want.shape == (2, 40 * hop)
    assert (out["cuda", "float32"] - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.isfinite(out["cuda", "bfloat16"]).all()
    assert out["cuda", "bfloat16"].shape == want.shape

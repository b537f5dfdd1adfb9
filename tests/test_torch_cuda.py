"""Tests that need a CUDA card: the port's hand-written kernels against their
plain PyTorch versions, the wrappers' refusals, one FastSpeech2 training
step and one HiFiGAN GAN step in bfloat16 and in float32, the vocoder's
re-fold after an optimizer step, a ResBlock2 generator, a StyleTTS2
synthesis, a StyleTTS2 training step, a stage-2 step with the
pretrained components and the SLM, the aligner's wav2vec2-CTC model and
windowed scoring, and a demo request. Without a card they skip.

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
torch-conv forward, 1e-4 of max|ref|; for the aligner's float32 log-probs,
the wav2vec2 golden's atol 5e-4, rtol 5e-3.
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


def test_styletts2_synthesis_on_the_card(card, tmp_path):
    """A StyleTTS2 synthesis in float32 on the card matches the CPU's from
    the same checkpoint and noise (1e-3 of max|ref|, the serving check's
    synthesis tolerance); in bfloat16 it is finite and as long."""
    import numpy as np

    from everyvoice_tpu_torch.config import styletts2_config
    from everyvoice_tpu_torch.convert import torch_to_flax
    from everyvoice_tpu_torch.models.styletts2.model import StyleTTS2
    from everyvoice_tpu_torch.models.styletts2.synthesize import (
        load_styletts2_model,
        synthesize_text,
    )
    from everyvoice_tpu_torch.onchip import seeded_init_
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.train.checkpoint import save_checkpoint

    raw = {"contact": {"contact_name": "Card", "contact_email": "card@example.org"},
           "model": {"hidden_dim": 64, "style_dim": 32, "max_dur": 8,
                     "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                   "head_features": 16}}},
           "training": {"max_len": 64},
           "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
    config = styletts2_config(raw)
    model = StyleTTS2.from_config(config, len(TextProcessor(config["text"]).symbols))
    seeded_init_(model, torch.Generator().manual_seed(0))
    path = save_checkpoint(tmp_path / "st2.ckpt", "StyleTTS2Module", raw,
                           {"generator": torch_to_flax(model.state_dict(), model)})
    out = {}
    for device, dtype in (("cpu", "float32"), ("cuda", "float32"), ("cuda", "bfloat16")):
        loaded, cfg, tp, _ = load_styletts2_model(path, compute_dtype=dtype, device=device)
        out[device, dtype] = synthesize_text(loaded, cfg, tp, "hello there, world", seed=1)
    want = out["cpu", "float32"]
    assert len(want) % 256 == 0 and 0 < len(want) <= 64 * 256
    assert out["cuda", "float32"].shape == want.shape
    assert np.abs(out["cuda", "float32"] - want).max() <= 1e-3 * np.abs(want).max()
    assert np.isfinite(out["cuda", "bfloat16"]).all()
    assert out["cuda", "bfloat16"].shape == want.shape


def _st2_batch(device, b=2, n_text=12, frames=64, hop=256, seed=0):
    """A StyleTTS2 training batch of seeded values, as ``StyleTTS2Dataset``
    lays one out (uniform durations and their token means)."""
    gen = torch.Generator().manual_seed(seed)
    text_lengths = torch.tensor([n_text, n_text - 4])
    mel_lengths = torch.tensor([frames, frames - 13])
    text = torch.randint(2, 28, (b, n_text), generator=gen)
    text[torch.arange(n_text)[None] >= text_lengths[:, None]] = 0
    valid = torch.arange(frames)[None] < mel_lengths[:, None]
    f0 = torch.where(valid, 80 + 170 * torch.rand(b, frames, generator=gen), 0.0)
    energy = torch.where(valid, torch.randn(b, frames, generator=gen), 0.0)
    durations = torch.zeros(b, n_text, dtype=torch.int32)
    for i in range(b):
        n, t = int(text_lengths[i]), int(mel_lengths[i])
        durations[i, :n] = t // n
        durations[i, n - 1] += t - int(durations[i, :n].sum())
    cum = torch.cumsum(durations.long(), 1)
    starts = cum - durations.long()
    f0_tok = torch.stack([torch.stack([f0[i, s:e].mean() if e > s else torch.tensor(0.0)
                                       for s, e in zip(starts[i], cum[i])]) for i in range(b)])
    energy_tok = torch.stack([torch.stack([energy[i, s:e].mean() if e > s else torch.tensor(0.0)
                                           for s, e in zip(starts[i], cum[i])]) for i in range(b)])
    t = torch.arange(frames * hop) / 22050
    audio = 0.5 * torch.sin(2 * np.pi * torch.tensor([[140.0], [210.0]]) * t)
    audio = audio + 0.05 * torch.randn(b, frames * hop, generator=gen)
    audio = torch.where(torch.arange(frames * hop)[None] < mel_lengths[:, None] * hop, audio, 0.0)
    batch = {"text": text, "text_lengths": text_lengths.int(), "mel_lengths": mel_lengths.int(),
             "mel": torch.where(valid[..., None], torch.randn(b, frames, 80, generator=gen) - 4, 0.0),
             "f0_frames": f0, "energy_frames": energy, "f0_tokens": f0_tok,
             "energy_tokens": energy_tok, "durations": durations, "audio": audio}
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_styletts2_training_step_on_the_card(card, tmp_path, compute_dtype):
    """One StyleTTS2 step of a small model on the card: in float32 (stage 1
    before the TMA, whose targets need no Viterbi path, dropout off) its
    losses and both gradient norms within 1e-3 relative of the CPU's from
    the same parameters and draws; in bfloat16 a stage-2 step (TMA and
    diffusion on) with finite losses that moves the parameters."""
    from everyvoice_tpu_torch.config import styletts2_config
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.text import TextProcessor

    raw = {"contact": {"contact_name": "Card", "contact_email": "card@example.org"},
           "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 20,
                     "decoder": {"mpd_layers": [2], "msd_layers": 1},
                     "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                   "head_features": 8}}},
           "training": {"max_len": 64, "decoder_segment_frames": 16,
                        "losses": {"tma_epoch": 1, "diff_epoch": 1},
                        "logger": {"save_dir": str(tmp_path), "name": "card"}},
           "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
    config = styletts2_config(raw)

    class Data:
        text_processor = TextProcessor(config["text"])
        n_symbols = len(text_processor.symbols)
        items: list = []

    def trainer(device, mode):
        t = StyleTTS2Trainer(config, Data(), Data(), {"default": 0}, run_dir=tmp_path / device,
                             mode=mode, compute_dtype=compute_dtype, device=device)
        t.init_params(seed=0)
        t.gen_opt_state = t.gen_opt.init(t.gen_params)
        t.disc_opt_state = t.disc_opt.init(t.disc_params)
        return t

    if compute_dtype == "bfloat16":
        t = trainer("cuda", "second")
        before = t.model.text_encoder.embed.weight.detach().clone()
        losses = t.train_step(_st2_batch("cuda"), epoch=1)
        assert {"gen/diff", "gen/sty", "gen/s2s", "gen/mono"} <= set(losses)
        assert all(torch.isfinite(v) for v in losses.values())
        assert not torch.equal(before, t.model.text_encoder.embed.weight)
        return
    result, draws = {}, None
    for device in ("cuda", "cpu"):
        t = trainer(device, "first")
        for module in t.model.modules():
            if isinstance(module, Dropout):
                module.p = 0.0
        batch = _st2_batch(device)
        if draws is None:
            draws = t.draw_step(_st2_batch("cpu"), torch.Generator().manual_seed(4))
        losses = t.train_step(batch, draws.to(device), epoch=0)
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": t.grad_norm.item(), "disc_grad_norm": t.disc_grad_norm.item()}
    for key, want in result["cpu"].items():
        assert abs(result["cuda"][key] - want) <= 1e-3 * max(abs(want), 1e-12), key


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_styletts2_regime2_step_on_the_card(card, tmp_path, compute_dtype):
    """One stage-2 StyleTTS2 step of a small model with all four pretrained
    components (seeded files in the published formats, small widths) and
    an out-of-domain bank, at the joint epoch: in float32 its losses and
    both gradient norms within 1e-3 relative of the CPU's from the same
    parameters and draws (dropout off); in bfloat16 (WavLM's bfloat16 copy)
    finite losses with every SLM term, a moved generator and a WavLM left
    as it was."""
    from everyvoice_tpu_torch.config import apply_overrides, styletts2_config
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.onchip import TEXTS, pretrained_overrides, write_pretrained_components
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.utils import write_filelist

    paths = write_pretrained_components(
        tmp_path / "pretrained", torch.Generator().manual_seed(0),
        jdc={"channels": (8, 8, 16, 16), "lstm_hidden": 8},
        asr={"input_dim": 80, "hidden_dim": 32, "n_token": 178, "n_layers": 1,
             "token_embedding_dim": 16},
        plbert={"vocab_size": 178, "hidden_size": 32, "num_layers": 2, "num_heads": 2,
                "intermediate_size": 64, "embedding_size": 16, "max_position_embeddings": 64},
        wavlm={"hidden_size": 32, "num_layers": 2, "num_heads": 2, "intermediate_size": 64,
               "conv_dim": (16,) * 7, "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
               "conv_stride": (5, 2, 2, 2, 2, 2, 2), "num_buckets": 32, "max_distance": 80,
               "num_conv_pos_embeddings": 15, "num_conv_pos_embedding_groups": 4})
    (tmp_path / "pre" / "ood").mkdir(parents=True)
    write_filelist([{"text": t} for t in TEXTS[:4]], tmp_path / "pre" / "ood" / "default.psv")
    raw = {"contact": {"contact_name": "Card", "contact_email": "card@example.org"},
           "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 20,
                     "decoder": {"mpd_layers": [2], "msd_layers": 1},
                     "slm": {"initial_channel": 8},
                     "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                   "head_features": 8}}},
           "preprocessing": {"save_dir": str(tmp_path / "pre")},
           "training": {"max_len": 64, "decoder_segment_frames": 16, "OOD_min_length": 10,
                        "losses": {"tma_epoch": 1, "diff_epoch": 1, "joint_epoch": 1},
                        "logger": {"save_dir": str(tmp_path), "name": "card"}},
           "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
    config = styletts2_config(apply_overrides(raw, pretrained_overrides(paths)))

    class Data:
        text_processor = TextProcessor(config["text"])
        n_symbols = len(text_processor.symbols)
        level = "characters"
        max_text_len = 12
        items: list = []

    def trainer(device):
        t = StyleTTS2Trainer(config, Data(), Data(), {"default": 0}, run_dir=tmp_path / device,
                             mode="second", compute_dtype=compute_dtype, device=device)
        t.init_params(seed=0)
        t.gen_opt_state = t.gen_opt.init(t.gen_params)
        t.disc_opt_state = t.disc_opt.init(t.disc_params)
        return t

    if compute_dtype == "bfloat16":
        t = trainer("cuda")
        assert next(t.wavlm.parameters()).dtype == torch.bfloat16
        wavlm = {n: p.clone() for n, p in t.wavlm.state_dict().items()}
        before = t.model.text_encoder.embed.weight.detach().clone()
        losses = t.train_step(_st2_batch("cuda"), epoch=1)
        assert {"gen/slm", "gen/slm_ood", "disc/slm", "disc/slm_ood", "gen/s2s"} <= set(losses)
        assert all(torch.isfinite(v) for v in losses.values())
        assert not torch.equal(before, t.model.text_encoder.embed.weight)
        assert all(torch.equal(p, wavlm[n]) for n, p in t.wavlm.state_dict().items())
        return
    result, draws = {}, None
    for device in ("cuda", "cpu"):
        t = trainer(device)
        for module in t.model.modules():
            if isinstance(module, Dropout):
                module.p = 0.0
        if draws is None:
            draws = t.draw_step(_st2_batch("cpu"), torch.Generator().manual_seed(4))
        losses = t.train_step(_st2_batch(device), draws.to(device), epoch=1)
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": t.grad_norm.item(), "disc_grad_norm": t.disc_grad_norm.item()}
    assert "gen/slm_ood" in result["cpu"]
    for key, want in result["cpu"].items():
        assert abs(result["cuda"][key] - want) <= 1e-3 * max(abs(want), 1e-12), key


@pytest.mark.parametrize("stable", [False, True], ids=["group_postnorm", "layer_stable"])
def test_wav2vec2_windows_on_the_card(card, stable):
    """A small wav2vec2-CTC and a two-window scoring in float32 on the card
    match the CPU's."""
    from everyvoice_tpu_torch.models.aligner.wav2vec2 import Wav2Vec2CTC, windowed_log_probs
    from everyvoice_tpu_torch.onchip import seeded_init_

    model = Wav2Vec2CTC(32, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                        conv_dim=(32,) * 4, conv_kernel=(10, 3, 3, 2), conv_stride=(5, 2, 2, 2),
                        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                        feat_extract_norm="layer" if stable else "group",
                        do_stable_layer_norm=stable, conv_bias=stable)
    seeded_init_(model, torch.Generator().manual_seed(0))
    model.eval()
    audio = np.random.default_rng(0).standard_normal(28_000).astype(np.float32)
    want = windowed_log_probs(model, audio, window_s=1.0, overlap_s=0.25)
    with torch.no_grad():
        one_cpu = model(torch.from_numpy(audio[:4000])[None])
        one_card = model.to(card)(torch.from_numpy(audio[:4000])[None].to(card)).cpu()
    got = windowed_log_probs(model, audio, window_s=1.0, overlap_s=0.25)
    assert got.shape == want.shape == (model.output_frames(len(audio)), 32)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(one_card.numpy(), one_cpu.numpy(), atol=5e-4, rtol=5e-3)


def test_demo_request_on_the_card(card, tmp_path):
    """A FastSpeech2 demo request served on the card launches the MRF
    kernel once a stage and answers a wav of frames × hop samples."""
    import base64
    import io
    import wave

    from everyvoice_tpu_torch.config import fs2_config, hifigan_config
    from everyvoice_tpu_torch.convert import torch_to_flax
    from everyvoice_tpu_torch.demo.app import create_demo_app_auto
    from everyvoice_tpu_torch.models.fs2.model import FastSpeech2
    from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
    from everyvoice_tpu_torch.onchip import seeded_init_
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.train.checkpoint import save_checkpoint

    conformer = {"layers": 1, "input_dim": 64, "feedforward_dim": 128, "conv_kernel_size": 3}
    vp = {"n_layers": 1, "input_dim": 64}
    fs2_raw = {"model": {"encoder": conformer, "decoder": conformer, "max_length": 128,
                         "variance_predictors": {"pitch": vp, "energy": vp, "duration": vp}},
               "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}}
    voc_raw = {"model": {}}  # HiFiGAN V1: every stage's channels a multiple of 32
    cfg = fs2_config(fs2_raw)
    fs2 = FastSpeech2.from_config(cfg, len(TextProcessor(cfg["text"]).symbols))
    voc = HiFiGANGenerator.from_config(hifigan_config(voc_raw))
    for module, seed in ((fs2, 0), (voc, 1)):
        seeded_init_(module, torch.Generator().manual_seed(seed))
    f = save_checkpoint(tmp_path / "fs2.ckpt", "FastSpeech2", fs2_raw,
                        torch_to_flax(fs2.state_dict(), fs2))
    v = save_checkpoint(tmp_path / "voc.ckpt", "HiFiGANGenerator", voc_raw,
                        torch_to_flax(voc.state_dict(), voc))
    app = create_demo_app_auto(f, vocoder_path=v)
    assert app.synthesizer.device.type == "cuda"
    before = mrf_stage.launches
    code, body = app.synthesize_api({"text": "hello world"})
    assert code == 200
    assert mrf_stage.launches - before == len(app.synthesizer.vocoder.ups)
    with wave.open(io.BytesIO(base64.b64decode(body["wav_base64"]))) as wf:
        assert wf.getnframes() % app.synthesizer._samples_per_frame() == 0
        assert wf.getnframes() > 0

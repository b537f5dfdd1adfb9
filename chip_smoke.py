#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``everyvoice_tpu_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, any failure of which exits nonzero:

1. print the card's name and power limit (``nvidia-smi``); refuse to run
   without CUDA;
2. build the MRF and log-mel kernels (``ops/csrc/mrf.cu`` and
   ``ops/csrc/mel.cu``, sm_90a), one nvcc each, in parallel, and print the
   seconds;
3. hold the MRF kernels to their plain PyTorch version at the four HiFiGAN
   V1 stage shapes (batch 2, 1000 mel frames) in float32 (the CUDA-core
   kernel, TF32 off; tolerance 1e-4 of max|ref|) and bfloat16 (the
   tensor-core launch sequence; 2e-2 of max|ref|), and time the stage, the
   plain version and a cuDNN ``conv1d`` chain computing the same stage;
4. serve requests of 1, 4 and 16 texts through ``Synthesizer`` from EVTP
   checkpoints of seeded full-width FastSpeech2 + HiFiGAN V1 weights, check
   the wavs, the stage's and its kernels' launch counts and the real-time
   factor; then serve them again holding every MRF stage they run, at the
   batch sizes the requests give it, to the plain version in bfloat16; and
   hold the card's float32 synthesis of one text to the CPU's;
5. hold the log-mel FFT kernel to its plain version at the two batch shapes
   the preprocessor serves, (16, 131072) and (16, 262144), in float32 (TF32
   off, tolerance 1e-4 absolute), and time the kernel, the plain version
   and a cuFFT ``torch.stft`` chain computing the same log-mel; hold the
   DFT kernel (n_fft 1000, not a power of two) to its plain version too;
6. preprocess a seeded 512-utterance corpus (3–10 s each, about 55 minutes
   of audio) through ``Preprocessor.preprocess`` on the card: audio, text,
   spec, attn, energy and pitch; check every artifact, the stats, the split
   and that the log-mel FFT kernel ran once per feature batch; then hold
   the log-mel kernel to its plain version on every batch the feature step
   serves, and hold the card's features of one served batch to the CPU's;
7. train FastSpeech2 on that corpus through ``train_text_to_spec`` at the
   default full width and depth (batch 16, bf16, 60 steps, validation audio
   through the seeded HiFiGAN V1, so ``mrf_stage`` runs on this path too);
   check the losses, the checkpoints (optimizer state in the JAX layout),
   the logs and the vocoder's MRF launches; resume two steps from
   ``last.ckpt``; hold one float32 step on the card to the CPU's; synthesize
   from the trained checkpoint; time a step and split it with CUDA events;
8. train the HiFiGAN V1 vocoder on the same corpus through
   ``train_spec_to_wav`` at the default full width (MPD periods 2/3/5/7/11,
   MSD 3 scales, batch 16 of 8192-sample segments, bf16, AdamW, 60 steps of
   which the first 10 warm the generator up alone, validation at steps 30
   and 60 through the inference forward, so ``mrf_stage`` runs there); check
   the losses, that the mel loss falls, the two optimizer states (JAX layout,
   the discriminator's count 50), the logs and the MRF launches; resume two
   steps; time a step and split it with CUDA events and torch.profiler; time
   a checkpoint write; hold one float32 GAN step on the card to the CPU's;
   train the iSTFTNet variant 4 steps and run its inference forward; export
   the V1 generator and serve the 1- and 16-text requests from the trained
   FastSpeech2 and it. Every MRF stage this phase runs (the validations,
   the iSTFT variant's forwards, the served requests) is held, on the
   weights being trained, to the plain version in bfloat16;
9. print the kernels line, the card line, and last ``{"ok": true, ...}``.

It imports nothing of JAX or of ``everyvoice_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12    # dense tensor-core peak
H100_FP32_FLOPS = 67e12     # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
V1_STAGES = ((256, 8), (128, 64), (64, 128), (32, 256))  # (C, samples per frame)
DESIGN = {"torch.float32": "cuda-core fp32 FMA, one launch",
          "torch.bfloat16": "tensor-core mma.sync implicit GEMM, one launch per conv position"}
KERNEL_SIZES = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
MEL_FRAMES = 1000
SR = 22050
MEL_SHAPES = ((16, 131072), (16, 262144))  # the preprocessor's served buckets
CORPUS_UTTERANCES = 512
FEATURE_STEPS = ("audio", "text", "spec", "attn", "energy", "pitch")
TRAIN_STEPS = 60       # about two epochs of 28 batches of 16
TRAIN_VAL_INTERVAL = 30
TRAIN_WARMUP = 20      # Noam warmup, shortened so the loss falls within the run
RESUME_STEPS = 2
WARMUP_STEPS = 3       # steps left out of the step-time median
VOCODER_STEPS = 60
VOCODER_VAL_INTERVAL = 30
VOCODER_WARMUP = 10    # generator_warmup_steps: both branches of the gate run
VOCODER_F32_SEGMENT = 8192  # the float32 card-vs-CPU step's segment
ISTFT_STEPS = 4


def fail(message: str) -> None:
    raise RuntimeError(message)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cudnn_chain(x, w_packed, b_packed):
    """The same MRF stage as a chain of cuDNN convolutions in x's dtype: the
    library yardstick for the kernel's time, used nowhere in the port."""
    import torch.nn.functional as F

    from everyvoice_tpu_torch.ops.mrf import _unpack

    c = x.shape[-1]
    v = x.transpose(1, 2)
    total = None
    for k, dils, convs in zip(KERNEL_SIZES, DILATIONS, _unpack(w_packed, b_packed, c, KERNEL_SIZES, DILATIONS)):
        cur = v
        for u, d in enumerate(dils):
            (w1, b1), (w2, b2) = convs[2 * u], convs[2 * u + 1]
            y = F.conv1d(F.leaky_relu(cur, 0.1), w1.reshape(k, c, c).permute(2, 1, 0), b1,
                         padding=(k - 1) // 2 * d, dilation=d)
            y = F.conv1d(F.leaky_relu(y, 0.1), w2.reshape(k, c, c).permute(2, 1, 0), b2,
                         padding=(k - 1) // 2)
            cur = cur + y
        total = cur if total is None else total + cur
    return (total / len(KERNEL_SIZES)).transpose(1, 2)


def check_kernel(gen) -> list:
    """Kernel vs plain version at the V1 stage shapes; returns per-stage rows."""
    import torch

    from everyvoice_tpu_torch.ops.mrf import mrf_stage, mrf_stage_reference, pack_mrf_weights

    batch = 2
    rows = []
    for c, rate in V1_STAGES:
        t = MEL_FRAMES * rate
        x = torch.randn(batch, t, c, generator=gen)
        weights, biases = [], []
        for k, dils in zip(KERNEL_SIZES, DILATIONS):
            for _ in range(2 * len(dils)):
                weights.append(torch.randn(k * c, c, generator=gen) / (k * c) ** 0.5)
                biases.append(0.1 * torch.randn(c, generator=gen))
        for dt, rel_tol, peak in ((torch.float32, 1e-4, H100_FP32_FLOPS),
                                  (torch.bfloat16, 2e-2, H100_BF16_FLOPS)):
            xd = x.to(dt).cuda()
            w, b = pack_mrf_weights(weights, biases, dt)
            w, b = w.cuda(), b.cuda()
            ref = mrf_stage_reference(xd, w, b, KERNEL_SIZES, DILATIONS)
            issued = mrf_stage.kernel_launches
            got = mrf_stage(xd, w, b, KERNEL_SIZES, DILATIONS)
            torch.cuda.synchronize()
            issued = mrf_stage.kernel_launches - issued
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = rel_tol * scale
            if not (err <= tol and torch.isfinite(got).all()):
                fail(f"mrf_stage disagrees with its plain version at C={c} {dt}: "
                     f"max diff {err} > {tol}")
            flops = 2 * batch * t * c * c * sum(2 * len(d) * k for k, d in zip(KERNEL_SIZES, DILATIONS))
            n_bytes = (2 * xd.numel() + w.numel() + b.numel()) * xd.element_size()
            row = {
                "C": c, "T": t, "B": batch, "dtype": str(dt).replace("torch.", ""),
                "design": DESIGN[str(dt)], "kernel_launches": issued,
                "max_abs_err": err, "tol": tol,
                "kernel_ms": cuda_ms(lambda: mrf_stage(xd, w, b, KERNEL_SIZES, DILATIONS), 5),
                "plain_ms": cuda_ms(lambda: mrf_stage_reference(xd, w, b, KERNEL_SIZES, DILATIONS), 3),
                "library_ms": cuda_ms(lambda: cudnn_chain(xd, w, b), 5),
                "bound_ms": 1e3 * max(flops / peak, n_bytes / H100_BYTES_PER_S),
                "bound_by": "operations" if flops / peak >= n_bytes / H100_BYTES_PER_S else "bytes",
            }
            row["tflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e12
            row["launches"] = mrf_stage.launches
            print("stage " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def check_wav(res: dict, hop: int, what: str) -> None:
    """A synthesized result's wav: present, finite, within [-1, 1] and
    ``frames × hop`` samples long."""
    import numpy as np

    wav, mel = res["wav"], res["mel"]
    if wav is None or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        fail(f"{what}: wav missing, not finite or outside [-1, 1]")
    if wav.shape != (mel.shape[0] * hop,):
        fail(f"{what}: wav of {wav.shape} for {mel.shape[0]} frames")


def serve(synth, out_dir: Path, card: str) -> dict:
    """The main path: requests of 1, 4 and 16 texts through Synthesizer."""
    import torch

    from everyvoice_tpu_torch.onchip import REQUESTS, TEXTS
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    if synth.compute_dtype != "bfloat16" or synth.device.type != "cuda":
        fail(f"Synthesizer resolved to {synth.compute_dtype} on {synth.device}")
    forwards = []
    synth.vocoder.register_forward_hook(lambda *_: forwards.append(1))
    synth.synthesize(TEXTS[:1])  # warm-up: cuDNN and allocator start-up
    hop = synth._samples_per_frame()
    sr = synth.config["preprocessing"]["audio"]["output_sampling_rate"]

    forwards.clear()
    mrf_stage.launches = 0
    mrf_stage.kernel_launches = 0
    timings = []
    for i, texts in enumerate(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = synth.synthesize(texts)
        wall = time.perf_counter() - t0
        written = synth.write_outputs(results, out_dir / f"request{i}", ("wav",))
        audio_s = 0.0
        for res in results:
            check_wav(res, hop, f"request {i}")
            audio_s += res["wav"].shape[0] / sr
        if len(written) != len(texts):
            fail(f"request {i}: wrote {len(written)} wavs for {len(texts)} texts")
        row = {"texts": len(texts), "chunks": sum(len(r["tokens"]) for r in results),
               "wall_s": wall, "audio_s": audio_s, "rtf": audio_s / wall, "card": card}
        print("request " + json.dumps(row), flush=True)
        timings.append(row)
    launches, issued = mrf_stage.launches, mrf_stage.kernel_launches
    n_stages = len(synth.vocoder.ups)
    if launches == 0 or launches != n_stages * len(forwards):
        fail(f"mrf_stage launched {launches} times for {len(forwards)} generator forwards")
    # bf16: a prologue, two convs per dilation step and a finish per stage
    per_stage = 2 + 2 * max(len(d) for d in synth.vocoder.resblock_dilation_sizes)
    if issued != per_stage * launches:
        fail(f"mrf_stage issued {issued} kernel launches in {launches} stages")
    print(f"serving: {len(forwards)} generator forwards, {launches} MRF stages, "
          f"{issued} MRF kernel launches", flush=True)
    return {"launches": launches, "kernel_launches": issued, "forwards": len(forwards),
            "requests": timings}


def checked_mrf_stages(rows: dict):
    """An ``mrf_stage`` that holds every call to the plain version on the
    same input (bf16: 2e-2 of max|ref|) and records, per (B, T, C), the
    calls, the largest error, the tolerance and the kernel launches one
    stage issued."""
    import torch

    from everyvoice_tpu_torch.ops.mrf import mrf_stage, mrf_stage_reference

    def checked(x, w, b, kernel_sizes, dilation_sizes, slope):
        issued = mrf_stage.kernel_launches
        got = mrf_stage(x, w, b, kernel_sizes, dilation_sizes, slope)
        issued = mrf_stage.kernel_launches - issued
        ref = mrf_stage_reference(x, w, b, kernel_sizes, dilation_sizes, slope).float()
        err = (got.float() - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        batch, t, c = x.shape
        if not (err <= tol and torch.isfinite(got).all()):
            fail(f"mrf_stage disagrees with its plain version (B={batch}, T={t}, C={c}, "
                 f"{x.dtype}): max diff {err} > {tol}")
        row = rows.setdefault((batch, t, c), {
            "B": batch, "T": t, "C": c, "dtype": str(x.dtype).replace("torch.", ""),
            "design": DESIGN[str(x.dtype)], "kernel_launches": issued, "calls": 0,
            "max_abs_err": 0.0, "tol": float("inf")})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["tol"] = min(row["tol"], tol)
        return got

    return checked


def check_served_stages(synth) -> list:
    """Each MRF stage the requests run, at the batch the request gives it,
    held to the plain version on the same input; one row per stage shape,
    with the kernel launches one stage issued."""
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import REQUESTS
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    seen: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(seen)
    try:
        for texts in REQUESTS:
            synth.synthesize(texts)
    finally:
        hifigan.mrf_stage = mrf_stage
    rows = [seen[k] for k in sorted(seen)]
    for row in rows:
        print("served stage " + json.dumps(row), flush=True)
    return rows


def reference_check(fs2_path: Path, voc_path: Path) -> dict:
    """The card's float32 synthesis of one text against the CPU's."""
    import numpy as np

    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from everyvoice_tpu_torch.onchip import TEXTS

    text = TEXTS[:1]
    card = Synthesizer(fs2_path, voc_path, compute_dtype="float32").synthesize(text)[0]
    cpu = Synthesizer(fs2_path, voc_path, compute_dtype="float32", device="cpu").synthesize(text)[0]
    if not all(np.array_equal(a, b) for a, b in zip(card["durations"], cpu["durations"])):
        fail("card and CPU float32 synthesis chose different durations")
    mel_diff = float(np.abs(card["mel"] - cpu["mel"]).max())
    wav_diff = float(np.abs(card["wav"] - cpu["wav"]).max())
    print(f"reference: card vs CPU float32, max |mel diff| {mel_diff:.3e}, "
          f"max |wav diff| {wav_diff:.3e} (tolerance 1e-3)", flush=True)
    if mel_diff > 1e-3 or wav_diff > 1e-3:
        fail("card and CPU float32 synthesis disagree")
    return {"mel_diff": mel_diff, "wav_diff": wav_diff}


def library_log_mel(x, window, basis, n_fft: int = 1024, hop: int = 256):
    """The same log-mel as a chain of PyTorch library calls: cuFFT's
    ``torch.stft`` (centre, reflect pad, periodic Hann), magnitude, mel
    matmul, log-clamp, TF32 off. The library yardstick for the kernel's
    time, used nowhere in the port."""
    import torch

    spec = torch.stft(x, n_fft, hop, window.shape[0], window, center=True,
                      pad_mode="reflect", return_complex=True)
    mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag + 1e-9)
    return torch.log(torch.clamp(basis @ mag, min=1e-5))


def check_mel_kernel(gen) -> list:
    """Log-mel FFT kernel vs plain version at the preprocessor's two served
    batch shapes; returns one row per shape. Then the DFT kernel, which
    takes an n_fft that is not a power of two, at the first shape."""
    import torch

    from everyvoice_tpu_torch.dsp.spectral import hann_window, librosa_mel_basis
    from everyvoice_tpu_torch.ops.mel import fft_route, log_mel, log_mel_reference

    n_fft, hop, n_mels = 1024, 256, 80
    n_bins = n_fft // 2 + 1
    basis = torch.from_numpy(librosa_mel_basis(SR, n_fft, n_mels, 0.0, 8000.0)).cuda()
    window = torch.from_numpy(hann_window(n_fft)).cuda()
    rows = []
    for b, s in MEL_SHAPES:
        x = (0.3 * torch.randn(b, s, generator=gen)).cuda()
        fft_before = log_mel.fft_launches
        got = log_mel(x)
        if log_mel.fft_launches != fft_before + 1:
            fail(f"log_mel at n_fft {n_fft} did not take the FFT kernel")
        ref = log_mel_reference(x)
        lib = library_log_mel(x, window, basis)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not (err <= 1e-4 and torch.isfinite(got).all()):
            fail(f"log_mel disagrees with its plain version at ({b}, {s}): max diff {err} > 1e-4")
        frames = s // hop + 1
        # The function's least work: a real FFT of n_fft points (about
        # 2.5·n_fft·log2(n_fft) flops), the magnitude (4 a bin), the mel
        # product over the mel basis's nonzeros, the log; and its bytes: the
        # audio, window and mel weights read once, the log-mel written once.
        flops = b * frames * (2.5 * n_fft * math.log2(n_fft) + 4 * n_bins
                              + 2 * int((basis != 0).sum()) + n_mels)
        n_bytes = 4 * (x.numel() + n_fft + n_bins * n_mels + b * n_mels * frames)
        row = {
            "B": b, "S": s, "frames": frames, "route": "fft", "kernel_launches": 1,
            "max_abs_err": err, "tol": 1e-4,
            "library_max_abs_err": (lib - ref).abs().max().item(),
            "kernel_ms": cuda_ms(lambda: log_mel(x), 20),
            "plain_ms": cuda_ms(lambda: log_mel_reference(x), 10),
            "library_ms": cuda_ms(lambda: library_log_mel(x, window, basis), 20),
            "bound_ms": 1e3 * max(flops / H100_FP32_FLOPS, n_bytes / H100_BYTES_PER_S),
            "bound_by": "operations" if flops / H100_FP32_FLOPS >= n_bytes / H100_BYTES_PER_S
            else "bytes",
            "gflop": flops / 1e9, "bytes": n_bytes,
        }
        row["gflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e9
        print("mel " + json.dumps(row), flush=True)
        rows.append(row)

    b, s = MEL_SHAPES[0]
    args = (SR, 1000, 1000, 250)
    if fft_route(args[1]):
        fail("n_fft 1000 should take the DFT kernel")
    x = (0.3 * torch.randn(b, s, generator=gen)).cuda()
    launches, fft_before = log_mel.launches, log_mel.fft_launches
    got = log_mel(x, *args)
    torch.cuda.synchronize()
    if (log_mel.launches - launches, log_mel.fft_launches - fft_before) != (1, 0):
        fail("log_mel at n_fft 1000 did not take the DFT kernel")
    err = (got - log_mel_reference(x, *args)).abs().max().item()
    if not (err <= 1e-4 and torch.isfinite(got).all()):
        fail(f"the DFT log-mel kernel disagrees with its plain version: max diff {err} > 1e-4")
    print("mel dft " + json.dumps({
        "B": b, "S": s, "n_fft": 1000, "hop": 250, "route": "dft", "max_abs_err": err,
        "tol": 1e-4, "kernel_ms": cuda_ms(lambda: log_mel(x, *args), 10)}), flush=True)
    return rows


def corpus_config(root: Path, filelist: Path, wavs: Path) -> dict:
    return {
        "preprocessing": {
            "dataset": "seeded-corpus", "save_dir": str(root / "preprocessed"),
            "source_data": [{"label": "seeded", "permissions_obtained": True,
                             "data_dir": str(wavs), "filelist": str(filelist)}],
        },
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
    }


def preprocess_corpus(root: Path, card: str) -> dict:
    """The main path: ``Preprocessor.preprocess`` over a seeded corpus on the
    card, every artifact checked."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.dsp.audio_io import read_wav
    from everyvoice_tpu_torch.onchip import write_corpus
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    t0 = time.perf_counter()
    filelist, wavs, audio_s = write_corpus(root / "corpus", CORPUS_UTTERANCES, seed=0)
    print(f"corpus: {CORPUS_UTTERANCES} utterances, {audio_s:.1f} s of audio, "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = corpus_config(root, filelist, wavs)
    pre = Preprocessor(cfg)  # the card by default
    if pre.device.type != "cuda":
        fail(f"Preprocessor resolved to {pre.device}")
    cpus = min(8, os.cpu_count() or 1)

    log_mel.launches = 0
    log_mel.fft_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre.preprocess(to_process=FEATURE_STEPS, cpus=cpus)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fft_launches = log_mel.launches, log_mel.fft_launches

    save = pre.save_dir
    hop = pre.audio_config["fft_hop_size"]
    summary = json.loads((save / "summary.txt").read_text())
    if summary["processed_files"] != CORPUS_UTTERANCES:
        fail(f"the audio step kept {summary['processed_files']} of {CORPUS_UTTERANCES} files")
    rows = generic_psv_filelist_reader(save / "filelist.psv")
    for kind in ("spec", "energy", "pitch", "attn"):
        n = len(list((save / kind).glob("*.npy")))
        if n != CORPUS_UTTERANCES:
            fail(f"{n} {kind} artifacts for {CORPUS_UTTERANCES} utterances")
    for row in rows:
        item = pre.get_speaker_and_language(row)
        frames = read_wav(pre.create_path(item, "audio", f"audio-{SR}.wav"))[0].shape[1] // hop
        spec = np.load(pre.create_path(item, "spec", pre._spec_filename()))
        energy = np.load(pre.create_path(item, "energy", "energy.npy"))
        pitch = np.load(pre.create_path(item, "pitch", "pitch.npy"))
        attn = np.load(pre.create_path(item, "attn", "characters-attn-prior.npy"))
        n_tokens = len([t for t in pre.text_processor.split_tokens(row["character_tokens"]) if t])
        if (spec.shape != (80, frames) or energy.shape != (frames,) or pitch.shape != (frames,)
                or attn.shape != (frames, n_tokens)):
            fail(f"{row['basename']}: shapes {spec.shape} {energy.shape} {pitch.shape} "
                 f"{attn.shape} for {frames} frames and {n_tokens} tokens")
        if not all(np.isfinite(a).all() for a in (spec, energy, pitch, attn)):
            fail(f"{row['basename']}: an artifact is not finite")
    stats = json.loads((save / "stats.json").read_text())
    if {k: stats[k]["sample_size"] for k in ("energy", "pitch")} != {
            "energy": CORPUS_UTTERANCES, "pitch": CORPUS_UTTERANCES}:
        fail(f"stats.json: {stats}")
    n_train = len(generic_psv_filelist_reader(save / "training_filelist.psv"))
    n_val = len(generic_psv_filelist_reader(save / "validation_filelist.psv"))
    if (n_train, n_val) != (int(CORPUS_UTTERANCES * 0.9), CORPUS_UTTERANCES - int(CORPUS_UTTERANCES * 0.9)):
        fail(f"split of {n_train} + {n_val}")
    batches = len(pre.last_batch_shapes)
    if launches == 0 or launches != batches or fft_launches != batches:
        fail(f"log_mel launched {launches} times ({fft_launches} through the FFT "
             f"kernel) for {batches} feature batches")
    row = {
        "utterances": CORPUS_UTTERANCES, "audio_s": audio_s, "wall_s": wall,
        "audio_s_per_s": audio_s / wall, "step_seconds": pre.last_step_seconds,
        "cpus": cpus, "batches": batches, "launches": launches, "fft_launches": fft_launches,
        "bucket_shapes": sorted([list(k), v] for k, v in Counter(pre.last_batch_shapes).items()),
        "transfer_bytes": pre.last_transfer_bytes, "card": card,
    }
    print("preprocess " + json.dumps(row), flush=True)
    return {"pre": pre, "cfg": cfg, "launches": launches, "fft_launches": fft_launches,
            "row": row}


def check_served_features(pre) -> tuple:
    """Every batch the feature step serves over the same corpus, as the
    program sees it (int16 PCM / 32768 on the card), through the log-mel
    kernel and its plain version (1e-4 absolute); one row per batch shape.
    Returns (rows, the last batch of each shape)."""
    import torch

    from everyvoice_tpu_torch.ops.mel import fft_route, log_mel, log_mel_reference

    a = pre.audio_config
    args = (a["input_sampling_rate"], a["n_fft"], a["fft_window_size"], a["fft_hop_size"],
            a["n_mels"], float(a["f_min"]), float(a["f_max"]))
    filelist = pre.load_filelist(pre.save_dir / "filelist.psv")
    seen, last = {}, {}
    pre.overwrite = True  # every utterance, though its artifacts exist
    try:
        for _, batch in pre.feature_batches(filelist, ("spec", "energy", "pitch")):
            x = torch.from_numpy(batch).to(pre.device)
            if x.dtype == torch.int16:
                x = x.to(torch.float32) / 32768.0
            got = log_mel(x, *args)
            err = (got - log_mel_reference(x, *args)).abs().max().item()
            if not (err <= 1e-4 and torch.isfinite(got).all()):
                fail(f"log_mel disagrees with its plain version on a served batch "
                     f"{batch.shape}: max diff {err} > 1e-4")
            row = seen.setdefault(batch.shape, {
                "B": batch.shape[0], "S": batch.shape[1],
                "route": "fft" if fft_route(a["n_fft"]) else "dft", "kernel_launches": 1,
                "calls": 0, "max_abs_err": 0.0, "tol": 1e-4})
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            last[batch.shape] = batch
    finally:
        pre.overwrite = False
    rows = [seen[k] for k in sorted(seen)]
    for row in rows:
        print("served mel " + json.dumps(row), flush=True)
    if sum(r["calls"] for r in rows) != len(pre.last_batch_shapes):
        fail("the feature step served another number of batches the second time")
    return rows, last


def time_feature_program(pre, batches: dict, mel_rows: list) -> list:
    """Device time of the whole feature program (int16 → float, log-mel,
    energy, F0) on one served batch of each shape, beside the log-mel
    kernel's share of it."""
    import torch

    program = pre._feature_program()
    kernel_ms = {(r["B"], r["S"]): r["kernel_ms"] for r in mel_rows}
    rows = []
    for shape, batch in sorted(batches.items()):
        x = torch.from_numpy(batch).cuda()
        row = {"shape": list(shape), "program_ms": cuda_ms(lambda: program(x), 10),
               "log_mel_ms": kernel_ms[shape]}
        row["log_mel_share"] = row["log_mel_ms"] / row["program_ms"]
        print("feature program " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def features_card_vs_cpu(cfg: dict, batch) -> dict:
    """One served batch's features on the card and on the CPU: spec within
    1e-3, energy within 1e-3 of max|ref|, and F0 within 1e-3 relative on at
    least 99% of frames (a frame whose CMNDF or voicing decision sits on a
    threshold may flip under another float32 summation order)."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.preprocessor import Preprocessor

    x = torch.from_numpy(batch)
    card = [t.cpu().numpy() for t in Preprocessor(cfg)._feature_program()(x.cuda())]
    cpu = [t.numpy() for t in Preprocessor(cfg, device="cpu")._feature_program()(x)]
    spec_diff = float(np.abs(card[0] - cpu[0]).max())
    energy_diff = float(np.abs(card[1] - cpu[1]).max() / np.abs(cpu[1]).max())
    rel = np.abs(card[2] - cpu[2]) / np.maximum(np.abs(cpu[2]), 1e-6)
    flipped = int((rel > 1e-3).sum())
    row = {"shape": list(batch.shape), "spec_max_abs_diff": spec_diff,
           "energy_max_rel_diff": energy_diff, "f0_frames": int(rel.size),
           "f0_frames_over_1e-3": flipped, "f0_max_rel_diff": float(rel.max())}
    print("features card vs cpu " + json.dumps(row), flush=True)
    if spec_diff > 1e-3 or energy_diff > 1e-3 or flipped > 0.01 * rel.size:
        fail("the card's features disagree with the CPU's")
    return row


def training_config(root: Path, cfg: dict, voc_path: Path, version: str, **training) -> dict:
    """The corpus config with a training section: FastSpeech2's default
    model and Noam AdamW (warmup shortened), batch 16, the seeded vocoder
    for validation audio."""
    from everyvoice_tpu_torch.onchip import CONTACT

    save = Path(cfg["preprocessing"]["save_dir"])
    return {
        **cfg,
        "contact": CONTACT,
        "training": {
            "batch_size": 16, "max_steps": TRAIN_STEPS, "val_check_interval": TRAIN_VAL_INTERVAL,
            "optimizer": {"learning_rate": 1e-3, "weight_decay": 1e-6, "betas": [0.9, 0.999],
                          "warmup_steps": TRAIN_WARMUP},
            "training_filelist": str(save / "training_filelist.psv"),
            "validation_filelist": str(save / "validation_filelist.psv"),
            "vocoder_path": str(voc_path),
            "logger": {"save_dir": str(root / "logs"), "name": "chip-smoke", "version": version},
            **training,
        },
    }


def trace(fn) -> dict:
    """``fn`` under torch.profiler: its CUDA kernel launches, their summed
    device time and the traced wall (the profiler's own host overhead
    included); None where the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"kernels": None, "busy_ms": None, "wall_ms": None}
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    return {"kernels": len(kernels),
            "busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "wall_ms": (end - start) / 1e3}


def split_step(trainer) -> dict:
    """CUDA-event times of one bf16 training step on a training batch:
    model forward (Viterbi included) with the losses (forward-sum
    included), backward, optimizer; and, on the same log-attention, the
    host Viterbi and the forward-sum (forward and backward) alone, which
    the first two contain. Kernel launches, device busy time and traced
    wall of a step and of the alignment, from torch.profiler."""
    import torch

    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.fs2.alignment import forward_sum_loss, viterbi_alignment
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.train.loop import _decompress
    from everyvoice_tpu_torch.utils.precision import no_tf32

    host = next(trainer.dataset.batches(16, shuffle=False))
    host.pop("basenames")
    batch = to_device(compress_for_transfer(host, ("mel", "attn_prior")), trainer.device)
    trainer.train_step(batch, 1.0)  # warm
    events = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    trainer.model.train()
    with no_tf32():
        events[0].record()
        losses = trainer.losses(batch, 1.0)
        events[1].record()
        for p in trainer.params.values():
            p.grad = None
        losses["total"].backward()
        events[2].record()
        trainer.optimizer.step(trainer.params, {n: p.grad for n, p in trainer.params.items()},
                               trainer.opt_state)
        events[3].record()
        plain = _decompress(batch)
        out = trainer.model(plain["text"], plain["text_lengths"], **trainer._model_kwargs(plain))
        logprob = out["attn_logprob"].detach().requires_grad_(True)
        lengths = (batch["text_lengths"], batch["mel_lengths"])

        def alignment():
            viterbi_alignment(logprob.detach(), *lengths)
            forward_sum_loss(logprob, *lengths).backward()

        torch.cuda.synchronize()
        events[4].record()
        viterbi_alignment(logprob.detach(), *lengths)
        events[5].record()
        forward_sum_loss(logprob, *lengths).backward()
        events[6].record()
        torch.cuda.synchronize()
        step_trace = trace(lambda: trainer.train_step(batch, 1.0))
        alignment_trace = trace(alignment)
    return {
        "forward_ms": events[0].elapsed_time(events[1]),
        "backward_ms": events[1].elapsed_time(events[2]),
        "optimizer_ms": events[2].elapsed_time(events[3]),
        "viterbi_ms": events[4].elapsed_time(events[5]),
        "forward_sum_ms": events[5].elapsed_time(events[6]),
        "kernels_per_step": step_trace["kernels"], "alignment_kernels": alignment_trace["kernels"],
        "traced_step_ms": step_trace["wall_ms"], "traced_busy_ms": step_trace["busy_ms"],
    }


def float32_step_card_vs_cpu(config: dict, ckpt_path: Path, run_root: Path) -> dict:
    """One float32 training step, dropout off, from the trained checkpoint's
    parameters, on one batch of 2 rows, on the card and on the CPU: losses
    and the global gradient norm within 1e-3 relative."""
    from everyvoice_tpu_torch.config import fs2_training_config
    from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    config = fs2_training_config(config)
    ckpt = load_checkpoint(ckpt_path)
    hp = ckpt["hyper_parameters"]
    rows = generic_psv_filelist_reader(config["training"]["training_filelist"])
    ds = FastSpeech2Dataset(rows, config, hp["lang2id"], hp["speaker2id"])
    host = next(ds.batches(2, shuffle=False))
    host.pop("basenames")
    host = compress_for_transfer(host, ("mel", "attn_prior"))
    result = {}
    for device in ("cuda", "cpu"):
        trainer = FastSpeech2Trainer(config, ds, ds, hp["lang2id"], hp["speaker2id"],
                                     run_dir=run_root / f"f32-{device}",
                                     compute_dtype="float32", device=device)
        for module in trainer.model.modules():
            if isinstance(module, Dropout):
                module.p = 0.0
        trainer.load_params(ckpt["state_dict"])
        trainer.opt_state = trainer.optimizer.init(trainer.params)
        losses = trainer.train_step(to_device(host, trainer.device), 1.0)
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": trainer.grad_norm.item()}
    diffs = {k: abs(result["cuda"][k] - v) / max(abs(v), 1e-12) for k, v in result["cpu"].items()}
    row = {"rows": 2, "card": result["cuda"], "cpu": result["cpu"], "max_rel_diff": max(diffs.values())}
    print("train float32 card vs cpu " + json.dumps(row), flush=True)
    if row["max_rel_diff"] > 1e-3:
        fail(f"the card's float32 training step disagrees with the CPU's: {diffs}")
    return row


def check_run(trainer, expect_tagged: int) -> list:
    """The run's files: metrics, hparams, an event file, last.ckpt and the
    tagged checkpoints, each loading with its optimizer state in the JAX
    layout (the moments' trees are the parameters' tree). Returns the
    logged training records."""
    import numpy as np

    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    run = trainer.run_dir
    for name in ("metrics.jsonl", "hparams.yaml"):
        if not (run / name).is_file():
            fail(f"the training run wrote no {name}")
    if not list(run.glob("events.out.tfevents.*")):
        fail("the training run wrote no event file")
    tagged = sorted(trainer.ckpt_dir.glob("epoch=*-step=*-loss=*.ckpt"))
    if not (trainer.ckpt_dir / "last.ckpt").is_file() or len(tagged) != expect_tagged:
        fail(f"checkpoints: {sorted(p.name for p in trainer.ckpt_dir.iterdir())}")

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k, v in sorted(tree.items()) for x in leaves(v, prefix + (k,))]
        return [(prefix, np.shape(tree))]

    for path in [trainer.ckpt_dir / "last.ckpt", *tagged]:
        ckpt = load_checkpoint(path)
        opt = ckpt["optimizer_states"]
        params = leaves(ckpt["state_dict"])
        if "alignment" not in ckpt["state_dict"]["params"]:
            fail(f"{path.name} has no alignment encoder")
        if (sorted(opt) != ["0", "1", "2"] or opt["1"] != {}
                or leaves(opt["0"]["mu"]) != params or leaves(opt["0"]["nu"]) != params
                or int(opt["0"]["count"]) != ckpt["global_step"]
                or int(opt["2"]["count"]) != ckpt["global_step"]):
            fail(f"{path.name}: the optimizer state is not in the JAX package's layout")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return [r for r in records if "training/total" in r]


def train_phase(root: Path, cfg: dict, voc_path: Path, card: str) -> dict:
    """The main path's training slice: ``train_text_to_spec`` on the
    preprocessed corpus at full width and depth, on the card, then a resume
    from ``last.ckpt``; every check above."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train import loop
    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec

    config = training_config(root, cfg, voc_path, "train")
    t = config["training"]
    print("train overrides " + json.dumps({
        "max_steps": t["max_steps"], "val_check_interval": t["val_check_interval"],
        "warmup_steps": t["optimizer"]["warmup_steps"], "batch_size": t["batch_size"],
        "logger": t["logger"], "compute_precision": "auto"}), flush=True)

    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda module, *_: forwards.append(1) if isinstance(module, HiFiGANGenerator) else None)
    step_s = []
    plain_step = loop.FastSpeech2Trainer.train_step

    def timed_step(self, batch, bin_ramp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_step(self, batch, bin_ramp)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    loop.FastSpeech2Trainer.train_step = timed_step
    mrf_stage.launches = 0
    mrf_stage.kernel_launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = train_text_to_spec(config, log_every=1)  # the card, 'auto' precision
        wall = time.perf_counter() - t0
    finally:
        loop.FastSpeech2Trainer.train_step = plain_step
        hook.remove()
    launches, vocoder_forwards = mrf_stage.launches, len(forwards)
    peak = torch.cuda.max_memory_allocated()
    if trainer.device.type != "cuda" or trainer.compute_dtype != "bfloat16":
        fail(f"the trainer resolved to {trainer.compute_dtype} on {trainer.device}")
    if launches == 0 or launches != 4 * vocoder_forwards:
        fail(f"mrf_stage launched {launches} times for {vocoder_forwards} vocoder forwards "
             "in validation")
    records = check_run(trainer, expect_tagged=TRAIN_STEPS // TRAIN_VAL_INTERVAL)
    totals = [r["training/total"] for r in records]
    values = [v for r in records for k, v in r.items() if k.startswith("training/")]
    if len(totals) != TRAIN_STEPS or not np.isfinite(values).all():
        fail(f"{len(totals)} logged steps, finite: {np.isfinite(values).all()}")
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    if not last < first:
        fail(f"the training loss did not fall: first 10 steps {first}, last 10 {last}")

    resume = training_config(root, cfg, voc_path, "resume", max_steps=TRAIN_STEPS + RESUME_STEPS,
                             finetune_checkpoint=str(trainer.ckpt_dir / "last.ckpt"))
    resumed = train_text_to_spec(resume, log_every=1)
    resumed_steps = [r["step"] for r in check_run(resumed, expect_tagged=1)]
    if resumed.resumed != "full" or resumed_steps != list(range(TRAIN_STEPS + 1, TRAIN_STEPS
                                                                 + RESUME_STEPS + 1)):
        fail(f"resume: mode {resumed.resumed}, steps {resumed_steps}")

    split = split_step(trainer)
    f32 = float32_step_card_vs_cpu(config, trainer.ckpt_dir / "last.ckpt", root / "f32")
    median_ms = 1e3 * float(np.median(step_s[WARMUP_STEPS:TRAIN_STEPS]))
    steps_per_s = 1e3 / median_ms
    row = {
        "steps": len(totals), "resumed_steps": len(resumed_steps), "wall_s": wall,
        "median_step_ms": median_ms, "steps_per_s": steps_per_s,
        "padded_frames_per_s": steps_per_s * t["batch_size"] * trainer.model.max_frames,
        "peak_memory_gb": peak / 1e9, "loss_first10": first, "loss_last10": last,
        **split, "vocoder_forwards": vocoder_forwards, "mrf_launches": launches,
        "float32_max_rel_diff": f32["max_rel_diff"], "card": card,
    }
    print("train " + json.dumps(row), flush=True)
    return {"trainer": trainer, "launches": launches, "row": row}


def synthesize_trained(ckpt_path: Path, voc_path: Path, out_dir: Path) -> dict:
    """The 1-text request from the trained checkpoint, on the card, with the
    serving phase's checks."""
    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from everyvoice_tpu_torch.onchip import TEXTS

    synth = Synthesizer(ckpt_path, voc_path)
    if synth.device.type != "cuda":
        fail(f"Synthesizer resolved to {synth.device}")
    [res] = synth.synthesize(TEXTS[:1])
    wav, mel = res["wav"], res["mel"]
    check_wav(res, synth._samples_per_frame(), "synthesis from the trained checkpoint")
    if not synth.write_outputs([res], out_dir, ("wav",)):
        fail("synthesis from the trained checkpoint wrote no wav")
    row = {"frames": int(mel.shape[0]), "samples": int(wav.shape[0]),
           "durations": [int(d) for d in res["durations"][0]]}
    print("trained synthesis " + json.dumps(row), flush=True)
    return row


def check_vocoder_run(trainer, expect_steps: list, disc_updates: int, expect_tagged: int) -> list:
    """The vocoder run's files: metrics (every logged loss finite, the
    steps ``expect_steps``), hparams, an event file, last.ckpt and the
    tagged checkpoints, each with both optimizer states in the JAX layout
    (AdamW's moments keyed like the parameters' trees; the generator's
    count the step, the discriminators' ``disc_updates`` at last.ckpt).
    Returns the logged training records."""
    import numpy as np

    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    run = trainer.run_dir
    for name in ("metrics.jsonl", "hparams.yaml"):
        if not (run / name).is_file():
            fail(f"the vocoder run wrote no {name}")
    if not list(run.glob("events.out.tfevents.*")):
        fail("the vocoder run wrote no event file")
    tagged = sorted(trainer.ckpt_dir.glob("epoch=*-step=*-loss=*.ckpt"))
    if not (trainer.ckpt_dir / "last.ckpt").is_file() or len(tagged) != expect_tagged:
        fail(f"vocoder checkpoints: {sorted(p.name for p in trainer.ckpt_dir.iterdir())}")

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k, v in sorted(tree.items()) for x in leaves(v, prefix + (k,))]
        return [(prefix, np.shape(tree))]

    ckpt = load_checkpoint(trainer.ckpt_dir / "last.ckpt")
    params, opt = ckpt["state_dict"], ckpt["optimizer_states"]
    if sorted(params) != ["discriminators", "generator"] or sorted(opt) != ["disc", "gen"]:
        fail(f"vocoder checkpoint trees: {sorted(params)}, {sorted(opt)}")
    for key, tree, count in (("gen", params["generator"], ckpt["global_step"]),
                             ("disc", params["discriminators"], disc_updates)):
        state = opt[key]
        if (sorted(state) != ["0", "1", "2"] or leaves(state["0"]["mu"]) != leaves(tree)
                or leaves(state["0"]["nu"]) != leaves(tree) or int(state["0"]["count"]) != count):
            fail(f"the {key} optimizer state is not in the JAX package's layout or counted "
                 f"{int(state['0']['count'])} updates, not {count}")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    training = [r for r in records if "training/gen/total" in r]
    values = [v for r in records for k, v in r.items() if k.startswith(("training/", "validation/"))]
    if [r["step"] for r in training] != expect_steps or not np.isfinite(values).all():
        fail(f"vocoder run logged steps {[r['step'] for r in training]}, "
             f"finite: {np.isfinite(values).all()}")
    return training


def split_gan_step(trainer, batch) -> dict:
    """CUDA-event times of one bf16 GAN step's parts, on a training batch:
    the generator's forward; the discriminators' forward and backward; the
    generator's mel loss, discriminator passes and backward; the two
    optimizer updates; and two whole steps on the host clock beside them.
    Kernel launches, device busy time and traced wall of a whole step,
    from torch.profiler."""
    import torch

    from everyvoice_tpu_torch.train.loop import _decompress
    from everyvoice_tpu_torch.utils.precision import no_tf32

    whole_ms = []
    for _ in range(3):  # the first warms; whole steps on the host clock beside the split
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, True)
        torch.cuda.synchronize()
        whole_ms.append(1e3 * (time.perf_counter() - t0))
    plain = _decompress(batch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with no_tf32():
        events[0].record()
        fake = trainer.generator.train_forward(plain["mel"])
        events[1].record()
        _, d_grads = trainer.discriminator_grads(plain["audio"], fake, True)
        events[2].record()
        trainer.update_discriminators(d_grads)
        events[3].record()
        _, g_grads = trainer.generator_grads(plain["audio"], fake, True)
        events[4].record()
        trainer.update_generator(g_grads)
        events[5].record()
    torch.cuda.synchronize()
    step_trace = trace(lambda: trainer.train_step(batch, True))
    return {
        "generator_forward_ms": events[0].elapsed_time(events[1]),
        "discriminator_grads_ms": events[1].elapsed_time(events[2]),
        "generator_grads_ms": events[3].elapsed_time(events[4]),
        "optimizers_ms": events[2].elapsed_time(events[3]) + events[4].elapsed_time(events[5]),
        "whole_steps_after_run_ms": whole_ms[1:],
        "kernels_per_step": step_trace["kernels"], "traced_busy_ms": step_trace["busy_ms"],
        "traced_step_ms": step_trace["wall_ms"],
    }


def vocoder_float32_card_vs_cpu(config: dict, ckpt_path: Path, run_root: Path) -> dict:
    """One float32 GAN step from the trained checkpoint's parameters, on
    one batch of 2 segments, on the card and on the CPU: the losses and
    both gradient norms within 1e-3 relative."""
    from everyvoice_tpu_torch.config import hifigan_training_config
    from everyvoice_tpu_torch.dataloader import HiFiGANDataset
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.train.loop import HiFiGANTrainer
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    config = hifigan_training_config(config)
    ckpt = load_checkpoint(ckpt_path)
    ds = HiFiGANDataset(generic_psv_filelist_reader(config["training"]["training_filelist"]), config)
    host = next(ds.segment_batches(2, VOCODER_F32_SEGMENT, seed=0))
    host.pop("basenames")
    host = compress_for_transfer(host, ("mel",))
    result, seconds = {}, {}
    for device in ("cuda", "cpu"):
        trainer = HiFiGANTrainer(config, ds, ds, run_dir=run_root / f"voc-f32-{device}",
                                 compute_dtype="float32", device=device)
        trainer.load_params(ckpt["state_dict"])
        trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
        trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)
        t0 = time.perf_counter()
        losses = trainer.train_step(to_device(host, trainer.device), True)
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": trainer.grad_norm.item(),
                          "disc_grad_norm": trainer.disc_grad_norm.item()}
        seconds[device] = time.perf_counter() - t0
    diffs = {k: abs(result["cuda"][k] - v) / max(abs(v), 1e-12) for k, v in result["cpu"].items()}
    row = {"rows": 2, "segment": VOCODER_F32_SEGMENT, "card": result["cuda"], "cpu": result["cpu"],
           "cpu_step_s": seconds["cpu"], "max_rel_diff": max(diffs.values())}
    print("vocoder float32 card vs cpu " + json.dumps(row), flush=True)
    if row["max_rel_diff"] > 1e-3:
        fail(f"the card's float32 GAN step disagrees with the CPU's: {diffs}")
    return row


def istft_phase(root: Path, cfg: dict) -> dict:
    """The iSTFTNet variant (upsample 8·8, 512 channels, an inverse STFT of
    hop 4) trained ISTFT_STEPS steps through ``train_spec_to_wav``; then its
    inference forward on the validation segments, the wavs frames × 256
    samples long. Every MRF stage of both, its validation's included, is
    held to the plain version."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import ISTFT_MODEL, vocoder_config
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train.spec_to_wav import train_spec_to_wav

    config = vocoder_config(cfg, root / "logs", "istft", model=ISTFT_MODEL,
                            max_steps=ISTFT_STEPS, save_top_k_ckpts=1)
    rows: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(rows)
    try:
        mrf_stage.launches = 0
        trainer = train_spec_to_wav(config, log_every=1)
        launches = mrf_stage.launches
        check_vocoder_run(trainer, list(range(1, ISTFT_STEPS + 1)), ISTFT_STEPS, 1)
        generator = trainer.generator
        if (generator.istft_hop, generator.istft_n_fft) != (4, 16):
            fail(f"iSTFT head of hop {generator.istft_hop}, n_fft {generator.istft_n_fft}")
        frames = samples = 0
        for batch in trainer.val_dataset.segment_batches(16, trainer.segment_size, shuffle=False):
            mel = to_device({"mel": batch["mel"]}, trainer.device)["mel"]
            wav = generator(mel).float().cpu().numpy()
            if wav.shape != (mel.shape[0], mel.shape[1] * 256) or not np.isfinite(wav).all():
                fail(f"iSTFT wav of {wav.shape} for mel {tuple(mel.shape)}")
            frames, samples = mel.shape[1], wav.shape[1]
    finally:
        hifigan.mrf_stage = mrf_stage
    torch.cuda.synchronize()
    row = {"steps": ISTFT_STEPS, "mrf_launches": launches, "frames": frames, "samples": samples,
           "stages": [rows[k] for k in sorted(rows)]}
    print("istft " + json.dumps(row), flush=True)
    return {"launches": launches, "stages": row["stages"]}


def serve_with_trained_vocoder(fs2_ckpt: Path, voc_ckpt: Path, out_dir: Path) -> dict:
    """The 1- and 16-text requests through ``Synthesizer`` from the trained
    FastSpeech2 and the exported trained vocoder, with the serving checks
    and every MRF stage held to the plain version (wall times include
    those checks)."""
    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import REQUESTS
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    synth = Synthesizer(fs2_ckpt, voc_ckpt)
    if synth.device.type != "cuda" or synth.vocoder is None:
        fail(f"Synthesizer resolved to {synth.device}")
    hop = synth._samples_per_frame()
    mrf_stage.launches = 0
    rows, seen = [], {}
    hifigan.mrf_stage = checked_mrf_stages(seen)
    try:
        for texts in (REQUESTS[0], REQUESTS[2]):
            t0 = time.perf_counter()
            results = synth.synthesize(texts)
            wall = time.perf_counter() - t0
            for res in results:
                check_wav(res, hop, "trained vocoder")
            if len(synth.write_outputs(results, out_dir, ("wav",))) != len(texts):
                fail("trained vocoder: a wav was not written")
            rows.append({"texts": len(texts), "wall_s": wall,
                         "samples": sum(r["wav"].shape[0] for r in results)})
    finally:
        hifigan.mrf_stage = mrf_stage
    launches = mrf_stage.launches
    if launches == 0:
        fail("serving from the trained vocoder launched no mrf_stage")
    stages = [seen[k] for k in sorted(seen)]
    row = {"requests": rows, "mrf_launches": launches, "stages": stages}
    print("trained vocoder serving " + json.dumps(row), flush=True)
    return {"launches": launches, "stages": stages, "row": row}


def vocoder_phase(root: Path, cfg: dict, fs2_ckpt: Path, card: str) -> dict:
    """The main path's vocoder slice: ``train_spec_to_wav`` on the
    preprocessed corpus at full width, on the card; a resume; the step's
    split; a float32 step held to the CPU's; the iSTFT variant; and serving
    from the exported trained generator."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.fs2.synthesize import export_generator
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.models.hifigan.model import HiFiGANGenerator
    from everyvoice_tpu_torch.onchip import vocoder_config
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train import loop
    from everyvoice_tpu_torch.train.checkpoint import save_checkpoint
    from everyvoice_tpu_torch.train.spec_to_wav import train_spec_to_wav

    config = vocoder_config(cfg, root / "logs", "vocoder", max_steps=VOCODER_STEPS,
                            val_check_interval=VOCODER_VAL_INTERVAL,
                            generator_warmup_steps=VOCODER_WARMUP, save_top_k_ckpts=1)
    t = config["training"]
    print("vocoder overrides " + json.dumps({
        k: t[k] for k in ("batch_size", "max_steps", "val_check_interval",
                          "generator_warmup_steps", "save_top_k_ckpts", "logger")}), flush=True)
    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda module, *_: forwards.append(1) if isinstance(module, HiFiGANGenerator) else None)
    step_s = []
    plain_step = loop.HiFiGANTrainer.train_step

    def timed_step(self, batch, gan_on):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_step(self, batch, gan_on)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    loop.HiFiGANTrainer.train_step = timed_step
    # Every validation forward's MRF stages, on the weights being trained,
    # held to the plain version on the same input.
    val_stages: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(val_stages)
    mrf_stage.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = train_spec_to_wav(config, log_every=1)  # the card, 'auto' precision
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, val_forwards = mrf_stage.launches, len(forwards)
        resume = vocoder_config(cfg, root / "logs", "vocoder-resume",
                                max_steps=VOCODER_STEPS + RESUME_STEPS,
                                val_check_interval=VOCODER_VAL_INTERVAL,
                                generator_warmup_steps=VOCODER_WARMUP, save_top_k_ckpts=1,
                                finetune_checkpoint=str(trainer.ckpt_dir / "last.ckpt"))
        resumed = train_spec_to_wav(resume, log_every=1)
    finally:
        loop.HiFiGANTrainer.train_step = plain_step
        hifigan.mrf_stage = mrf_stage
        hook.remove()
    training_launches = mrf_stage.launches
    val_rows = [val_stages[k] for k in sorted(val_stages)]
    for stage in val_rows:
        print("vocoder validation stage " + json.dumps(stage), flush=True)
    if sum(r["calls"] for r in val_rows) != training_launches:
        fail(f"{training_launches} mrf_stage launches, "
             f"{sum(r['calls'] for r in val_rows)} held to the plain version")
    if trainer.device.type != "cuda" or trainer.compute_dtype != "bfloat16":
        fail(f"the vocoder trainer resolved to {trainer.compute_dtype} on {trainer.device}")
    if launches == 0 or launches != 4 * val_forwards:
        fail(f"mrf_stage launched {launches} times for {val_forwards} validation forwards")
    records = check_vocoder_run(trainer, list(range(1, VOCODER_STEPS + 1)),
                                VOCODER_STEPS - VOCODER_WARMUP, 1)
    mels = [r["training/gen/mel"] for r in records]
    first, last = float(np.mean(mels[:10])), float(np.mean(mels[-10:]))
    if not last < first:
        fail(f"the vocoder's mel loss did not fall: first 10 steps {first}, last 10 {last}")
    check_vocoder_run(resumed, list(range(VOCODER_STEPS + 1, VOCODER_STEPS + RESUME_STEPS + 1)),
                      VOCODER_STEPS - VOCODER_WARMUP + RESUME_STEPS, 1)
    if resumed.resumed != "full":
        fail(f"vocoder resume: mode {resumed.resumed}")

    host = next(trainer.dataset.segment_batches(t["batch_size"], trainer.segment_size, seed=0))
    host.pop("basenames")
    split = split_gan_step(trainer, to_device(compress_for_transfer(host, ("mel",)), trainer.device))
    t0 = time.perf_counter()
    params, opt = trainer.host_state()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    written = save_checkpoint(root / "write-timing.ckpt", "HiFiGAN", {}, params, opt_state=opt)
    write_s = time.perf_counter() - t0
    ckpt_bytes = written.stat().st_size
    written.unlink()
    del params, opt
    f32 = vocoder_float32_card_vs_cpu(config, trainer.ckpt_dir / "last.ckpt", root / "f32")

    istft = istft_phase(root, cfg)
    exported = export_generator(trainer.ckpt_dir / "last.ckpt", root / "vocoder-generator.ckpt")
    served = serve_with_trained_vocoder(fs2_ckpt, exported, root / "trained-vocoder")

    median_ms = 1e3 * float(np.median(step_s[WARMUP_STEPS:VOCODER_STEPS]))
    steps_per_s = 1e3 / median_ms
    row = {
        "steps": len(records), "resumed_steps": RESUME_STEPS, "wall_s": wall,
        "median_step_ms": median_ms,
        "median_warmup_step_ms": 1e3 * float(np.median(step_s[WARMUP_STEPS:VOCODER_WARMUP])),
        "median_gan_step_ms": 1e3 * float(np.median(step_s[VOCODER_WARMUP:VOCODER_STEPS])),
        "steps_per_s": steps_per_s,
        "audio_s_per_s": steps_per_s * t["batch_size"] * trainer.segment_size / SR,
        "peak_memory_gb": peak / 1e9, "gen_mel_first10": first, "gen_mel_last10": last,
        **split, "host_state_s": host_s, "checkpoint_write_s": write_s,
        "checkpoint_gb": ckpt_bytes / 1e9, "validation_forwards": val_forwards,
        "mrf_launches": launches, "float32_max_rel_diff": f32["max_rel_diff"],
        "float32_cpu_step_s": f32["cpu_step_s"], "card": card,
    }
    print("vocoder train " + json.dumps(row), flush=True)
    return {"launches": training_launches + istft["launches"], "serving_launches": served["launches"],
            "stages": val_rows + istft["stages"] + served["stages"], "row": row}


def timed_build(name: str) -> tuple:
    from everyvoice_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build(name)
    return time.perf_counter() - t0, lib


def main() -> int:
    if not (ROOT / "everyvoice_tpu_torch" / "ops" / "csrc" / "mrf.cu").exists():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from everyvoice_tpu_torch.onchip import card_line, write_seeded_checkpoints

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {name: pool.submit(timed_build, name) for name in ("mrf", "mel")}
        for name, future in builds.items():
            seconds, lib = future.result()
            print(f"build: {name}.cu in {seconds:.2f} s -> {lib.name}", flush=True)

    gen = torch.Generator().manual_seed(0)
    stages = check_kernel(gen)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        fs2_path, voc_path = write_seeded_checkpoints(tmp, gen, "cuda")
        synth = Synthesizer(fs2_path, voc_path)  # device cuda, compute 'auto' = bf16
        served = serve(synth, tmp / "out", card)
        served_stages = check_served_stages(synth)
        del synth
        reference_check(fs2_path, voc_path)

        mel_rows = check_mel_kernel(torch.Generator().manual_seed(1))
        prep = preprocess_corpus(tmp, card)
        served_mel, batches = check_served_features(prep["pre"])
        time_feature_program(prep["pre"], batches, mel_rows)
        features_card_vs_cpu(prep["cfg"], batches[max(batches)])

        trained = train_phase(tmp, prep["cfg"], voc_path, card)
        training_launches = trained["launches"]
        fs2_ckpt = trained["trainer"].ckpt_dir / "last.ckpt"
        synthesize_trained(fs2_ckpt, voc_path, tmp / "trained")
        del trained
        vocoder = vocoder_phase(tmp, prep["cfg"], fs2_ckpt, card)

    bf16 = [r for r in stages if r["dtype"] == "bfloat16"]
    kernels = {"kernels": [{
        "name": "mrf_stage",
        "route": "cuda",
        "source": "everyvoice_tpu_torch/ops/csrc/mrf.cu",
        "replaces": "everyvoice_tpu/ops/mrf_pallas.py:137",
        "launches": (served["launches"] + training_launches + vocoder["launches"]
                     + vocoder["serving_launches"]),
        "serving_launches": served["launches"],
        "training_launches": training_launches,
        "vocoder_training_launches": vocoder["launches"],
        "trained_vocoder_serving_launches": vocoder["serving_launches"],
        "kernel_launches": served["kernel_launches"],
        "design": DESIGN["torch.bfloat16"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16 + served_stages + vocoder["stages"]),
        "ms": sum(r["kernel_ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
        "bound_ms": sum(r["bound_ms"] for r in bf16),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bf16) else "bytes",
        "library_ms": sum(r["library_ms"] for r in bf16),
        "shapes": "sum of the four V1 stages, B=2, 1000 mel frames, bfloat16",
    }, {
        "name": "log_mel",
        "route": "cuda",
        "source": "everyvoice_tpu_torch/ops/csrc/mel.cu",
        "replaces": "everyvoice_tpu/ops/mel_pallas.py:67",
        "launches": prep["launches"],
        "fft_launches": prep["fft_launches"],
        "design": "shared-memory radix-2 Stockham FFT (n_fft a power of two)",
        "max_abs_err": max(r["max_abs_err"] for r in mel_rows + served_mel),
        "ms": sum(r["kernel_ms"] for r in mel_rows),
        "plain_ms": sum(r["plain_ms"] for r in mel_rows),
        "bound_ms": sum(r["bound_ms"] for r in mel_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in mel_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in mel_rows),
        "shapes": "sum of the two served batches (16, 131072) and (16, 262144), float32",
    }]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
9. a phone-level English voice with global style tokens: preprocess a
   seeded 128-utterance corpus given as characters (language ``eng``)
   through audio, text, pfs, spec, attn, energy and pitch, G2P giving the
   phones, and hold every feature batch's log-mel to the plain version;
   train FastSpeech2 at phone level with GST through ``train_text_to_spec``
   (full width and depth, batch 16, bf16, 30 steps, validation at 30) and
   set its median step beside phase 7's; write the teacher-forced specs in
   float32; finetune the V1 vocoder of phase 8 on them 10 steps
   (``finetune: true``); serve the 1-, 4- and 16-text requests in English
   with a corpus wav as the style reference, into wav, spec, TextGrid and
   read-along XML and HTML, each checked; hold one float32 synthesis with
   the style reference to the CPU's. Every MRF stage of the phase (both
   validations, the served requests) is held to the plain version;
10. the command-line journey at full width: a seeded 64-utterance corpus
    and a project of YAML files as the JAX wizard writes one (paths
    relative to ``config/``), then, from another working directory, each
    verb through ``cli.main``: ``preprocess text-to-spec`` (every feature
    batch's log-mel held to the plain version), ``train text-to-spec`` (20
    steps, the seeded V1 for validation audio) and ``train spec-to-wav``
    (20 steps, 5 of warmup) at full width, ``export spec-to-wav``,
    ``synthesize from-text`` into all five formats and ``from-spec`` on its
    specs, ``evaluate`` on the card (SI-SDR of the one against the other;
    two rows held to the CPU's),
    ``checkpoint inspect`` and ``rename-speaker`` and a synthesis as the
    renamed speaker, ``g2p``, ``check text-config`` and ``check data``.
    Every MRF stage of the phase is held to the plain version in bfloat16.
    ``python -m everyvoice_tpu_torch --help`` and ``synthesize from-spec``
    then run as processes, the latter with no ``EVERYVOICE_DEVICE``, and
    must land on the card;
11. StyleTTS2 text→wav serving at full width (hidden 512, style 128, the
    512-channel AdaIN iSTFT decoder, 800 frames), which launches neither
    kernel: seeded checkpoints with the conv context encoder and with the
    multilingual PL-BERT (768 wide, 12 layers) through ``onchip.py``; the
    1-, 4- and 16-text requests in bf16 through ``synthesize_text`` (5
    diffusion steps), one at embedding scale 2 (the denoiser twice a step)
    and one with a corpus wav as the style reference, every wav checked;
    the PL-BERT variant's 4- and 16-text requests; one float32 synthesis
    on the card against the CPU's (1e-3 of max|ref|); bf16 against float32
    (the JAX package's criteria: relative RMS below 0.2, correlation and
    style-vector correlation above 0.98); ``synthesize text-to-wav``
    through ``cli.main`` with no ``EVERYVOICE_DEVICE``, which must land on
    the card; and a 16-text request split by CUDA events and
    torch.profiler;
12. StyleTTS2 training at full width (hidden 512, style 128, the 512-channel
    AdaIN iSTFT decoder, MPD periods 2/3/5/7/11 and MSD 3 scales, batch 2,
    ``max_len`` 800, clips of 320 frames, bf16) through ``cli.main`` from
    another working directory: a seeded 8-utterance project with an
    out-of-domain text file; ``preprocess text-to-wav`` (the ood step
    included; every feature batch's log-mel held to the plain version);
    ``train text-to-wav --mode first`` (2 epochs, the TMA from epoch 1) and
    ``--mode second`` (2 epochs, the diffusion from epoch 1), which must
    pick up stage 1's checkpoint and start from its weights; two steps
    resumed from ``stage-2-last.ckpt``; the logs and checkpoints checked
    (losses, keys, validations, the stage tag, both optimizer states in
    optax's layout); one float32 stage-2 step on the card against the CPU's
    (clips of 64 frames; a Viterbi tie shared only where ``path_tie`` proves
    it); a step split by CUDA events and torch.profiler; and the trained
    checkpoint served through ``synthesize text-to-wav`` with no device
    given, then its 1-text request. Cut to make room for phase 17: 8
    utterances, not 24 (3 steps an epoch, not 10, the trainers logging
    every 3), and no 16-text request from the trained checkpoint;
13. StyleTTS2 training with its pretrained components at full width:
    seeded files in the published formats and geometries (the JDC pitch
    network, the ASR aligner, the multilingual PL-BERT, WavLM base plus,
    written by ``onchip.write_pretrained_components``), an 8-utterance
    project with out-of-domain text (cut from 24 to make room for phase 17:
    3 steps an epoch, not 10, logged every 3), and through ``cli.main`` with the
    ``-c`` overrides ``fetch-pretrained`` would print: ``preprocess
    text-to-wav`` (every feature batch's log-mel held to the plain
    version), both stages (2 epochs each; the ASR aligner's targets from
    epoch 0, the diffusion and the out-of-domain SLM terms from epoch 1 of
    stage 2) and a 2-step resume; the grafted weights, the JDC's F0
    targets, the regime-2 losses, the frozen WavLM and JDC, the groups'
    learning rates on the first Adam step, the checkpoints' geometries and
    ``multi_transform`` states, bf16 WavLM features against float32, a
    float32 stage-2 step on the card against the CPU's, a step split
    (the ASR decoder loop, WavLM and the out-of-domain decode apart) and
    traced, and the trained checkpoint served;
14. long-audio CTC segmentation at wav2vec2-base's geometry (768 wide, 12
    layers, the 32 characters of wav2vec2-base-960h): a seeded model
    directory in the HuggingFace layout (``onchip.write_wav2vec2_ctc``), a
    seeded stereo recording of about 100 s at 22,050 Hz (six 20 s windows
    at 16 kHz, the last padded) and a 12-line transcript; ``segment align``
    and ``segment extract`` through ``cli.main`` with no device given; the
    TextGrid (the lines in order, in non-decreasing intervals inside the
    recording), the wavs (``int(end·sr) − int(start·sr)`` samples each) and
    ``metadata.psv`` checked; the windowed scoring's load time, wall, audio
    seconds per wall second and peak memory; its float32 log-probs on the
    card against the CPU's (atol 5e-4, rtol 5e-3, the wav2vec2 golden's)
    and the spans they give, equal or a tie that ``ctc_path_tie`` proves;
    one 20 s window of the stable-layer-norm variant at wav2vec2-large's
    geometry (1024 wide, 24 layers), card against CPU. Launches neither
    kernel;
15. the demo server: the FastSpeech2 app of phase 4's checkpoints with a
    denylist and an output directory, served by ``make_server`` on a
    thread: the page and ``/api/info``, an empty, a denied and a homograph
    text refused with the JAX app's messages, one text answered (frames ×
    hop samples), four texts posted at once (each within 1 LSB of the text
    served alone), all five output formats written, every MRF stage of the
    requests held to the plain version in bf16 (their launches are
    ``mrf_stage``'s ``demo_launches``); the StyleTTS2 app of a seeded
    full-width checkpoint with a named reference speaker, a request with 5
    diffusion steps and seed 3 held to ``synthesize_text`` on the card
    with that seed and speaker's styles (1 LSB); and ``python -m
    everyvoice_tpu_torch demo`` as a process with no device given, which
    must come up on the card within 120 s, refuse the empty and the denied
    text and answer "hello world";
16. multi-device training (``parallel_phase``): (a) ``train text-to-spec``,
    ``spec-to-wav`` and ``text-to-wav --mode first`` through ``cli.main`` at
    full width on phase 10's and phase 12's projects with ``-d 1`` under
    ddp (and fsdp and tp1 for FastSpeech2, the same path on one rank), each
    one rank of a one-rank NCCL group, and FastSpeech2's same training
    without a mesh: three steps, a validation (every MRF stage held to the
    plain version) and a checkpoint (the loaders read back ``train``'s),
    each run's step time and peak memory; (b) two ranks on the one card,
    started with ``spawn``: NCCL first, then, where it refuses two ranks on
    one card, gloo over the card's tensors; two FastSpeech2 and two HiFiGAN float32
    steps under ddp and fsdp, each step's losses and gradient norms and
    each network's update norm held to the one-process steps on the
    concatenated batch (1e-3 relative), with each rank's peak memory;
17. a project from nothing (``project_phase``): a seeded corpus of 256
    utterances at 48,000 Hz (3–10 s, about 1,660 s of audio) with 4 quiet
    ones under the −36 LUFS gate and 2 stereo ones; ``python -m
    everyvoice_tpu_torch new-project`` as a process answering from standard
    input, its five config files and filelist loaded back through
    ``config_files.py``; ``preprocess text-to-spec --device-audio`` as a
    process with no device given (it must land on the card), every default
    step, outputs at 22,050 and 44,100 Hz (48,000→22,050 and →44,100 on the
    card), and the same through ``cli.main`` on the host audio path into a
    second save dir: every audio artifact of the two within 1 LSB, the same
    rows, the 4 quiet files rejected by both, the spec, energy, pitch and
    attention artifacts' shapes and finiteness, ``log_mel`` launched once a
    feature batch and each batch held to the plain version; the audio
    step's wall and audio seconds a wall second on each path, the bytes
    each way, the bucket shapes and the peak memory; DIO on 16 of the
    project's clips on the card against the CPU (voicing equal on 99% of
    frames, median F0 gap under 0.1 Hz where both voice) and on a vibrato
    tone (median error under 0.5 Hz), timed beside the YIN tracker; the
    segment samplers with given starts equal on the card and the CPU;
18. print the kernels line, the card line, and last ``{"ok": true, ...}``.

Each phase's wall seconds are printed as it ends (``phase N (...): s``).

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
from contextlib import contextmanager
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
PHONE_UTTERANCES = 128
PHONE_STEPS = ("audio", "text", "pfs", "spec", "attn", "energy", "pitch")
PHONE_MODEL = {"target_text_representation_level": "phones", "use_global_style_token_module": True}
PHONE_TRAIN_STEPS = 30
FINETUNE_STEPS = 10


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


def reference_check(fs2_path: Path, voc_path: Path, **options) -> dict:
    """The card's float32 synthesis of one text against the CPU's;
    ``options`` go to ``synthesize`` (a language, a style reference)."""
    import numpy as np

    from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
    from everyvoice_tpu_torch.onchip import TEXTS

    text = TEXTS[:1]
    card = Synthesizer(fs2_path, voc_path, compute_dtype="float32").synthesize(text, **options)[0]
    cpu = Synthesizer(fs2_path, voc_path, compute_dtype="float32",
                      device="cpu").synthesize(text, **options)[0]
    if not all(np.array_equal(a, b) for a, b in zip(card["durations"], cpu["durations"])):
        fail("card and CPU float32 synthesis chose different durations")
    mel_diff = float(np.abs(card["mel"] - cpu["mel"]).max())
    wav_diff = float(np.abs(card["wav"] - cpu["wav"]).max())
    print(f"reference: card vs CPU float32 {sorted(options)}, max |mel diff| {mel_diff:.3e}, "
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


@contextmanager
def timed_steps(trainer_class, step_s: list):
    """``trainer_class.train_step`` timed on the host clock, the card
    synchronized around each step; the seconds go to ``step_s``."""
    import torch

    plain_step = trainer_class.train_step

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_step(self, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    trainer_class.train_step = timed_step
    try:
        yield
    finally:
        trainer_class.train_step = plain_step


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


# The profiler's own bookkeeping ops, which torch.profiler's event list skips.
UNTRACED = ("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
            "profiler::_record_function_enter_new", "profiler::_record_function_exit",
            "aten::is_leaf", "aten::output_nr", "aten::_version")


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
    # The raw events, with the ones prof.events() leaves out left out too:
    # parsing them into prof.events() takes about 20 s for a StyleTTS2
    # step's 300,000 events, much longer than the step.
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()
              and e.name() not in UNTRACED]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    if not kernels:
        return {"kernels": None, "busy_ms": None, "wall_ms": None}
    start = min(e.start_ns() for e in events)
    end = max(e.end_ns() for e in events)
    return {"kernels": len(kernels),
            "busy_ms": sum(e.duration_ns() for e in kernels) / 1e6,
            "wall_ms": (end - start) / 1e6}


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


def path_tie(logp_card, hard_card, logp_cpu, hard_cpu) -> dict:
    """Where the card's and the CPU's hard alignments part (each a (B, T, N)
    0/1 path, found on its own device's (B, T, N) log-probabilities, all
    float64): the frames they part on, how far the card's path scores below
    the CPU's own under the CPU's log-probabilities, and the most a tie
    allows. Each path is the best on its own device, so the gap is at most
    what the two devices' log-probabilities differ by on the cells where
    the paths part, plus a few float32 roundings of the path's score."""
    import numpy as np

    parted = hard_card != hard_cpu
    own = float((hard_cpu * logp_cpu).sum())
    gap = own - float((hard_card * logp_cpu).sum())
    bound = float((logp_card - logp_cpu).abs()[parted].sum()) + 8 * float(
        np.finfo(np.float32).eps) * abs(own)
    return {"frames_parted": int(parted.any(-1).sum()), "score_gap": gap, "tie_bound": bound}


def float32_step_card_vs_cpu(config: dict, ckpt_path: Path, run_root: Path) -> dict:
    """One float32 training step, dropout off, from the trained checkpoint's
    parameters, on one batch of 2 rows, on the card and on the CPU: losses
    and the global gradient norm within 1e-3 relative.

    The hard alignment is an argmax (the Viterbi path, in the JAX package
    too), and the card's log-probabilities differ from the CPU's by about
    1e-4, so on about one batch in twenty the two devices pick different
    paths of equal score, a frame apart, and every loss that follows the
    durations moves by about 1e-3. So the CPU's step takes the card's path,
    once ``path_tie`` shows it to be a tie on the CPU."""
    from everyvoice_tpu_torch.config import fs2_training_config
    from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.fs2 import model as fs2_model
    from everyvoice_tpu_torch.models.fs2.alignment import _masked_log_softmax
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
    viterbi = fs2_model.viterbi_alignment
    paths: dict = {}  # device -> (the log-probabilities the path search saw, its path)

    def shared_viterbi(device: str):
        def search(attn_logprob, src_lengths, mel_lengths):
            hard = viterbi(attn_logprob, src_lengths, mel_lengths)
            logp = _masked_log_softmax(attn_logprob.detach().float(), src_lengths)
            paths[device] = (logp.cpu().double(), hard.cpu().double())
            return hard if device == "cuda" else paths["cuda"][1].float().to(hard.device)
        return search

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
        fs2_model.viterbi_alignment = shared_viterbi(device)
        try:
            losses = trainer.train_step(to_device(host, trainer.device), 1.0)
        finally:
            fs2_model.viterbi_alignment = viterbi
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": trainer.grad_norm.item()}
    alignment = path_tie(*paths["cuda"], *paths["cpu"])
    diffs = {k: abs(result["cuda"][k] - v) / max(abs(v), 1e-12) for k, v in result["cpu"].items()}
    row = {"rows": 2, "card": result["cuda"], "cpu": result["cpu"], "alignment": alignment,
           "max_rel_diff": max(diffs.values())}
    print("train float32 card vs cpu " + json.dumps(row), flush=True)
    if alignment["score_gap"] > alignment["tie_bound"]:
        fail(f"the card's alignment path is not a tie of the CPU's: {alignment}")
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

    from everyvoice_tpu_torch.models.hifigan import model as hifigan
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
    step_s: list = []
    # The validation audio's MRF stages, held to the plain version.
    val_stages: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(val_stages)
    mrf_stage.launches = 0
    mrf_stage.kernel_launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with timed_steps(loop.FastSpeech2Trainer, step_s):
            t0 = time.perf_counter()
            trainer = train_text_to_spec(config, log_every=1)  # the card, 'auto' precision
            wall = time.perf_counter() - t0
    finally:
        hifigan.mrf_stage = mrf_stage
        hook.remove()
    launches, vocoder_forwards = mrf_stage.launches, len(forwards)
    stages = [val_stages[k] for k in sorted(val_stages)]
    for stage in stages:
        print("train validation stage " + json.dumps(stage), flush=True)
    if sum(r["calls"] for r in stages) != launches:
        fail(f"{launches} mrf_stage launches in validation, "
             f"{sum(r['calls'] for r in stages)} held to the plain version")
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
    return {"trainer": trainer, "launches": launches, "stages": stages, "row": row}


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
    step_s: list = []
    # Every validation forward's MRF stages, on the weights being trained,
    # held to the plain version on the same input.
    val_stages: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(val_stages)
    mrf_stage.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with timed_steps(loop.HiFiGANTrainer, step_s):
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
            "stages": val_rows + istft["stages"] + served["stages"], "row": row,
            "ckpt": trainer.ckpt_dir / "last.ckpt"}


def phone_symbols() -> list:
    """The phones the port's ``eng`` engine gives for the corpus's words and
    the served texts: the inventory a phone-level English voice declares."""
    from everyvoice_tpu_torch.onchip import CORPUS_WORDS, TEXTS
    from everyvoice_tpu_torch.text.phonemizer import get_g2p_engine

    engine = get_g2p_engine("eng")
    words = list(CORPUS_WORDS) + [w for text in TEXTS for w in text.lower().split()]
    return sorted({t for w in words for t in engine(w) if any(ch.isalpha() for ch in t)})


def preprocess_phone_corpus(root: Path, card: str) -> dict:
    """``Preprocessor.preprocess`` on the card over a seeded English corpus
    given as characters only: G2P gives every row its phones, the pfs step
    its (N_phones, 43) features; the log-mel kernel runs once per feature
    batch, and every batch is then held to the plain version."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.onchip import write_corpus
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    filelist, wavs, audio_s = write_corpus(root / "eng-corpus", PHONE_UTTERANCES, seed=6,
                                           language="eng")
    cfg = corpus_config(root / "eng", filelist, wavs)
    cfg["text"]["symbols"]["eng_phones"] = phone_symbols()
    pre = Preprocessor(cfg)
    log_mel.launches = 0
    log_mel.fft_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre.preprocess(to_process=PHONE_STEPS, cpus=min(8, os.cpu_count() or 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fft_launches = log_mel.launches, log_mel.fft_launches
    batches = len(pre.last_batch_shapes)
    if launches == 0 or launches != batches or fft_launches != batches:
        fail(f"log_mel launched {launches} times ({fft_launches} through the FFT "
             f"kernel) for {batches} feature batches of the English corpus")
    rows = generic_psv_filelist_reader(pre.save_dir / "filelist.psv")
    if len(rows) != PHONE_UTTERANCES:
        fail(f"the English corpus kept {len(rows)} of {PHONE_UTTERANCES} rows")
    n_phones = 0
    for row in rows:
        item = pre.get_speaker_and_language(row)
        phones = [t for t in pre.text_processor.split_tokens(row.get("phone_tokens") or "") if t]
        if not phones:
            fail(f"{row['basename']}: no phone_tokens")
        pfs = np.load(pre.create_path(item, "pfs", "pfs.npy"))
        frames = np.load(pre.create_path(item, "spec", pre._spec_filename()), mmap_mode="r").shape[1]
        attn = np.load(pre.create_path(item, "attn", "phones-attn-prior.npy"))
        if pfs.shape != (len(phones), 43) or not np.isfinite(pfs).all():
            fail(f"{row['basename']}: pfs of {pfs.shape} for {len(phones)} phones")
        if attn.shape != (frames, len(phones)):
            fail(f"{row['basename']}: phone prior of {attn.shape} for {frames} frames")
        n_phones += len(phones)
    dropped = dict(pre.text_processor.missing_symbols)
    if dropped:
        fail(f"G2P gave phones the inventory lacks: {dropped}")
    served, _ = check_served_features(pre)
    row = {"utterances": len(rows), "audio_s": audio_s, "wall_s": wall,
           "step_seconds": pre.last_step_seconds, "phones": n_phones, "batches": batches,
           "launches": launches, "card": card}
    print("phone preprocess " + json.dumps(row), flush=True)
    return {"cfg": cfg, "save_dir": pre.save_dir, "launches": launches, "served": served,
            "row": row}


def gst_layout(dim: int = 256, n_mels: int = 80, heads: int = 4,
               channels=(32, 32, 64, 64, 128, 128)) -> dict:
    """The JAX package's ``gst`` subtree, leaf path → shape."""
    out, c_in, m = {}, 1, n_mels
    for i, c in enumerate(channels):
        out.update({f"Conv_{i}/kernel": (3, 3, c_in, c), f"Conv_{i}/bias": (c,),
                    f"GroupNorm_{i}/scale": (c,), f"GroupNorm_{i}/bias": (c,)})
        c_in, m = c, -(-m // 2)
    out.update({"Dense_0/kernel": (m * c_in, dim // 2), "Dense_0/bias": (dim // 2,),
                "Dense_1/kernel": (dim, dim), "Dense_1/bias": (dim,), "style_tokens": (10, dim)})
    attn = "MultiHeadDotProductAttention_0"
    for name in ("query", "key", "value"):
        out.update({f"{attn}/{name}/kernel": (dim, heads, dim // heads),
                    f"{attn}/{name}/bias": (heads, dim // heads)})
    out.update({f"{attn}/out/kernel": (heads, dim // heads, dim), f"{attn}/out/bias": (dim,)})
    return out


def flat_shapes(tree, prefix: str = "") -> dict:
    import numpy as np

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_shapes(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(np.shape(tree))}


def train_phone_voice(root: Path, cfg: dict, voc_path: Path, card: str) -> dict:
    """``train_text_to_spec`` at phone level with global style tokens, at
    the default full width and depth, on the card: PHONE_TRAIN_STEPS steps
    of batch 16 in bf16, validation at the last through the seeded HiFiGAN
    V1 with every MRF stage held to the plain version; the losses finite, a
    ``gst`` subtree of the JAX layout in every checkpoint."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train import loop
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec

    config = {**training_config(root, cfg, voc_path, "phones", max_steps=PHONE_TRAIN_STEPS,
                                val_check_interval=PHONE_TRAIN_STEPS),
              "model": PHONE_MODEL}
    step_s: list = []
    stages: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(stages)
    mrf_stage.launches = 0
    try:
        with timed_steps(loop.FastSpeech2Trainer, step_s):
            trainer = train_text_to_spec(config, log_every=1)
    finally:
        hifigan.mrf_stage = mrf_stage
    launches = mrf_stage.launches
    stages = [stages[k] for k in sorted(stages)]
    if launches == 0 or sum(r["calls"] for r in stages) != launches:
        fail(f"phone-level validation: {launches} mrf_stage launches, "
             f"{sum(r['calls'] for r in stages)} held to the plain version")
    if trainer.compute_dtype != "bfloat16" or trainer.model.gst is None:
        fail(f"the phone-level trainer ran {trainer.compute_dtype}, "
             f"GST {trainer.model.gst is not None}")
    records = check_run(trainer, expect_tagged=1)
    values = [v for r in records for k, v in r.items() if k.startswith("training/")]
    if len(records) != PHONE_TRAIN_STEPS or not np.isfinite(values).all():
        fail(f"phone-level run: {len(records)} logged steps, finite: {np.isfinite(values).all()}")
    want = gst_layout(trainer.model.dim)
    for path in trainer.ckpt_dir.glob("*.ckpt"):
        got = flat_shapes(load_checkpoint(path)["state_dict"]["params"].get("gst", {}))
        if got != want:
            fail(f"{path.name}: the gst subtree is not in the JAX layout: {got}")
    torch.cuda.synchronize()
    row = {"steps": len(records), "median_step_ms": 1e3 * float(np.median(step_s[WARMUP_STEPS:])),
           "loss_first5": float(np.mean([r["training/total"] for r in records[:5]])),
           "loss_last5": float(np.mean([r["training/total"] for r in records[-5:]])),
           "mrf_launches": launches, "card": card}
    return {"ckpt": trainer.ckpt_dir / "last.ckpt", "config": config, "launches": launches,
            "stages": stages, "row": row}


def write_teacher_forced(fs2_ckpt: Path, config: dict, save_dir: Path) -> dict:
    """``synthesize_teacher_forced_specs`` on every row of the corpus (the
    finetune's training and validation rows) in float32 on the card: one
    (80, frames) file per row, shaped like its ``spec/``."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.models.fs2.synthesize import synthesize_teacher_forced_specs
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    rows = generic_psv_filelist_reader(save_dir / "filelist.psv")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = synthesize_teacher_forced_specs(fs2_ckpt, rows, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if written != len(rows):
        fail(f"teacher forcing wrote {written} specs for {len(rows)} rows")
    for path in (save_dir / "spec").glob("*.npy"):
        got = np.load(save_dir / "synthesized_spec" / path.name)
        if got.shape != np.load(path, mmap_mode="r").shape or not np.isfinite(got).all():
            fail(f"{path.name}: teacher-forced spec of {got.shape}")
    row = {"rows": written, "wall_s": wall}
    print("teacher forced " + json.dumps(row), flush=True)
    return row


def finetune_vocoder(root: Path, cfg: dict, v1_ckpt: Path) -> dict:
    """``train_spec_to_wav`` with ``finetune: true`` on the teacher-forced
    specs, from the vocoder phase's V1 checkpoint, FINETUNE_STEPS steps
    with validation at the last, every MRF stage held to the plain
    version; then the generator exported for serving."""
    from everyvoice_tpu_torch.models.fs2.synthesize import export_generator
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import vocoder_config
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train.spec_to_wav import train_spec_to_wav

    start = VOCODER_STEPS
    config = vocoder_config(cfg, root / "logs", "finetune", max_steps=start + FINETUNE_STEPS,
                            val_check_interval=FINETUNE_STEPS,
                            generator_warmup_steps=VOCODER_WARMUP, save_top_k_ckpts=1,
                            finetune=True, finetune_checkpoint=str(v1_ckpt))
    stages: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(stages)
    mrf_stage.launches = 0
    try:
        t0 = time.perf_counter()
        trainer = train_spec_to_wav(config, log_every=1)
        wall = time.perf_counter() - t0
    finally:
        hifigan.mrf_stage = mrf_stage
    launches = mrf_stage.launches
    stages = [stages[k] for k in sorted(stages)]
    if not trainer.dataset.finetune or trainer.resumed != "full":
        fail(f"finetune: dataset finetune={trainer.dataset.finetune}, resume {trainer.resumed}")
    check_vocoder_run(trainer, list(range(start + 1, start + FINETUNE_STEPS + 1)),
                      start - VOCODER_WARMUP + FINETUNE_STEPS, 1)
    if launches == 0 or sum(r["calls"] for r in stages) != launches:
        fail(f"finetune: {launches} mrf_stage launches, "
             f"{sum(r['calls'] for r in stages)} held to the plain version")
    exported = export_generator(trainer.ckpt_dir / "last.ckpt", root / "finetuned-generator.ckpt")
    row = {"steps": FINETUNE_STEPS, "wall_s": wall, "mrf_launches": launches,
           "train_rows": len(trainer.dataset), "validation_rows": len(trainer.val_dataset)}
    print("vocoder finetune " + json.dumps(row), flush=True)
    return {"generator": exported, "launches": launches, "stages": stages, "row": row}


def check_text_outputs(res: dict, stem_files: dict, hop_s: float, what: str) -> None:
    """A result's TextGrid (one interval a token, ``xmax`` the summed used
    durations in seconds) and read-along XML (parses)."""
    import xml.etree.ElementTree as ET

    tokens = sum(len(ids) for ids in res["tokens"])
    seconds = sum(float(sum(d)) for d in res["durations"]) * hop_s
    grid = stem_files[".TextGrid"].read_text(encoding="utf8")
    intervals = grid.count("intervals [")
    xmax = float(next(line for line in grid.splitlines() if line.startswith("xmax = ")).split("=")[1])
    if intervals != tokens or abs(xmax - seconds) > 1e-5:
        fail(f"{what}: TextGrid of {intervals} intervals to {xmax} s for {tokens} tokens "
             f"and {seconds} s")
    words = ET.parse(stem_files[".readalong"]).getroot().iter("w")
    if sum(1 for _ in words) != tokens:
        fail(f"{what}: the read-along XML does not hold one <w> a token")


def serve_phone_voice(fs2_ckpt: Path, generator: Path, style: Path, out_dir: Path,
                      char_requests: list) -> dict:
    """``onchip.py``'s 1-, 4- and 16-text requests in English through
    ``Synthesizer`` from the phone-level GST checkpoint and the finetuned
    generator, conditioned on a corpus wav, writing all five output
    formats, each checked; the walls beside phase 4's. Then the same
    requests again, every MRF stage they run held to the plain version."""
    import torch

    from everyvoice_tpu_torch.models.fs2.synthesize import OUTPUT_FORMATS, Synthesizer
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import REQUESTS
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    synth = Synthesizer(fs2_ckpt, generator)
    if synth.device.type != "cuda" or synth.model.gst is None:
        fail(f"phone-level Synthesizer on {synth.device}, GST {synth.model.gst is not None}")
    options = {"language": "eng", "style_reference": style}
    synth.synthesize(REQUESTS[0], **options)  # warm-up
    hop = synth._samples_per_frame()
    hop_s = hop / synth.config["preprocessing"]["audio"]["output_sampling_rate"]
    rows = []
    mrf_stage.launches = 0
    for i, texts in enumerate(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = synth.synthesize(texts, **options)
        wall = time.perf_counter() - t0
        names = [f"r{i}t{j}" for j in range(len(texts))]
        written = synth.write_outputs(results, out_dir, OUTPUT_FORMATS, language="eng",
                                      basenames=names)
        if len(written) != len(OUTPUT_FORMATS) * len(texts):
            fail(f"phone-level request {i}: {len(written)} files for {len(texts)} texts")
        for name, res in zip(names, results):
            check_wav(res, hop, f"phone-level request {i}")
            files = {p.suffix: p for p in written if p.name.startswith(f"{name}--")}
            check_text_outputs(res, files, hop_s, f"phone-level request {i}")
        rows.append({"texts": len(texts), "chunks": sum(len(r["tokens"]) for r in results),
                     "phones": sum(len(ids) for r in results for ids in r["tokens"]),
                     "frames": sum(r["mel"].shape[0] for r in results),
                     "wall_s": wall, "character_level_wall_s": char_requests[i]["wall_s"]})
    launches = mrf_stage.launches
    seen: dict = {}
    hifigan.mrf_stage = checked_mrf_stages(seen)
    try:
        for texts in REQUESTS:
            synth.synthesize(texts, **options)
    finally:
        hifigan.mrf_stage = mrf_stage
    stages = [seen[k] for k in sorted(seen)]
    if launches == 0 or sum(r["calls"] for r in stages) != launches:
        fail(f"phone-level serving: {launches} mrf_stage launches, "
             f"{sum(r['calls'] for r in stages)} held to the plain version")
    t0 = time.perf_counter()
    synth.load_style_reference(style)
    torch.cuda.synchronize()
    row = {"requests": rows, "mrf_launches": launches, "stages": stages,
           "load_style_reference_s": time.perf_counter() - t0}
    print("phone-level serving " + json.dumps(row), flush=True)
    return {"launches": launches, "stages": stages, "row": row}


def phone_voice_phase(root: Path, voc_path: Path, v1_ckpt: Path, char_step_ms: float,
                      char_requests: list, card: str) -> dict:
    """A phone-level English voice with global style tokens, end to end on
    the card: preprocess from characters through G2P and phonological
    features, train, write teacher-forced specs, finetune the vocoder on
    them, serve with a style reference into every output format, and hold
    one float32 synthesis to the CPU's."""
    t0 = time.perf_counter()
    prep = preprocess_phone_corpus(root, card)
    trained = train_phone_voice(root, prep["cfg"], voc_path, card)
    trained["row"]["character_level_median_step_ms"] = char_step_ms
    print("phone train " + json.dumps(trained["row"]), flush=True)
    teacher = write_teacher_forced(trained["ckpt"], trained["config"], prep["save_dir"])
    tuned = finetune_vocoder(root, prep["cfg"], v1_ckpt)
    style = sorted((prep["save_dir"] / "audio").glob("*.wav"))[0]
    served = serve_phone_voice(trained["ckpt"], tuned["generator"], style, root / "phone-out",
                               char_requests)
    reference = reference_check(trained["ckpt"], tuned["generator"], language="eng",
                                style_reference=style)
    print("phone voice " + json.dumps({
        "wall_s": time.perf_counter() - t0, "validation_stages": trained["stages"],
        "finetune_stages": tuned["stages"]}), flush=True)
    return {"mel_launches": prep["launches"], "served_mel": prep["served"],
            "mrf_launches": trained["launches"] + tuned["launches"] + served["launches"],
            "stages": trained["stages"] + tuned["stages"] + served["stages"],
            "row": {"preprocess": prep["row"], "train": trained["row"], "teacher_forced": teacher,
                    "finetune": tuned["row"], "serving": served["row"], "reference": reference}}


CLI_UTTERANCES = 64
CLI_TRAIN_STEPS = 20
CLI_VOCODER_WARMUP = 5
CLI_TEXTS = 16
# The floor of the mean SI-SDR of ``synthesize from-spec``'s wavs against
# ``synthesize from-text``'s (the same specs through the same vocoder): 10 dB
# below the 39.21 dB of the first run on an NVIDIA H100 80GB HBM3 at 700 W.
CLI_SI_SDR_FLOOR_DB = 29.2
# ``evaluate``'s metrics on the card against the CPU: up to one unit in the
# last place each is rounded to (float32 sums in another order can cross a
# rounding boundary); the duration and the sample counts exact.
EVALUATE_TOLERANCES = {"duration_s": 0.0, "loudness_lufs": 0.015, "clipping_rate": 0.0,
                       "silence_ratio": 0.0, "spectral_flatness": 1.5e-4, "si_sdr": 1.5e-3,
                       "stoi": 1.5e-4}


def cli_phase(root: Path, voc_path: Path, card: str) -> dict:
    """The command-line journey at full width: a seeded corpus and a project
    of YAML files with paths relative to ``config/``, then each verb through
    ``cli.main`` from another working directory; ``python -m
    everyvoice_tpu_torch`` as a real process twice. Every MRF stage of the
    trainings, validations and syntheses is held to the plain version, every
    feature batch's log-mel too."""
    import subprocess

    import numpy as np
    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.evaluation import evaluate_directory
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import TEXTS, write_corpus, write_project
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint_header
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    t_phase = time.perf_counter()
    work = root / "cli"
    project = work / "cli-project"
    filelist, wavs, audio_s = write_corpus(project / "corpus", CLI_UTTERANCES, seed=10)
    config_dir = write_project(work, filelist, wavs, name="cli-project",
                               symbols={"characters": list("abcdefghijklmnopqrstuvwxyz")})
    fs2_yaml = config_dir / "everyvoice-text-to-spec.yaml"
    voc_yaml = config_dir / "everyvoice-spec-to-wav.yaml"
    data = (config_dir / "everyvoice-shared-data.yaml").read_text()
    if "../" not in data or str(work) in data:
        fail(f"the project's data config holds no relative paths:\n{data}")
    texts = work / "texts.psv"
    texts.write_text("basename|characters\n" + "".join(
        f"text{i:02d}|{(TEXTS * 2)[i]}\n" for i in range(CLI_TEXTS)), encoding="utf8")
    logs = project / "logs_and_checkpoints"
    walls: dict = {}

    def run(name: str, *args) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([str(a) for a in args])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            fail(f"{name}: exit code {rc}")

    preprocessors = []
    plain_preprocess = Preprocessor.preprocess

    def recording(self, *args, **kwargs):
        preprocessors.append(self)
        return plain_preprocess(self, *args, **kwargs)

    stages: dict = {}
    cwd = Path.cwd()
    (work / "elsewhere").mkdir()
    os.chdir(work / "elsewhere")
    Preprocessor.preprocess = recording
    hifigan.mrf_stage = checked_mrf_stages(stages)
    log_mel.launches = 0
    log_mel.fft_launches = 0
    mrf_stage.launches = 0
    try:
        run("preprocess", "preprocess", "text-to-spec", fs2_yaml)
        mel_launches, fft_launches = log_mel.launches, log_mel.fft_launches
        run("train text-to-spec", "train", "text-to-spec", fs2_yaml,
            "-c", f"training.max_steps={CLI_TRAIN_STEPS}",
            "-c", f"training.val_check_interval={CLI_TRAIN_STEPS}",
            "-c", f"training.vocoder_path={voc_path}", "-c", "training.logger.name=fs2")
        run("train spec-to-wav", "train", "spec-to-wav", voc_yaml,
            "-c", f"training.max_steps={CLI_TRAIN_STEPS}",
            "-c", f"training.generator_warmup_steps={CLI_VOCODER_WARMUP}",
            "-c", "training.logger.name=vocoder")
        [fs2_ckpt] = logs.glob("fs2/base/*/checkpoints/last.ckpt")
        [voc_ckpt] = logs.glob("vocoder/base/*/checkpoints/last.ckpt")
        generator = work / "generator.ckpt"
        run("export spec-to-wav", "export", "spec-to-wav", voc_ckpt, generator)
        run("synthesize from-text", "synthesize", "from-text", fs2_ckpt, "-f", texts,
            "--vocoder-path", generator, "-o", "from-text", *[
                x for t in ("wav", "spec", "textgrid", "readalong-xml", "readalong-html")
                for x in ("-O", t)])
        run("synthesize from-spec", "synthesize", "from-spec", generator,
            "-i", "from-text/synthesized_spec", "-o", "from-spec")
        run("evaluate", "evaluate", "-d", "from-spec/wav", "-g", "from-text/wav",
            "-o", "evaluation.json")
        run("checkpoint inspect", "checkpoint", "inspect", fs2_ckpt, "--show-architecture")
        run("checkpoint rename-speaker", "checkpoint", "rename-speaker", fs2_ckpt, "default",
            "narrator", work / "renamed.ckpt")
        run("synthesize from-text -s", "synthesize", "from-text", work / "renamed.ckpt",
            "-t", TEXTS[0], "-s", "narrator", "--vocoder-path", generator, "-o", "renamed")
        run("g2p", "g2p", "eng", "hello world")
        run("check text-config", "check", "text-config",
            config_dir / "everyvoice-shared-text.yaml", "-f", filelist)
        run("check data", "check", "data", fs2_yaml, "--model-path", fs2_ckpt,
            "-o", "checked-data.json")
        mrf_launches = mrf_stage.launches
        out = Path.cwd()
    finally:
        os.chdir(cwd)
        Preprocessor.preprocess = plain_preprocess
        hifigan.mrf_stage = mrf_stage

    [pre] = preprocessors
    batches = len(pre.last_batch_shapes)
    if mel_launches == 0 or mel_launches != batches or fft_launches != batches:
        fail(f"preprocess: log_mel launched {mel_launches} times ({fft_launches} through the "
             f"FFT kernel) for {batches} feature batches")
    save = pre.save_dir
    if save != (project / "preprocessed").resolve():
        fail(f"preprocess wrote to {save}, not the project's preprocessed/")
    for kind in ("spec", "energy", "pitch", "attn"):
        n = len(list((save / kind).glob("*.npy")))
        if n != CLI_UTTERANCES:
            fail(f"preprocess: {n} {kind} artifacts for {CLI_UTTERANCES} utterances")
    n_train = len(generic_psv_filelist_reader(save / "training_filelist.psv"))
    if n_train != int(CLI_UTTERANCES * 0.9):
        fail(f"preprocess: {n_train} training rows")
    served_mel, _ = check_served_features(pre)

    for ckpt, name in ((fs2_ckpt, "FastSpeech2"), (voc_ckpt, "HiFiGAN"),
                       (generator, "HiFiGANGenerator")):
        header = load_checkpoint_header(ckpt)
        if header["model_info"]["name"] != name or header["global_step"] != CLI_TRAIN_STEPS:
            fail(f"{ckpt.name}: {header['model_info']} at step {header['global_step']}")
    if load_checkpoint_header(work / "renamed.ckpt")["hyper_parameters"]["speaker2id"] != {
            "narrator": 0}:
        fail("rename-speaker did not rename 'default' to 'narrator'")
    wavs_text = sorted((out / "from-text" / "wav").glob("*.wav"))
    wavs_spec = sorted((out / "from-spec" / "wav").glob("*.wav"))
    for sub, pattern in (("synthesized_spec", "*.npy"), ("textgrids", "*.TextGrid"),
                         ("readalongs", "*.readalong"), ("readalongs", "*.html")):
        if len(list((out / "from-text" / sub).glob(pattern))) != CLI_TEXTS:
            fail(f"synthesize from-text wrote no {CLI_TEXTS} {sub}/{pattern}")
    if len(wavs_text) != CLI_TEXTS or [p.name for p in wavs_spec] != [p.name for p in wavs_text]:
        fail(f"synthesize wrote {len(wavs_text)} wavs from text, {len(wavs_spec)} from specs")
    if not list((out / "renamed" / "wav").glob("*--narrator--default.wav")):
        fail("synthesis as 'narrator' wrote no wav")
    results = json.loads((out / "evaluation.json").read_text())
    si_sdr = float(np.mean([r["si_sdr"] for r in results]))
    if len(results) != CLI_TEXTS or not np.isfinite(si_sdr):
        fail(f"evaluate: {len(results)} rows, mean SI-SDR {si_sdr}")
    if si_sdr < CLI_SI_SDR_FLOOR_DB:
        fail(f"evaluate: mean SI-SDR {si_sdr} dB below {CLI_SI_SDR_FLOOR_DB} dB")
    # The card's rows against the CPU's for the first two wavs: equal up to
    # one unit in the last place each metric is rounded to.
    for card_row in results[:2]:
        wav = Path(card_row["file"])
        if not wav.is_absolute():
            wav = out / wav
        [cpu_row] = evaluate_directory(wav, reference_dir=out / "from-text" / "wav",
                                       device="cpu")
        for key, tol in EVALUATE_TOLERANCES.items():
            if card_row[key] is None or abs(card_row[key] - cpu_row[key]) > tol:
                fail(f"evaluate {wav.name}: {key} {card_row[key]} on the card, "
                     f"{cpu_row[key]} on the CPU")
    checked = json.loads((out / "checked-data.json").read_text())
    if len(checked) != n_train or not all(
            np.isfinite(v) for r in checked for k, v in r.items() if k != "basename"):
        fail(f"check data: {len(checked)} rows for {n_train} items, or a loss not finite")

    rows = [stages[k] for k in sorted(stages)]
    for row in rows:
        print("cli stage " + json.dumps(row), flush=True)
    if sum(r["calls"] for r in rows) != mrf_launches or mrf_launches == 0:
        fail(f"{mrf_launches} mrf_stage launches in the CLI journey, "
             f"{sum(r['calls'] for r in rows)} held to the plain version")
    if any(r["dtype"] != "bfloat16" for r in rows):
        fail(f"an MRF stage of the CLI journey ran in {[r['dtype'] for r in rows]}")

    env = {k: v for k, v in os.environ.items() if k != "EVERYVOICE_DEVICE"}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    shown = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "--help"], cwd=work,
                           env=env, capture_output=True, text=True, timeout=120)
    walls["--help (process)"] = time.perf_counter() - t0
    if shown.returncode != 0 or "synthesize" not in shown.stdout:
        fail(f"python -m everyvoice_tpu_torch --help: exit {shown.returncode}\n{shown.stderr}")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "everyvoice_tpu_torch", "synthesize", "from-spec", generator,
         "-i", out / "from-text" / "synthesized_spec", "-o", work / "child"],
        cwd=work, env=env, capture_output=True, text=True, timeout=300)
    walls["synthesize from-spec (process)"] = time.perf_counter() - t0
    device_lines = [line for line in child.stderr.splitlines() if line.startswith("device: ")]
    if child.returncode != 0 or device_lines != ["device: cuda"]:
        fail(f"the synthesize from-spec process: exit {child.returncode}, {device_lines}\n"
             f"{child.stderr[-2000:]}")
    if len(list((work / "child" / "wav").glob("*.wav"))) != CLI_TEXTS:
        fail("the synthesize from-spec process wrote no wavs")

    row = {"utterances": CLI_UTTERANCES, "audio_s": audio_s, "walls_s": walls,
           "verbs_s": sum(v for k, v in walls.items() if "process" not in k),
           "phase_s": time.perf_counter() - t_phase, "mrf_launches": mrf_launches,
           "log_mel_launches": mel_launches, "feature_batches": batches,
           "si_sdr_db": si_sdr, "child_device": device_lines[0], "card": card}
    print("cli " + json.dumps(row), flush=True)
    return {"mrf_launches": mrf_launches, "mel_launches": mel_launches, "stages": rows,
            "served_mel": served_mel, "row": row, "config_dir": config_dir}


ST2_STEPS = 5  # diffusion steps, the CLI's default


def check_st2_wav(wav, hop: int, max_frames: int, what: str) -> None:
    """A StyleTTS2 wav: float32, finite and a whole number of frames of
    ``hop`` samples, at most ``max_frames`` of them."""
    import numpy as np

    if wav.dtype != np.float32 or not np.isfinite(wav).all():
        fail(f"{what}: a wav of {wav.dtype}, or not finite")
    if len(wav) == 0 or len(wav) % hop or len(wav) > max_frames * hop:
        fail(f"{what}: {len(wav)} samples, not frames × {hop} (at most {max_frames} frames)")


def serve_st2(model, config, tp, card: str, what: str, requests, **options) -> list:
    """Each request's texts through ``synthesize_text``, one at a time as
    the JAX package serves them: wall, audio, RTF and peak memory per
    request, each wav checked."""
    import torch

    from everyvoice_tpu_torch.models.styletts2.synthesize import synthesize_text

    rows = []
    sr = config["preprocessing"]["audio"]["output_sampling_rate"]
    for texts in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wavs = [synthesize_text(model, config, tp, t, diffusion_steps=ST2_STEPS, **options)
                for t in texts]
        wall = time.perf_counter() - t0
        for wav in wavs:
            check_st2_wav(wav, model.hop, model.max_frames, f"{what}, {len(texts)} texts")
        audio_s = sum(len(w) for w in wavs) / sr
        row = {"what": what, "texts": len(texts), "frames": sum(len(w) for w in wavs) // model.hop,
               "wall_s": wall, "audio_s": audio_s, "rtf": audio_s / wall,
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "card": card}
        print("styletts2 request " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def split_st2_request(model, config, tp, texts) -> dict:
    """One request's texts split by CUDA events into the serving parts:
    PL-BERT (the text context), the style diffusion, the text side (the
    text encoder's and prosody predictor's LSTMs, durations, regulation),
    the decoder's stack and its iSTFT head, summed over the texts; then the
    request traced by torch.profiler (kernels, device busy time, wall)."""
    import torch

    from everyvoice_tpu_torch.models.styletts2.model import sample_style_diffusion
    from everyvoice_tpu_torch.models.styletts2.synthesize import (
        draw_noise,
        encode,
        prosody_frames,
        synthesize_text,
    )
    from everyvoice_tpu_torch.utils.precision import no_tf32

    parts = ("plbert_ms", "diffusion_ms", "text_side_ms", "decoder_ms", "istft_head_ms")
    out = dict.fromkeys(parts, 0.0)
    with torch.no_grad(), no_tf32():
        for text in texts:
            diffusion_noise, source_noise = draw_noise(model)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
            tokens, mask = encode(model, config, tp, text)
            events[0].record()
            emb = model.text_context_embedding(tokens, mask)
            events[1].record()
            joint = sample_style_diffusion(model.denoise_style, diffusion_noise.to(emb.device),
                                           emb, steps=ST2_STEPS)
            events[2].record()
            frames, f0, _ = prosody_frames(model, tokens, mask, joint[:, model.style_dim:])
            events[3].record()
            x = model.decoder.stack(frames, f0, joint[:, : model.style_dim],
                                    source_noise.to(emb.device))
            events[4].record()
            model.decoder.head(x, frames.shape[1] * model.hop)
            events[5].record()
            torch.cuda.synchronize()
            for i, name in enumerate(parts):
                out[name] += events[i].elapsed_time(events[i + 1])
    traced = trace(lambda: [synthesize_text(model, config, tp, t, diffusion_steps=ST2_STEPS)
                            for t in texts])
    out.update({"texts": len(texts), "kernels": traced["kernels"],
                "busy_ms": traced["busy_ms"], "traced_wall_ms": traced["wall_ms"],
                "idle_share": (None if traced["busy_ms"] is None
                               else 1.0 - traced["busy_ms"] / traced["wall_ms"])})
    return out


def styletts2_phase(root: Path, card: str) -> dict:
    """StyleTTS2 text→wav serving at full width (phase 11): seeded
    checkpoints (the conv context encoder, and the multilingual PL-BERT),
    the 1-, 4- and 16-text requests in bf16 on the card, one at embedding
    scale 2 and one with a style reference; a float32 synthesis on the card
    against the CPU's; bf16 against float32; ``synthesize text-to-wav``
    through ``cli.main`` with no device given; and a 16-text request split
    into its parts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.models.styletts2 import synthesize as st2
    from everyvoice_tpu_torch.onchip import (
        REQUESTS,
        TEXTS,
        write_corpus,
        write_styletts2_checkpoint,
    )

    t_phase = time.perf_counter()
    work = root / "styletts2"
    gen = torch.Generator().manual_seed(3)
    t0 = time.perf_counter()
    plain = write_styletts2_checkpoint(work, gen)
    with_plbert = write_styletts2_checkpoint(work, gen, plbert=True)
    write_s = time.perf_counter() - t0
    _, wavs, _ = write_corpus(work / "corpus", 1, seed=12)
    reference = next(wavs.glob("*.wav"))

    model, config, tp, _ = st2.load_styletts2_model(plain)  # cuda, 'auto' = bf16
    if model.decoder.dtype != torch.bfloat16 or next(model.parameters()).device.type != "cuda":
        fail(f"StyleTTS2 resolved to {model.decoder.dtype} on {next(model.parameters()).device}")
    st2.synthesize_text(model, config, tp, TEXTS[0])  # warm-up: cuDNN and allocator start-up
    rows = serve_st2(model, config, tp, card, "plain", REQUESTS)

    calls = []
    plain_denoise = model.denoise_style
    model.denoise_style = lambda *a: calls.append(1) or plain_denoise(*a)
    try:
        rows += serve_st2(model, config, tp, card, "embedding scale 2", REQUESTS[:1],
                          embedding_scale=2.0)
    finally:
        del model.denoise_style
    if len(calls) != 2 * ST2_STEPS:
        fail(f"embedding scale 2: the denoiser ran {len(calls)} times in {ST2_STEPS} steps")
    ref_styles = st2.load_reference_style(model, reference, config)
    rows += serve_st2(model, config, tp, card, "style reference", REQUESTS[:1],
                      ref_styles=ref_styles, acoustic_blend=0.5, prosody_blend=0.5)

    # float32 on the card against the CPU, and bf16 against float32
    f32, _, _, _ = st2.load_styletts2_model(plain, compute_dtype="float32")
    cpu, _, _, _ = st2.load_styletts2_model(plain, compute_dtype="float32", device="cpu")
    text = REQUESTS[0][0]
    wav32 = st2.synthesize_text(f32, config, tp, text)
    wav_cpu = st2.synthesize_text(cpu, config, tp, text)
    wav16 = st2.synthesize_text(model, config, tp, text)
    if wav32.shape != wav_cpu.shape:
        fail(f"float32 card vs CPU: {wav32.shape} and {wav_cpu.shape} samples")
    card_cpu = float(np.abs(wav32 - wav_cpu).max())
    card_cpu_tol = 1e-3 * float(np.abs(wav_cpu).max())
    rel_rms = float(np.sqrt(np.mean((wav32 - wav16) ** 2)) / np.sqrt(np.mean(wav32 ** 2)))
    corr = float(np.corrcoef(wav32, wav16)[0, 1])
    style_corr = float(np.corrcoef(np.concatenate(st2.load_reference_style(f32, reference, config)),
                                   np.concatenate(ref_styles))[0, 1])
    precision = {"card_vs_cpu_max_abs": card_cpu, "card_vs_cpu_tol": card_cpu_tol,
                 "bf16_rel_rms": rel_rms, "bf16_corr": corr, "bf16_style_corr": style_corr}
    print("styletts2 precision " + json.dumps(precision), flush=True)
    if not card_cpu <= card_cpu_tol:
        fail(f"StyleTTS2 float32: card vs CPU {card_cpu} > {card_cpu_tol}")
    if not (rel_rms < 0.2 and corr > 0.98 and style_corr > 0.98):
        fail(f"StyleTTS2 bf16 vs float32: relative RMS {rel_rms}, correlation {corr}, "
             f"style correlation {style_corr}")
    del f32, cpu, model

    # the multilingual PL-BERT variant
    plbert_model, config, tp, _ = st2.load_styletts2_model(with_plbert)
    if plbert_model.plbert_geometry["num_layers"] != 12:
        fail(f"PL-BERT geometry {plbert_model.plbert_geometry}")
    st2.synthesize_text(plbert_model, config, tp, TEXTS[0])
    rows += serve_st2(plbert_model, config, tp, card, "PL-BERT", REQUESTS[1:])
    split = split_st2_request(plbert_model, config, tp, REQUESTS[2])
    split["card"] = card
    print("styletts2 split " + json.dumps(split), flush=True)
    del plbert_model

    # the command line, with no device given
    env = os.environ.pop("EVERYVOICE_DEVICE", None)
    err = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["synthesize", "text-to-wav", str(plain), "-t", TEXTS[0],
                           "-r", str(reference), "-o", str(work / "cli")])
        cli_s = time.perf_counter() - t0
    finally:
        if env is not None:
            os.environ["EVERYVOICE_DEVICE"] = env
    devices = [line for line in err.getvalue().splitlines() if line.startswith("device: ")]
    written = list((work / "cli" / "wav").glob("*--default--default.wav"))
    if rc != 0 or devices != ["device: cuda"] or len(written) != 1:
        fail(f"synthesize text-to-wav: exit {rc}, {devices}, {written}\n{err.getvalue()[-2000:]}")
    row = {"phase_s": time.perf_counter() - t_phase, "checkpoint_write_s": write_s,
           "cli_s": cli_s, "card": card}
    print("styletts2 " + json.dumps(row), flush=True)
    return {"requests": rows, "precision": precision, "split": split, "row": row}


ST2_UTTERANCES = 8     # 7 for training (3 steps of 2 an epoch), 1 for validation
# The trainers log every epoch's last step (the CLI's interval, 10 steps, is
# longer than an epoch here), so each epoch's losses are checked.
ST2_LOG_EVERY = 3
ST2_EPOCHS = 2         # each stage; the TMA (stage 1) and the diffusion (stage 2) from epoch 1
ST2_RESUME_STEPS = 2
ST2_F32_SEGMENT = 64   # decoder frames of the float32 card-vs-CPU step (320 in training)
ST2_GEN_KEYS = {"disc/total"} | {f"gen/{k}" for k in ("s2s", "mono", "mel", "ce", "dur", "f0",
                                                       "norm", "gen", "fm", "total")}


def check_multi_transform(opt: dict, tree: dict, step: int) -> bool:
    """Whether ``opt`` is ``optax.multi_transform``'s state over ``tree``
    (adamws of the ``base``, ``bert`` and ``ft`` groups), each group's
    count ``step`` and its moments in the tree's shapes on its own modules
    (PL-BERT ``bert``, the ASR aligner ``ft``), ``{}`` on the others'."""
    groups = {"plbert_encoder": "bert", "text_aligner": "ft"}
    inner = opt.get("inner_states", {})
    if sorted(inner) != ["base", "bert", "ft"]:
        return False
    for group, state in inner.items():
        adam = state["inner_state"]["0"]
        if sorted(state["inner_state"]) != ["0", "1", "2"] or int(adam["count"]) != step:
            return False
        for moment in ("mu", "nu"):
            for module, sub in tree["params"].items():
                mine = groups.get(module, "base") == group
                got = adam[moment]["params"].get(module)  # a masked leaf is {}: no shape
                if got is None or flat_shapes(got) != (flat_shapes(sub) if mine else {}):
                    return False
    return True


def check_st2_run(trainer, stage_ckpt: str, expect_keys: set, components=None,
                  later_keys: set = frozenset()) -> list:
    """A StyleTTS2 stage's run: metrics (finite losses, every key, one
    validation an epoch; ``later_keys``, the out-of-domain SLM terms, in the
    last record and not the first), hparams, events, and its checkpoints
    (the stage tag, the pretrained components' geometries, both optimizer
    states in the optax layout with the step's count: ``multi_transform``'s
    for the generator with PL-BERT or the ASR aligner). ``expect_keys`` are
    the training record's keys past ``training/``. Returns the training
    records."""
    import numpy as np

    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    components = components or {"plbert": None, "asr": None}
    run = trainer.run_dir
    for name in ("metrics.jsonl", "hparams.yaml"):
        if not (run / name).is_file():
            fail(f"the StyleTTS2 run wrote no {name}")
    if not list(run.glob("events.out.tfevents.*")):
        fail("the StyleTTS2 run wrote no event file")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "training/gen/total" in r]
    val = [r for r in records if "validation/total" in r]
    keys = {f"training/{k}" for k in expect_keys}
    later = {f"training/{k}" for k in later_keys}

    def logged(r):
        return set(k for k in r if k.startswith("training/"))

    if (not train or any(logged(r) - later != keys for r in train)
            or (later and (logged(train[-1]) & later != later or logged(train[0]) & later))):
        fail(f"StyleTTS2 training records lack keys: {[sorted(r) for r in train]}")
    if not all(np.isfinite(v) for r in records for k, v in r.items() if "/" in k):
        fail(f"StyleTTS2 losses are not finite: {records}")
    if len(val) != ST2_EPOCHS:
        fail(f"{len(val)} validations in {ST2_EPOCHS} epochs")
    paths = [trainer.ckpt_dir / stage_ckpt, *trainer.ckpt_dir.glob("epoch=*-step=*-loss=*.ckpt")]
    if len(paths) != 2 or not paths[0].is_file():
        fail(f"StyleTTS2 checkpoints: {sorted(p.name for p in trainer.ckpt_dir.iterdir())}")
    for path in paths:
        ckpt = load_checkpoint(path)
        opt = ckpt["optimizer_states"]
        if (ckpt.get("stage") != trainer.mode
                or ckpt.get("pretrained_components") != components
                or sorted(ckpt["state_dict"]) != ["discriminators", "generator"]
                or sorted(opt) != ["disc", "gen"]):
            fail(f"{path.name}: header or trees not the JAX package's")
        for net in ("gen", "disc"):
            tree = ckpt["state_dict"]["generator" if net == "gen" else "discriminators"]
            if net == "gen" and (components["plbert"] or components["asr"]):
                if not check_multi_transform(opt[net], tree, ckpt["global_step"]):
                    fail(f"{path.name}: the gen optimizer state is not optax.multi_transform's")
                continue
            adam = opt[net]["0"]
            if (sorted(opt[net]) != ["0", "1", "2"] or int(adam["count"]) != ckpt["global_step"]
                    or flat_shapes(adam["mu"]) != flat_shapes(tree)
                    or flat_shapes(adam["nu"]) != flat_shapes(tree)):
                fail(f"{path.name}: the {net} optimizer state is not optax.adamw's layout")
    return train


def split_st2_step(trainer, batch) -> dict:
    """CUDA-event times of one bf16 StyleTTS2 step on a training batch:
    the alignment targets, the discriminators' pass and update, the
    generator's pass (aligner, decode, losses, backward) and update, and,
    on the decoder's output shape, its iSTFT head alone; with the
    pretrained components, the generator pass's pieces alone too (``pieces
    _ms``): the ASR aligner's pass (its decoder loop) with the s2s loss's
    backward, WavLM's forward and backward on the decoded clip, and the
    out-of-domain decode with its backward; then the step traced by
    torch.profiler (launches, device busy time, wall) and its peak
    memory."""
    import torch

    from everyvoice_tpu_torch.models.styletts2.loss import asr_s2s_loss
    from everyvoice_tpu_torch.models.layers import lengths_to_mask
    from everyvoice_tpu_torch.utils.precision import no_tf32

    trainer.train_step(batch)  # warm
    draws = trainer.draw_step(batch)
    epoch = trainer.epoch
    tma, ood = trainer.tma_active(epoch), trainer.ood_active(epoch)
    _, diff_on, joint_on = trainer.phase_weights(epoch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    with no_tf32():
        events[0].record()
        targets = trainer.alignment_targets(batch, tma)
        targets["segment_starts"] = draws.segment_starts
        events[1].record()
        _, d_grads = trainer.discriminator_grads(batch, targets, draws, joint_on, ood)
        trainer.disc_opt.step(trainer.disc_params, d_grads, trainer.disc_opt_state)
        events[2].record()
        _, g_grads = trainer.generator_grads(batch, targets, draws, diff_on, tma, joint_on, ood)
        events[3].record()
        trainer.gen_opt.step(trainer.gen_params, g_grads, trainer.gen_opt_state)
        events[4].record()
        seg = trainer.model.segment_frames
        x = torch.randn(2, trainer.model.decoder.conv_post.weight.shape[1], seg * 64,
                        device=trainer.device, dtype=trainer.model.decoder.dtype)
        events[5].record()
        with torch.no_grad():
            trainer.model.decoder.head(x, seg * trainer.model.hop)
        events[6].record()
    pieces = {}

    def piece(name, fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with no_tf32():
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        pieces[name] = start.elapsed_time(end)

    if trainer.asr_geometry is not None:
        def asr_pass():
            _, _, aux = trainer.model.align_text_mel(
                batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"],
                asr_draws=(draws.asr_unk, draws.asr_keep))
            mask = lengths_to_mask(batch["text_lengths"], batch["text"].shape[1])
            asr_s2s_loss(aux["s2s_logits"], batch["text"], mask).backward()
        piece("asr_aligner_fwd_bwd_ms", asr_pass)
    if trainer.wavlm is not None:
        wav = draws.gen_noise.mul(0.1).requires_grad_(True)
        piece("wavlm_fwd_bwd_ms", lambda: trainer.slm_features(wav).square().mean().backward())
    if trainer.ood_bank is not None:
        piece("ood_decode_fwd_bwd_ms", lambda: trainer.synthesize_ood(
            batch, draws.ood_index_gen, draws.ood_noise_gen).square().mean().backward())
    trainer.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    traced = trace(lambda: trainer.train_step(batch))
    parts = ("alignment_targets_ms", "disc_pass_and_update_ms", "gen_pass_ms", "gen_update_ms")
    out = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(parts)}
    out["pieces_ms"] = pieces
    out.update({"istft_head_ms": events[5].elapsed_time(events[6]),"kernels_per_step": traced["kernels"], "traced_step_ms": traced["wall_ms"],
                "traced_busy_ms": traced["busy_ms"],
                "idle_share": (None if traced["busy_ms"] is None
                               else 1.0 - traced["busy_ms"] / traced["wall_ms"]),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out


def st2_float32_card_vs_cpu(config: dict, ckpt_path: Path, run_root: Path,
                            what: str = "styletts2 train", seed: int | None = None) -> dict:
    """One float32 stage-2 step (TMA and diffusion on, dropout off) from the
    stage-2 checkpoint's parameters (or, given ``seed``, from the trainer's
    seeded initial parameters with the staged components grafted), on one
    batch of 2 rows, on the card and on the CPU, with the same draws (made
    on the CPU) and decoder clips of
    ``ST2_F32_SEGMENT`` frames so that the CPU's side is short: every loss
    and both gradient norms within 1e-3 relative. A step searches two
    Viterbi paths (the targets' and the binarization loss's); the CPU takes
    the card's where ``path_tie`` shows it to be a tie on the CPU, as
    phase 7's check does."""
    import torch

    from everyvoice_tpu_torch.config import styletts2_config
    from everyvoice_tpu_torch.dataloader import StyleTTS2Dataset
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.fs2 import alignment
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    config = styletts2_config({**config, "training": {
        **config["training"], "decoder_segment_frames": ST2_F32_SEGMENT}})
    ckpt = load_checkpoint(ckpt_path)
    lang2id = ckpt["hyper_parameters"]["lang2id"]
    rows = generic_psv_filelist_reader(config["training"]["training_filelist"])
    ds = StyleTTS2Dataset(rows, config)
    host = next(ds.batches(2, shuffle=False))
    host.pop("basenames")
    viterbi = alignment.viterbi_alignment
    paths: dict = {"cuda": [], "cpu": []}  # per device: (log-probabilities, path) of each search

    def shared_viterbi(device: str):
        def search(attn_logprob, src_lengths, mel_lengths):
            hard = viterbi(attn_logprob, src_lengths, mel_lengths)
            logp = alignment._masked_log_softmax(attn_logprob.detach().float(), src_lengths)
            paths[device].append((logp.cpu().double(), hard.cpu().double()))
            if device == "cuda":
                return hard
            return paths["cuda"][len(paths["cpu"]) - 1][1].float().to(hard.device)
        return search

    result, draws = {}, None
    for device in ("cuda", "cpu"):
        trainer = StyleTTS2Trainer(config, ds, ds, lang2id, run_dir=run_root / f"st2-f32-{device}",
                                   mode="second", compute_dtype="float32", device=device)
        for module in trainer.model.modules():
            if isinstance(module, Dropout):
                module.p = 0.0
        if seed is None:
            trainer.load_params(ckpt["state_dict"])
        else:
            trainer.init_params(seed)
        trainer.gen_opt_state = trainer.gen_opt.init(trainer.gen_params)
        trainer.disc_opt_state = trainer.disc_opt.init(trainer.disc_params)
        batch = to_device(host, trainer.device)
        if draws is None:
            draws = trainer.draw_step(to_device(host, torch.device("cpu")),
                                      torch.Generator().manual_seed(5))
        alignment.viterbi_alignment = shared_viterbi(device)
        try:
            losses = trainer.train_step(batch, draws.to(trainer.device), epoch=1)
        finally:
            alignment.viterbi_alignment = viterbi
        result[device] = {**{k: v.item() for k, v in losses.items()},
                          "grad_norm": trainer.grad_norm.item(),
                          "disc_grad_norm": trainer.disc_grad_norm.item()}
    ties = [path_tie(*card, *cpu) for card, cpu in zip(paths["cuda"], paths["cpu"])]
    diffs = {k: abs(result["cuda"][k] - v) / max(abs(v), 1e-12) for k, v in result["cpu"].items()}
    row = {"rows": 2, "segment_frames": ST2_F32_SEGMENT, "card": result["cuda"],
           "cpu": result["cpu"], "alignments": ties, "max_rel_diff": max(diffs.values())}
    print(f"{what} float32 card vs cpu " + json.dumps(row), flush=True)
    if len(ties) != 2:
        fail(f"the stage-2 step searched {len(ties)} Viterbi paths, not 2")
    for tie in ties:
        if tie["score_gap"] > tie["tie_bound"]:
            fail(f"the card's alignment path is not a tie of the CPU's: {tie}")
    if row["max_rel_diff"] > 1e-3:
        fail(f"the card's float32 StyleTTS2 step disagrees with the CPU's: {diffs}")
    return row


def st2_training_phase(root: Path, card: str) -> dict:
    """StyleTTS2 training at full width (phase 12), every step through
    ``cli.main`` from another working directory: ``preprocess
    text-to-wav`` of a seeded corpus (the ood step included; every feature
    batch's log-mel held to the plain version), ``train text-to-wav --mode
    first`` then ``--mode second`` (which picks up stage 1's checkpoint),
    two steps resumed from ``stage-2-last.ckpt``; each run checked; a
    float32 step on the card against the CPU's; a step split; and the
    trained stage-2 checkpoint served through ``synthesize text-to-wav``
    with no device given, then the 1-text request. Cut to make room for
    phase 17: ``ST2_UTTERANCES`` 8, not 24 (3 steps an epoch, not 10; one
    validation utterance, not 3; the trainers log every ``ST2_LOG_EVERY``
    steps, an epoch's end, where the CLI logs every 10), and no 16-text
    request from the trained checkpoint; every check is kept."""
    import contextlib
    import io

    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.config_files import load_config_from_path
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.styletts2 import synthesize as st2
    from everyvoice_tpu_torch.models.styletts2 import train as st2_train
    from everyvoice_tpu_torch.onchip import REQUESTS, TEXTS, write_styletts2_project
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.train import loop as train_loop
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    work = root / "st2-train"
    cfg_path = write_styletts2_project(work, ST2_UTTERANCES, seed=14, epochs_1st=ST2_EPOCHS,
                                       epochs_2nd=ST2_EPOCHS,
                                       losses={"tma_epoch": 1, "diff_epoch": 1})
    walls: dict = {}

    def run(name: str, *args) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([str(a) for a in args])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            fail(f"{name}: exit code {rc}")

    trainers, step_s, loaded, first_weights = [], [], [], {}
    Trainer = st2_train.StyleTTS2Trainer
    plain = {"fit": Trainer.fit, "train_step": Trainer.train_step,
             "load_checkpoint": st2_train.load_checkpoint, "preprocess": Preprocessor.preprocess}
    # stage 2's pickup of stage 1 and TrainerBase's finetune_checkpoint load
    preprocessors = []

    def recording_fit(self, *args, **kwargs):
        trainers.append(self)
        return plain["fit"](self, *args, **{**kwargs, "log_every": ST2_LOG_EVERY})

    def timed_step(self, *args, **kwargs):
        if self not in first_weights:  # the weights the run starts from
            first_weights[self] = self.model.text_encoder.embed.weight.detach().cpu().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain["train_step"](self, *args, **kwargs)
        torch.cuda.synchronize()
        step_s.append((self.mode, time.perf_counter() - t0))
        return out

    def recording_load(path):
        loaded.append(Path(path))
        return plain["load_checkpoint"](path)

    def recording_preprocess(self, *args, **kwargs):
        preprocessors.append(self)
        return plain["preprocess"](self, *args, **kwargs)

    cwd = Path.cwd()
    (work / "elsewhere").mkdir()
    os.chdir(work / "elsewhere")
    Trainer.fit, Trainer.train_step = recording_fit, timed_step
    st2_train.load_checkpoint = train_loop.load_checkpoint = recording_load
    Preprocessor.preprocess = recording_preprocess
    log_mel.launches = 0
    log_mel.fft_launches = 0
    mrf_stage.launches = 0
    try:
        run("preprocess text-to-wav", "preprocess", "text-to-wav", cfg_path)
        mel_launches, fft_launches = log_mel.launches, log_mel.fft_launches
        run("train text-to-wav --mode first", "train", "text-to-wav", cfg_path, "--mode", "first")
        run("train text-to-wav --mode second", "train", "text-to-wav", cfg_path,
            "--mode", "second")
        stage1, stage2 = trainers
        resumed_from = stage2.ckpt_dir / "stage-2-last.ckpt"
        run("resume", "train", "text-to-wav", cfg_path, "--mode", "second",
            "-c", f"training.finetune_checkpoint={resumed_from}",
            "-c", f"training.epochs_2nd={ST2_EPOCHS + 1}",
            "-c", f"training.max_steps={stage2.global_step + ST2_RESUME_STEPS}")
    finally:
        Trainer.fit, Trainer.train_step = plain["fit"], plain["train_step"]
        st2_train.load_checkpoint = train_loop.load_checkpoint = plain["load_checkpoint"]
        Preprocessor.preprocess = plain["preprocess"]
        os.chdir(cwd)
    st2_mrf_launches = mrf_stage.launches
    resumed = trainers[2]

    # preprocessing: the ood step and every feature batch's log-mel
    pre = preprocessors[0]
    ood = pre.save_dir / "ood" / "default.psv"
    if not ood.is_file() or len(ood.read_text().splitlines()) < 2:
        fail(f"preprocess text-to-wav wrote no OOD text at {ood}")
    if mel_launches == 0 or fft_launches != len(pre.last_batch_shapes):
        fail(f"preprocess text-to-wav: {mel_launches} log_mel launches, {fft_launches} FFT "
             f"launches, {len(pre.last_batch_shapes)} feature batches")
    served_mel, _ = check_served_features(pre)

    # the runs
    if (stage1.mode, stage2.mode, resumed.mode) != ("first", "second", "second"):
        fail("the three runs were not stage 1, stage 2 and its resume")
    if any(t.compute_dtype != "bfloat16" or t.device.type != "cuda" for t in trainers):
        fail(f"StyleTTS2 trained in {[(t.compute_dtype, str(t.device)) for t in trainers]}")
    records1 = check_st2_run(stage1, "stage-1-last.ckpt", ST2_GEN_KEYS)
    records2 = check_st2_run(stage2, "stage-2-last.ckpt", ST2_GEN_KEYS | {"gen/diff", "gen/sty"})
    if records1[0]["training/gen/s2s"] != 0.0 or records1[-1]["training/gen/s2s"] == 0.0:
        fail(f"stage 1's TMA did not come in at epoch 1: {records1}")
    stage1_ckpt = stage1.ckpt_dir / "stage-1-last.ckpt"
    if loaded[:1] != [stage1_ckpt]:
        fail(f"stage 2 loaded {loaded}, not {stage1_ckpt}")
    embed = load_checkpoint(stage1_ckpt)["state_dict"]["generator"]["params"]["text_encoder"][
        "Embed_0"]["embedding"]
    if not torch.equal(first_weights[stage2], torch.from_numpy(embed)):
        fail("stage 2 did not start from stage 1's weights")
    if loaded[1:] != [resumed_from] or resumed.global_step != stage2.global_step + ST2_RESUME_STEPS:
        fail(f"the resume loaded {loaded[1:]} and ended at step {resumed.global_step}")
    final = load_checkpoint(resumed.ckpt_dir / "stage-2-last.ckpt")
    if int(final["optimizer_states"]["gen"]["0"]["count"]) != resumed.global_step:
        fail("the resumed run's optimizer count does not continue the checkpoint's")

    # float32 card vs CPU, a step split, and the trained checkpoint served
    config = load_config_from_path("text-to-wav", cfg_path)
    t0 = time.perf_counter()
    f32 = st2_float32_card_vs_cpu(config, stage2.ckpt_dir / "stage-2-last.ckpt", work)
    walls["float32 card vs cpu"] = time.perf_counter() - t0
    batch = next(stage2.dataset.batches(2, shuffle=True, seed=0, drop_last=True))
    batch.pop("basenames")
    t0 = time.perf_counter()
    split = split_st2_step(stage2, to_device(batch, stage2.device))
    walls["split"] = time.perf_counter() - t0
    split["card"] = card
    print("styletts2 train split " + json.dumps(split), flush=True)

    ckpt = stage2.ckpt_dir / "stage-2-last.ckpt"
    env = os.environ.pop("EVERYVOICE_DEVICE", None)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(["synthesize", "text-to-wav", str(ckpt), "-t", TEXTS[0],
                           "-o", str(work / "served")])
    finally:
        if env is not None:
            os.environ["EVERYVOICE_DEVICE"] = env
    devices = [line for line in err.getvalue().splitlines() if line.startswith("device: ")]
    if rc != 0 or devices != ["device: cuda"] or len(list((work / "served" / "wav").glob("*.wav"))) != 1:
        fail(f"synthesize text-to-wav from the trained checkpoint: exit {rc}, {devices}\n"
             f"{err.getvalue()[-2000:]}")
    t0 = time.perf_counter()
    model, st2_config, tp, _ = st2.load_styletts2_model(ckpt)
    served = serve_st2(model, st2_config, tp, card, "trained", (REQUESTS[0],))
    del model
    walls["load and serve a request"] = time.perf_counter() - t0

    steps = {mode: sorted(s for m, s in step_s[:] if m == mode) for mode in ("first", "second")}
    row = {"utterances": ST2_UTTERANCES, "walls_s": walls,
           "steps": {"first": stage1.global_step, "second": stage2.global_step,
                     "resumed": resumed.global_step},
           "median_step_ms": {m: 1e3 * s[len(s) // 2] for m, s in steps.items() if s},
           "gen_total": {"first": [records1[0]["training/gen/total"],
                                   records1[-1]["training/gen/total"]],
                         "second": [records2[0]["training/gen/total"],
                                    records2[-1]["training/gen/total"]]},
           "log_mel_launches": mel_launches, "fft_launches": fft_launches,
           "mrf_launches": st2_mrf_launches, "phase_s": time.perf_counter() - t_phase,
           "card": card}
    print("styletts2 train " + json.dumps(row), flush=True)
    return {"mel_launches": mel_launches, "fft_launches": fft_launches,
            "mrf_launches": st2_mrf_launches, "served_mel": served_mel, "f32": f32,
            "split": split, "served": served, "row": row, "config": cfg_path}


ST2P_SEED = 13         # the seeded pretrained components' generator
ST2P_LATER_KEYS = {"gen/slm_ood", "disc/slm_ood"}  # from joint_epoch (1) on
# bf16 WavLM features against float32 on the same wavs: relative RMS of
# the stacked hidden states. Two full-width runs on an H100 read 0.01098;
# the bound is about three times that.
SLM_BF16_REL_RMS = 0.03


def st2_pretrained_phase(root: Path, card: str) -> dict:
    """StyleTTS2 training with its pretrained components at full width
    (phase 13): seeded components in their published formats and
    geometries (``onchip.write_pretrained_components``: the JDC, the ASR
    aligner, the multilingual PL-BERT, WavLM base plus) and an 8-utterance
    project with out-of-domain text (cut from 24 utterances to make room
    for phase 17: 3 steps an epoch, not 10, logged every 3; every check is
    kept), then
    through ``cli.main`` from another working directory, every train verb given the ``-c`` overrides
    that point at the components: ``preprocess text-to-wav`` (the ood step
    included; every feature batch's log-mel held to the plain version),
    ``train text-to-wav --mode first`` then ``--mode second`` (2 epochs
    each: the ASR aligner's targets from epoch 0, its s2s loss from the TMA
    epoch 1 of stage 1; the diffusion and the out-of-domain SLM terms from
    epoch 1 of stage 2), a 2-step resume. Checked: the grafted weights are
    the files'; the JDC's F0 targets are finite and not the
    preprocessor's; the regime-2 losses are finite; WavLM (both copies)
    and the JDC are bit-unchanged, and stage 2's first Adam step moved
    PL-BERT, the aligner and the rest by their own learning rates; the
    checkpoints' geometries and ``multi_transform`` states; a float32
    stage-2 step on the card against the CPU's; bf16 WavLM features against
    float32; a step split and traced; the trained checkpoint served."""
    import contextlib
    import io

    import numpy as np
    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.config import PRETRAINED_SYMBOL_TABLE
    from everyvoice_tpu_torch.config_files import load_config_from_path
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.dsp.resample import resample
    from everyvoice_tpu_torch.models.styletts2 import synthesize as st2
    from everyvoice_tpu_torch.models.styletts2 import train as st2_train
    from everyvoice_tpu_torch.models.styletts2.slm import (
        load_wavlm_params,
        stack_hidden_states,
        wavlm_from_flax,
    )
    from everyvoice_tpu_torch.onchip import REQUESTS, TEXTS, write_styletts2_pretrained_project
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    work = root / "st2-pretrained"
    walls: dict = {}
    t0 = time.perf_counter()
    cfg_path, overrides, paths = write_styletts2_pretrained_project(
        work, ST2_UTTERANCES, torch.Generator().manual_seed(ST2P_SEED), seed=15,
        epochs_1st=ST2_EPOCHS, epochs_2nd=ST2_EPOCHS,
        losses={"tma_epoch": 1, "diff_epoch": 1, "joint_epoch": 1})
    walls["write components and project"] = time.perf_counter() - t0
    staged = [x for o in overrides for x in ("-c", o)]

    def run(name: str, *args) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([str(a) for a in args])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            fail(f"{name}: exit code {rc}")

    trainers, step_s, preprocessors = [], [], []
    first: dict = {}  # per trainer: what its first step started from, and moved
    Trainer = st2_train.StyleTTS2Trainer
    plain = {"fit": Trainer.fit, "train_step": Trainer.train_step,
             "preprocess": Preprocessor.preprocess}

    def recording_fit(self, *args, **kwargs):
        trainers.append(self)
        return plain["fit"](self, *args, **{**kwargs, "log_every": ST2_LOG_EVERY})

    def timed_step(self, *args, **kwargs):
        record = self not in first
        if record:
            m = self.model
            symbols = self.dataset.text_processor.symbols
            first[self] = {
                "plbert_row": m.plbert_encoder.word_embeddings.detach()[symbols.index("a")]
                .cpu().clone(),
                "asr_conv": m.text_aligner.init_cnn.weight.detach().cpu().clone(),
                "jdc": {n: p.detach().clone() for n, p in self.jdc.state_dict().items()},
                "wavlm": None if self.wavlm is None else {
                    n: p.detach().clone() for n, p in self.wavlm.state_dict().items()},
                "before": {n: p.detach().clone() for n, p in self.gen_params.items()},
            }
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain["train_step"](self, *args, **kwargs)
        torch.cuda.synchronize()
        step_s.append((self.mode, time.perf_counter() - t0))
        if record:
            before = first[self].pop("before")
            moved = {}
            for n, p in self.gen_params.items():
                group = self.gen_opt.group_of(n)
                delta = (p.detach() - before[n]).abs().max().item()
                moved[group] = max(moved.get(group, 0.0), delta)
            first[self]["moved"] = moved
        return out

    def recording_preprocess(self, *args, **kwargs):
        preprocessors.append(self)
        return plain["preprocess"](self, *args, **kwargs)

    cwd = Path.cwd()
    (work / "elsewhere").mkdir()
    os.chdir(work / "elsewhere")
    Trainer.fit, Trainer.train_step = recording_fit, timed_step
    Preprocessor.preprocess = recording_preprocess
    log_mel.launches = 0
    log_mel.fft_launches = 0
    mrf_stage.launches = 0
    try:
        run("preprocess text-to-wav", "preprocess", "text-to-wav", cfg_path)
        mel_launches, fft_launches = log_mel.launches, log_mel.fft_launches
        run("train text-to-wav --mode first", "train", "text-to-wav", cfg_path, "--mode",
            "first", *staged)
        run("train text-to-wav --mode second", "train", "text-to-wav", cfg_path, "--mode",
            "second", *staged)
        stage1, stage2 = trainers
        resumed_from = stage2.ckpt_dir / "stage-2-last.ckpt"
        run("resume", "train", "text-to-wav", cfg_path, "--mode", "second", *staged,
            "-c", f"training.finetune_checkpoint={resumed_from}",
            "-c", f"training.epochs_2nd={ST2_EPOCHS + 1}",
            "-c", f"training.max_steps={stage2.global_step + ST2_RESUME_STEPS}")
    finally:
        Trainer.fit, Trainer.train_step = plain["fit"], plain["train_step"]
        Preprocessor.preprocess = plain["preprocess"]
        os.chdir(cwd)
    mrf_launches = mrf_stage.launches
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    resumed = trainers[2]

    pre = preprocessors[0]
    if mel_launches == 0 or fft_launches != len(pre.last_batch_shapes):
        fail(f"preprocess text-to-wav: {mel_launches} log_mel launches, {fft_launches} FFT "
             f"launches, {len(pre.last_batch_shapes)} feature batches")
    served_mel, _ = check_served_features(pre)

    # the runs, their components and their checkpoints
    if (stage1.mode, stage2.mode, resumed.mode) != ("first", "second", "second"):
        fail("the three runs were not stage 1, stage 2 and its resume")
    if any(t.compute_dtype != "bfloat16" or t.device.type != "cuda" for t in trainers):
        fail(f"StyleTTS2 trained in {[(t.compute_dtype, str(t.device)) for t in trainers]}")
    if (stage1.wavlm is not None or stage2.wavlm is None or stage2.ood_bank is None
            or any(t.jdc is None or t.plbert_geometry is None or t.asr_geometry is None
                   for t in trainers)):
        fail("the stages did not load the components the config stages")
    components = {"plbert": stage1.plbert_geometry, "asr": stage1.asr_geometry}
    if components["plbert"]["hidden_size"] != 768 or components["asr"]["hidden_dim"] != 256:
        fail(f"the components are not at their published geometry: {components}")
    records1 = check_st2_run(stage1, "stage-1-last.ckpt", ST2_GEN_KEYS, components)
    records2 = check_st2_run(
        stage2, "stage-2-last.ckpt",
        ST2_GEN_KEYS | {"gen/diff", "gen/sty", "gen/slm", "disc/slm"}, components,
        later_keys=ST2P_LATER_KEYS)
    if records1[0]["training/gen/s2s"] != 0.0 or records1[-1]["training/gen/s2s"] == 0.0:
        fail(f"stage 1's s2s loss did not come in at epoch 1: {records1}")
    final = load_checkpoint(resumed.ckpt_dir / "stage-2-last.ckpt")
    if not check_multi_transform(final["optimizer_states"]["gen"],
                                 final["state_dict"]["generator"], resumed.global_step):
        fail("the resumed run's optimizer counts do not continue the checkpoint's")

    # grafted weights, frozen networks and the first step's rates
    files = {"plbert": torch.load(paths["plbert"], weights_only=False)["net"],
             "asr": torch.load(paths["asr"], weights_only=False)["model"],
             "jdc": torch.load(paths["f0"], weights_only=False)["net"]}
    start = first[stage1]
    grafted = {
        "plbert": torch.equal(start["plbert_row"], files["plbert"][
            "module.encoder.embeddings.word_embeddings.weight"][PRETRAINED_SYMBOL_TABLE.index("a")]),
        "asr": torch.equal(start["asr_conv"], files["asr"]["init_cnn.conv.weight"]),
        "jdc": torch.equal(start["jdc"]["stem_conv1.weight"].cpu(),
                           files["jdc"]["conv_block.0.weight"])}
    if not all(grafted.values()):
        fail(f"stage 1 did not start from the staged weights (equal: {grafted})")
    for trainer in trainers[:2]:
        if any(not torch.equal(p, first[trainer]["jdc"][n])
               for n, p in trainer.jdc.state_dict().items()):
            fail(f"stage {trainer.mode}'s JDC changed in training")
    saved = first[stage2]["wavlm"]
    if any(not torch.equal(p, saved[n]) for n, p in stage2.wavlm.state_dict().items()):
        fail("WavLM changed in training")
    opt = stage2.training_config["optimizer"]
    rates = {"base": opt["lr"], "bert": opt["bert_lr"], "ft": opt["ft_lr"]}
    moved = first[stage2]["moved"]
    ratios = {g: moved[g] / rates[g] for g in rates}
    if any(not 0.9 <= r <= 1.1 for r in ratios.values()):
        fail(f"stage 2's first Adam step moved the groups by {moved}, not their rates {rates}")

    # the JDC's F0 targets, bf16 WavLM features, float32 card vs CPU, the split
    batch = next(stage2.dataset.batches(2, shuffle=True, seed=0, drop_last=True))
    batch.pop("basenames")
    batch = to_device(batch, stage2.device)
    with torch.no_grad():
        f0 = stage2.target_f0_frames(batch)
        frames = torch.arange(f0.shape[1], device=f0.device) < batch["mel_lengths"][:, None]
        f0_gap = (f0 - batch["f0_frames"])[frames].abs().max().item()
        audio = batch["audio"][:, : ST2_F32_SEGMENT * stage2.model.hop * 5]
        a = stage2.config["preprocessing"]["audio"]
        wav16 = resample(audio, a["output_sampling_rate"], stage2.config["model"]["slm"]["sr"])
        wavlm32 = wavlm_from_flax(*load_wavlm_params(paths["wavlm"])).to(stage2.device)
        feats32 = stack_hidden_states(wavlm32(wav16))
        del wavlm32
        feats16 = stage2.slm_features(audio)
        rel_rms = ((feats16 - feats32).norm() / feats32.norm()).item()
    if not bool(torch.isfinite(f0).all()) or f0_gap < 1.0:
        fail(f"the JDC's F0 targets are not finite or equal the preprocessor's (gap {f0_gap})")
    if not rel_rms < SLM_BF16_REL_RMS:
        fail(f"bf16 WavLM features: relative RMS {rel_rms} against float32")
    config = load_config_from_path("text-to-wav", cfg_path, overrides)
    t0 = time.perf_counter()
    # From seeded parameters: a trained state's conditioning varies from run
    # to run, and with it the float32 gap (PERF.md, PR 10).
    f32 = st2_float32_card_vs_cpu(config, stage2.ckpt_dir / "stage-2-last.ckpt", work,
                                  "styletts2 pretrained", seed=ST2P_SEED)
    walls["float32 card vs cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = split_st2_step(stage2, batch)
    walls["split"] = time.perf_counter() - t0
    split["card"] = card
    print("styletts2 pretrained split " + json.dumps(split), flush=True)

    ckpt = stage2.ckpt_dir / "stage-2-last.ckpt"
    env = os.environ.pop("EVERYVOICE_DEVICE", None)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(["synthesize", "text-to-wav", str(ckpt), "-t", TEXTS[0],
                           "-o", str(work / "served")])
    finally:
        if env is not None:
            os.environ["EVERYVOICE_DEVICE"] = env
    if rc != 0 or len(list((work / "served" / "wav").glob("*.wav"))) != 1:
        fail(f"synthesize text-to-wav from the regime-2 checkpoint: exit {rc}\n"
             f"{err.getvalue()[-2000:]}")
    model, st2_config, tp, _ = st2.load_styletts2_model(ckpt)
    if model.asr_geometry != components["asr"] or model.plbert_geometry != components["plbert"]:
        fail("serving did not rebuild the checkpoint's components")
    served = serve_st2(model, st2_config, tp, card, "regime 2", (REQUESTS[0],))
    del model

    steps = {mode: sorted(s for m, s in step_s if m == mode) for mode in ("first", "second")}
    row = {"utterances": ST2_UTTERANCES, "walls_s": walls,
           "steps": {"first": stage1.global_step, "second": stage2.global_step,
                     "resumed": resumed.global_step},
           "median_step_ms": {m: 1e3 * s[len(s) // 2] for m, s in steps.items() if s},
           "first_adam_step_over_lr": ratios, "jdc_f0_gap_hz": f0_gap,
           "slm_bf16_rel_rms": rel_rms,
           "losses": {k: records2[-1][f"training/{k}"] for k in
                      ("gen/s2s", "gen/mono", "gen/slm", "gen/slm_ood", "disc/slm",
                       "disc/slm_ood")},
           "log_mel_launches": mel_launches, "fft_launches": fft_launches,
           "mrf_launches": mrf_launches, "training_peak_gib": train_peak_gib,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print("styletts2 pretrained " + json.dumps(row), flush=True)
    if not all(np.isfinite(v) for v in row["losses"].values()):
        fail(f"regime-2 losses are not finite: {row['losses']}")
    return {"mel_launches": mel_launches, "fft_launches": fft_launches,
            "mrf_launches": mrf_launches, "served_mel": served_mel, "f32": f32,
            "split": split, "served": served, "row": row}


ALIGN_SECONDS = 101.37  # 22,050 Hz stereo; at 16 kHz six 20 s windows, the last padded
ALIGN_LINES = 12
ALIGN_ATOL, ALIGN_RTOL = 5e-4, 5e-3  # the wav2vec2 golden's tolerance


def ctc_path_tie(spans_card, spans_cpu, lp_card, lp_cpu, targets) -> dict:
    """Where the card's and the CPU's CTC alignments part (each found on its
    own device's log-probabilities): the frames they part on, how far the
    card's path scores below the CPU's own under the CPU's log-probabilities
    (float64), and the most a tie allows: what the two devices'
    log-probabilities differ by on the cells where the paths part, plus a
    few float32 roundings of the path's score. A path's score is its labels'
    log-probabilities over their spans and the blank's elsewhere."""
    import numpy as np

    def emissions(spans):
        out = np.zeros(len(lp_cpu), np.int64)  # the blank
        for i, start, end in spans:
            out[start:end] = targets[i]
        return out

    frames = np.arange(len(lp_cpu))
    e_card, e_cpu = emissions(spans_card), emissions(spans_cpu)
    lp_card, lp_cpu = lp_card.astype(np.float64), lp_cpu.astype(np.float64)
    own = float(lp_cpu[frames, e_cpu].sum())
    gap = own - float(lp_cpu[frames, e_card].sum())
    parted = e_card != e_cpu
    delta = np.abs(lp_card - lp_cpu)
    bound = float(delta[frames, e_card][parted].sum() + delta[frames, e_cpu][parted].sum()) \
        + 8 * float(np.finfo(np.float32).eps) * abs(own)
    return {"frames_parted": int(parted.sum()), "score_gap": gap, "tie_bound": bound}


def aligner_phase(root: Path, card: str) -> dict:
    """Long-audio CTC segmentation at wav2vec2-base's geometry (phase 14): a
    seeded model directory in the HuggingFace layout, a seeded stereo
    recording of about 100 s at 22,050 Hz (six 20 s windows at 16 kHz, the
    last padded) and a 12-line transcript; ``segment align`` and ``segment
    extract`` through ``cli.main`` with no device given, which must land on
    the card; the TextGrid and the extracted wavs and filelist checked; the
    load time, the scoring wall, audio seconds per wall second and peak
    memory of the windowed scoring; the card's float32 log-probs against the
    CPU's and the spans they give (equal, or a proven tie); and one 20 s
    window of the stable-layer-norm variant at wav2vec2-large's geometry,
    card against CPU. Launches neither kernel."""
    import contextlib
    import io

    import numpy as np
    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.dsp import read_wav
    from everyvoice_tpu_torch.dsp.resample import resample
    from everyvoice_tpu_torch.models.aligner import segment
    from everyvoice_tpu_torch.models.aligner.wav2vec2 import (
        WAV2VEC2_LARGE,
        convert_torch_wav2vec2_state,
        load_wav2vec2_ctc,
        wav2vec2_from_flax,
        window_plan,
        windowed_log_probs,
    )
    from everyvoice_tpu_torch.onchip import (
        published_wav2vec2_state,
        write_long_recording,
        write_wav2vec2_ctc,
    )
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    t_phase = time.perf_counter()
    work = root / "aligner"
    gen = torch.Generator().manual_seed(14)
    t0 = time.perf_counter()
    model_dir = write_wav2vec2_ctc(work / "wav2vec2-base-960h", gen)
    wav, transcript = write_long_recording(work, ALIGN_LINES, ALIGN_SECONDS, seed=14)
    write_s = time.perf_counter() - t0
    audio, sr = read_wav(wav)
    lines = segment.read_transcript(transcript)
    duration = audio.shape[1] / sr
    if audio.shape[0] != 2 or len(lines) != ALIGN_LINES:
        fail(f"the recording has {audio.shape[0]} channels, the transcript {len(lines)} lines")
    kernel_counts = (mrf_stage.launches, log_mel.launches)

    # the verbs, from another working directory, with no device given
    env = os.environ.pop("EVERYVOICE_DEVICE", None)
    err = io.StringIO()
    grid, out_dir = work / "long.TextGrid", work / "segments"
    walls = {}
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            rc_align = cli.main(["segment", "align", str(wav), str(transcript), "-o", str(grid),
                                 "--acoustic-model", str(model_dir)])
            walls["segment align"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rc_extract = cli.main(["segment", "extract", str(wav), str(grid), "-o", str(out_dir)])
            walls["segment extract"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        if env is not None:
            os.environ["EVERYVOICE_DEVICE"] = env
    devices = [line for line in err.getvalue().splitlines() if line.startswith("device: ")]
    if rc_align != 0 or rc_extract != 0 or devices != ["device: cuda"] * 2:
        fail(f"segment align/extract: exit {rc_align}/{rc_extract}, {devices}\n"
             f"{err.getvalue()[-2000:]}")

    # the TextGrid: the transcript's lines, in order, in non-decreasing
    # intervals inside the recording
    parsed = segment.parse_textgrid(grid)
    if [text for text, _, _ in parsed] != lines:
        fail(f"the TextGrid's intervals {[t for t, _, _ in parsed]} are not the lines {lines}")
    bounds = [x for _, start, end in parsed for x in (start, end)]
    if bounds[0] < 0 or bounds[-1] > duration + 1e-6 or any(
            a > b for a, b in zip(bounds, bounds[1:])):
        fail(f"the TextGrid's intervals are not ordered inside {duration} s: {parsed}")
    # the extracted wavs and filelist
    rows = []
    for i, (text, start, end) in enumerate(parsed):
        clip, clip_sr = read_wav(out_dir / "wavs" / f"segment-{i:05d}.wav")
        if clip_sr != sr or clip.shape != (1, int(end * sr) - int(start * sr)):
            fail(f"segment {i}: {clip.shape} at {clip_sr} Hz for [{start}, {end}] s")
        rows.append(f"segment-{i:05d}|{text}")
    listed = (out_dir / "metadata.psv").read_text(encoding="utf8").splitlines()
    if listed != ["basename|characters"] + rows or len(list((out_dir / "wavs").iterdir())) != len(rows):
        fail(f"segment extract wrote {listed[:3]}... for {len(rows)} intervals")

    # the windowed scoring on the card, timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, vocab, do_normalize = load_wav2vec2_ctc(model_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mono = audio.mean(axis=0)
    audio_16k = resample(torch.from_numpy(mono).cuda(), sr, 16000).cpu().numpy()
    normalized = segment.normalize_utterance(audio_16k) if do_normalize else audio_16k
    win, starts = window_plan(model, len(audio_16k))
    windows = len(starts)
    if len(audio_16k) % model.total_stride == 0 or windows < 5 or starts[-1] + win == len(audio_16k):
        fail(f"{len(audio_16k)} samples at 16 kHz in {windows} windows: the last does not pad")
    windowed_log_probs(model, normalized[:win])  # warm-up: cuDNN and cuBLAS start-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lp_card = windowed_log_probs(model, normalized)
    score_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if lp_card.shape != (model.output_frames(len(audio_16k)), 32) or not np.isfinite(lp_card).all():
        fail(f"windowed log-probs of {lp_card.shape}, or not finite")
    del model

    # float32 on the card against the CPU, and the spans they give
    cpu_model, _, _ = load_wav2vec2_ctc(model_dir, device="cpu")
    lp_cpu = windowed_log_probs(cpu_model, normalized)
    del cpu_model
    excess = float((np.abs(lp_card - lp_cpu) - (ALIGN_ATOL + ALIGN_RTOL * np.abs(lp_cpu))).max())
    targets, _ = segment.line_targets(lines, vocab)
    spans_card = segment.ctc_forced_alignment(lp_card, targets)
    spans_cpu = segment.ctc_forced_alignment(lp_cpu, targets)
    tie = None
    if spans_card != spans_cpu:
        tie = ctc_path_tie(spans_card, spans_cpu, lp_card, lp_cpu, targets)
        print("aligner spans parted " + json.dumps(tie), flush=True)
        if not tie["score_gap"] <= tie["tie_bound"]:
            fail(f"the card's CTC path scores {tie['score_gap']} below the CPU's, more than a "
                 f"tie allows ({tie['tie_bound']})")

    # one window of the stable-layer-norm variant at wav2vec2-large's geometry
    geometry = dict(WAV2VEC2_LARGE)
    state = published_wav2vec2_state(torch.Generator().manual_seed(15), geometry)
    large = wav2vec2_from_flax(geometry, convert_torch_wav2vec2_state(
        state, geometry["num_layers"], geometry["feat_extract_norm"],
        geometry["do_stable_layer_norm"]))
    del state
    window = normalized[:win]
    large_cpu = windowed_log_probs(large, window)
    large = large.cuda()
    large_card = windowed_log_probs(large, window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    windowed_log_probs(large, window)
    large_window_s = time.perf_counter() - t0
    del large
    large_excess = float((np.abs(large_card - large_cpu)
                          - (ALIGN_ATOL + ALIGN_RTOL * np.abs(large_cpu))).max())
    if (mrf_stage.launches, log_mel.launches) != kernel_counts:
        fail("the aligner launched a kernel it does not use")

    row = {"audio_s": duration, "samples_16k": len(audio_16k), "windows": windows,
           "frames": len(lp_card), "lines": len(lines), "write_s": write_s, "walls_s": walls,
           "load_s": load_s, "score_s": score_s, "audio_s_per_s": duration / score_s,
           "peak_mib": peak_mib,
           "card_vs_cpu_max_abs": float(np.abs(lp_card - lp_cpu).max()),
           "card_vs_cpu_excess": excess, "spans_equal": spans_card == spans_cpu, "tie": tie,
           "large_window_s": large_window_s,
           "large_card_vs_cpu_max_abs": float(np.abs(large_card - large_cpu).max()),
           "large_card_vs_cpu_excess": large_excess,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print("aligner " + json.dumps(row), flush=True)
    if excess > 0 or large_excess > 0:
        fail(f"aligner float32 card vs CPU outside atol {ALIGN_ATOL}, rtol {ALIGN_RTOL}: "
             f"base {row['card_vs_cpu_max_abs']}, large {row['large_card_vs_cpu_max_abs']}")
    return row


DEMO_DENIED = "forbidden"


def wav_samples(blob: bytes):
    """The int16 samples of a RIFF wav's bytes."""
    import io
    import wave

    import numpy as np

    if blob[:4] != b"RIFF":
        fail("not a RIFF wav")
    with wave.open(io.BytesIO(blob)) as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2").astype(np.int64)


def answer_samples(body: dict):
    """The int16 samples of a demo answer's base64 wav."""
    import base64

    return wav_samples(base64.b64decode(body["wav_base64"]))


def http(url: str, payload: dict | None = None, timeout: float = 300) -> tuple:
    """(status, body) of a GET, or of a JSON POST of ``payload``; JSON
    bodies decoded."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, body, kind = resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        status, body, kind = e.code, e.read(), e.headers.get("Content-Type")
    return status, json.loads(body) if kind == "application/json" else body


def check_refusals(base: str, what: str) -> None:
    """An empty text, a denied word and a homograph of it: 400, with the
    JAX app's messages."""
    for text, error in ((" ", "Please enter some text to synthesize."),
                        (f"this is {DEMO_DENIED.title()} speech",
                         "Oops, that word is not allowed to be synthesized."),
                        ("ｆｏｒｂｉｄｄｅｎ", "Oops, that word is not allowed to be synthesized.")):
        status, body = http(base + "/api/synthesize", {"text": text})
        if status != 400 or body != {"error": error}:
            fail(f"{what}: {text!r} answered {status} {body}")


def fs2_demo_requests(app, base: str, frames: int, walls: dict | None = None) -> None:
    """The FastSpeech2 demo's requests, each answer checked: the page and
    ``/api/info``, the refusals, a warm-up, one text (``frames`` × hop
    samples), four texts one at a time and then posted at once (each within
    1 LSB of the text served alone), and one text into all five output
    formats. ``walls`` gets the request walls, where given."""
    import numpy as np
    import torch

    from everyvoice_tpu_torch.demo.app import OUTPUT_FORMAT_CHOICES
    from everyvoice_tpu_torch.onchip import TEXTS

    hop = app.synthesizer._samples_per_frame()
    status, page = http(base + "/")
    if status != 200 or page.decode("utf8") != app.render_page():
        fail(f"GET / answered {status}")
    status, info = http(base + "/api/info")
    if status != 200 or info != {"languages": ["default"], "speakers": ["default"],
                                 "model": "FastSpeech2"}:
        fail(f"GET /api/info answered {status} {info}")
    check_refusals(base, "the demo")
    http(base + "/api/synthesize", {"text": TEXTS[2]})  # warm-up
    timed = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status, body = http(base + "/api/synthesize", {"text": TEXTS[0]})
    timed["1 text"] = time.perf_counter() - t0
    if status != 200 or len(answer_samples(body)) != frames * hop:
        fail(f"one text answered {status}, not {frames} frames of {hop} samples")
    texts = TEXTS[4:8]
    t0 = time.perf_counter()
    alone = [http(base + "/api/synthesize", {"text": t}) for t in texts]
    timed["4 texts one at a time"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        answers = list(pool.map(lambda t: http(base + "/api/synthesize", {"text": t}), texts))
    timed["4 texts at once"] = time.perf_counter() - t0
    for text, (status, body), (status_alone, body_alone) in zip(texts, answers, alone):
        if status != 200 or status_alone != 200:
            fail(f"{text!r} answered {status} served concurrently, {status_alone} alone")
        got, want = answer_samples(body), answer_samples(body_alone)
        if got.shape != want.shape or np.abs(got - want).max() > 1:
            fail(f"{text!r} served concurrently is not the text served alone")
    status, body = http(base + "/api/synthesize", {"text": TEXTS[1],
                                                  "output_formats": list(OUTPUT_FORMAT_CHOICES)})
    written = sorted(Path(f).relative_to(app.output_dir).parts[0] for f in body.get("files", []))
    if status != 200 or written != ["readalongs", "readalongs", "synthesized_spec", "textgrids",
                                    "wav"]:
        fail(f"all five output formats: {status}, wrote {written}")
    if walls is not None:
        walls.update(timed)


def demo_phase(root: Path, fs2_path: Path, voc_path: Path, card: str) -> dict:
    """The demo server (phase 15): the FastSpeech2 app from phase 4's seeded
    full-width checkpoints with a denylist and an output directory, served
    by ``make_server`` on a thread, answers ``fs2_demo_requests`` (timed;
    its ``mrf_stage`` launches are the phase's), then the same requests
    again with every MRF stage held to the plain version in bf16. Then the
    StyleTTS2 app with a named reference speaker, one request held to
    ``synthesize_text`` with the same seed and styles; and ``python -m
    everyvoice_tpu_torch demo`` as a process with no device given."""
    import socket
    import subprocess
    import threading

    import numpy as np
    import torch

    from everyvoice_tpu_torch.demo.app import create_demo_app_auto
    from everyvoice_tpu_torch.dsp import write_wav
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.models.styletts2.synthesize import (
        load_reference_style,
        synthesize_text,
    )
    from everyvoice_tpu_torch.onchip import TEXTS, write_corpus, write_styletts2_checkpoint
    from everyvoice_tpu_torch.ops.mrf import mrf_stage

    t_phase = time.perf_counter()
    work = root / "demo"
    work.mkdir(parents=True, exist_ok=True)
    denylist = work / "denylist.txt"
    denylist.write_text(DEMO_DENIED + "\n", encoding="utf8")
    walls = {}

    app = create_demo_app_auto(fs2_path, vocoder_path=voc_path, denylist=denylist,
                               output_dir=work / "out")
    synth = app.synthesizer
    if synth.device.type != "cuda" or synth.compute_dtype != "bfloat16":
        fail(f"the demo's Synthesizer resolved to {synth.compute_dtype} on {synth.device}")
    hop = synth._samples_per_frame()
    frames = synth.synthesize([TEXTS[0]])[0]["mel"].shape[0]  # what one text's answer holds
    server = app.make_server()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://%s:%d" % server.server_address
    stages: dict = {}
    try:
        mrf_stage.launches = 0
        fs2_demo_requests(app, base, frames, walls)
        demo_launches = mrf_stage.launches
        hifigan.mrf_stage = checked_mrf_stages(stages)
        fs2_demo_requests(app, base, frames)
    finally:
        server.shutdown()
        hifigan.mrf_stage = mrf_stage
    rows = [stages[k] for k in sorted(stages)]
    for row in rows:
        print("demo stage " + json.dumps(row), flush=True)
    if demo_launches == 0 or sum(r["calls"] for r in rows) != demo_launches:
        fail(f"{demo_launches} mrf_stage launches in the demo's requests, "
             f"{sum(r['calls'] for r in rows)} held to the plain version on them again")
    if any(r["dtype"] != "bfloat16" for r in rows):
        fail(f"an MRF stage of the demo ran in {[r['dtype'] for r in rows]}")
    del app, synth

    # StyleTTS2 with a named reference speaker
    st2_ckpt = write_styletts2_checkpoint(work, torch.Generator().manual_seed(15))
    _, wavs, _ = write_corpus(work / "corpus", 1, seed=15)
    reference = next(wavs.glob("*.wav"))
    st2_app = create_demo_app_auto(st2_ckpt, ref_speakers={"Reader": reference},
                                   denylist=denylist)
    server = st2_app.make_server()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://%s:%d" % server.server_address
    payload = {"text": TEXTS[0], "speaker": "Reader", "diffusion_steps": 5, "seed": 3}
    try:
        check_refusals(base, "the StyleTTS2 demo")
        http(base + "/api/synthesize", payload)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status, body = http(base + "/api/synthesize", payload)
        walls["StyleTTS2 1 text"] = time.perf_counter() - t0
    finally:
        server.shutdown()
    styles = load_reference_style(st2_app.model, reference, st2_app.config)
    if not all(np.array_equal(a, b) for a, b in zip(styles, st2_app.ref_styles["Reader"])):
        fail("the StyleTTS2 demo's reference styles are not load_reference_style's")
    direct = synthesize_text(st2_app.model, st2_app.config, st2_app.text_processor, TEXTS[0],
                             ref_styles=styles, diffusion_steps=5, seed=3)
    write_wav(work / "direct.wav", direct, st2_app.config["preprocessing"]["audio"]
              ["output_sampling_rate"])
    want = wav_samples((work / "direct.wav").read_bytes())
    got = answer_samples(body) if status == 200 else None
    if got is None or got.shape != want.shape or np.abs(got - want).max() > 1:
        fail(f"the StyleTTS2 demo answered {status}, not synthesize_text with seed 3")
    del st2_app

    # the demo verb as a process, with no device given
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "EVERYVOICE_DEVICE"}
    env["PYTHONPATH"] = str(ROOT)
    log = work / "demo-process.log"
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "everyvoice_tpu_torch", "demo", str(fs2_path),
             "--vocoder-path", str(voc_path), "--port", str(port), "--server-name", "127.0.0.1",
             "--denylist", str(denylist)], cwd=work, env=env, stdout=out, stderr=out)
        try:
            up = False
            while not up and proc.poll() is None and time.perf_counter() - t0 < 120:
                try:
                    up = http(base + "/", timeout=5)[0] == 200
                except OSError:
                    time.sleep(0.25)
            if not up:
                fail(f"the demo process did not come up in 120 s (exit {proc.poll()}):\n"
                     f"{log.read_text()[-2000:]}")
            walls["process up"] = time.perf_counter() - t0
            check_refusals(base, "the demo process")
            status, body = http(base + "/api/synthesize", {"text": "hello world"})
            n = len(answer_samples(body)) if status == 200 else 0
            if n == 0 or n % hop:
                fail(f"the demo process answered {status} to hello world")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    devices = [line for line in log.read_text().splitlines() if line.startswith("device: ")]
    if devices != ["device: cuda"]:
        fail(f"the demo process ran on {devices}:\n{log.read_text()[-2000:]}")

    row = {"walls_s": walls, "mrf_launches": demo_launches, "stages": len(rows),
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print("demo " + json.dumps(row), flush=True)
    return {"mrf_launches": demo_launches, "stages": rows, "row": row}

PARALLEL_STEPS = 3        # each phase-16 run: three steps, then a validation and last.ckpt
# On one rank fsdp and tp1 lay nothing out, so each is ddp's path: FastSpeech2
# runs all three (the command line's proof) and "none", the same command's
# training without a mesh (``cli.fit_from_args``); the GAN trainers run ddp
# (two ranks shard them in ``two_rank_phase`` and the CPU tests).
PARALLEL_STRATEGIES = {"text-to-spec": ("ddp", "fsdp", "tp1", "none"),
                       "spec-to-wav": ("ddp",), "text-to-wav": ("ddp",)}
TWO_RANK_BACKENDS = ("nccl", "gloo")
TWO_RANK_VOCODER_ROWS = 4  # the float32 GAN step's global batch on two ranks
# the V1 generator with two MPD periods and one MSD scale: the
# discriminators' fixed widths would otherwise dominate the two ranks' set-up
TWO_RANK_VOCODER = ["model.mpd_layers=[2, 3]", "model.msd_layers=1"]
TWO_RANK_TIMEOUT_S = 300
TWO_RANK_TOL = 1e-3       # a float32 training step, as phases 7, 8 and 12 hold one


def _two_rank_steps(trainer, batch_fn, placements: dict, steps: int = 2) -> dict:
    """Float32 steps of ``trainer`` (placed, fresh optimizer states) on its
    first training batch: every step's global losses and gradient norms
    (each later step's come after a sharded update), the global norm of
    each placement's change over the steps (the updates' AdamW on shards),
    and the later steps' median milliseconds."""
    import statistics

    import torch

    _, batch = next(trainer._device_batches(1))  # this rank's rows, on its device
    before = {name: {n: p.detach().clone() for n, p in placement.owned.items()}
              for name, placement in placements.items()}
    out, times = {}, []
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = batch_fn(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses = trainer._global_mean(losses)
        out.update({f"step{k + 1}/{key}": float(v) for key, v in losses.items()})
        for norm in ("grad_norm", "disc_grad_norm"):
            if getattr(trainer, norm, None) is not None:
                out[f"step{k + 1}/{norm}"] = float(getattr(trainer, norm))
    for name, placement in placements.items():
        change = {n: (p.detach() - before[name][n]).norm() for n, p in placement.owned.items()}
        out[f"{name}/update_norm"] = float(placement.global_norm(change))
    out["step_ms"] = 1e3 * statistics.median(times[1:])
    return out


def _two_rank_runs(fs2, voc) -> dict:
    """``_two_rank_steps`` of phase 16's FastSpeech2 and HiFiGAN trainers."""
    return {"fs2": _two_rank_steps(fs2, lambda b: fs2.train_step(b, 1.0),
                                   {"fs2": fs2.placement}),
            "hifigan": _two_rank_steps(voc, lambda b: voc.train_step(b, gan_on=True),
                                       {"generator": voc.gen_placement,
                                        "discriminators": voc.disc_placement})}


def _two_rank_trainers(fs2_yaml: Path, voc_yaml: Path, mesh, fsdp: bool, run_dir: Path):
    """Phase 16's FastSpeech2 and HiFiGAN (the V1 generator,
    ``TWO_RANK_VOCODER``'s discriminators) trainers in float32, dropout off,
    placed on ``mesh`` (or one device) with fresh optimizer states."""
    from everyvoice_tpu_torch.config_files import load_config_from_path
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.parallel import fresh_sharded_opt_state
    from everyvoice_tpu_torch.train.spec_to_wav import spec_to_wav_trainer
    from everyvoice_tpu_torch.train.text_to_spec import text_to_spec_trainer

    device = None if mesh is not None else "cuda"
    logs = [f"training.logger.save_dir={run_dir}"]
    fs2 = text_to_spec_trainer(load_config_from_path("text-to-spec", fs2_yaml, logs),
                               compute_precision="float32", device=device, mesh=mesh, fsdp=fsdp)
    for module in fs2.model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    fs2.init_params()
    fs2.place()
    fs2.opt_state = fresh_sharded_opt_state(fs2.optimizer, fs2.placement)
    voc = spec_to_wav_trainer(
        load_config_from_path("spec-to-wav", voc_yaml, logs + TWO_RANK_VOCODER + [
            f"training.batch_size={TWO_RANK_VOCODER_ROWS}", "training.generator_warmup_steps=0"]),
        compute_precision="float32", device=device, mesh=mesh, fsdp=fsdp)
    voc.init_params()
    voc.place()
    voc.gen_opt_state = fresh_sharded_opt_state(voc.gen_opt, voc.gen_placement)
    voc.disc_opt_state = fresh_sharded_opt_state(voc.disc_opt, voc.disc_placement)
    return fs2, voc


def two_rank_worker(rank: int, backend: str, address: str, fs2_yaml: str, voc_yaml: str,
                    out: str) -> None:
    """One of two ranks on the one card: join a ``backend`` group, then the
    FastSpeech2 and HiFiGAN float32 steps under ddp and fsdp on this rank's
    rows; rank 0 writes what it saw. A strategy whose collectives the
    backend does not serve is recorded as such."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from everyvoice_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank, world_size=2,
                            timeout=timedelta(seconds=TWO_RANK_TIMEOUT_S // 2))
    probe = torch.ones(1, device="cuda")
    dist.all_reduce(probe)  # where two ranks on one card are refused, here
    result = {"backend": backend, "probe": float(probe)}
    mesh = make_mesh(torch.device("cuda", 0))
    for strategy in ("ddp", "fsdp"):
        try:
            torch.cuda.reset_peak_memory_stats()
            fs2, voc = _two_rank_trainers(Path(fs2_yaml), Path(voc_yaml), mesh,
                                          strategy == "fsdp", Path(out) / f"runs-{rank}")
            row = {**_two_rank_runs(fs2, voc),
                   "sharded_leaves": len(fs2.placement.shards) + len(voc.gen_placement.shards)
                   + len(voc.disc_placement.shards)}
            peaks = torch.tensor([torch.cuda.max_memory_allocated() / 2**20], device="cuda")
            gathered = [torch.zeros_like(peaks) for _ in range(2)]
            dist.all_gather(gathered, peaks)
            row["peak_mib_per_rank"] = [float(g) for g in gathered]
            del fs2, voc
            torch.cuda.empty_cache()
        except Exception as e:  # noqa: BLE001 - recorded, and the phase fails on ddp's
            row = {"error": f"{type(e).__name__}: {e}"[:400]}
        result[strategy] = row
    if rank == 0:
        (Path(out) / "two_rank.json").write_text(json.dumps(result))
    dist.destroy_process_group()


def two_rank_phase(fs2_yaml: Path, voc_yaml: Path, work: Path) -> dict:
    """Phase 16(b): two ranks on the one card, NCCL first, then gloo on the
    card's tensors; each rank's steps against the one-process steps on the
    concatenated batch (float32, ``TWO_RANK_TOL``)."""
    import torch
    import torch.multiprocessing as mp

    from everyvoice_tpu_torch.parallel.launch import free_port

    tried = {}
    result = None
    for backend in TWO_RANK_BACKENDS:
        out = work / f"two-rank-{backend}"
        out.mkdir(parents=True)
        context = mp.start_processes(
            two_rank_worker, args=(backend, f"127.0.0.1:{free_port()}", str(fs2_yaml),
                                   str(voc_yaml), str(out)),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
        try:
            while not context.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no result in {TWO_RANK_TIMEOUT_S} s")
        except Exception as e:  # noqa: BLE001 - a backend that cannot serve two ranks on one card
            for process in context.processes:
                if process.is_alive():
                    process.kill()
            tried[backend] = f"{type(e).__name__}: {e}".strip().splitlines()[-1][:300]
            continue
        result = json.loads((out / "two_rank.json").read_text())
        tried[backend] = "ran"
        break
    if result is None:
        return {"ran": False, "tried": tried}
    with tempfile.TemporaryDirectory(dir=work) as one:
        fs2, voc = _two_rank_trainers(fs2_yaml, voc_yaml, None, False, Path(one))
        want = _two_rank_runs(fs2, voc)
        del fs2, voc
        torch.cuda.empty_cache()
    if "error" in result["ddp"]:
        fail(f"two ranks on the card under ddp ({result['backend']}): {result['ddp']['error']}")
    compared = {}
    for strategy in ("ddp", "fsdp"):
        row = result[strategy]
        if "error" in row:
            continue
        worst = 0.0
        for model in ("fs2", "hifigan"):
            for key, value in want[model].items():
                if key == "step_ms":
                    continue
                got = row[model][key]
                err = abs(got - value) / max(abs(value), 1e-6)
                worst = max(worst, err)
                if not (math.isfinite(got) and err <= TWO_RANK_TOL):
                    fail(f"two-rank {strategy} {model} {key} {got} against the one-process "
                         f"{value} (relative {err:.3g} > {TWO_RANK_TOL})")
        compared[strategy] = worst
    if "error" not in result["fsdp"] and result["fsdp"]["sharded_leaves"] == 0:
        fail("two-rank fsdp sharded no parameter")
    return {"ran": True, "tried": tried, "backend": result["backend"], "result": result,
            "one_process": want, "worst_relative": compared}


def parallel_phase(root: Path, fs2_dir: Path, st2_yaml: Path, voc_path: Path,
                   card: str) -> dict:
    """Phase 16, multi-device training. (a) ``train text-to-spec``,
    ``spec-to-wav`` and ``text-to-wav --mode first`` through ``cli.main`` at
    full width on phase 10's and phase 12's projects with ``-d 1`` and
    ``PARALLEL_STRATEGIES``: each rank of a one-rank NCCL group, and
    FastSpeech2's same training without a mesh beside them, ``PARALLEL_STEPS`` steps, a
    validation and ``last.ckpt``, which the loaders read back (``train``'s);
    every MRF stage held to the plain version. (b) ``two_rank_phase``."""
    import statistics

    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.models.fs2.synthesize import (
        load_fs2_from_checkpoint,
        load_vocoder_from_checkpoint,
    )
    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.models.styletts2.synthesize import load_styletts2_model
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.ops.mrf import mrf_stage
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint_header
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer, HiFiGANTrainer

    t_phase = time.perf_counter()
    work = root / "parallel"
    work.mkdir()
    fs2_yaml = fs2_dir / "everyvoice-text-to-spec.yaml"
    voc_yaml = fs2_dir / "everyvoice-spec-to-wav.yaml"
    common = ["-d", "1", "-c", f"training.max_steps={PARALLEL_STEPS}",
              "-c", "training.save_top_k_ckpts=0"]
    jobs = (
        ("text-to-spec", fs2_yaml, ["-c", f"training.val_check_interval={PARALLEL_STEPS}",
                                    "-c", f"training.vocoder_path={voc_path}"],
         "last.ckpt", load_fs2_from_checkpoint),
        ("spec-to-wav", voc_yaml, ["-c", f"training.val_check_interval={PARALLEL_STEPS}",
                                   "-c", "training.generator_warmup_steps=1"],
         "last.ckpt", load_vocoder_from_checkpoint),
        ("text-to-wav", st2_yaml, ["--mode", "first"], "stage-1-last.ckpt",
         load_styletts2_model),
    )
    seen, stages = [], {}
    plain = {cls: cls.train_step for cls in (FastSpeech2Trainer, HiFiGANTrainer,
                                             StyleTTS2Trainer)}

    def timed(cls):
        def step(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain[cls](self, *args, **kwargs)
            torch.cuda.synchronize()
            seen.append((self, time.perf_counter() - t0))
            return out
        return step

    runs = []
    hifigan.mrf_stage = checked_mrf_stages(stages)
    for cls in plain:
        cls.train_step = timed(cls)
    mrf_stage.launches = 0
    try:
        for kind, yaml_path, extra, ckpt_name, loader in jobs:
            for strategy in PARALLEL_STRATEGIES[kind]:
                seen.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                launches = mrf_stage.launches
                t0 = time.perf_counter()
                argv = [str(a) for a in ("train", kind, yaml_path, *common, *extra, "-c",
                                         f"training.logger.name=parallel-{kind}-{strategy}")]
                if strategy == "none":
                    cli.fit_from_args(cli.build_parser().parse_args(argv), device="cuda")
                    rc = 0
                else:
                    rc = cli.main(argv[:3] + ["-s", strategy] + argv[3:])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rc != 0:
                    fail(f"train {kind} -s {strategy}: exit code {rc}")
                trainer = seen[0][0]
                mesh = trainer.mesh
                if strategy == "none":
                    if mesh is not None:
                        fail(f"train {kind} without a mesh ran on {mesh}")
                elif mesh is None or mesh.backend != "nccl" or mesh.world != 1:
                    fail(f"train {kind} -s {strategy} ran outside a one-rank NCCL group: {mesh}")
                if trainer.fsdp != (strategy == "fsdp"):
                    fail(f"train {kind} -s {strategy}: fsdp {trainer.fsdp}")
                ckpt = trainer.ckpt_dir / ckpt_name
                step = load_checkpoint_header(ckpt)["global_step"]
                if step != PARALLEL_STEPS:
                    fail(f"{ckpt}: global_step {step}, expected {PARALLEL_STEPS}")
                if strategy != "none":
                    loaded = loader(ckpt)
                    del loaded
                step_s = [t for _, t in seen]
                runs.append({
                    "model": kind, "strategy": strategy,
                    "backend": None if mesh is None else mesh.backend,
                    "world": 1, "steps": len(step_s),
                    "step_ms": 1e3 * statistics.median(step_s[1:] or step_s),
                    "first_step_ms": 1e3 * step_s[0],
                    "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "mrf_launches": mrf_stage.launches - launches, "wall_s": wall})
                del trainer
                seen.clear()
                torch.cuda.empty_cache()
    finally:
        hifigan.mrf_stage = mrf_stage
        for cls, step in plain.items():
            cls.train_step = step
    mrf_launches = mrf_stage.launches
    if not all(r["mrf_launches"] > 0 for r in runs if r["model"] != "text-to-wav"):
        fail(f"a FastSpeech2 or HiFiGAN validation ran no mrf_stage: {runs}")
    t_two = time.perf_counter()
    two = two_rank_phase(fs2_yaml, voc_yaml, work)
    two_rank_s = time.perf_counter() - t_two
    row = {
        "a_cli_nccl": runs,
        "b_two_ranks_one_card": {
            "ran": two["ran"], "tried": two["tried"], "backend": two.get("backend"),
            "note": ("two ranks shared the one card through " + two["backend"]
                     if two["ran"] else "no backend ran two ranks on the one card; the "
                     "multi-rank numbers are the CPU tests' (gloo)"),
            "strategies": {s: (two["result"][s] if two["ran"] else None) for s in ("ddp", "fsdp")},
            "one_process": two.get("one_process"), "worst_relative": two.get("worst_relative"),
            "seconds": two_rank_s},
        "mrf_launches": mrf_launches, "mrf_stages": list(stages.values()),
        "phase_s": time.perf_counter() - t_phase, "card": card}
    print("parallel " + json.dumps(row), flush=True)
    return {"mrf_launches": mrf_launches, "stages": list(stages.values()), "row": row}


PROJECT_UTTERANCES = 256  # 3–10 s each at 48,000 Hz, about 1,660 s of audio
PROJECT_QUIET = 4         # below the −36 LUFS gate: both paths reject them
PROJECT_STEREO = 2
PROJECT_SR = 48000
PROJECT_OUTPUT_SR = 44100  # so both targets resample: 48,000→22,050 and →44,100
# The new-project wizard's answers on standard input (a menu by its number).
PROJECT_ANSWERS = ("Smoke Project", "Chip Smoke", "smoke@example.org", "{out}", "{filelist}",
                   "yes", "0", "0", "0",  # psv, characters, no text processing
                   "1", "1", "0",  # speaker and language columns, keep the G2P
                   "{wavs}", "22050", "0", "smoke",
                   "0", "0", "0")  # no more datasets, validation OOD, yaml
DIO_ROWS = 16
DIO_VOICED_AGREE = 0.99  # voicing equal on at least this share of frames, card vs CPU
DIO_MEDIAN_HZ = 0.1      # median |F0 card − F0 CPU| where both are voiced
DIO_VIBRATO_HZ = 0.5     # tests/test_dsp.py::TestDioCrossValidation's bound


def project_phase(root: Path, card: str) -> dict:
    """A project from nothing (phase 17): a seeded corpus at 48,000 Hz with
    quiet and stereo files; ``python -m everyvoice_tpu_torch new-project``
    as a process answering from standard input, its project loaded back;
    ``preprocess text-to-spec --device-audio`` as a process with no device
    named (every default step, outputs at 22,050 and 44,100 Hz), and the
    same through ``cli.main`` on the host audio path into a second save dir;
    the artifacts of the two compared (audio within 1 LSB, the same rows,
    the quiet files rejected by both), the features checked and every
    feature batch's log-mel held to the plain version; then DIO on the card
    against the CPU on 16 of the project's clips and on a vibrato tone, its
    time beside the YIN tracker's, and the segment samplers card against
    CPU."""
    import subprocess

    import numpy as np
    import torch

    from everyvoice_tpu_torch import cli
    from everyvoice_tpu_torch.config_files import load_config_from_path
    from everyvoice_tpu_torch.dsp.audio_io import read_wav
    from everyvoice_tpu_torch.dsp.dio import estimate_f0_dio
    from everyvoice_tpu_torch.dsp.pitch import estimate_f0
    from everyvoice_tpu_torch.dsp.segments import get_segments_batched
    from everyvoice_tpu_torch.onchip import write_corpus
    from everyvoice_tpu_torch.ops.mel import log_mel
    from everyvoice_tpu_torch.preprocessor import Preprocessor
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    t_phase = time.perf_counter()
    work = root / "project"
    walls: dict = {}
    t0 = time.perf_counter()
    filelist, wavs, audio_s = write_corpus(work / "corpus", PROJECT_UTTERANCES, seed=17,
                                           sr=PROJECT_SR, n_quiet=PROJECT_QUIET,
                                           n_stereo=PROJECT_STEREO)
    walls["corpus"] = time.perf_counter() - t0
    env = {k: v for k, v in os.environ.items() if k != "EVERYVOICE_DEVICE"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])

    # (b) the wizard as a process
    answers = "\n".join(a.format(out=work, filelist=filelist, wavs=wavs)
                        for a in PROJECT_ANSWERS) + "\n"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "new-project"],
                          input=answers, cwd=work, env=env, capture_output=True, text=True,
                          timeout=300)
    walls["new-project"] = time.perf_counter() - t0
    project = work / "Smoke-Project"
    config_dir = project / "config"
    if proc.returncode != 0:
        fail(f"new-project: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    kinds = {"text-to-spec": "everyvoice-text-to-spec.yaml",
             "spec-to-wav": "everyvoice-spec-to-wav.yaml",
             "text-to-wav": "everyvoice-text-to-wav.yaml",
             "preprocessing": "everyvoice-shared-data.yaml"}
    loaded = {kind: load_config_from_path(kind, config_dir / name) for kind, name in kinds.items()}
    rows_in = generic_psv_filelist_reader(project / "smoke-filelist.psv")
    expect = PROJECT_UTTERANCES + PROJECT_QUIET + PROJECT_STEREO
    sources = loaded["text-to-spec"]["preprocessing"]["source_data"]
    if (len(rows_in) != expect or len(sources) != 1 or Path(sources[0]["data_dir"]) != wavs
            or loaded["text-to-wav"]["training"].get("use_validation_as_ood") is not True
            or "smoke_characters" not in loaded["text-to-spec"]["text"]["symbols"]):
        fail(f"new-project's project: {len(rows_in)} rows, sources {sources}")

    # (c) preprocess on the device audio path (a process) and the host path
    fs2_yaml = config_dir / kinds["text-to-spec"]
    rate = f"preprocessing.audio.output_sampling_rate={PROJECT_OUTPUT_SR}"
    cpus = str(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "preprocess",
                           "text-to-spec", str(fs2_yaml), "--device-audio", "-C", cpus, "-c", rate],
                          cwd=work, env=env, capture_output=True, text=True, timeout=600)
    walls["preprocess --device-audio (process)"] = time.perf_counter() - t0
    err = proc.stderr
    if proc.returncode != 0 or "device: cuda" not in err.splitlines():
        fail(f"preprocess --device-audio: exit {proc.returncode}\n{err[-3000:]}")
    device_audio = json.loads(err.split("device audio: ", 1)[1].splitlines()[0])
    steps_line = err.split("Finished preprocessing: ", 1)[1].splitlines()[0]
    device_steps = {k: float(v.rstrip("s")) for k, v in (
        part.rsplit(" ", 1) for part in steps_line.split("(", 1)[1].split(")", 1)[0].split(", "))}
    device_save = project / "preprocessed"

    host_save = work / "host-preprocessed"
    preprocessors = []
    plain = Preprocessor.preprocess

    def recording_preprocess(self, *args, **kwargs):
        preprocessors.append(self)
        return plain(self, *args, **kwargs)

    Preprocessor.preprocess = recording_preprocess
    log_mel.launches = 0
    log_mel.fft_launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["preprocess", "text-to-spec", str(fs2_yaml), "-C", cpus, "-c", rate,
                       "-c", f"preprocessing.save_dir={host_save}"])
        torch.cuda.synchronize()
        walls["preprocess host audio (cli.main)"] = time.perf_counter() - t0
    finally:
        Preprocessor.preprocess = plain
    mel_launches, fft_launches = log_mel.launches, log_mel.fft_launches
    if rc != 0:
        fail(f"preprocess on the host audio path: exit {rc}")
    pre = preprocessors[0]
    if pre.device.type != "cuda":
        fail(f"the host-path preprocess ran its features on {pre.device}")
    batches = len(pre.last_batch_shapes)
    if mel_launches == 0 or mel_launches != batches or fft_launches != batches:
        fail(f"log_mel launched {mel_launches} times ({fft_launches} through the FFT kernel) "
             f"for {batches} feature batches")

    # the two paths' artifacts
    t0 = time.perf_counter()
    for name in ("filelist.psv", "training_filelist.psv", "validation_filelist.psv"):
        if (device_save / name).read_bytes() != (host_save / name).read_bytes():
            fail(f"the device and host audio paths wrote different {name}")
    summaries = [json.loads((d / "summary.txt").read_text()) for d in (device_save, host_save)]
    kept = generic_psv_filelist_reader(device_save / "filelist.psv")
    quiet_kept = [r["basename"] for r in kept if r["basename"].startswith("quiet")]
    stereo_kept = [r["basename"] for r in kept if r["basename"].startswith("stereo")]
    if (any(s["audio_empty"] != PROJECT_QUIET for s in summaries) or quiet_kept
            or len(kept) != PROJECT_UTTERANCES + PROJECT_STEREO
            or len(stereo_kept) != PROJECT_STEREO
            or abs(summaries[0]["duration"] - summaries[1]["duration"]) > 1e-6):
        fail(f"audio step summaries {summaries}; kept {len(kept)} rows, quiet {quiet_kept}")
    lsb, worst, compared = 1.01 / 32768, 0.0, 0
    hop = pre.audio_config["fft_hop_size"]
    for row in kept:
        item = pre.get_speaker_and_language(row)
        for sr, step in ((22050, hop), (PROJECT_OUTPUT_SR, hop * PROJECT_OUTPUT_SR // 22050)):
            rel = pre.create_path(item, "audio", f"audio-{sr}.wav").relative_to(host_save)
            a, sr_a = read_wav(device_save / rel)
            b, sr_b = read_wav(host_save / rel)
            if sr_a != sr or sr_b != sr or a.shape != b.shape or a.shape[1] % step:
                fail(f"{rel}: {sr_a}/{sr_b} Hz, shapes {a.shape} {b.shape}")
            worst = max(worst, float(np.abs(a - b).max()))
            compared += 1
    if worst > lsb:
        fail(f"the device audio path's artifacts part from the host path's by {worst * 32768} LSB")
    for save in (device_save, host_save):
        for row in generic_psv_filelist_reader(save / "filelist.psv"):
            item = pre.get_speaker_and_language(row)
            frames = read_wav(save / pre.create_path(item, "audio", "audio-22050.wav")
                              .relative_to(host_save))[0].shape[1] // hop
            arts = [np.load(save / pre.create_path(item, k, n).relative_to(host_save)) for k, n in
                    (("spec", pre._spec_filename()), ("energy", "energy.npy"),
                     ("pitch", "pitch.npy"), ("attn", "characters-attn-prior.npy"))]
            n_tokens = len([t for t in pre.text_processor.split_tokens(row["character_tokens"])
                            if t])
            if ([a.shape for a in arts] != [(80, frames), (frames,), (frames,), (frames, n_tokens)]
                    or not all(np.isfinite(a).all() for a in arts)):
                fail(f"{save.name}/{row['basename']}: shapes {[a.shape for a in arts]} for "
                     f"{frames} frames, or not finite")
    walls["compare and check"] = time.perf_counter() - t0
    served_mel, _ = check_served_features(pre)

    # (d) DIO and the segment samplers on the card
    t0 = time.perf_counter()
    clips = sorted((read_wav(device_save / "audio" / f"{r['basename']}--default--default--"
                             "audio-22050.wav")[0][0] for r in kept), key=len)[:DIO_ROWS]
    t_len = max(len(c) for c in clips)
    batch = torch.zeros(DIO_ROWS, t_len)
    for i, c in enumerate(clips):
        batch[i, : len(c)] = torch.from_numpy(c)
    card_f0 = estimate_f0_dio(batch.cuda(), 22050, hop, interpolate=False).cpu()
    cpu_f0 = estimate_f0_dio(batch, 22050, hop, interpolate=False)
    both = (card_f0 > 0) & (cpu_f0 > 0)
    voicing_agree = ((card_f0 > 0) == (cpu_f0 > 0)).float().mean().item()
    median_hz = (card_f0[both] - cpu_f0[both]).abs().median().item() if both.any() else math.inf
    if voicing_agree < DIO_VOICED_AGREE or not median_hz < DIO_MEDIAN_HZ or both.sum() < 100:
        fail(f"DIO card vs CPU: voicing agrees on {voicing_agree}, median {median_hz} Hz over "
             f"{int(both.sum())} co-voiced frames")
    t = np.arange(int(2.0 * 22050)) / 22050
    f_true = 180 + 10 * np.sin(2 * np.pi * 3 * t)
    phase = 2 * np.pi * np.cumsum(f_true) / 22050
    tone = (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.3 * np.sin(3 * phase)).astype(np.float32)
    f0 = estimate_f0_dio(torch.from_numpy(tone).cuda(), 22050, 256, interpolate=False).cpu().numpy()
    centers = np.minimum(np.arange(f0.shape[-1]) * 256, len(tone) - 1)
    core = f0[10:-10]
    voiced = core > 0
    vibrato_err = float(np.median(np.abs(core[voiced] - f_true[centers][10:-10][voiced])))
    if voiced.mean() <= 0.95 or not vibrato_err < DIO_VIBRATO_HZ:
        fail(f"DIO on the vibrato tone: voiced {voiced.mean()}, median error {vibrato_err} Hz")
    x = batch.cuda()
    dio_ms = cuda_ms(lambda: estimate_f0_dio(x, 22050, hop, interpolate=False), 3)
    yin_ms = cuda_ms(lambda: estimate_f0(x, 22050, hop, interpolate=False), 3)
    lengths = torch.tensor([len(c) for c in clips])
    starts = torch.tensor([(i * 997) % max(len(c) - 8192, 1) for i, c in enumerate(clips)])
    seg_cpu, _ = get_segments_batched(batch, lengths, 8192, starts=starts)
    seg_card, _ = get_segments_batched(batch.cuda(), lengths.cuda(), 8192, starts=starts.cuda())
    if not torch.equal(seg_card.cpu(), seg_cpu):
        fail("get_segments_batched with given starts differs between the card and the CPU")
    walls["dio and segments"] = time.perf_counter() - t0

    host_audio_s = pre.last_step_seconds["audio"]
    kept_s = summaries[1]["duration"]
    row = {
        "utterances": expect, "audio_s": audio_s, "kept_audio_s": kept_s, "walls_s": walls,
        "audio_step_s": {"device": device_steps["audio"], "host": host_audio_s},
        "audio_s_per_s": {"device": kept_s / device_steps["audio"], "host": kept_s / host_audio_s},
        "device_steps_s": device_steps, "host_steps_s": pre.last_step_seconds,
        "transfer_bytes": {"up": device_audio["up"], "down": device_audio["down"]},
        "bucket_shapes": sorted([list(k), v] for k, v in
                                Counter((b[0], tuple(b[1]), b[2])
                                        for b in device_audio["batches"]).items()),
        "device_audio_peak_mib": device_audio.get("peak_bytes", 0) / 2**20,
        "artifacts_compared": compared, "max_audio_diff_lsb": worst * 32768,
        "feature_batches": batches, "log_mel_launches": mel_launches,
        "dio": {"voicing_agree": voicing_agree, "median_abs_hz": median_hz,
                "vibrato_median_err_hz": vibrato_err, "dio_ms": dio_ms, "yin_ms": yin_ms,
                "shape": [DIO_ROWS, t_len]},
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    print("project " + json.dumps(row), flush=True)
    return {"mel_launches": mel_launches, "fft_launches": fft_launches,
            "served_mel": served_mel, "row": row}


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

    marks = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print the wall seconds since the last lap."""
        marks.append(time.perf_counter())
        print(f"phase {phase}: {marks[-1] - marks[-2]:.1f} s", flush=True)

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {name: pool.submit(timed_build, name) for name in ("mrf", "mel")}
        for name, future in builds.items():
            seconds, lib = future.result()
            print(f"build: {name}.cu in {seconds:.2f} s -> {lib.name}", flush=True)
    lap("2 (build)")

    gen = torch.Generator().manual_seed(0)
    stages = check_kernel(gen)
    lap("3 (mrf_stage)")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        fs2_path, voc_path = write_seeded_checkpoints(tmp, gen, "cuda")
        synth = Synthesizer(fs2_path, voc_path)  # device cuda, compute 'auto' = bf16
        served = serve(synth, tmp / "out", card)
        served_stages = check_served_stages(synth)
        del synth
        reference_check(fs2_path, voc_path)
        lap("4 (serving)")

        mel_rows = check_mel_kernel(torch.Generator().manual_seed(1))
        lap("5 (log_mel)")
        prep = preprocess_corpus(tmp, card)
        served_mel, batches = check_served_features(prep["pre"])
        time_feature_program(prep["pre"], batches, mel_rows)
        features_card_vs_cpu(prep["cfg"], batches[max(batches)])
        lap("6 (preprocessing)")

        trained = train_phase(tmp, prep["cfg"], voc_path, card)
        training_launches, training_stages = trained["launches"], trained["stages"]
        char_step_ms = trained["row"]["median_step_ms"]
        fs2_ckpt = trained["trainer"].ckpt_dir / "last.ckpt"
        synthesize_trained(fs2_ckpt, voc_path, tmp / "trained")
        del trained
        lap("7 (FastSpeech2 training)")
        vocoder = vocoder_phase(tmp, prep["cfg"], fs2_ckpt, card)
        lap("8 (vocoder training)")
        phone = phone_voice_phase(tmp, voc_path, vocoder["ckpt"], char_step_ms,
                                  served["requests"], card)
        lap("9 (phone-level voice)")
        cli_run = cli_phase(tmp, voc_path, card)
        lap("10 (command line)")
        styletts2_phase(tmp, card)
        lap("11 (StyleTTS2 serving)")
        st2_trained = st2_training_phase(tmp, card)
        lap("12 (StyleTTS2 training)")
        st2_pretrained = st2_pretrained_phase(tmp, card)
        lap("13 (StyleTTS2 pretrained components)")
        aligner_phase(tmp, card)
        lap("14 (aligner)")
        demo = demo_phase(tmp, fs2_path, voc_path, card)
        lap("15 (demo)")
        parallel = parallel_phase(tmp, cli_run["config_dir"], st2_trained["config"], voc_path,
                                  card)
        lap("16 (multi-device training)")
        project = project_phase(tmp, card)
        lap("17 (a project from nothing)")
    print(f"phases 2-17: {marks[-1] - marks[0]:.1f} s", flush=True)

    bf16 = [r for r in stages if r["dtype"] == "bfloat16"]
    kernels = {"kernels": [{
        "name": "mrf_stage",
        "route": "cuda",
        "source": "everyvoice_tpu_torch/ops/csrc/mrf.cu",
        "replaces": "everyvoice_tpu/ops/mrf_pallas.py:137",
        "launches": (served["launches"] + training_launches + vocoder["launches"]
                     + vocoder["serving_launches"] + phone["mrf_launches"]
                     + cli_run["mrf_launches"] + demo["mrf_launches"]
                     + parallel["mrf_launches"]),
        "serving_launches": served["launches"],
        "training_launches": training_launches,
        "vocoder_training_launches": vocoder["launches"],
        "trained_vocoder_serving_launches": vocoder["serving_launches"],
        "phone_voice_launches": phone["mrf_launches"],
        "cli_launches": cli_run["mrf_launches"],
        "styletts2_training_launches": st2_trained["mrf_launches"],
        "styletts2_pretrained_launches": st2_pretrained["mrf_launches"],
        "demo_launches": demo["mrf_launches"],
        "parallel_launches": parallel["mrf_launches"],
        "kernel_launches": served["kernel_launches"],
        "design": DESIGN["torch.bfloat16"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16 + served_stages + training_stages
                           + vocoder["stages"] + phone["stages"] + cli_run["stages"]
                           + demo["stages"] + parallel["stages"]),
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
        "launches": (prep["launches"] + phone["mel_launches"] + cli_run["mel_launches"]
                     + st2_trained["mel_launches"] + st2_pretrained["mel_launches"]
                     + project["mel_launches"]),
        "fft_launches": (prep["fft_launches"] + phone["mel_launches"] + cli_run["mel_launches"]
                         + st2_trained["fft_launches"] + st2_pretrained["fft_launches"]
                         + project["fft_launches"]),
        "phone_voice_launches": phone["mel_launches"],
        "cli_launches": cli_run["mel_launches"],
        "styletts2_training_launches": st2_trained["mel_launches"],
        "styletts2_pretrained_launches": st2_pretrained["mel_launches"],
        "project_launches": project["mel_launches"],
        "design": "shared-memory radix-2 Stockham FFT (n_fft a power of two)",
        "max_abs_err": max(r["max_abs_err"] for r in mel_rows + served_mel + phone["served_mel"]
                           + cli_run["served_mel"] + st2_trained["served_mel"]
                           + st2_pretrained["served_mel"] + project["served_mel"]),
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

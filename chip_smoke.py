#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``everyvoice_tpu_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, any failure of which exits nonzero:

1. print the card's name and power limit (``nvidia-smi``); refuse to run
   without CUDA;
2. build the MRF kernel (``ops/csrc/mrf.cu``, sm_90a) and print the seconds;
3. hold the kernel to its plain PyTorch version at the four HiFiGAN V1 stage
   shapes (batch 2, 1000 mel frames) in float32 (TF32 off; tolerance 1e-4 of
   max|ref|) and bfloat16 (2e-2 of max|ref|), and time the kernel, the plain
   version and a cuDNN ``conv1d`` chain computing the same stage;
4. serve requests of 1, 4 and 16 texts through ``Synthesizer`` from EVTP
   checkpoints of seeded full-width FastSpeech2 + HiFiGAN V1 weights, check
   the wavs, the kernel's launch count and the real-time factor; then serve
   them again holding every MRF stage they run, at the batch sizes (and so
   time tiles) the requests give it, to the plain version in bfloat16; and
   hold the card's float32 synthesis of one text to the CPU's;
5. print the kernels line, the card line, and last ``{"ok": true, ...}``.

It imports nothing of JAX or of ``everyvoice_tpu``.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12    # dense tensor-core peak
H100_FP32_FLOPS = 67e12     # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
V1_STAGES = ((256, 8), (128, 64), (64, 128), (32, 256))  # (C, samples per frame)
KERNEL_SIZES = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
MEL_FRAMES = 1000


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
            got = mrf_stage(xd, w, b, KERNEL_SIZES, DILATIONS)
            torch.cuda.synchronize()
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


def serve(synth, out_dir: Path, card: str) -> dict:
    """The main path: requests of 1, 4 and 16 texts through Synthesizer."""
    import numpy as np
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
    timings = []
    for i, texts in enumerate(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = synth.synthesize(texts)
        wall = time.perf_counter() - t0
        written = synth.write_outputs(results, out_dir / f"request{i}", ("wav",))
        audio_s = 0.0
        for res in results:
            wav, mel = res["wav"], res["mel"]
            if wav is None or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
                fail(f"request {i}: wav missing, not finite or outside [-1, 1]")
            if wav.shape != (mel.shape[0] * hop,):
                fail(f"request {i}: wav of {wav.shape} for {mel.shape[0]} frames")
            audio_s += wav.shape[0] / sr
        if len(written) != len(texts):
            fail(f"request {i}: wrote {len(written)} wavs for {len(texts)} texts")
        row = {"texts": len(texts), "chunks": sum(len(r["tokens"]) for r in results),
               "wall_s": wall, "audio_s": audio_s, "rtf": audio_s / wall, "card": card}
        print("request " + json.dumps(row), flush=True)
        timings.append(row)
    launches = mrf_stage.launches
    n_stages = len(synth.vocoder.ups)
    if launches == 0 or launches != n_stages * len(forwards):
        fail(f"mrf_stage launched {launches} times for {len(forwards)} generator forwards")
    return {"launches": launches, "forwards": len(forwards), "requests": timings}


def check_served_stages(synth) -> list:
    """Each MRF stage the requests run, at the batch the request gives it,
    held to the plain version on the same input (bf16, 2e-2 of max|ref|);
    one row per stage shape, with the time tile the kernel planned."""
    import torch

    from everyvoice_tpu_torch.models.hifigan import model as hifigan
    from everyvoice_tpu_torch.onchip import REQUESTS
    from everyvoice_tpu_torch.ops.mrf import _plan, mrf_stage, mrf_stage_reference

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    seen = {}

    def checked(x, w, b, kernel_sizes, dilation_sizes, slope):
        got = mrf_stage(x, w, b, kernel_sizes, dilation_sizes, slope)
        ref = mrf_stage_reference(x, w, b, kernel_sizes, dilation_sizes, slope).float()
        err = (got.float() - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        batch, t, c = x.shape
        if not (err <= tol and torch.isfinite(got).all()):
            fail(f"mrf_stage disagrees with its plain version on a served batch "
                 f"(B={batch}, T={t}, C={c}, {x.dtype}): max diff {err} > {tol}")
        row = seen.setdefault((batch, t, c), {
            "B": batch, "T": t, "C": c, "dtype": str(x.dtype).replace("torch.", ""),
            "tile": _plan(batch, t, c, n_sm)[0], "calls": 0, "max_abs_err": 0.0,
            "tol": float("inf")})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["tol"] = min(row["tol"], tol)
        return got

    hifigan.mrf_stage = checked
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
    from everyvoice_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build("mrf")
    print(f"build: mrf.cu in {time.perf_counter() - t0:.2f} s -> {lib.name}", flush=True)

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

    bf16 = [r for r in stages if r["dtype"] == "bfloat16"]
    kernels = {"kernels": [{
        "name": "mrf_stage",
        "route": "cuda",
        "source": "everyvoice_tpu_torch/ops/csrc/mrf.cu",
        "replaces": "everyvoice_tpu/ops/mrf_pallas.py::fused_mrf",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16 + served_stages),
        "ms": sum(r["kernel_ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
        "bound_ms": sum(r["bound_ms"] for r in bf16),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bf16) else "bytes",
        "library_ms": sum(r["library_ms"] for r in bf16),
        "shapes": "sum of the four V1 stages, B=2, 1000 mel frames, bfloat16",
    }]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

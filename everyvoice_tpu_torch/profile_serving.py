"""Where a serving request's time goes on the card.

    python -m everyvoice_tpu_torch.profile_serving [--out FILE]

Serves the on-card check's requests (1, 4 and 16 texts, see ``onchip.py``)
from seeded full-width FastSpeech2 + HiFiGAN V1 checkpoints through
``Synthesizer`` (CUDA, bfloat16 compute) and prints one JSON line per
request:

- ``wall_s``: ``Synthesizer.synthesize`` on the host clock, synchronized,
  median and spread of 5 runs after a warm-up; the audio it
  made and the real-time factor;
- ``batches``: each padded batch the request ran, with CUDA-event times of
  its FastSpeech2 forward and its generator forward (median of 3 runs on the
  same inputs), and their sum against the wall time;
- ``peak_mib``: peak device memory of one run.

Then it traces one run of the largest request with ``torch.profiler`` and
prints the device's busy time (the union of kernel and copy intervals), its
idle share of the run's wall time, the device time of its device-to-host
copies, and device time by kernel, the MRF kernels' first. Where the trace holds no device activity it says "not
measured". Needs a CUDA card; builds the MRF kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

from everyvoice_tpu_torch.models.fs2.synthesize import Synthesizer
from everyvoice_tpu_torch.onchip import REQUESTS, card_line, write_seeded_checkpoints

REPEATS = 5
SEED = 0


def event_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one more."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(synth: Synthesizer, texts) -> list:
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth.synthesize(texts)
        out.append(time.perf_counter() - t0)
    return out


def capture_batches(synth: Synthesizer, texts) -> list:
    """The (FastSpeech2 args, kwargs, generator mel) of each padded batch a
    request runs, taken with forward pre-hooks."""
    fs2_calls, mels = [], []
    h1 = synth.model.register_forward_pre_hook(
        lambda m, args, kwargs: fs2_calls.append((args, kwargs)), with_kwargs=True
    )
    h2 = synth.vocoder.register_forward_pre_hook(lambda m, args: mels.append(args[0]))
    try:
        synth.synthesize(texts)
    finally:
        h1.remove()
        h2.remove()
    return [(a, k, mel) for (a, k), mel in zip(fs2_calls, mels)]


def merged_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace(synth: Synthesizer, texts) -> dict:
    """Device busy time, idle share and time by kernel for one run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize(texts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return {"device_busy": "not measured", "wall_ms": wall_us / 1e3}
    busy_us = merged_us((e.time_range.start, e.time_range.end) for e in device)
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    # the MRF stage's kernels: mrf_conv_kernel, mrf_prologue_kernel and
    # mrf_finish_kernel in bfloat16, mrf_stage_kernel in float32
    mrf_us = sum(v for k, v in by_name.items() if "mrf_" in k)
    dtoh_us = sum(v for k, v in by_name.items() if "DtoH" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / wall_us,
        "mrf_kernel_ms": mrf_us / 1e3,
        "mrf_share_of_wall": mrf_us / wall_us,
        "other_device_ms": (sum(by_name.values()) - mrf_us) / 1e3,
        "dtoh_ms": dtoh_us / 1e3,
        "device_events": len(device),
        "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    card = card_line()
    lines = [{"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}]
    print(json.dumps(lines[0]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator().manual_seed(SEED)
        fs2_path, voc_path = write_seeded_checkpoints(Path(tmp), gen, "cuda")
        synth = Synthesizer(fs2_path, voc_path)
    for texts in REQUESTS:
        synth.synthesize(texts)  # warm-up
    sr = synth.config["preprocessing"]["audio"]["output_sampling_rate"]
    for texts in REQUESTS:
        results = synth.synthesize(texts)
        audio_s = sum(len(r["wav"]) for r in results) / sr
        walls = wall_s(synth, texts)
        torch.cuda.reset_peak_memory_stats()
        batches = []
        for fs2_args, fs2_kwargs, mel in capture_batches(synth, texts):
            with torch.no_grad():
                fs2_ms = event_ms(lambda: synth.model(*fs2_args, **fs2_kwargs))
                gen_ms = event_ms(lambda: synth.vocoder(mel))
            batches.append({"text_shape": list(fs2_args[0].shape), "fs2_ms": fs2_ms,
                            "generator_ms": gen_ms})
        median = statistics.median(walls)
        line = {
            "texts": len(texts), "chunks": sum(len(r["tokens"]) for r in results),
            "wall_s": median, "wall_s_min": min(walls), "wall_s_max": max(walls),
            "audio_s": audio_s, "rtf": audio_s / median, "batches": batches,
            "device_forward_share": sum(b["fs2_ms"] + b["generator_ms"] for b in batches)
            / 1e3 / median,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "card": card,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    traced = {"trace_of_texts": len(REQUESTS[-1]), **trace(synth, REQUESTS[-1]), "card": card}
    print(json.dumps(traced), flush=True)
    lines.append(traced)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""How often the card and the CPU pick different hard alignments in the
float32 FastSpeech2 training step, and what that does to its losses.

    python3 alignment_ties.py [--budget-s SECONDS]

Trains ``chip_smoke.py``'s FastSpeech2 (its seeded 512-utterance corpus,
full width, 60 bf16 steps) on the card, then runs ``chip_smoke.py``'s own
check, ``float32_step_card_vs_cpu``, on each batch of 2 of the training set
in turn until the budget is spent: one float32 step of the trained
checkpoint, dropout off, on the card and on the CPU, the CPU taking the
card's path where the two tie; losses and gradient norm within 1e-3. Where the two devices' Viterbi paths part, it
prints one JSON line: the frames they part on, each path's score under the
CPU's log-probabilities, the forward losses' relative differences with
each device on its own path (what the check saw before it shared the
path) and with the CPU on the card's, and the check's result. Last, a
summary line: batches, parted paths, failed checks, the largest
difference a check passed with. Needs a CUDA card; builds the kernels that
``chip_smoke.py``'s phases before training use.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--budget-s", type=float, default=400.0,
                        help="seconds of checks after training")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("alignment_ties.py: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from everyvoice_tpu_torch.config import fs2_training_config
    from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
    from everyvoice_tpu_torch.dataloader.prefetch import to_device
    from everyvoice_tpu_torch.models.fs2 import model as fs2_model
    from everyvoice_tpu_torch.models.fs2.alignment import _masked_log_softmax
    from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
    from everyvoice_tpu_torch.models.layers import Dropout
    from everyvoice_tpu_torch.onchip import card_line, write_seeded_checkpoints
    from everyvoice_tpu_torch.parallel import compress_for_transfer
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint
    from everyvoice_tpu_torch.train.loop import FastSpeech2Trainer, _decompress
    from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader
    from everyvoice_tpu_torch.utils.precision import no_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    for name in ("mrf", "mel"):
        cs.timed_build(name)
    viterbi = fs2_model.viterbi_alignment
    batches = FastSpeech2Dataset.batches
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        _, voc_path = write_seeded_checkpoints(tmp, torch.Generator().manual_seed(0), "cuda")
        prep = cs.preprocess_corpus(tmp, card)
        config = cs.training_config(tmp, prep["cfg"], voc_path, "train")
        ckpt_path = train_text_to_spec(config, log_every=1).ckpt_dir / "last.ckpt"
        config = fs2_training_config(config)
        ckpt = load_checkpoint(ckpt_path)
        hp = ckpt["hyper_parameters"]
        rows = generic_psv_filelist_reader(config["training"]["training_filelist"])
        ds = FastSpeech2Dataset(rows, config, hp["lang2id"], hp["speaker2id"])
        trainers = {}
        for device in ("cuda", "cpu"):
            trainer = FastSpeech2Trainer(config, ds, ds, hp["lang2id"], hp["speaker2id"],
                                         run_dir=tmp / f"ties-{device}", compute_dtype="float32",
                                         device=device)
            for module in trainer.model.modules():
                if isinstance(module, Dropout):
                    module.p = 0.0
            trainer.load_params(ckpt["state_dict"])
            trainer.model.train()
            trainers[device] = trainer

        def losses(device: str, host: dict, path=None) -> tuple:
            trainer = trainers[device]
            batch = _decompress(to_device(host, trainer.device))
            if path is not None:
                fs2_model.viterbi_alignment = lambda *_: path.to(trainer.device)
            try:
                with torch.no_grad(), no_tf32():
                    out = trainer.model(batch["text"], batch["text_lengths"],
                                        **trainer._model_kwargs(batch))
                    terms = compute_fs2_losses(out, batch, trainer._loss_weights(),
                                               mel_loss_kind=config["model"]["mel_loss"],
                                               learn_alignment=config["model"]["learn_alignment"])
            finally:
                fs2_model.viterbi_alignment = viterbi
            return out, {k: v.item() for k, v in terms.items()}, batch

        def rel(a: dict, b: dict) -> dict:
            return {k: abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items()}

        def first_batch_from(skip: int):
            def shifted(self, *a, **k):
                it = batches(self, *a, **k)
                for _ in range(skip):
                    next(it)
                return it
            return shifted

        t0 = time.perf_counter()
        checks, parted_rows = [], []
        for index, host in enumerate(batches(ds, 2, shuffle=False)):
            if time.perf_counter() - t0 > args.budget_s:
                break
            FastSpeech2Dataset.batches = first_batch_from(index)
            try:
                check = cs.float32_step_card_vs_cpu(config, ckpt_path, tmp / f"check-{index}")
                checks.append({"batch": index, "max_rel_diff": check["max_rel_diff"],
                               **check["alignment"]})
            except RuntimeError as e:
                checks.append({"batch": index, "failed": str(e)})
                continue
            finally:
                FastSpeech2Dataset.batches = batches
            if not check["alignment"]["frames_parted"]:
                continue
            host.pop("basenames")
            host = compress_for_transfer(host, ("mel", "attn_prior"))
            out_card, card_losses, _ = losses("cuda", host)
            out_cpu, cpu_losses, batch = losses("cpu", host)
            hard_card, hard_cpu = out_card["attn_hard"].cpu(), out_cpu["attn_hard"]
            logp = _masked_log_softmax(out_cpu["attn_logprob"], batch["text_lengths"]).double()
            _, shared, _ = losses("cpu", host, path=hard_card)
            row = {
                "batch": index,
                "frames_parted": int((hard_card != hard_cpu).any(-1).sum()),
                "logprob_max_diff": float((out_card["attn_logprob"].cpu() - out_cpu["attn_logprob"])
                                          .abs()[batch["attn_prior"] > 0].max()),
                "cpu_score_cpu_path": (logp * hard_cpu).sum(dim=(1, 2)).tolist(),
                "cpu_score_card_path": (logp * hard_card).sum(dim=(1, 2)).tolist(),
                "losses_rel_own_paths": rel(card_losses, cpu_losses),
                "losses_rel_card_path": rel(card_losses, shared),
                "check": checks[-1],
            }
            parted_rows.append(row)
            print("parted " + json.dumps(row), flush=True)
        passed = [c for c in checks if "failed" not in c]
        worst = max(passed, key=lambda c: c["max_rel_diff"], default=None)
        summary = {
            "batches": len(checks), "parted": len(parted_rows),
            "parted_over_1e-3_own_paths": sum(max(r["losses_rel_own_paths"].values()) > 1e-3
                                              for r in parted_rows),
            "checks_failed": [c for c in checks if "failed" in c],
            "check_max_rel_diff": worst,
            "seconds": time.perf_counter() - t0, "card": card,
        }
        print("alignment ties " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Score every training item's losses with a trained FastSpeech2 model, to
find bad data: the port's counterpart of ``everyvoice-tpu check data``
(everyvoice_tpu/cli.py:837-889).

    from everyvoice_tpu_torch.train.check_data import check_data
    rows = check_data(config, "last.ckpt")  # the CUDA card

Each item of the config's training filelist runs alone through the
checkpoint's training forward (target mel, pitch, energy and attention
prior; dropout off; float32) and ``models/fs2/loss.py``; the rows
(``basename`` and every loss) come back sorted by ``total``, worst first.
"""

from __future__ import annotations

from pathlib import Path

import torch

from everyvoice_tpu_torch.dataloader import FastSpeech2Dataset
from everyvoice_tpu_torch.device import resolve_device
from everyvoice_tpu_torch.models.fs2.loss import compute_fs2_losses
from everyvoice_tpu_torch.models.fs2.synthesize import load_fs2_from_checkpoint
from everyvoice_tpu_torch.utils import resolve_filelist_loader


@torch.no_grad()
def check_data(config: dict, model_path: Path | str, device=None) -> list:
    """Per-item losses of ``config``'s training filelist under the model at
    ``model_path``, worst total first. Runs on the CUDA card unless
    ``device`` names the CPU."""
    device = resolve_device(device)
    model, _, text_processor, lang2id, speaker2id = load_fs2_from_checkpoint(
        model_path, "float32", device)
    t = config["training"]
    items = resolve_filelist_loader(t["filelist_loader"])(t["training_filelist"])
    dataset = FastSpeech2Dataset(items, config, lang2id, speaker2id, text_processor=text_processor)
    learn_alignment = config["model"]["learn_alignment"]
    rows = []
    for i in range(len(dataset)):
        item = dataset.load_item(i)
        batch = dataset.pad_batch([item], len(item["text"]), model.max_frames)
        batch.pop("basenames")
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        out = model(b["text"], b["text_lengths"], mel=b["mel"], mel_lengths=b["mel_lengths"],
                    attn_prior=b.get("attn_prior"), pitch=b["pitch"], energy=b["energy"])
        losses = compute_fs2_losses(out, b, {}, learn_alignment=learn_alignment)
        host = torch.stack([v.float().reshape(()) for v in losses.values()]).tolist()
        rows.append({"basename": item["basename"], **dict(zip(losses, host))})
    rows.sort(key=lambda r: -r["total"])
    return rows

"""Host batch helpers of the trainers, for one device (copied from
everyvoice_tpu/parallel/mesh.py). Meshes, FSDP and tensor parallelism are a
later slice of the port."""

from everyvoice_tpu_torch.parallel.batching import (  # noqa: F401
    compress_for_transfer,
    pad_batch_for_eval,
    pad_batch_to_devices,
    stack_batches,
)

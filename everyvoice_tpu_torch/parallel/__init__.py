"""Multi-device training over ``torch.distributed`` (counterpart of
everyvoice_tpu/parallel/): the mesh and its process groups (``mesh``),
parameter layouts for data parallelism, ZeRO-3 and tensor parallelism
(``sharding``), the step's collectives (``collectives``), one worker process
per device (``launch``), and the host batch helpers (``batching``)."""

from everyvoice_tpu_torch.parallel.batching import (  # noqa: F401
    compress_for_transfer,
    pad_batch_for_eval,
    pad_batch_to_devices,
    stack_batches,
)
from everyvoice_tpu_torch.parallel.collectives import (  # noqa: F401
    data_parallel,
    mean_denominator,
)
from everyvoice_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    NODE_AXIS,
    Mesh,
    init_distributed,
    local_rows,
    make_mesh,
    resolve_devices,
    setup_mesh,
    teardown,
)
from everyvoice_tpu_torch.parallel.sharding import (  # noqa: F401
    FS2_PARAM_RULES,
    Placement,
    Strategy,
    fresh_sharded_opt_state,
    fsdp_shardings,
    full_opt_state,
    param_shardings,
    parse_strategy,
    shard_opt_state_like,
    shard_params,
)

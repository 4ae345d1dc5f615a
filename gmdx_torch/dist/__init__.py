"""Multi-process data-parallel training on ``torch.distributed`` (the
counterpart of ``gmdx.dist``'s multihost and data-mesh halves; tensor and
spatial parallelism are not ported yet)."""

from gmdx_torch.dist.mesh import (
    STRATEGIES,
    DataParallel,
    ShardLayout,
    Sharded,
    all_reduce_mean,
    apply_shard_strategy,
    batch_rows,
    check_strategy,
    data_parallel_size,
    randint_rows,
    randn_rows,
    shard_batch,
)
from gmdx_torch.dist.multihost import (
    barrier,
    broadcast_from_main,
    device,
    initialize,
    is_initialized,
    is_main_process,
    local_rank,
    main_process_first,
    rank,
    shutdown,
    world_size,
)

__all__ = [
    "initialize",
    "is_initialized",
    "world_size",
    "rank",
    "local_rank",
    "device",
    "is_main_process",
    "barrier",
    "main_process_first",
    "broadcast_from_main",
    "shutdown",
    "STRATEGIES",
    "check_strategy",
    "data_parallel_size",
    "batch_rows",
    "shard_batch",
    "randn_rows",
    "randint_rows",
    "all_reduce_mean",
    "ShardLayout",
    "Sharded",
    "DataParallel",
    "apply_shard_strategy",
]

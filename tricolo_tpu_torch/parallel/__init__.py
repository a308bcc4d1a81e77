"""Data parallelism over processes, one GPU each.

Port of ``tricolo_tpu.parallel``: the process group and the rank triple
(``multiprocess``), the world in place of the mesh with the config guards
and the model's synchronised BatchNorm and dropout (``world``), the
differentiable collectives with the three contrastive loss forms
(``collectives``), and parameter sharding, replicated or FSDP
(``sharding_rules``) over the world's ``DeviceMesh`` (``mesh``).
"""

from .collectives import (
    all_gather_rows,
    all_reduce_gradients,
    all_reduce_sum,
    broadcast_state,
    make_parallel_loss_fn,
    psum,
)
from .multiprocess import (
    World,
    default_device,
    is_multiprocess,
    local_batch_size,
    maybe_initialize,
    process_count,
    process_index,
)
from .sharding_rules import fsdp_axis, shard_model, sharded_leaves
from .world import attach, check_parallel_config

__all__ = [
    "World",
    "all_gather_rows",
    "all_reduce_gradients",
    "all_reduce_sum",
    "attach",
    "broadcast_state",
    "check_parallel_config",
    "default_device",
    "fsdp_axis",
    "is_multiprocess",
    "local_batch_size",
    "make_parallel_loss_fn",
    "maybe_initialize",
    "process_count",
    "process_index",
    "psum",
    "shard_model",
    "sharded_leaves",
]

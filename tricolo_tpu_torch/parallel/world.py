"""The data-parallel world in place of the JAX mesh.

Port of ``tricolo_tpu.parallel.mesh`` and of the ``param_sharding`` guard:
the JAX package's 1-D data mesh over every device maps onto the process
group, one process per GPU, so ``parallel.data_parallel`` is the world
size ("auto" means it; an int must equal it). ``attach`` makes a model's
train-mode forward compute what pjit computes over the global batch:

* every BatchNorm (the voxel blocks' masked and all-site statistics, the
  image backbones' ``BatchNorm2d``) all-reduces its sums over the ranks
  when the world has more than one, as ``torch.nn.SyncBatchNorm`` does
  (at one rank each normalises as the single-process model does);
* the CLIP heads' dropout and the EfficientNet's stochastic depth draw
  their masks for the global batch and keep the rank's rows.
"""

from __future__ import annotations

from torch import nn

from .multiprocess import World, local_batch_size


def check_parallel_config(cfg, world: World | None) -> None:
    """Refuse what the port does not run: ``param_sharding`` other than
    replicated, a ``data_parallel`` unlike the world size, a global batch
    the world does not divide."""
    par = cfg.parallel
    sharding = par.get("param_sharding", "replicated")
    if sharding != "replicated":
        raise NotImplementedError(
            f"parallel.param_sharding={sharding}: the port replicates parameters (FSDP is "
            "not ported)")
    size = 1 if world is None else world.size
    dp = par.get("data_parallel", "auto")
    if dp not in ("auto", None) and int(dp) != size:
        raise NotImplementedError(
            f"parallel.data_parallel={dp} with a world of {size}: the port runs one process "
            f"per GPU; start {dp} processes with parallel.multiprocess=true (torchrun "
            f"--nproc_per_node={dp}, or the parallel.* rank keys)")
    local_batch_size(cfg.data.batch_size, size)


def attach(model: nn.Module, world: World) -> None:
    """Point ``model``'s BatchNorms and dropout at ``world`` (module
    docstring)."""
    from ..models.common import BatchNorm2d, MLPHead
    from ..models.efficientnet import MBConv
    from ..models.voxel_cnn import ConvBlock

    group = world.group if world.size > 1 else None
    for module in model.modules():
        if isinstance(module, (ConvBlock, BatchNorm2d)):
            module.bn_group = group
        elif isinstance(module, (MLPHead, MBConv)):
            module.rows = (world.rank, world.size)

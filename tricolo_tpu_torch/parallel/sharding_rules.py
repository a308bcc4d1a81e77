"""Parameter sharding: replicated (the default) or FSDP.

Port of ``tricolo_tpu.parallel.sharding_rules``:

* ``"replicated"``: every rank holds every parameter, and the train step
  sums the gradients in one all-reduce (``collectives.all_reduce_gradients``);
* ``"fsdp"``: a parameter of at least ``min_size`` elements is sharded over
  the data-parallel ranks along its largest axis that the world size
  divides (``fsdp_axis``, the JAX package's ``_fsdp_spec`` rule for rule);
  the others stay whole on every rank.

The JAX package places its train state on the mesh and lets XLA insert the
all-gathers and reduce-scatters. The port applies PyTorch's FSDP
(``fully_shard``) to each encoder and then to the root ``TriCoLoNet``
(``shard_model``), over the world's ``DeviceMesh`` (``mesh.data_mesh``):

* each rank holds its shard of every sharded leaf as a ``DTensor``, and so
  the gradient and both Adam moments of that shard alone
  (``training/optim.py`` creates the moments like their parameter, as
  ``_place_opt_state`` places them beside theirs);
* FSDP all-gathers an encoder's parameters before its forward and again
  before its backward (and ``precision.remat_voxel``'s recompute, which
  runs inside that backward);
* the backward reduce-scatters the sharded leaves' gradients as an f32
  SUM over the ranks: a bf16 gradient is rounded once, from the f32 total,
  as ``all_reduce_gradients`` rounds the replicated leaves' and as XLA
  reduces the gradient of a bf16 leaf;
* the leaves the rule keeps whole (``ignored_params``) and every buffer
  (the BN running statistics, replicated like JAX's ``batch_stats``) are
  plain tensors, and the train step all-reduces those leaves' gradients
  as before.

The torch layouts differ from flax's: a Linear is ``(out, in)`` where a
Dense kernel is ``(in, out)``, a 3-D conv ``(O, I, k, k, k)`` where flax's
is ``(k, k, k, I, O)``, and ``nn.GRU`` stacks its three gates in one
matrix. So the axis the rule picks for a port leaf, and which elements a
rank holds, may differ from JAX's for the same weight. The math does not:
every element of a step is computed from the same operands.

Checkpoints, validation and ``Trainer.test`` see full tensors: the
trainer gathers the state with ``gathered`` (every rank, the same order)
and a load puts each rank's shard back with ``placed_like``. Serving loads
a checkpoint into a model of its own, which is never sharded.

With no world (one process), ``"fsdp"`` is the replicated model, as the
JAX package's ``shard_state`` over a one-device mesh is.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from .mesh import data_mesh
from .multiprocess import World

MODES = ("replicated", "fsdp")
MIN_SIZE = 2**16


def fsdp_axis(shape, world_size: int, min_size: int = MIN_SIZE) -> int | None:
    """The axis FSDP shards a leaf of ``shape`` along over ``world_size``
    ranks, or None to keep it whole: whole below ``min_size`` elements;
    otherwise the largest axis ``world_size`` divides, the later one on a
    tie; whole when none divides."""
    shape = tuple(shape)
    if math.prod(shape) < min_size:
        return None
    best = None
    for axis, dim in enumerate(shape):
        if dim % world_size == 0 and (best is None or dim >= shape[best]):
            best = axis
    return best


def shard_model(model: nn.Module, world: World | None, mode: str,
                min_size: int = MIN_SIZE) -> nn.Module:
    """Place ``model``'s parameters by ``mode`` (module docstring), in place;
    ValueError for a mode not in ``MODES``. ``"fsdp"`` with a world shards
    every leaf ``fsdp_axis`` gives an axis over the world's ranks; the model
    must be on its rank's device and, for a fit, ``attach``-ed and
    checked equal across ranks (``broadcast_state``) before."""
    if mode not in MODES:
        raise ValueError(f"unknown param sharding mode: {mode}")
    if mode == "replicated" or world is None:
        return model
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    mesh = data_mesh(world, next(model.parameters()).device.type)
    whole = {p for p in model.parameters() if fsdp_axis(p.shape, world.size, min_size) is None}
    policy = MixedPrecisionPolicy(reduce_dtype=torch.float32)

    def placement(param):
        return Shard(fsdp_axis(param.shape, world.size, min_size))

    names = ("text_encoder", "image_encoder", "voxel_encoder")
    encoders = [m for m in (getattr(model, name, None) for name in names) if m is not None]
    for module in (*encoders, model):
        fully_shard(module, mesh=mesh, shard_placement_fn=placement, mp_policy=policy,
                    ignored_params=whole)
        module.set_gradient_divide_factor(1.0)  # a SUM over the ranks, as the
        module.set_force_sum_reduction_for_comms(True)  # replicated step's
    return model


def sharded_leaves(model: nn.Module) -> dict[str, int]:
    """Each sharded parameter's name and the elements this rank holds."""
    return {name: p.to_local().numel() for name, p in model.named_parameters()
            if isinstance(p, DTensor)}


def full_tensor(t: DTensor) -> torch.Tensor:
    """A sharded leaf's full tensor: the ranks' equal shards (``fsdp_axis``
    shards only an axis the world divides) gathered by ``all_gather`` and
    joined along the shard axis. ``DTensor.full_tensor`` gathers through
    the functional collectives, which gloo cannot run on CUDA tensors."""
    (placement,) = t.placements
    local = t.to_local().contiguous()
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(local) for _ in range(group.size())]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=placement.dim)


def gathered(node):
    """``node`` (a tensor, or dicts and lists of them: a state_dict, an
    optimizer's) with every ``DTensor`` replaced by its full tensor, in the
    nesting's order; a collective on every rank that holds one, so every
    rank calls it on the same structure. Plain tensors pass as they are."""
    if isinstance(node, DTensor):
        return full_tensor(node)
    if isinstance(node, dict):
        return {key: gathered(value) for key, value in node.items()}
    if isinstance(node, list):
        return [gathered(value) for value in node]
    return node


def placed_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full tensor ``value`` placed as ``like`` is: this rank's shard
    as a ``DTensor`` (sliced here, no communication) when ``like`` is one,
    ``value`` itself otherwise."""
    if not isinstance(like, DTensor):
        return value
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(like.device, like.dtype), like.device_mesh,
                             like.placements, src_data_rank=None)

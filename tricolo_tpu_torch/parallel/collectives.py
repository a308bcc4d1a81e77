"""Differentiable collectives and the data-parallel contrastive losses.

Port of ``tricolo_tpu.parallel.collectives``, and of what pjit does for the
JAX package's default path. Each rank backpropagates its own copy of the
loss, and ``make_train_step`` sums the gradients over the ranks, so each
collective's backward is chosen to make that sum the gradient of the
single-process loss:

* ``all_gather_rows(x, world, "slice")``: forward all-gather along rows;
  backward the rank's own rows of the incoming gradient. For a loss that
  every rank computes whole from the gathered rows, that slice is the
  gradient of the rank's rows.
* ``all_gather_rows(x, world, "sum")``: the same forward; backward the sum
  of the incoming gradients over the ranks, then the slice, for a loss of
  which each rank computes a part (the transpose of JAX's ``all_gather``).
* ``all_reduce_sum``: forward and backward both an all-reduce (SUM): the
  batch statistics of BatchNorm over the global batch, whose gradient on
  each rank is the sum of every rank's.
* ``psum``: forward an all-reduce (SUM), backward the identity: the sum of
  the ranks' loss parts, the same value on every rank (JAX's ``psum`` into
  a replicated result).

The three loss forms (``make_parallel_loss_fn``):

* ``parallel.global_negatives=true`` (the default, JAX's pjit path):
  L2-normalise the rank's rows, gather both embeddings and run
  ``losses.make_loss_fn``'s loss at the global batch, through the blocked
  kernels K4-K6 with ``use_pallas``, as pjit runs the blocked Pallas loss
  on batch-sharded inputs. Rows normalise alone, and normalising before
  the gather keeps the graph above each embedding the single-process
  loss's, so at one rank the gradients are its own to the bit;
* ``parallel.explicit_collectives=true`` (``make_global_nt_xent``): each
  rank's (B_local × B_global) logit rows, in plain torch as the JAX
  package computes this form outside any kernel, ``psum`` ÷ B_global;
* ``parallel.global_negatives=false`` (``make_local_nt_xent``): the loss
  over the rank's own batch, then the mean over the ranks.

``loss.name=TripletLoss`` has one form under all three settings, as in the
JAX package, whose trainer builds the local and explicit forms for NT-Xent
only and leaves pjit to compute the triplet loss on the logically global
batch: gather the rank's raw rows (the triplet loss does not normalise)
and run ``triplet_loss`` at B_global.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .multiprocess import World


def _gather(x: torch.Tensor, world: World) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(world.size)]
    dist.all_gather(parts, x.contiguous(), group=world.group)
    return torch.cat(parts)


def _rows(x: torch.Tensor, world: World) -> torch.Tensor:
    n = x.shape[0] // world.size
    return x[world.rank * n:(world.rank + 1) * n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, backward):
        ctx.world, ctx.backward = world, backward
        return _gather(x, world)

    @staticmethod
    def backward(ctx, grad):
        if ctx.backward == "sum":
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.world.group)
        return _rows(grad, ctx.world).contiguous(), None, None


def all_gather_rows(x: torch.Tensor, world: World, backward: str = "slice") -> torch.Tensor:
    """(B_local, …) on each rank → (size·B_local, …), rank order; the
    backward ``"slice"`` or ``"sum"`` (module docstring)."""
    if backward not in ("slice", "sum"):
        raise ValueError(f"backward must be 'slice' or 'sum', got {backward!r}")
    return _GatherRows.apply(x, world, backward)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``group``; the gradient is summed the same way."""
    return _AllReduceSum.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, world: World) -> torch.Tensor:
    """Σ of the ranks' parts of a loss; each rank's gradient flows to its
    own part only."""
    return _Psum.apply(x, world.group)


def _local_direction_loss(z_local, z_other_global, temperature: float, rank: int):
    """The rank's rows' summed −log p(correct) for one direction: row i's
    correct column is rank·B_local + i (JAX ``_local_direction_loss``)."""
    n = z_local.shape[0]
    logprobs = torch.log_softmax(z_local @ z_other_global.T / temperature, dim=1)
    rows = torch.arange(n, device=z_local.device)
    return -logprobs[rows, rank * n + rows].sum()


def make_parallel_loss_fn(cfg, world: World, use_kernels: bool = True) -> Callable:
    """The pair loss of ``world``'s ranks under ``cfg.parallel``: each rank
    calls it on its own (B_local, D) embeddings and gets the global loss."""
    from ..losses import make_loss_fn  # the losses import the models, which import this
    from ..models.common import l2_normalize

    par = cfg.parallel
    if cfg.loss.name == "TripletLoss":
        base = make_loss_fn(cfg)
        return lambda zis, zjs: base(all_gather_rows(zis.float(), world),
                                     all_gather_rows(zjs.float(), world))
    if cfg.loss.name != "NTXentLoss":
        raise ValueError(f"unknown loss: {cfg.loss.name}")
    if not par.get("global_negatives", True):
        base = make_loss_fn(cfg, use_kernels=use_kernels)
        return lambda zis, zjs: psum(base(zis, zjs) / world.size, world)
    if not par.get("explicit_collectives", False):
        base = make_loss_fn(cfg, use_kernels=use_kernels, norm=False)

        def gathered(zis, zjs):
            zis, zjs = (all_gather_rows(l2_normalize(z.float()), world) for z in (zis, zjs))
            return base(zis, zjs)

        return gathered
    params = cfg.loss.NTXentLoss
    temperature, alpha = params.temperature, params.alpha_weight

    def explicit(zis, zjs):
        zis, zjs = l2_normalize(zis.float()), l2_normalize(zjs.float())
        zis_all = all_gather_rows(zis, world, "sum")
        zjs_all = all_gather_rows(zjs, world, "sum")
        batch = zis_all.shape[0]
        loss_a = psum(_local_direction_loss(zis, zjs_all, temperature, world.rank), world)
        loss_b = psum(_local_direction_loss(zjs, zis_all, temperature, world.rank), world)
        return alpha * loss_a / batch + (1.0 - alpha) * loss_b / batch

    return explicit


def sum_over_ranks(tensors, group) -> tuple:
    """The f32 ``tensors`` summed over ``group``'s ranks in one all-reduce
    over a flat buffer (not differentiable); as they are when ``group`` is
    None (one process)."""
    if group is None:
        return tuple(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return tuple(part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                     tensors))


def all_reduce_gradients(params, world: World) -> None:
    """Sum every parameter's ``.grad`` over the ranks in place (the ranks
    hold the same parameters with grads)."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        for grad, total in zip(grads, sum_over_ranks(grads, world.group)):
            grad.copy_(total)


def broadcast_state(module: torch.nn.Module, world: World) -> None:
    """Give every rank rank 0's parameters and buffers, and check that they
    were already equal (every rank initialises from ``train_seed``):
    RuntimeError names the first tensor that was not."""
    for name, tensor in module.state_dict().items():
        theirs = tensor.detach().clone()
        dist.broadcast(theirs, src=0, group=world.group)
        if not torch.equal(theirs, tensor):
            raise RuntimeError(f"rank {world.rank} initialised {name} unlike rank 0; "
                               "every rank must start from the same train_seed")

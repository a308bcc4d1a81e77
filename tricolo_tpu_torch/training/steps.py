"""The train step.

Port of ``tricolo_tpu.training.steps.make_train_step``: prepare the device
batch (normalise the images, densify packed or dense voxels), run the
forward in train mode under the compute dtype (bf16 autocast when
``precision.compute_dtype=bfloat16``, as ``inference.eval_step`` does),
compute the pairwise contrastive losses in f32 outside autocast,
backpropagate, set the step's learning rate and take one Adam step
(``training.optim.Adam``, the JAX step in each leaf's dtype: the gradient
of a bf16 parameter stays bf16, as JAX's cotangent of a bf16 leaf). BN
running statistics are updated by the forward (``models/voxel_cnn.py``,
``models/resnet.py``). The CLIP heads' dropout draws its masks from the
generator the caller passes; ``dropout_generator(train_seed, step)`` seeds
one from the global step count, as the JAX step folds ``state.step`` into
its dropout key, so a resumed run draws the masks of an uninterrupted one.
The masks are the port's own stream, not the JAX package's threefry bits.

With a data-parallel ``world`` (``parallel.maybe_initialize``) each rank
runs the step on its stripe of the global batch: the pair loss is
``parallel.make_parallel_loss_fn``'s form of ``cfg.parallel`` (by default
the loss at the global batch over the gathered embeddings), the model's
BatchNorms and dropout span the global batch (``parallel.attach``), and
after the backward one all-reduce sums the gradients over the ranks, so
every rank takes the same Adam step as one process on the global batch.
Under ``parallel.param_sharding=fsdp`` (``parallel.shard_model``, applied
before the step is made, so the step holds the sharded parameters) the
order is: FSDP's reduce-scatter of the sharded leaves' gradients inside the
backward, then the all-reduce of the leaves kept whole, then Adam on each
rank's shards.

The step is traced (``tracing``) as the span ``step``, which records its
kernel launches (the ``launches.*`` counters), with the children
``step.prepare``, ``forward.<encoder>`` (``TriCoLoNet.forward``),
``loss.forward``, ``backward`` (``backward.loss``, then each encoder's
``backward.<encoder>`` as the engine reaches it), ``all_reduce`` (data
parallel) and ``optimizer``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..inference import autocast, prepare_inputs
from ..losses import make_loss_fn, pairwise_losses
from ..parallel import all_reduce_gradients, make_parallel_loss_fn


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, global ``step``)."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 32 | int(words[1]))


def make_train_step(model, optimizer, cfg, use_kernels: bool = True,
                    world=None) -> Callable:
    """``step(device_batch, lr, generator=None) -> loss_dict`` (detached
    f32 scalars named ``train_loss/{a}_{b}_loss`` and
    ``train_loss/total_loss``); ``generator`` is the dropout masks' source,
    which a model with the CLIP heads needs (``dropout_generator``).
    ``use_kernels=False`` keeps the loss on the blocked kernels' plain
    versions (the voxel encoder has its own ``use_kernels``). ``world``:
    the data-parallel world (module docstring; the model must be
    ``parallel.attach``-ed to it)."""
    if world is not None:
        loss_pair = make_parallel_loss_fn(cfg, world, use_kernels=use_kernels)
    else:
        loss_pair = make_loss_fn(cfg, use_kernels=use_kernels)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: dict, lr: float, generator: torch.Generator | None = None) -> dict:
        with tracing.span("step", counters="launches."):
            model.train()
            with tracing.span("step.prepare"):
                inputs = prepare_inputs(model, batch)
            with autocast(model, batch["tokens"].device.type):
                output = model(inputs, generator)
            with tracing.span("loss.forward"):
                output = {k: v.float() for k, v in output.items()}
                loss_dict = pairwise_losses(loss_pair, output, "train_loss")
            optimizer.zero_grad(set_to_none=True)
            tracing.backward(loss_dict["train_loss/total_loss"])
            if world is not None:
                with tracing.span("all_reduce"):
                    all_reduce_gradients(params, world)
            for group in optimizer.param_groups:
                group["lr"] = lr
            with tracing.span("optimizer"):
                optimizer.step()
            return {k: v.detach() for k, v in loss_dict.items()}

    return train_step

"""The train step.

Port of ``tricolo_tpu.training.steps.make_train_step``: prepare the device
batch (normalise the images, densify packed or dense voxels), run the
forward in train mode under the compute dtype (bf16 autocast when
``precision.compute_dtype=bfloat16``, as ``inference.eval_step`` does),
compute the pairwise contrastive losses in f32 outside autocast,
backpropagate, set the step's learning rate and take one Adam step. BN
running statistics are updated by the forward (``models/voxel_cnn.py``,
``models/resnet.py``). The CLIP heads' dropout draws its masks from the
generator the caller passes; ``dropout_generator(train_seed, step)`` seeds
one from the global step count, as the JAX step folds ``state.step`` into
its dropout key, so a resumed run draws the masks of an uninterrupted one.
The masks are the port's own stream, not the JAX package's threefry bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..inference import autocast, prepare_inputs
from ..losses import make_loss_fn, pairwise_losses


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, global ``step``)."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 32 | int(words[1]))


def make_train_step(model, optimizer, cfg, use_kernels: bool = True) -> Callable:
    """``step(device_batch, lr, generator=None) -> loss_dict`` (detached
    f32 scalars named ``train_loss/{a}_{b}_loss`` and
    ``train_loss/total_loss``); ``generator`` is the dropout masks' source,
    which a model with the CLIP heads needs (``dropout_generator``).
    ``use_kernels=False`` keeps the loss on the blocked kernels' plain
    versions (the voxel encoder has its own ``use_kernels``)."""
    loss_pair = make_loss_fn(cfg, use_kernels=use_kernels)

    def train_step(batch: dict, lr: float, generator: torch.Generator | None = None) -> dict:
        model.train()
        inputs = prepare_inputs(model, batch)
        with autocast(model, batch["tokens"].device.type):
            output = model(inputs, generator)
        output = {k: v.float() for k, v in output.items()}
        loss_dict = pairwise_losses(loss_pair, output, "train_loss")
        optimizer.zero_grad(set_to_none=True)
        loss_dict["train_loss/total_loss"].backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    return train_step

"""The train step.

Port of ``tricolo_tpu.training.steps.make_train_step``: prepare the device
batch (normalise the images, densify packed or dense voxels), run the
forward in train mode under the compute dtype (bf16 autocast when
``precision.compute_dtype=bfloat16``, as ``inference.eval_step`` does),
compute the pairwise contrastive losses in f32 outside autocast,
backpropagate, set the step's learning rate and take one Adam step. BN
running statistics are updated by the forward (``models/voxel_cnn.py``,
``models/resnet.py``).
"""

from __future__ import annotations

from typing import Callable

from ..inference import autocast, prepare_inputs
from ..losses import make_loss_fn, pairwise_losses


def make_train_step(model, optimizer, cfg, use_kernels: bool = True) -> Callable:
    """``step(device_batch, lr) -> loss_dict`` (detached f32 scalars named
    ``train_loss/{a}_{b}_loss`` and ``train_loss/total_loss``).
    ``use_kernels=False`` keeps the loss on the blocked kernels' plain
    versions (the voxel encoder has its own ``use_kernels``)."""
    loss_pair = make_loss_fn(cfg, use_kernels=use_kernels)

    def train_step(batch: dict, lr: float) -> dict:
        model.train()
        inputs = prepare_inputs(model, batch)
        with autocast(model, batch["tokens"].device.type):
            output = model(inputs)
        output = {k: v.float() for k, v in output.items()}
        loss_dict = pairwise_losses(loss_pair, output, "train_loss")
        optimizer.zero_grad(set_to_none=True)
        loss_dict["train_loss/total_loss"].backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    return train_step

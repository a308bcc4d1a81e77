"""Eval step, shape embedding and embedding collection.

Port of the serving half of ``tricolo_tpu.training``: ``eval_step`` is
``make_eval_step`` without the loss (``prepare_device_batch`` on the
device — normalize images, densify packed or dense voxels — then the
forward with running statistics in the compute dtype — bf16 autocast when
``precision.compute_dtype=bfloat16`` — and float32 features out),
``shape_embedding_sum`` is ``steps.shape_embedding_sum`` and
``collect_embeddings`` is ``Trainer.collect_embeddings`` (padded tail rows
dropped through ``num_valid``).
"""

from __future__ import annotations

import torch

from .data.device_prep import prepare_device_batch
from .data.loader import ARRAY_DTYPES, host_tensor
from .losses import pairwise_losses


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises rather than
    running on the CPU when no GPU is present and the CPU was not asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tricolo_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_device_batch(batch: dict, device: torch.device) -> dict:
    """Host batch → tensors on ``device``: tokens, images, the voxel keys
    of the batch's transfer (packed u32 words travel as their int32 bit
    view) and the precached CLIP features — every key of
    ``data.loader.ARRAY_DTYPES`` the batch holds. The arrays are numpy
    arrays or, from a ``pin_memory`` loader, page-locked CPU tensors; a
    pinned tensor goes to a CUDA device with ``non_blocking=True``
    (PyTorch keeps its buffer until the copy has run).
    ``to_device_batch.copies`` counts the arrays sent to a CUDA device from
    pinned and from pageable memory."""
    out = {}
    for key in ARRAY_DTYPES:
        if key not in batch:
            continue
        value = batch[key]
        tensor = value if isinstance(value, torch.Tensor) else host_tensor(key, value)
        pinned = device.type == "cuda" and tensor.is_pinned()
        if device.type == "cuda":
            to_device_batch.copies["pinned" if pinned else "pageable"] += 1
        out[key] = tensor.to(device, non_blocking=pinned)
    return out


to_device_batch.copies = {"pinned": 0, "pageable": 0}


def prepare_inputs(model, batch: dict) -> dict:
    """``prepare_device_batch`` in the model's compute dtype and grid."""
    voxel_size = model.voxel_encoder.voxel_size if model.voxel_encoder is not None else 0
    return prepare_device_batch(batch, voxel_size, model.compute_dtype)


def autocast(model, device_type: str):
    """bf16 autocast when the model computes in bf16; off in f32."""
    dtype = model.compute_dtype
    return torch.autocast(device_type, dtype=dtype, enabled=dtype != torch.float32)


@torch.no_grad()
def eval_step(model, batch: dict) -> dict:
    """Device batch → float32 features (running-statistics forward)."""
    inputs = prepare_inputs(model, batch)
    with autocast(model, batch["tokens"].device.type):
        output = model(inputs)
    return {k: v.float() for k, v in output.items()}


def shape_embedding_sum(output: dict) -> torch.Tensor:
    """Shape embedding = image + voxel features (unnormalized sum, zeros
    template from the text features — the reference's quirk)."""
    shape = torch.zeros_like(output["text_features"])
    if "image_features" in output:
        shape = shape + output["image_features"]
    if "voxel_features" in output:
        shape = shape + output["voxel_features"]
    return shape


def collect_embeddings(model, loader, device: torch.device, loss_fn=None):
    """Run the eval step over a loader → ``(embeddings, val_losses)``:
    the evaluator's caption-tuple dict ``{"caption_embedding_tuples":
    [(None, category, model_id, text, shape)]}`` and, with ``loss_fn`` (a
    pair loss, ``losses.make_loss_fn``), ``pairwise_losses(...,
    "val_loss")`` of each batch's features averaged over the *full* batches
    only — a padded tail batch's repeated rows would act as false negatives
    (the JAX ``Trainer.collect_embeddings(with_loss=True)``). Without
    ``loss_fn`` the losses are ``{}``."""
    model.eval()
    tuples = []
    totals: dict[str, float] = {}
    n_loss_batches = 0
    for batch in loader:
        output = eval_step(model, to_device_batch(batch, device))
        n_valid = batch["num_valid"]
        text = output["text_features"][:n_valid].cpu().numpy()
        shape = shape_embedding_sum(output)[:n_valid].cpu().numpy()
        for i in range(n_valid):
            tuples.append(
                (None, batch["category"][i], batch["model_id"][i], text[i], shape[i])
            )
        if loss_fn is not None and n_valid == loader.batch_size:
            n_loss_batches += 1
            with torch.no_grad():
                for key, value in pairwise_losses(loss_fn, output, "val_loss").items():
                    totals[key] = totals.get(key, 0.0) + float(value)
    embeddings = {"caption_embedding_tuples": tuples}
    return embeddings, {k: v / max(n_loss_batches, 1) for k, v in totals.items()}

"""Eval step, shape embedding and embedding collection.

Port of the serving half of ``tricolo_tpu.training``: ``eval_step`` is
``make_eval_step`` without the loss (normalize images, forward with
running statistics in the compute dtype — bf16 autocast when
``precision.compute_dtype=bfloat16`` — and return float32 features),
``shape_embedding_sum`` is ``steps.shape_embedding_sum`` and
``collect_embeddings`` is ``Trainer.collect_embeddings`` (padded tail rows
dropped through ``num_valid``).
"""

from __future__ import annotations

import numpy as np
import torch

from .data.device_prep import normalize_images


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
    """Host numpy batch → tensors on ``device`` (packed u32 rows travel as
    their int32 bit view)."""
    out = {"tokens": torch.from_numpy(np.asarray(batch["tokens"], np.int32)).to(device)}
    if "images" in batch:
        out["images"] = torch.from_numpy(np.asarray(batch["images"])).to(device)
    if "voxel_rows" in batch:
        rows = np.ascontiguousarray(batch["voxel_rows"], np.uint32).view(np.int32)
        out["voxel_rows"] = torch.from_numpy(rows).to(device)
        out["voxel_row_ids"] = torch.from_numpy(
            np.asarray(batch["voxel_row_ids"], np.int32)
        ).to(device)
    return out


def autocast(model, device_type: str):
    """bf16 autocast when the model computes in bf16; off in f32."""
    dtype = model.compute_dtype
    return torch.autocast(device_type, dtype=dtype, enabled=dtype != torch.float32)


@torch.no_grad()
def eval_step(model, batch: dict) -> dict:
    """Device batch → float32 features (running-statistics forward)."""
    inputs = dict(batch)
    if "images" in inputs:
        inputs["images"] = normalize_images(inputs["images"], model.compute_dtype)
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


def collect_embeddings(model, loader, device: torch.device) -> dict:
    """Run the eval step over a loader → the evaluator's caption-tuple dict
    ``{"caption_embedding_tuples": [(None, category, model_id, text, shape)]}``."""
    model.eval()
    tuples = []
    for batch in loader:
        output = eval_step(model, to_device_batch(batch, device))
        n_valid = batch["num_valid"]
        text = output["text_features"][:n_valid].cpu().numpy()
        shape = shape_embedding_sum(output)[:n_valid].cpu().numpy()
        for i in range(n_valid):
            tuples.append(
                (None, batch["category"][i], batch["model_id"][i], text[i], shape[i])
            )
    return {"caption_embedding_tuples": tuples}

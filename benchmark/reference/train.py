"""The reference's training steps: forward, NT-Xent over every pair of
modalities, backward and torch's Adam, in float32.

``follow`` takes the benchmark's initial weights and the raw batches of the
compared steps and returns what the comparison reads:

* ``loss``: each step's total loss (the sum over the pairs, in the order
  text → image → voxel);
* ``emb``: each encoder's embeddings at the first step;
* ``grad``: each trainable leaf's norm of the first gradient as Adam takes
  it (the gradient plus weight decay times the weight);
* ``grad_abs``: the same norm of the plain gradient (the rule that leaves
  a leaf whose gradient is nought to rounding out of ``change``);
* ``change``: each leaf's and running statistic's norm of its change over
  the steps;
* ``ndim``: each leaf's number of dimensions.

Adam is ``torch.optim.Adam``'s formula with coupled weight decay:
g ← g + wd·p; m ← b1·m + (1 − b1)·g; v ← b2·v + (1 − b2)·g²;
p ← p − lr/(1 − b1ᵗ) · m / (√v / √(1 − b2ᵗ) + eps). TF32 is off while it
runs. ``q`` rounds the operands of convolutions and matrix products
(``precision.fp8`` for the control); ``rows`` keeps only the first rows of
each batch (a planted fault: half the batch left out). With
``reference_voxel_block`` in ``hyper`` (the configuration's ``train``), the
voxel encoder runs over blocks of that many samples
(``Model.voxel_blocked``), for a configuration whose whole-batch graph
does not fit the card.
"""

from __future__ import annotations

import contextlib
import math
from itertools import combinations

import numpy as np
import torch

from .batch import dense_voxels, packed_grid
from .model import Model, identity, nt_xent, running, trainable


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encode(model: Model, m: dict, items: list, device, block: int | None = None) -> dict:
    tokens = torch.from_numpy(np.stack([it["tokens"] for it in items]))
    out = {"text": model.text(tokens.long().to(device))}
    if m["image"]:
        images = torch.from_numpy(np.stack([it["images"] for it in items]))
        out["image"] = model.image(images.to(device))
    if m["voxel"]:
        rgb, occupied = dense_voxels(packed_grid(items, m["voxel_size"], device))
        out["voxel"] = (model.voxel_blocked(rgb, occupied, int(block)) if block
                        else model.voxel(rgb, occupied))
    return out


def total_loss(emb: dict, hyper: dict) -> torch.Tensor:
    return sum(nt_xent(emb[a], emb[b], hyper["temperature"], hyper["alpha"])
               for a, b in combinations(emb.keys(), 2))


def follow(m: dict, hyper: dict, specs: list, weights0: dict, batches: list, device,
           q=identity, rows: int | None = None, frozen: bool = False) -> dict:
    """``batches``: one list of raw items a step (module docstring).
    ``frozen`` plants the fault of a step that leaves its state unchanged:
    no update of the weights, of Adam's moments or of the running
    statistics."""
    names, stats_names = trainable(specs), running(specs)
    w = {n: weights0[n].detach().clone().float().requires_grad_(True) for n in names}
    stats = {n: weights0[n].detach().clone().float() for n in stats_names}
    mom = {n: torch.zeros_like(w[n]) for n in names}
    vel = {n: torch.zeros_like(w[n]) for n in names}
    b1, b2 = hyper["betas"]
    lr, wd, eps = hyper["lr"], hyper["weight_decay"], hyper["eps"]
    out = {"loss": [], "emb": {}, "grad": {}, "grad_abs": {}, "change": {},
           "ndim": {name: len(shape) for name, shape, *_ in specs}}
    with no_tf32():
        for t, items in enumerate(batches, start=1):
            items = items[:rows] if rows else items
            model = Model(m, w, stats if not frozen else dict(stats), q)
            emb = encode(model, m, items, device, hyper.get("reference_voxel_block"))
            loss = total_loss(emb, hyper)
            grads = torch.autograd.grad(loss, [w[n] for n in names])
            out["loss"].append(float(loss.detach()))
            if t == 1:
                out["emb"] = {k: v.detach().float().cpu() for k, v in emb.items()}
            del emb, loss
            if frozen:
                out["grad"] = out["grad"] or dict.fromkeys(names, 0.0)
                out["grad_abs"] = out["grad_abs"] or {n: float(g.norm()) for n, g in zip(names, grads)}
                continue
            with torch.no_grad():
                for n, g in zip(names, grads):
                    p = w[n]
                    if t == 1:
                        out["grad_abs"][n] = float(g.norm())
                    g = g + wd * p
                    if t == 1:
                        out["grad"][n] = float(g.norm())
                    mom[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    vel[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = vel[n].sqrt() / math.sqrt(1.0 - b2 ** t) + eps
                    p.sub_(lr / (1.0 - b1 ** t) * mom[n] / denom)
            del grads
    with torch.no_grad():
        for n in names:
            out["change"][n] = float((w[n] - weights0[n].float()).norm())
        for n in stats_names:
            out["change"][n] = float((stats[n] - weights0[n].float()).norm())
    return out

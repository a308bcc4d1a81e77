"""Contrastive losses and the pairwise combination rule.

Port of ``tricolo_tpu.losses``: ``make_loss_fn`` builds the configured
pair loss — for ``loss.name=NTXentLoss`` the plain ``nt_xent_loss``, or
with ``loss.NTXentLoss.use_pallas=true`` the blocked kernels K4-K6
(``ops.blocked_nt_xent_loss``); for ``loss.name=TripletLoss`` the
semi-hard ``triplet_loss`` (``loss.TripletLoss.margin``) — and
``pairwise_losses`` applies it to every pair of present modality features
in insertion order (text → image → voxel), named
``{prefix}/{a}_{b}_loss`` with ``{prefix}/total_loss`` their sum.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable

import torch

from .nt_xent import nt_xent_loss, soft_xent
from .triplet import pairwise_distances, triplet_loss

__all__ = ["make_loss_fn", "nt_xent_loss", "pairwise_distances", "pairwise_losses",
           "soft_xent", "triplet_loss"]


def make_loss_fn(cfg, use_kernels: bool = True,
                 norm: bool = True) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The configured pairwise loss (the train step's, and ``Trainer``'s
    validation losses). For NT-Xent, ``use_kernels=False`` keeps the
    blocked loss on its kernels' plain versions (the reference path on the
    card) and ``norm=False`` takes embeddings already L2-normalised. Neither
    applies to the triplet loss, which has no kernel and never normalises:
    it ignores both. An unknown ``loss.name`` raises ValueError."""
    name = cfg.loss.name
    if name == "TripletLoss":
        margin = cfg.loss.TripletLoss.margin
        return lambda a, b: triplet_loss(a, b, margin)
    if name != "NTXentLoss":
        raise ValueError(f"unknown loss: {name}")
    params = cfg.loss.NTXentLoss
    temperature, alpha = params.temperature, params.alpha_weight
    if params.get("use_pallas", False):
        from ..ops.nt_xent import blocked_nt_xent_loss

        return lambda a, b: blocked_nt_xent_loss(a, b, temperature, alpha, norm,
                                                 use_kernels=use_kernels)
    return lambda a, b: nt_xent_loss(a, b, temperature, alpha, norm)


def pairwise_losses(loss_fn, output: dict, prefix: str) -> dict:
    """Sum the loss over all pairs of present modality features."""
    if len(output) < 2:
        raise ValueError(
            "contrastive training needs at least two modalities; configure an "
            "image and/or voxel encoder alongside the text encoder"
        )
    loss_dict = {}
    for key_a, key_b in combinations(output.keys(), 2):
        # "text_features" → "text"
        loss_dict[f"{prefix}/{key_a[:-9]}_{key_b[:-9]}_loss"] = loss_fn(output[key_a],
                                                                         output[key_b])
    loss_dict[f"{prefix}/total_loss"] = sum(loss_dict.values())
    return loss_dict

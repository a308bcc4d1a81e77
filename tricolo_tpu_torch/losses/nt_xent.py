"""Bidirectional NT-Xent (InfoNCE) contrastive loss, plain PyTorch.

Port of ``tricolo_tpu.losses.nt_xent`` (the loss the JAX package runs when
``loss.NTXentLoss.use_pallas=false``): both sides L2-normalised, logits
``zi·zjᵀ/τ`` in both directions, identity targets, soft cross-entropy
``sum(−targets·log_softmax)/B``, combined as ``α·loss_ab + (1−α)·loss_ba``.
All in f32.
"""

from __future__ import annotations

import torch

from ..models.common import l2_normalize


def soft_xent(targets: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """sum(-targets * log_softmax(logits)) / batch."""
    logprobs = torch.log_softmax(logits, dim=1)
    return -(targets * logprobs).sum() / logits.shape[0]


def nt_xent_loss(zis: torch.Tensor, zjs: torch.Tensor, temperature: float = 0.1,
                 alpha_weight: float = 0.25, norm: bool = True) -> torch.Tensor:
    """NT-Xent between two modality embedding batches of shape (B, D)."""
    zis, zjs = zis.float(), zjs.float()
    if norm:
        zis, zjs = l2_normalize(zis), l2_normalize(zjs)
    labels = torch.eye(zis.shape[0], dtype=torch.float32, device=zis.device)
    loss_a = soft_xent(labels, (zis @ zjs.T) / temperature)
    loss_b = soft_xent(labels, (zjs @ zis.T) / temperature)
    return alpha_weight * loss_a + (1.0 - alpha_weight) * loss_b

"""Shared model building blocks.

Port of ``tricolo_tpu.models.common``: ``TorchLinear`` is ``nn.Linear``
(the JAX package re-created torch's default init; here it is the default),
``MLPHead`` is Linear → ReLU → Linear, ``l2_normalize`` matches
``F.normalize`` with eps 1e-12.
"""

from __future__ import annotations

import torch
from torch import nn


class MLPHead(nn.Module):
    """Linear → ReLU → Linear projection head (no dropout on this path)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(‖x‖₂, eps) along ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def fold_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, ...) → (B·V, ...) for shared per-view backbones."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

"""Shared model building blocks.

Port of ``tricolo_tpu.models.common``: ``TorchLinear`` is ``nn.Linear``
(the JAX package re-created torch's default init; here it is the default),
``MLPHead`` is Linear → ReLU → [Dropout] → Linear, ``dropout`` is flax's
``nn.Dropout`` with its masks drawn from a caller's ``torch.Generator``,
``l2_normalize`` matches ``F.normalize`` with eps 1e-12.
"""

from __future__ import annotations

import torch
from torch import nn


class MLPHead(nn.Module):
    """Linear → ReLU → [Dropout] → Linear projection head.

    The MVCNN and voxel heads have ``dropout`` 0; the CLIP heads 0.1. The
    dropout acts in train mode only, with masks drawn from the ``generator``
    passed to ``forward`` (never the global RNG); in eval mode, and at 0,
    it is the identity. ``rows`` = (rank, ranks): the masks are drawn for
    the global batch and this rank's rows kept (``parallel.attach``)."""

    rows = (0, 1)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.fc1(x))
        if self.training and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator, self.rows)
        return self.fc2(x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            rows: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    1 − ``rate``, scaled by 1 / (1 − ``rate``); the uniform draws come from
    ``generator`` (on ``x``'s device), which a train-mode caller must pass.
    ``rows`` = (rank, ranks): ``x`` is rank's stripe of a global batch of
    ranks·len(x) rows, whose draws are made whole and sliced, so the ranks
    together draw the masks of one process on the global batch."""
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator; "
                         "pass one (training.steps.dropout_generator)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    rank, ranks = rows
    n = x.shape[0]
    draws = torch.rand((n * ranks, *x.shape[1:]), generator=generator, device=x.device)
    keep = draws[rank * n:(rank + 1) * n] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(‖x‖₂, eps) along ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def fold_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, ...) → (B·V, ...) for shared per-view backbones."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

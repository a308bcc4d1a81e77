"""Shared model building blocks.

Port of ``tricolo_tpu.models.common``: ``TorchLinear`` is ``nn.Linear``
(the JAX package re-created torch's default init; here it is the default),
``MLPHead`` is Linear → ReLU → [Dropout] → Linear, ``dropout`` is flax's
``nn.Dropout`` with its masks drawn from a caller's ``torch.Generator``
(``stochastic_depth`` its per-sample form), ``l2_normalize`` matches
``F.normalize`` with eps 1e-12. ``BatchNorm2d`` is flax ``nn.BatchNorm``
for the image backbones (ResNet, EfficientNet).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax ``nn.BatchNorm``.

    In eval mode it is torch's own (running statistics); in train mode it
    normalises with the batch statistics and updates its running buffers as
    flax does: ``running = momentum·running + (1 − momentum)·batch`` with the
    flax ``momentum`` (0.9 for the ResNets, 0.99 for EfficientNet) and the
    *biased* batch variance (torch's module would use the unbiased one).
    ``bn_group``: the process group whose global batch the statistics span
    (``parallel.attach``, more than one rank); then they are the global
    batch's, as pjit computes them, in f32 plain torch and two passes: the
    mean from Σx, then the biased variance from Σ(x − mean)², each sum
    through a differentiable all-reduce (whose backward sums the ranks'
    cotangents); each rank's dγ, dβ stay its own sums. Two passes, because
    E[x²] − mean² loses the variance to cancellation where a channel's mean
    dwarfs its spread over the batch."""

    bn_group = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.bn_group is not None:
            return self._global_batch_norm(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.eps)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.collectives import all_reduce_sum

        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        x32 = x.float()
        total = all_reduce_sum(torch.cat([x32.sum(dim=dims),
                                          x32.new_tensor([x.numel() // x.shape[1]])]),
                               self.bn_group)
        count = total[-1].detach()
        mean = total[:-1] / count
        centred = x32 - mean.view(shape)
        var = all_reduce_sum(centred.square().sum(dim=dims), self.bn_group) / count
        self.update_running(mean, var)
        out = centred * torch.rsqrt(var + self.eps).view(shape)
        return (out * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


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


def stochastic_depth(x: torch.Tensor, rate: float, generator: torch.Generator | None,
                     rows: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Drop-connect on a residual branch in train mode: keep each sample
    (row of ``x``) with probability 1 − ``rate``, scaled by 1 / (1 −
    ``rate``), as the JAX EfficientNet's per-sample Bernoulli of shape
    (N, 1, 1, 1). The draws come from ``generator`` (which a train-mode
    caller must pass) and, as in ``dropout``, ``rows`` = (rank, ranks) draws
    them for the global batch and keeps the rank's stripe."""
    if generator is None:
        raise ValueError("stochastic depth in train mode draws from an explicit "
                         "torch.Generator; pass one (training.steps.dropout_generator)")
    keep = 1.0 - rate
    rank, ranks = rows
    n = x.shape[0]
    draws = torch.rand((n * ranks,), generator=generator, device=x.device)
    mask = (draws[rank * n:(rank + 1) * n] < keep).to(x.dtype).view(n, *[1] * (x.dim() - 1))
    return x * mask / keep


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(‖x‖₂, eps) along ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def fold_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, ...) → (B·V, ...) for shared per-view backbones."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

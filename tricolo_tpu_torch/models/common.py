"""Shared model building blocks.

Port of ``tricolo_tpu.models.common``: ``TorchLinear`` is ``Linear``
(the JAX package re-created torch's default init; here it is the default),
``MLPHead`` is Linear → ReLU → [Dropout] → Linear, ``dropout`` is flax's
``nn.Dropout`` with its masks drawn from a caller's ``torch.Generator``
(``stochastic_depth`` its per-sample form), ``l2_normalize`` matches
``F.normalize`` with eps 1e-12. ``BatchNorm2d`` is flax ``nn.BatchNorm``
for the image backbones (ResNet, EfficientNet).

Parameter and compute dtypes (``precision.param_dtype`` and
``compute_dtype``) are flax's ``param_dtype``/``dtype`` pair: a module
holds its parameters in the parameter dtype, created in it (``dtype=``
factory arguments), and uses them in the compute dtype. The compute dtype
is bf16 autocast or none (f32); ``in_compute`` is the one rule: under
autocast a parameter goes in as it is (autocast casts it where an op
computes in bf16), outside it a bf16 parameter is widened to f32 in the
forward. The leaf stays bf16, so its gradient comes back in bf16, as JAX's
cotangent of a bf16 leaf does. ``Linear`` and ``Conv2d`` apply it to
their weight and bias. A BatchNorm's γ, β take the parameter dtype and its
running statistics stay f32 (``hold_affine_in``); it normalises with γ, β
widened to f32, as flax's ``_normalize`` promotes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def widen(t: torch.Tensor | None) -> torch.Tensor | None:
    """A bf16 tensor as f32 (differentiable); any other as it is."""
    return t.float() if t is not None and t.dtype == torch.bfloat16 else t


def in_compute(t: torch.Tensor | None) -> torch.Tensor | None:
    """A parameter as the compute dtype uses it: as it is under autocast,
    widened from bf16 to f32 without (module docstring)."""
    if t is None or torch.is_autocast_enabled(t.device.type):
        return t
    return widen(t)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias enter through ``in_compute``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, in_compute(self.weight), in_compute(self.bias))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias enter through ``in_compute``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, in_compute(self.weight), in_compute(self.bias))


def hold_affine_in(bn: nn.modules.batchnorm._BatchNorm, dtype) -> None:
    """Make a BatchNorm's γ, β parameters of ``dtype`` (their init, ones
    and zeros, in it); its running statistics stay f32."""
    if dtype != bn.weight.dtype:
        bn.weight = nn.Parameter(torch.ones(bn.num_features, dtype=dtype))
        bn.bias = nn.Parameter(torch.zeros(bn.num_features, dtype=dtype))


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
    dwarfs its spread over the batch. γ, β are of ``param_dtype`` and
    enter every form widened to f32; the running statistics are f32."""

    bn_group = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9,
                 param_dtype=torch.float32):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
        hold_affine_in(self, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = widen(self.weight), widen(self.bias)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias,
                                training=False, eps=self.eps)
        if self.bn_group is not None:
            return self._global_batch_norm(x, weight, bias)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.update_running(mean, var)
        return F.batch_norm(x, None, None, weight, bias, training=True, eps=self.eps)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def _global_batch_norm(self, x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
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
        return (out * weight.view(shape) + bias.view(shape)).to(x.dtype)


class MLPHead(nn.Module):
    """Linear → ReLU → [Dropout] → Linear projection head.

    The MVCNN and voxel heads have ``dropout`` 0; the CLIP heads 0.1. The
    dropout acts in train mode only, with masks drawn from the ``generator``
    passed to ``forward`` (never the global RNG); in eval mode, and at 0,
    it is the identity. ``rows`` = (rank, ranks): the masks are drawn for
    the global batch and this rank's rows kept (``parallel.attach``)."""

    rows = (0, 1)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.0,
                 param_dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=param_dtype)
        self.fc2 = Linear(hidden_dim, out_dim, dtype=param_dtype)
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

"""Optimizer with the reference's torch-Adam semantics + its LR schedule.

Port of ``tricolo_tpu.training.optim``. The JAX package rebuilt
``torch.optim.Adam(lr=3.5e-4, weight_decay=1e-6)`` as optax's
``add_decayed_weights → scale_by_adam(0.9, 0.999, 1e-8)`` (coupled L2:
wd·param is added to the gradient before the moments) and applies the
direction as ``(p − lr·u).astype(p.dtype)`` (``training/steps.py``).
``Adam`` here takes each leaf by its dtype:

* f32 leaves take ``torch.optim.Adam``'s own update (its functional form,
  ``torch.optim.adam.adam``, with the same defaults), as the port did
  before it had bf16 parameters: the same function as optax's up to f32
  rounding, which the f32 train tests hold to their tolerances;
* bf16 leaves (``precision.param_dtype=bfloat16``) take the JAX step
  operation for operation, which no torch optimizer does. The moments are
  bf16; every Python scalar of the JAX step (lr, wd, b1, 1 − b1, b2,
  1 − b2, eps) is weakly typed there and so rounded to bf16 before use
  (b2 = 0.999 becomes 1.0 and ν does not decay: the reference's semantics,
  reproduced); each operation rounds to bf16: g + wd·p; μ = (1 − b1)·g +
  b1·μ; ν = (1 − b2)·g² + b2·ν; μ̂ = μ / c1 and ν̂ = ν / c2 with
  ck = 1 − bk^count computed in f32 and then rounded; u = μ̂ / (√ν̂ + eps);
  p − lr·u. A plain elementwise update over the bf16 leaves
  (``torch._foreach_*``), as the JAX package writes no kernel for it.

Under ``parallel.param_sharding=fsdp`` a sharded leaf is a ``DTensor``:
its moments are created like it (``zeros_like``), so each rank holds the
moments of its own shard, and both updates run on the local tensors of the
parameter, its gradient and its moments. Adam is elementwise, so the shard
a rank updates equals those elements of the replicated update, bit for bit.

It is a ``torch.optim.Optimizer`` with ``torch.optim.Adam``'s state names
(``step``, ``exp_avg``, ``exp_avg_sq``, each moment in its leaf's dtype) and
param-group keys, so the trainer, checkpoints, resume and
``convert.jax_checkpoint_to_torch`` see the state they saw. The learning
rate is set by the train step each step from ``lr_for_epoch``.
``optimizer.flat_update`` (the JAX package's one flat buffer, the same
step) is accepted and changes nothing here.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.optim.adam import adam as torch_adam


def _rounded(x: float, dtype) -> float:
    """A Python scalar as JAX's weak typing uses it beside a ``dtype``
    leaf: rounded to ``dtype`` (exactly representable as a Python float)."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _local(t: torch.Tensor) -> torch.Tensor:
    """The elements this rank holds: a ``DTensor``'s local shard (its
    storage, updated in place), any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _bias_correction(beta: float, count: int, dtype) -> float:
    """optax's ``1 − beta**count``, computed in f32, then in ``dtype``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float((one - torch.tensor(beta, dtype=torch.float32) ** count).to(dtype))


class Adam(torch.optim.Optimizer):
    """The JAX package's Adam step for each leaf's dtype (module docstring)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            wide, bf16 = [], defaultdict(list)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                if p.dtype == torch.bfloat16:
                    state["step"] += 1
                    bf16[int(state["step"])].append(p)
                else:
                    wide.append(p)
            if wide:
                self._torch_update(group, wide)
            for count, params in bf16.items():
                self._bf16_update(group, params, count)

    def _torch_update(self, group: dict, params: list) -> None:
        """``torch.optim.Adam``'s step (it counts ``step`` itself)."""
        states = [self.state[p] for p in params]
        b1, b2 = group["betas"]
        torch_adam([_local(p) for p in params], [_local(p.grad) for p in params],
                   [_local(s["exp_avg"]) for s in states],
                   [_local(s["exp_avg_sq"]) for s in states], [], [s["step"] for s in states],
                   amsgrad=False, beta1=b1, beta2=b2, lr=group["lr"],
                   weight_decay=group["weight_decay"], eps=group["eps"], maximize=False)

    def _bf16_update(self, group: dict, params: list, count: int) -> None:
        """The JAX step on bf16 leaves whose step is ``count``."""
        c = lambda x: _rounded(x, torch.bfloat16)  # noqa: E731
        b1, b2 = group["betas"]
        grads = [_local(p.grad) for p in params]
        mu = [_local(self.state[p]["exp_avg"]) for p in params]
        nu = [_local(self.state[p]["exp_avg_sq"]) for p in params]
        params = [_local(p) for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, c(group["weight_decay"])))
        torch._foreach_mul_(mu, c(b1))
        torch._foreach_add_(mu, torch._foreach_mul(grads, c(1.0 - b1)))
        squared = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squared, c(1.0 - b2))
        torch._foreach_mul_(nu, c(b2))
        torch._foreach_add_(nu, squared)
        correction1 = _bias_correction(b1, count, torch.bfloat16)
        correction2 = _bias_correction(b2, count, torch.bfloat16)
        mu_hat = torch._foreach_div(mu, correction1)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, correction2))
        torch._foreach_add_(denom, c(group["eps"]))
        direction = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(direction, c(group["lr"]))
        torch._foreach_sub_(params, direction)


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    opt = cfg.optimizer
    if opt.name.lower() != "adam":
        raise ValueError(f"unsupported optimizer: {opt.name}")
    return Adam(model.parameters(), lr=opt.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=opt.weight_decay or 0.0)


def lr_for_epoch(cfg, epoch: int) -> float:
    """Learning rate used during 0-indexed ``epoch``.

    Replicates the reference LrDecayCallback's *end-of-epoch* update: after
    epoch e completes and e ≥ start_epoch, lr is set to
    clip + ½(base−clip)(1+cos(π·(e−start)/(end−start))) — which takes effect
    from epoch e+1. So epoch E trains with the base lr for E ≤ start_epoch,
    and with the formula evaluated at e = E−1 afterwards. Inert at the
    shipped defaults (start_epoch == max_epochs == 20).
    """
    base = cfg.optimizer.lr
    start = cfg.lr_decay.start_epoch
    end = cfg.trainer.max_epochs
    if epoch <= start:
        return base
    clip = 1e-6
    progress = (epoch - 1 - start) / (end - start)
    return clip + 0.5 * (base - clip) * (1 + math.cos(math.pi * progress))

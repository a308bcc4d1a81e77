"""Optimizer with the reference's torch-Adam semantics + its LR schedule.

Port of ``tricolo_tpu.training.optim``. The JAX package rebuilt
``torch.optim.Adam(lr=3.5e-4, weight_decay=1e-6)`` as
``add_decayed_weights → scale_by_adam(0.9, 0.999, 1e-8)`` (coupled L2:
wd·param is added to the gradient before the moments); here it is that
optimizer itself, over all parameters. The learning rate is set by the
train step each step from ``lr_for_epoch``.
"""

from __future__ import annotations

import math

import torch


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    opt = cfg.optimizer
    if opt.name.lower() != "adam":
        raise ValueError(f"unsupported optimizer: {opt.name}")
    return torch.optim.Adam(model.parameters(), lr=opt.lr, betas=(0.9, 0.999), eps=1e-8,
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

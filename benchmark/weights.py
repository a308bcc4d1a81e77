"""Seeded weights on the device, in a few large draws.

``make(specs, seed, device)`` turns ``reference.model.param_specs`` into
tensors: one uniform draw for every ``uniform`` leaf (each slice scaled to
±its bound: torch's default 1/√fan_in), one normal draw for the embedding,
constants for BatchNorm (γ 1, β 0, running mean 0, variance 1). The voxel
stem's fourth input channel is zero, as the program's encoder holds it.
The same seed on the same device gives the same weights, which the
benchmark loads into the program and hands to the reference.
"""

from __future__ import annotations

import math

import torch


def make(specs: list, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {name: math.prod(shape) for name, shape, _, _ in specs}
    n_uniform = sum(sizes[n] for n, _, kind, _ in specs if kind.startswith("uniform"))
    n_normal = sum(sizes[n] for n, _, kind, _ in specs if kind == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, u, v = {}, 0, 0
    for name, shape, kind, bound in specs:
        size = sizes[name]
        if kind.startswith("uniform"):
            t = uniform[u:u + size].view(shape).mul_(bound)
            u += size
            if kind == "uniform_pad":
                t[:, 3:] = 0
        elif kind == "normal":
            t = normal[v:v + size].view(shape).mul_(bound)
            v += size
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            t = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
        out[name] = t
    return out

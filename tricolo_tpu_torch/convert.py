"""Weight bridge between the JAX package's trees and the port's state_dict.

``jax_to_torch(params, batch_stats)`` maps the ``{params, batch_stats}``
trees of ``tricolo_tpu``'s TriCoLoNet (nested dicts of numpy arrays) onto
this package's ``TriCoLoNet.state_dict()``; ``torch_to_jax`` is the exact
inverse. Both are renames plus layout transposes — no arithmetic, so a
round trip is bit-exact:

* conv kernels (kd, kh, kw, Cin, Cout) ↔ (Cout, Cin, kd, kh, kw), 2-D alike;
* Dense kernels (in, out) ↔ Linear weights (out, in);
* GRU ``w_ih (E, 3H)`` / ``w_hh (H, 3H)`` ↔ ``weight_ih_l0`` / ``weight_hh_l0``
  transposed (``_reverse`` for ``gru_bwd``); gate order r, z, n both sides;
* BN ``scale/bias`` + batch_stats ``mean/var`` ↔
  ``weight/bias/running_mean/running_var`` (``num_batches_tracked`` is 0).

A port checkpoint is ``torch.save`` of the state_dict. Reading the JAX
package's msgpack checkpoints needs flax or msgpack and is not ported yet.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_TO_TORCH = {
    "MLPHead_0": "head",
    "TorchLinear_0": "fc1",
    "TorchLinear_1": "fc2",
    "Conv_0": "conv",
    "BatchNorm_0": "bn",
    "Embed_0": "embedding",
}
_TO_JAX = {v: k for k, v in _TO_TORCH.items()}
_GRU_LEAF = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
             "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}
_GRU_LEAF_INV = {v: k for k, v in _GRU_LEAF.items()}
_KERNEL_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_KERNEL_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _module_to_torch(part: str) -> list[str]:
    m = re.fullmatch(r"ConvBlock_(\d+)", part)
    if m:
        return ["blocks", m.group(1)]
    m = re.fullmatch(r"(layer\d+)_(\d+)", part)
    if m:
        return [m.group(1), m.group(2)]
    return [_TO_TORCH.get(part, part)] if part != "Dense_0" else []


def _tensor(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(array, copy=True, order="C"))


def jax_to_torch(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` trees → the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        *mods, leaf = path
        if mods and mods[-1] in ("gru_fwd", "gru_bwd"):
            suffix = "_reverse" if mods[-1] == "gru_bwd" else ""
            key = ".".join(_join(mods[:-1]) + ["gru", _GRU_LEAF[leaf] + suffix])
            out[key] = _tensor(value.T if value.ndim == 2 else value)
            continue
        prefix = _join(mods)
        if leaf == "kernel":
            out[".".join(prefix + ["weight"])] = _tensor(
                value.transpose(_KERNEL_TO_TORCH[value.ndim])
            )
        elif leaf in ("scale", "embedding"):
            out[".".join(prefix + ["weight"])] = _tensor(value)
        elif leaf == "bias":
            out[".".join(prefix + ["bias"])] = _tensor(value)
        else:
            raise KeyError(f"unmapped parameter {'/'.join(path)}")
    for path, value in _flatten(batch_stats):
        *mods, leaf = path
        prefix = ".".join(_join(mods))
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[f"{prefix}.{name}"] = _tensor(value)
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def _join(mods) -> list[str]:
    parts: list[str] = []
    for part in mods:
        parts.extend(_module_to_torch(part))
    return parts


def _module_to_jax(parts: list[str]) -> list[str]:
    out: list[str] = []
    i = 0
    while i < len(parts):
        part = parts[i]
        if part == "blocks":
            out.append(f"ConvBlock_{parts[i + 1]}")
            i += 2
        elif re.fullmatch(r"layer\d+", part) and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{part}_{parts[i + 1]}")
            i += 2
        else:
            out.append(_TO_JAX.get(part, part))
            i += 1
    return out


def _put(tree: dict, path: list[str], value: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def torch_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """The port's state_dict → JAX ``(params, batch_stats)`` numpy trees."""
    params: dict = {}
    stats: dict = {}
    for key, tensor in state_dict.items():
        *mods, leaf = key.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if mods and mods[-1] == "gru":
            base = leaf.removesuffix("_reverse")
            direction = "gru_bwd" if leaf.endswith("_reverse") else "gru_fwd"
            path = _module_to_jax(mods[:-1]) + [direction, _GRU_LEAF_INV[base]]
            _put(params, path, value.T if value.ndim == 2 else value)
            continue
        prefix = _module_to_jax(mods)
        is_bn = ".".join(mods + ["running_mean"]) in state_dict
        if leaf in ("running_mean", "running_var"):
            _put(stats, prefix + [leaf.removeprefix("running_")], value)
        elif mods and mods[-1] == "embedding":
            _put(params, prefix + ["embedding"], value)
        elif leaf == "weight" and is_bn:
            _put(params, prefix + ["scale"], value)
        elif leaf == "weight" and value.ndim == 2:
            _put(params, prefix + ["Dense_0", "kernel"], value.T)
        elif leaf == "weight":
            _put(params, prefix + ["kernel"], value.transpose(_KERNEL_TO_JAX[value.ndim]))
        elif leaf == "bias" and is_bn:
            _put(params, prefix + ["bias"], value)
        elif leaf == "bias":
            _put(params, prefix + ["Dense_0", "bias"], value)
        else:
            raise KeyError(f"unmapped state_dict entry {key}")
    return params, stats

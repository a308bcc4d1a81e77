"""Weight bridge between the JAX package's trees and the port's state_dict.

``jax_to_torch(params, batch_stats)`` maps the ``{params, batch_stats}``
trees of ``tricolo_tpu``'s TriCoLoNet (nested dicts of numpy arrays) onto
this package's ``TriCoLoNet.state_dict()``; ``torch_to_jax`` is the exact
inverse. Both are renames plus layout transposes — no arithmetic, so a
round trip is bit-exact:

* conv kernels (kd, kh, kw, Cin, Cout) ↔ (Cout, Cin, kd, kh, kw), 2-D alike;
* Dense kernels (in, out) ↔ Linear weights (out, in), their biases under
  ``Dense_0``; a conv's bias (EfficientNet's ``se_reduce``/``se_expand``)
  stays beside its kernel — told apart by the weight beside the bias
  (2-D: a Linear, 4-D or 5-D: a conv);
* GRU ``w_ih (E, 3H)`` / ``w_hh (H, 3H)`` ↔ ``weight_ih_l0`` / ``weight_hh_l0``
  transposed (``_reverse`` for ``gru_bwd``); gate order r, z, n both sides;
* BN ``scale/bias`` + batch_stats ``mean/var`` ↔
  ``weight/bias/running_mean/running_var`` (``num_batches_tracked`` is 0);
  a model without BatchNorm (the CLIP heads alone) has empty batch_stats
  both ways. The CLIP heads map as the other MLP heads:
  ``text_encoder/MLPHead_0/TorchLinear_{0,1}/Dense_0`` ↔
  ``text_encoder.head.fc{1,2}``, ``image_encoder`` alike.

``jax_checkpoint_to_torch`` carries a whole JAX checkpoint (as
``training.jax_checkpoint.load_jax_checkpoint`` reads it, no flax needed)
over: the weights through ``jax_to_torch`` after
``migrate_legacy_voxel_kernel``, the Adam moments of either JAX optimizer
layout as ``torch.optim.Adam`` state.
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
        elif leaf == "bias" and (is_bn or state_dict[".".join(mods + ["weight"])].ndim > 2):
            _put(params, prefix + ["bias"], value)  # a BN's, or a biased conv's
        elif leaf == "bias":
            _put(params, prefix + ["Dense_0", "bias"], value)
        else:
            raise KeyError(f"unmapped state_dict entry {key}")
    return params, stats


def migrate_legacy_voxel_kernel(raw: dict) -> dict:
    """Zero-pad a legacy (3,3,3,3,C) block-0 voxel conv kernel of a JAX
    checkpoint to the (3,3,3,4,C) layout, in place, in the params and in
    the per-leaf Adam moments (``tricolo_tpu``'s function of this name):
    the pad channel's input is always zero, so the zeros change nothing."""

    def walk(node):
        if not isinstance(node, dict):
            return
        voxel = node.get("voxel_encoder")
        if isinstance(voxel, dict):
            conv = voxel.get("ConvBlock_0", {}).get("Conv_0", {})
            kernel = conv.get("kernel")
            if kernel is not None and getattr(kernel, "ndim", 0) == 5 and kernel.shape[-2] == 3:
                conv["kernel"] = np.concatenate([kernel, np.zeros_like(kernel[..., :1, :])],
                                                axis=-2)
        for value in node.values():
            walk(value)

    walk(raw.get("params", {}))
    walk(raw.get("opt_state", {}))
    return raw


def _find_adam_moments(node):
    """The ``{count, mu, nu}`` dict inside a JAX opt-state tree: the
    optax chain's ``ScaleByAdamState`` or the flat ``FlatTorchAdamState``."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        for value in node.values():
            found = _find_adam_moments(value)
            if found is not None:
                return found
    return None


def _unravel(flat: np.ndarray, like: dict) -> dict:
    """A flat moment buffer (``optimizer.flat_update=true``) → a tree shaped
    like ``like``, in ``jax.flatten_util.ravel_pytree``'s order: dict keys
    sorted at every level, each leaf in C order."""
    offset = 0

    def walk(node):
        nonlocal offset
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                out[key] = walk(value)
            else:
                n = int(np.asarray(value).size)
                out[key] = flat[offset:offset + n].reshape(np.shape(value))
                offset += n
        return out

    tree = walk(like)
    if offset != flat.size:
        raise ValueError(f"flat Adam moment holds {flat.size} values, the params {offset}")
    return tree


def jax_checkpoint_to_torch(raw: dict, param_names: list[str] | None = None) -> dict:
    """A restored JAX checkpoint → the port's checkpoint payload
    ``{"model", "optimizer", "step", "epoch", "extra"}``.

    ``param_names`` (the model's ``named_parameters`` order, the optimizer's
    parameter order) asks for the Adam state too: ``step`` = count,
    ``exp_avg`` = mu, ``exp_avg_sq`` = nu, each in its parameter's torch
    layout; without it, or before the first step, ``optimizer`` is None."""
    raw = migrate_legacy_voxel_kernel(raw)
    params = raw["params"]
    optimizer = None
    adam = _find_adam_moments(raw.get("opt_state", {})) if param_names is not None else None
    if adam is not None and int(np.asarray(adam["count"])) > 0:
        mu, nu = adam["mu"], adam["nu"]
        if not isinstance(mu, dict):
            mu, nu = _unravel(np.asarray(mu), params), _unravel(np.asarray(nu), params)
        exp_avg, exp_avg_sq = jax_to_torch(mu, {}), jax_to_torch(nu, {})
        step = float(np.asarray(adam["count"]))
        optimizer = {"state": {
            i: {"step": torch.tensor(step), "exp_avg": exp_avg[name],
                "exp_avg_sq": exp_avg_sq[name]}
            for i, name in enumerate(param_names)}}
    return {
        "model": jax_to_torch(params, raw.get("batch_stats", {})),
        "optimizer": optimizer,
        "step": int(np.asarray(raw.get("step", 0))),
        "epoch": int(np.asarray(raw["epoch"])) if "epoch" in raw else None,
        "extra": raw.get("extra", {}),
    }

"""Pretrained image backbones: a torchvision or efficientnet_pytorch
``state_dict`` file → the backbone npz that ``Trainer`` grafts.

    python -m tricolo_tpu_torch.convert_torchvision_weights +src=resnet50.pth \\
        +cnn_name=resnet50 +out=pretrained/resnet50.npz

Port of the JAX package's root ``convert_torchvision_weights.py``, without
its download branch: the weights must be supplied as a file (``+src``,
a ``torch.save``d state_dict, or a dict holding one under
``"state_dict"``). ``convert_torchvision_state_dict`` maps a torchvision
ResNet (resnet18/34/50), ``convert_efficientnet_state_dict`` an
efficientnet_pytorch EfficientNet (b0/b3, lukemelas key names, the
classifier ``_fc`` dropped) onto the JAX package's backbone trees, and
``save_pretrained`` writes them in its npz layout (flat
``params/<module>/…/<leaf>`` and ``batch_stats/…`` keys, flax layouts:
conv kernels HWIO), which ``models.resnet.load_pretrained`` and both
packages' trainers read. Point ``model.modules.MVCNNEncoder.pretrained_path``
at the output.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .models.efficientnet import _BASE_BLOCKS, _SCALING, _round_repeats
from .models.resnet import _ARCHS, Bottleneck


def _assign(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = np.asarray(value)


def _converter(state_dict: dict):
    """(params, stats, put_conv, put_bn) over ``state_dict``'s numpy values."""
    params: dict = {}
    stats: dict = {}

    def put_conv(torch_key: str, path: tuple, bias_key: str | None = None) -> None:
        _assign(params, path + ("kernel",), np.asarray(state_dict[torch_key]).transpose(2, 3, 1, 0))
        if bias_key is not None:
            _assign(params, path + ("bias",), state_dict[bias_key])

    def put_bn(prefix: str, path: tuple) -> None:
        _assign(params, path + ("scale",), state_dict[f"{prefix}.weight"])
        _assign(params, path + ("bias",), state_dict[f"{prefix}.bias"])
        _assign(stats, path + ("mean",), state_dict[f"{prefix}.running_mean"])
        _assign(stats, path + ("var",), state_dict[f"{prefix}.running_var"])

    return params, stats, put_conv, put_bn


def convert_torchvision_state_dict(state_dict: dict, cnn_name: str = "resnet18"):
    """A torchvision ResNet ``state_dict`` → (params, batch_stats): conv
    weights OIHW → HWIO, BN weight/bias → scale/bias and the running
    statistics → batch_stats; ``fc`` is ignored (MVCNN owns its own)."""
    block, stage_sizes = _ARCHS[cnn_name]
    params, stats, put_conv, put_bn = _converter(state_dict)
    put_conv("conv1.weight", ("conv1",))
    put_bn("bn1", ("bn1",))
    n_convs = 3 if block is Bottleneck else 2
    for stage, num_blocks in enumerate(stage_sizes):
        for i in range(num_blocks):
            src, dst = f"layer{stage + 1}.{i}", f"layer{stage + 1}_{i}"
            for conv in range(1, n_convs + 1):
                put_conv(f"{src}.conv{conv}.weight", (dst, f"conv{conv}"))
                put_bn(f"{src}.bn{conv}", (dst, f"bn{conv}"))
            if f"{src}.downsample.0.weight" in state_dict:
                put_conv(f"{src}.downsample.0.weight", (dst, "downsample_conv"))
                put_bn(f"{src}.downsample.1", (dst, "downsample_bn"))
    return params, stats


def convert_efficientnet_state_dict(state_dict: dict, cnn_name: str = "efficientnet_b0"):
    """An efficientnet_pytorch ``state_dict`` → (params, batch_stats): stem
    ``_conv_stem``/``_bn0``, the flattened ``_blocks.{i}`` (``_expand_conv``/
    ``_bn0``, ``_depthwise_conv``/``_bn1``, ``_se_reduce``, ``_se_expand``
    with their biases, ``_project_conv``/``_bn2``), head ``_conv_head``/
    ``_bn1``; the classifier ``_fc`` is dropped."""
    _, depth = _SCALING[cnn_name]
    params, stats, put_conv, put_bn = _converter(state_dict)
    put_conv("_conv_stem.weight", ("stem_conv",))
    put_bn("_bn0", ("stem_bn",))
    i = 0
    for stage, (expand, *_, repeats) in enumerate(_BASE_BLOCKS):
        for rep in range(_round_repeats(repeats, depth)):
            src, dst = f"_blocks.{i}.", f"block{stage + 1}_{rep}"
            if expand != 1:
                put_conv(src + "_expand_conv.weight", (dst, "expand"))
                put_bn(src + "_bn0", (dst, "bn_expand"))
            put_conv(src + "_depthwise_conv.weight", (dst, "depthwise"))
            put_bn(src + "_bn1", (dst, "bn_depthwise"))
            put_conv(src + "_se_reduce.weight", (dst, "se_reduce"), src + "_se_reduce.bias")
            put_conv(src + "_se_expand.weight", (dst, "se_expand"), src + "_se_expand.bias")
            put_conv(src + "_project_conv.weight", (dst, "project"))
            put_bn(src + "_bn2", (dst, "bn_project"))
            i += 1
    put_conv("_conv_head.weight", ("head_conv",))
    put_bn("_bn1", ("head_bn",))
    return params, stats


def save_pretrained(path: str, params: dict, batch_stats: dict) -> None:
    """(params, batch_stats) → an npz of flat ``params/…`` and
    ``batch_stats/…`` keys (the JAX ``models/resnet.py::save_pretrained``)."""
    flat: dict = {}

    def flatten(prefix: str, tree: dict) -> None:
        for key, value in tree.items():
            if isinstance(value, dict):
                flatten(f"{prefix}/{key}", value)
            else:
                flat[f"{prefix}/{key}"] = np.asarray(value)

    flatten("params", params)
    flatten("batch_stats", batch_stats)
    np.savez(path, **flat)


def main(argv: list[str] | None = None) -> str:
    import torch

    from .config import load_config

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    cnn_name = cfg.get("cnn_name", "resnet18")
    out = cfg.get("out", f"pretrained/{cnn_name}.npz")
    src = cfg.get("src", None)
    if not src:
        raise ValueError("pass +src=<state_dict file>: the weights must be supplied as a file "
                         "(torchvision or efficientnet_pytorch state_dict); nothing is "
                         "downloaded")
    state_dict = torch.load(src, map_location="cpu")
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    state_dict = {k: v.numpy() for k, v in state_dict.items()}
    convert = (convert_efficientnet_state_dict if cnn_name.startswith("efficientnet")
               else convert_torchvision_state_dict)
    params, stats = convert(state_dict, cnn_name)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_pretrained(out, params, stats)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()

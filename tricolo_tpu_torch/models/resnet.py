"""ResNet-18/34/50 backbones, channels-last.

Port of ``tricolo_tpu.models.resnet.ResNet``: the 7×7/2 pad-3 stem conv →
BN → ReLU → 3×3/2 pad-1 max pool, four stages of ``BasicBlock``\\ s
(resnet18 (2, 2, 2, 2), resnet34 (3, 4, 6, 3)) or ``Bottleneck``\\ s
(resnet50 (3, 4, 6, 3), the 1×1 → 3×3/stride → 1×1·4 chain) over 64/128/
256/512 features, stride 2 from stage 2 on, a 1×1/stride downsample conv
and BN where the shape changes, global average pool. Parameter names
follow the JAX tree (``layer1.0.conv1`` for ``layer1_0/conv1``) so
``convert.py`` is a rename. BatchNorm is ``common.BatchNorm2d`` (flax
momentum 0.9, eps 1e-5).

The JAX package's stem opt-ins (``hybrid_stem``: bn1 → ReLU → max pool
with a hand-derived backward; ``s2d_stem``: the 7×7/2 conv over a 2×2
space-to-depth input) are exact rewrites of this stem with the same
variables, made for the TPU's layout. ``TriCoLoNet.from_config`` accepts
both keys and runs this stem: the mathematics, checkpoints and converted
weights are the same.

``load_pretrained`` reads the backbone weights that ``save_pretrained``
(the JAX package's, or ``tricolo_tpu_torch.convert_torchvision_weights``)
writes; the trainer grafts them over the random init.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d

__all__ = ["BatchNorm2d", "BasicBlock", "Bottleneck", "ResNet", "load_pretrained"]


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        self.has_downsample = stride != 1 or cin != features
        if self.has_downsample:
            self.downsample_conv = _conv(cin, features, 1, stride)
            self.downsample_bn = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1, 1)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        self.conv3 = _conv(features, out, 1, 1)
        self.bn3 = BatchNorm2d(out, eps=1e-5)
        self.has_downsample = stride != 1 or cin != out
        if self.has_downsample:
            self.downsample_conv = _conv(cin, out, 1, stride)
            self.downsample_bn = BatchNorm2d(out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


_ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


class ResNet(nn.Module):
    """(N, H, W, 3) NHWC → pooled features (N, ``feature_dim``)."""

    def __init__(self, cnn_name: str = "resnet18"):
        super().__init__()
        if cnn_name not in _ARCHS:
            raise ValueError(f"unknown ResNet {cnn_name!r}; one of {sorted(_ARCHS)}")
        block, stage_sizes = _ARCHS[cnn_name]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            features = 64 * 2**stage
            blocks = []
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(cin, features, stride))
                cin = features * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.feature_dim = cin

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is unused: a ResNet draws nothing in train mode (the
        EfficientNet's stochastic depth does)."""
        # NHWC → NCHW view with channels-last strides: no copy.
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))


def load_pretrained(path: str) -> tuple[dict, dict]:
    """Backbone weights of a ``save_pretrained`` npz → (params, batch_stats)
    nested numpy trees in the JAX package's names and layouts: the file's
    flat keys are ``params/<module>/…/<leaf>`` and ``batch_stats/…``."""
    params: dict = {}
    stats: dict = {}
    with np.load(path) as data:
        for flat_key in data.files:
            root, *parts = flat_key.split("/")
            node = params if root == "params" else stats
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[flat_key]
    return params, stats

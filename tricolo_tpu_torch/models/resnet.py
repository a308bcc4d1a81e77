"""ResNet18 backbone (eval), channels-last.

Port of ``tricolo_tpu.models.resnet.ResNet`` with ``BasicBlock``: the
7×7/2 pad-3 stem conv → BN → ReLU → 3×3/2 pad-1 max pool, four stages of
two BasicBlocks (64/128/256/512, stride 2 from stage 2 on, 1×1/stride
downsample where the shape changes), global average pool. BN runs with its
running statistics (``F.batch_norm(training=False)`` through
``nn.BatchNorm2d`` in eval mode). Parameter names follow the JAX tree
(``layer1.0.conv1`` for ``layer1_0/conv1``) so ``convert.py`` is a rename.

ResNet34/50, EfficientNet and the stem opt-ins (hybrid/space-to-depth) are
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.has_downsample = stride != 1 or cin != features
        if self.has_downsample:
            self.downsample_conv = _conv(cin, features, 1, stride)
            self.downsample_bn = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


_ARCHS = {"resnet18": (2, 2, 2, 2)}


class ResNet(nn.Module):
    """(N, H, W, 3) NHWC → pooled features (N, 512)."""

    def __init__(self, cnn_name: str = "resnet18"):
        super().__init__()
        if cnn_name not in _ARCHS:
            raise NotImplementedError(f"backbone {cnn_name!r} is not ported yet")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for stage, num_blocks in enumerate(_ARCHS[cnn_name]):
            features = 64 * 2**stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(cin, features, stride))
                cin = features
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.feature_dim = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC → NCHW view with channels-last strides: no copy.
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))

"""ResNet18 backbone, channels-last.

Port of ``tricolo_tpu.models.resnet.ResNet`` with ``BasicBlock``: the
7×7/2 pad-3 stem conv → BN → ReLU → 3×3/2 pad-1 max pool, four stages of
two BasicBlocks (64/128/256/512, stride 2 from stage 2 on, 1×1/stride
downsample where the shape changes), global average pool. Parameter names
follow the JAX tree (``layer1.0.conv1`` for ``layer1_0/conv1``) so
``convert.py`` is a rename.

BatchNorm is ``BatchNorm2d``: in eval mode torch's own (running
statistics); in train mode it normalises with the batch statistics and
updates its running buffers as flax ``nn.BatchNorm`` does — momentum 0.9
and the *biased* batch variance (torch's module would use the unbiased one).
With a ``bn_group`` (``parallel.attach``, more than one rank) the
statistics are the global batch's, as pjit computes them, in f32 plain
torch and two passes: the mean from Σx, then the biased variance from
Σ(x − mean)², each sum through a differentiable all-reduce (whose
backward sums the ranks' cotangents); each rank's dγ, dβ stay its own
sums. Two passes, because E[x²] − mean² loses the variance to
cancellation where a channel's mean dwarfs its spread over the batch.

``load_pretrained`` reads the backbone weights that the JAX package's
``models/resnet.py::save_pretrained`` writes (converted torchvision
weights); the trainer grafts them over the random init.

ResNet34/50, EfficientNet and the stem opt-ins (hybrid/space-to-depth) are
not ported yet (``TriCoLoNet.from_config`` refuses the stems).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_MOMENTUM = 0.9  # flax convention: running = 0.9·running + 0.1·batch


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax ``nn.BatchNorm``;
    ``bn_group``: the process group whose global batch its statistics span."""

    bn_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.bn_group is not None:
            return self._global_batch_norm(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.copy_(_MOMENTUM * self.running_mean + (1.0 - _MOMENTUM) * mean)
            self.running_var.copy_(_MOMENTUM * self.running_var + (1.0 - _MOMENTUM) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.eps)

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
        with torch.no_grad():
            self.running_mean.copy_(_MOMENTUM * self.running_mean + (1.0 - _MOMENTUM) * mean)
            self.running_var.copy_(_MOMENTUM * self.running_var + (1.0 - _MOMENTUM) * var)
        out = centred * torch.rsqrt(var + self.eps).view(shape)
        return (out * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
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


_ARCHS = {"resnet18": (2, 2, 2, 2)}


class ResNet(nn.Module):
    """(N, H, W, 3) NHWC → pooled features (N, 512)."""

    def __init__(self, cnn_name: str = "resnet18"):
        super().__init__()
        if cnn_name not in _ARCHS:
            raise NotImplementedError(f"backbone {cnn_name!r} is not ported yet")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
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

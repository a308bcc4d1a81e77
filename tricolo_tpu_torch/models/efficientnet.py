"""EfficientNet-B0/B3 backbones, channels-last.

Port of ``tricolo_tpu.models.efficientnet``: the compound-scaled network of
efficientnet_pytorch that the reference's MVCNN may use (reference
mv_cnn.py:53-60): a 3×3/2 stem conv → BN → SiLU, seven stages of
``MBConv`` blocks (1×1 expansion, depthwise k×k, squeeze-excitation over a
quarter of the block's *input* channels, 1×1 projection, a stochastic-depth
residual where stride is 1 and the width unchanged), a 1×1 head conv → BN
→ SiLU and a global average pool; B3 scales width 1.2 and depth 1.4 with
the same filter and repeat rounding. Parameter names follow the JAX tree
(``block2_1.depthwise`` for ``block2_1/depthwise``), so ``convert.py`` is a
rename; a depthwise kernel (k, k, 1, mid) is ``Conv2d(groups=mid)``'s
(mid, 1, k, k).

* Convolutions pad as flax's ``padding="SAME"``: at stride s the total pad
  is max((⌈in/s⌉ − 1)·s + k − in, 0), its half (rounded down) before and
  the rest after, so a stride-2 conv at an even size pads one more at the
  end than at the start (``SameConv2d``, from the input's static shape).
* BatchNorm is efficientnet_pytorch's: flax momentum 0.99, eps 1e-3.
* Stochastic depth: block i of n drops its residual branch per sample at
  rate 0.2·i/n (``DROP_CONNECT_RATE``, the JAX package's default, which it
  exposes through no config key) in train mode, the masks drawn from the
  generator passed to ``forward`` (``common.stochastic_depth``; ``rows``
  set by ``parallel.attach``). The JAX masks come from flax's dropout RNG,
  so the two streams differ.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, stochastic_depth

# (expand_ratio, kernel, stride, in_channels, out_channels, repeats) — base B0.
_BASE_BLOCKS = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)

_SCALING = {
    # name: (width_mult, depth_mult)
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b3": (1.2, 1.4),
}

_BN_EPS, _BN_MOMENTUM = 1e-3, 0.99
DROP_CONNECT_RATE = 0.2


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:  # never round down by more than 10%
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/lax ``SAME`` padding of one spatial axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``padding="SAME"``: symmetric ``k // 2`` at
    stride 1 (odd k), the asymmetric pad of ``same_padding`` otherwise."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2 if stride == 1 else 0,
                         groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride[0] == 1:
            return super().forward(x)
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=_BN_EPS, momentum=_BN_MOMENTUM)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation (JAX ``MBConv``)."""

    rows = (0, 1)  # (rank, ranks) of the stochastic-depth draws: parallel.attach

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: int, kernel: int,
                 stride: int, drop_rate: float = 0.0):
        super().__init__()
        mid = in_channels * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = nn.Conv2d(in_channels, mid, 1, bias=False)
            self.bn_expand = _bn(mid)
        self.depthwise = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn_depthwise = _bn(mid)
        se_dim = max(1, int(in_channels * 0.25))
        self.se_reduce = nn.Conv2d(mid, se_dim, 1)
        self.se_expand = nn.Conv2d(se_dim, mid, 1)
        self.project = nn.Conv2d(mid, out_channels, 1, bias=False)
        self.bn_project = _bn(out_channels)
        self.has_residual = stride == 1 and in_channels == out_channels
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        residual = x
        if self.has_expand:
            x = F.silu(self.bn_expand(self.expand(x)))
        x = F.silu(self.bn_depthwise(self.depthwise(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = self.se_expand(F.silu(self.se_reduce(se)))
        x = x * torch.sigmoid(se)
        x = self.bn_project(self.project(x))
        if self.has_residual:
            if self.training and self.drop_rate > 0.0:
                x = stochastic_depth(x, self.drop_rate, generator, self.rows)
            x = x + residual.to(x.dtype)
        return x


class EfficientNet(nn.Module):
    """(N, H, W, 3) NHWC → pooled features (N, ``feature_dim``)."""

    def __init__(self, cnn_name: str = "efficientnet_b0"):
        super().__init__()
        if cnn_name not in _SCALING:
            raise ValueError(f"unknown EfficientNet {cnn_name!r}; one of {sorted(_SCALING)}")
        width, depth = _SCALING[cnn_name]
        stem = _round_filters(32, width)
        self.stem_conv = SameConv2d(3, stem, 3, stride=2)
        self.stem_bn = _bn(stem)
        total_blocks = sum(_round_repeats(r, depth) for *_, r in _BASE_BLOCKS)
        self.block_names = []
        block_idx = 0
        for stage, (expand, kernel, stride, c_in, c_out, repeats) in enumerate(_BASE_BLOCKS):
            c_in, c_out = _round_filters(c_in, width), _round_filters(c_out, width)
            for rep in range(_round_repeats(repeats, depth)):
                name = f"block{stage + 1}_{rep}"
                setattr(self, name, MBConv(
                    c_in if rep == 0 else c_out, c_out, expand, kernel,
                    stride if rep == 0 else 1,
                    DROP_CONNECT_RATE * block_idx / total_blocks))
                self.block_names.append(name)
                block_idx += 1
        head = _round_filters(1280, width)
        self.head_conv = nn.Conv2d(_round_filters(320, width), head, 1, bias=False)
        self.head_bn = _bn(head)
        self.feature_dim = head

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the stochastic-depth masks' source in train mode."""
        # NHWC → NCHW view with channels-last strides: no copy.
        x = F.silu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        for name in self.block_names:
            x = getattr(self, name)(x, generator)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3))

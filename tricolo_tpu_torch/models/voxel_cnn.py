"""Voxel encoder on host-windowed tile rows, channels-last.

Port of ``tricolo_tpu.models.voxel_cnn.VoxelCNNEncoder._windowed_forward``
under the masked (submanifold) semantics, eval and train. Input is the
``windowed_compact`` transfer: per-sample packed rows (B, k, s³) of each
active 8³ tile's halo'd window (s = 8 + 2·halo) and their local tile ids
(B, k).

Halo 3 (the default, 14³ rows): blocks 1-2 run on the tile rows — VALID
3³ conv, then K1 (``ops.bn_relu_pool``). Block 1 normalises with two
masks: zero over the full-region occupancy ``m_full[1:-1]³`` and pool the
centre occupancy ``pad(m_full[3:-3]³, 2)``; block 2's single mask is the
pooled centre mask cropped by its VALID conv. K2 (``ops.scatter_tiles_ps``)
then places the (B, k, 2³, 64) tiles and their mask on dense 16³ grids,
blocks 3-5 run dense (SAME conv + K1), and the NDHWC flatten feeds the MLP
head. Halo 1 (10³ rows) runs block 1 on the rows and blocks 2-5 dense.

In ``train()`` mode each block normalises with its masked batch statistics
through ``ops.masked_bn_relu_pool_train`` (K1 forward with the argmax
index, K3 backward) and updates ``running_mean``/``running_var`` by hand:
flax momentum 0.9 and the *biased* masked variance, as the JAX package does
(``nn.BatchNorm3d``'s own update would use the unbiased variance over all
sites). K2 runs through its autograd Function (``ops.scatter_tiles``).

Convolutions are ``F.conv3d`` on channels-last-3d views (cuDNN on the
card), as the JAX package leaves them to XLA. ``use_kernels=False`` runs
the same path through the kernels' plain PyTorch versions (the reference
the kernels are held against on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..data.device_prep import unpack_windowed_rows
from ..ops.bn_relu_pool import (
    bn_relu_pool,
    bn_relu_pool_plain,
    fold_bn,
    masked_bn_relu_pool_train,
)
from ..ops.tile_scatter import scatter_tiles
from .common import MLPHead, l2_normalize

_TILE = 8


_MOMENTUM = 0.9  # flax convention: running = 0.9·running + 0.1·batch


class ConvBlock(nn.Module):
    """Conv3D(3³, no bias) → masked BN → ReLU → zero → MaxPool(2³)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, 3, bias=False)
        # Holds weight/bias/running_mean/running_var; folded by fold_bn.
        self.bn = nn.BatchNorm3d(features, eps=1e-5)

    def forward(self, x, zero_mask, stats_mask=None, padding: int = 0,
                use_kernels: bool = True):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.conv.weight, padding=padding)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        bn = self.bn
        zero_mask = zero_mask.to(y.dtype).contiguous()
        if stats_mask is not None:
            stats_mask = stats_mask.to(y.dtype).contiguous()
        if self.training:
            # Two masks: statistics over stats_mask, zeroing over zero_mask.
            stats = zero_mask if stats_mask is None else stats_mask
            pooled, mean, var, pooled_mask = masked_bn_relu_pool_train(
                y, bn.weight, bn.bias, stats, zero_mask, bn.eps, use_kernels
            )
            with torch.no_grad():
                bn.running_mean.copy_(_MOMENTUM * bn.running_mean + (1.0 - _MOMENTUM) * mean)
                bn.running_var.copy_(_MOMENTUM * bn.running_var + (1.0 - _MOMENTUM) * var)
            return pooled, pooled_mask
        mul, add = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                           bn.eps, y.dtype)
        op = bn_relu_pool if use_kernels else bn_relu_pool_plain
        return op(y, mul, add, zero_mask, stats_mask)


class VoxelCNNEncoder(nn.Module):
    """rows (B, k, s³) int32 + row_ids (B, k) int32 → (B, out_dim) float32."""

    def __init__(self, voxel_size: int = 64, ef_dim: int = 32, z_dim: int = 512,
                 out_dim: int = 512, compute_dtype=torch.float32):
        super().__init__()
        if voxel_size % 32:
            raise ValueError(f"voxel_size must be a multiple of 32, got {voxel_size}")
        self.voxel_size = voxel_size
        self.compute_dtype = compute_dtype
        self.use_kernels = True
        channels = (ef_dim, ef_dim * 2, ef_dim * 4, ef_dim * 8, z_dim)
        cins = (4,) + channels[:-1]
        self.blocks = nn.ModuleList(ConvBlock(c, f) for c, f in zip(cins, channels))
        flat = (voxel_size // 32) ** 3 * z_dim
        self.head = MLPHead(flat, out_dim, out_dim)
        with torch.no_grad():
            # RGB padded 3 → 4 input channels: torch's init for the real
            # 3-channel conv (fan_in 27·3), zero taps on the pad channel.
            bound = 1.0 / math.sqrt(27 * 3)
            self.blocks[0].conv.weight.uniform_(-bound, bound)
            self.blocks[0].conv.weight[:, 3].zero_()

    def forward(self, rows: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
        if rows.ndim != 3 or row_ids.ndim != 2:
            raise ValueError(
                "compact windowed input must be per-sample: rows (B, k, s³) + "
                f"ids (B, k); got {tuple(rows.shape)} / {tuple(row_ids.shape)}"
            )
        for halo in (1, 3):
            if (_TILE + 2 * halo) ** 3 == rows.shape[-1]:
                break
        else:
            raise ValueError(
                f"windowed rows have {rows.shape[-1]} voxels; expected 10³ "
                "(halo 1) or 14³ (halo 3)"
            )
        kernels = self.use_kernels
        batch, k = rows.shape[:2]
        s = _TILE + 2 * halo
        x_t, m_full = unpack_windowed_rows(rows.reshape(-1, s, s, s), self.compute_dtype)
        if halo == 1:
            m_t = m_full[:, 1:-1, 1:-1, 1:-1]
            x_t, m_t = self.blocks[0](x_t, m_t, use_kernels=kernels)
            dense_from, grid = 1, self.voxel_size // 2
        else:
            mz1 = m_full[:, 1:-1, 1:-1, 1:-1]
            ms1 = F.pad(m_full[:, 3:-3, 3:-3, 3:-3], (0, 0, 2, 2, 2, 2, 2, 2))
            x_t, m_p = self.blocks[0](x_t, mz1, ms1, use_kernels=kernels)
            m2 = m_p[:, 1:-1, 1:-1, 1:-1]
            x_t, m_t = self.blocks[1](x_t, m2, use_kernels=kernels)
            dense_from, grid = 2, self.voxel_size // 4
        t = x_t.shape[1]
        ids = row_ids.to(torch.int32).contiguous()
        x = scatter_tiles(x_t.reshape(batch, k, t, t, t, -1), ids, grid, kernels)
        mask = scatter_tiles(m_t.reshape(batch, k, t, t, t, 1), ids, grid, kernels)
        for block in self.blocks[dense_from:]:
            x, mask = block(x, mask, padding=1, use_kernels=kernels)
        x = self.head(x.reshape(batch, -1))
        return l2_normalize(x.float())

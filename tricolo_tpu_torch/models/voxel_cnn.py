"""Voxel encoder, channels-last: masked (submanifold) BN and all-site BN.

Port of ``tricolo_tpu.models.voxel_cnn.VoxelCNNEncoder``, eval and train,
under both of its BatchNorm semantics (``masked_bn``). With
``masked_bn=true`` (the config default) on every input the JAX package
takes:

* **windowed_compact** (``rows`` (B, k, s³) + ``row_ids`` (B, k)): per-sample
  packed rows of each active 8³ tile's halo'd window (s = 8 + 2·halo) and
  their local tile ids. Halo 3 (14³ rows): blocks 1-2 run on the rows —
  VALID 3³ conv, then K1 (``ops.bn_relu_pool``). Block 1 normalises with two
  masks: zero over the full-region occupancy ``m_full[1:-1]³`` and pool the
  centre occupancy ``pad(m_full[3:-3]³, 2)``; block 2's single mask is the
  pooled centre mask cropped by its VALID conv. K2 (``ops.scatter_tiles_ps``)
  then places the (B, k, 2³, 64) tiles and their mask on dense 16³ grids.
  Halo 1 (10³ rows) runs block 1 on the rows.
* **windowed** (``windows`` (B·tg³, s³) + ``tile_occ`` (B·tg³,)): every
  tile's rows; the active ones are taken on the device
  (``ops.tile_sparse.compact_ids`` under the static global budget), run as
  above, and K2's global entry (``ops.scatter_tiles_global``) places them.
* **dense** (``voxels`` (B, D, D, D, 4): RGB + the occupancy channel, or 3
  channels with the nonzero-RGB mask): the dense-input plan. With
  ``tile_sparse`` the first ``min(tile_sparse_blocks, 3)`` blocks run on the
  active tiles of the input occupancy (``ops.active_tile_ids``): K7
  (``ops.gather_tiles``) cuts halo-1 windows of x and halo-0 tiles of the
  mask, a VALID conv and K1 run on them, and K2's global entry scatters
  both onto the half-resolution grid.

The remaining blocks run dense (SAME conv + K1), and the NDHWC flatten
feeds the MLP head. Every masked path is exact against the dense masked
path (the JAX package's tests), so checkpoints interchange; the parameter
tree is one.

With ``masked_bn=false`` (the JAX class default and the torch-oracle
parity path) the encoder takes dense ``voxels`` only, as the JAX package
does: a 4th (occupancy) channel is dropped, RGB is padded to 4 channels,
``tile_sparse`` is ignored, and all five blocks run a SAME conv and
BatchNorm over every site → ReLU → MaxPool(2³) through K1's unmasked entry
(``ops.bn_relu_pool_unmasked``, the Pallas ``_fwd_kernel``'s function);
windowed input raises ``ValueError``.

In ``train()`` mode each block normalises with its batch statistics
through ``ops.masked_bn_relu_pool_train`` (masked: K1 forward with the
argmax index, K3 backward) or ``ops.bn_relu_pool_train`` (all sites: K1's
and K3's unmasked entries) and updates ``running_mean``/``running_var`` by
hand: flax momentum 0.9 and the *biased* batch variance, as the JAX
package does (``nn.BatchNorm3d``'s own update would use the unbiased
variance). K2 and K7 run through their autograd Functions.

Under ``parallel.attach`` with more than one rank (``bn_group``), the
train-mode statistics and the backward's per-channel sums are all-reduced
over the ranks: the global batch's BatchNorm, as pjit computes it.

With ``remat`` (``precision.remat_voxel``; JAX wraps the class in
``nn.remat``) the train-mode forward runs under
``torch.utils.checkpoint`` (non-reentrant): it keeps only its inputs and
runs again in the backward, so a remat step launches K1 10 times and the
per-sample K2 4 times (K3 still 5). The blocks then hand their batch
statistics out of the checkpointed region and the encoder updates the
running statistics once, from the first pass.

Convolutions are ``F.conv3d`` on channels-last-3d views (cuDNN on the
card), as the JAX package leaves them to XLA, with two exceptions, each
taken by the conv's form in bf16 on the card: the input gradient of a
VALID (tile) conv whose input needs one, at a form K8 is built for
(``ops.conv3d.takes_kernel_dgrad``: block 2 on the window rows, the dense
plan's tile-sparse blocks past the first, at ``ef_dim`` 32), is kernel K8
(``ops.conv3d_valid_kernel_dgrad``); the weight gradient of a VALID conv at
a form K9 is built for (``ops.conv3d.takes_kernel_wgrad``: block 1 on the
window rows and the dense plan's first tile-sparse block, at ``ef_dim``
32), is kernel K9 (``ops.conv3d_valid_kernel_wgrad``). The CPU, an
f32-compute step and other widths keep autograd's gradients.
``explicit_dgrad`` writes the VALID convs' input gradient as a forward conv
instead (``ops.conv3d``), as the JAX package applies it to VALID convs
only, and keeps cuDNN's weight gradient. ``use_kernels=False`` runs the
same path through the kernels' plain PyTorch versions (the reference the
kernels are held against on the card; for K8 and K9, autograd's own
convolution backward).

The conv weights, the BN γ, β and the head are created in ``param_dtype``
and used in the compute dtype (``common.in_compute``); the running
statistics stay f32. K1 and K3's train entries take γ, β as they are: the
statistics and the fold run in f32, and dγ, dβ come back in γ's dtype, as
the JAX package's ``fused_bn_pool`` ops return them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..data.device_prep import unpack_windowed_rows
from ..ops.bn_relu_pool import (
    bn_relu_pool,
    bn_relu_pool_plain,
    bn_relu_pool_train,
    fold_bn,
    masked_bn_relu_pool_train,
)
from ..ops.conv3d import (
    conv3d_valid_explicit_dgrad,
    conv3d_valid_kernel_dgrad,
    conv3d_valid_kernel_wgrad,
    takes_kernel_dgrad,
    takes_kernel_wgrad,
)
from ..ops.tile_gather import gather_tiles_autograd
from ..ops.tile_scatter import scatter_tiles, scatter_tiles_global_autograd
from ..ops.tile_sparse import active_tile_ids, compact_ids, tile_budget
from .common import MLPHead, hold_affine_in, in_compute, l2_normalize

_TILE = 8
_MOMENTUM = 0.9  # flax convention: running = 0.9·running + 0.1·batch


def _update_running(bn, mean, var) -> None:
    with torch.no_grad():
        bn.running_mean.copy_(_MOMENTUM * bn.running_mean + (1.0 - _MOMENTUM) * mean)
        bn.running_var.copy_(_MOMENTUM * bn.running_var + (1.0 - _MOMENTUM) * var)


class ConvBlock(nn.Module):
    """Conv3D(3³, no bias) → BN → ReLU [→ zero] → MaxPool(2³): masked BN
    with a ``zero_mask``, all-site BN without one. ``bn_group``: the
    process group whose global batch the train-mode statistics span (None:
    this process's batch). ``stats_sink``: a list that takes (mean, var)
    instead of the running statistics' update (the remat forward)."""

    bn_group = None
    stats_sink = None

    def __init__(self, cin: int, features: int, param_dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, 3, bias=False, dtype=param_dtype)
        # Holds weight/bias/running_mean/running_var; folded by fold_bn.
        self.bn = nn.BatchNorm3d(features, eps=1e-5)
        hold_affine_in(self.bn, param_dtype)

    def forward(self, x, zero_mask=None, stats_mask=None, padding: int = 0,
                use_kernels: bool = True, explicit_dgrad: bool = False):
        """(pooled, pooled mask) under masks; pooled alone without them."""
        x = x.permute(0, 4, 1, 2, 3)
        weight = in_compute(self.conv.weight)
        if padding == 0 and explicit_dgrad:
            y = conv3d_valid_explicit_dgrad(x, weight)
        elif padding == 0 and use_kernels and takes_kernel_dgrad(x, weight):
            y = conv3d_valid_kernel_dgrad(x, weight)
        elif padding == 0 and use_kernels and takes_kernel_wgrad(x, weight):
            y = conv3d_valid_kernel_wgrad(x, weight)
        else:
            y = F.conv3d(x, weight, padding=padding)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        bn = self.bn
        if zero_mask is not None:
            zero_mask = zero_mask.to(y.dtype).contiguous()
        if stats_mask is not None:
            stats_mask = stats_mask.to(y.dtype).contiguous()
        if self.training:
            if zero_mask is None:
                pooled, mean, var = bn_relu_pool_train(y, bn.weight, bn.bias, bn.eps,
                                                       use_kernels, self.bn_group)
                out = pooled
            else:
                # Two masks: statistics over stats_mask, zeroing over zero_mask.
                stats = zero_mask if stats_mask is None else stats_mask
                pooled, mean, var, pooled_mask = masked_bn_relu_pool_train(
                    y, bn.weight, bn.bias, stats, zero_mask, bn.eps, use_kernels, self.bn_group
                )
                out = pooled, pooled_mask
            if self.stats_sink is None:
                _update_running(bn, mean, var)
            else:
                self.stats_sink.append((mean, var))
            return out
        mul, add = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                           bn.eps, y.dtype)
        op = bn_relu_pool if use_kernels else bn_relu_pool_plain
        return op(y, mul, add, zero_mask, stats_mask)


class VoxelCNNEncoder(nn.Module):
    """Packed rows, window rows or a dense grid → (B, out_dim) float32."""

    def __init__(self, voxel_size: int = 64, ef_dim: int = 32, z_dim: int = 512,
                 out_dim: int = 512, compute_dtype=torch.float32, tile_sparse: bool = False,
                 tile_sparse_blocks: int = 2, tile_budget_frac: float = 0.5,
                 explicit_dgrad: bool = False, masked_bn: bool = True, remat: bool = False,
                 param_dtype=torch.float32):
        super().__init__()
        if voxel_size % 32:
            raise ValueError(f"voxel_size must be a multiple of 32, got {voxel_size}")
        self.voxel_size = voxel_size
        self.masked_bn = masked_bn
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.use_kernels = True
        self.tile_sparse = tile_sparse
        self.tile_sparse_blocks = int(tile_sparse_blocks)
        self.tile_budget_frac = float(tile_budget_frac)
        channels = (ef_dim, ef_dim * 2, ef_dim * 4, ef_dim * 8, z_dim)
        cins = (4,) + channels[:-1]
        self.blocks = nn.ModuleList(ConvBlock(c, f, param_dtype)
                                    for c, f in zip(cins, channels))
        self.explicit_dgrad = explicit_dgrad  # for the VALID (tile) convs
        flat = (voxel_size // 32) ** 3 * z_dim
        self.head = MLPHead(flat, out_dim, out_dim, param_dtype=param_dtype)
        with torch.no_grad():
            # RGB padded 3 → 4 input channels: torch's init for the real
            # 3-channel conv (fan_in 27·3), zero taps on the pad channel.
            bound = 1.0 / math.sqrt(27 * 3)
            self.blocks[0].conv.weight.uniform_(-bound, bound)
            self.blocks[0].conv.weight[:, 3].zero_()

    def forward(self, rows=None, row_ids=None, *, voxels=None, windows=None, tile_occ=None):
        """One of: ``rows`` (B, k, s³) int32 + ``row_ids`` (B, k) int32
        (windowed_compact); ``windows`` (B·tg³, s³) int32 + ``tile_occ``
        (B·tg³,) (windowed); ``voxels`` (B, D, D, D, 3 or 4) float (dense)."""
        inputs = dict(rows=rows, row_ids=row_ids, voxels=voxels, windows=windows,
                      tile_occ=tile_occ)
        tracing.count("voxel.tile_rows", self.tile_rows(rows, voxels, windows))
        if self.remat and self.training and torch.is_grad_enabled():
            return self._remat_forward(inputs)
        return self._forward(**inputs)

    def tile_rows(self, rows=None, voxels=None, windows=None) -> int:
        """The tile rows a call runs its first blocks on, from shapes: B·k
        (windowed_compact), the static budget (windowed, the dense plan's
        tile-sparse blocks), else 0. The ``voxel.tile_rows`` counter adds
        it a call (a remat recompute does not count again)."""
        tg3 = (self.voxel_size // _TILE) ** 3
        if voxels is not None:
            sparse = self.masked_bn and self.tile_sparse and min(self.tile_sparse_blocks, 3) > 0
            return tile_budget(self.tile_budget_frac, voxels.shape[0], tg3) if sparse else 0
        if windows is not None:
            return tile_budget(self.tile_budget_frac, windows.shape[0] // tg3, tg3)
        return rows.shape[0] * rows.shape[1] if rows is not None and rows.ndim == 3 else 0

    def _remat_forward(self, inputs: dict):
        """The forward under ``checkpoint``; every path runs the five blocks
        once, in order, and their statistics come out of it as outputs to
        update the running statistics here, once (the recompute in the
        backward fills a sink nobody reads)."""
        names = [name for name, value in inputs.items() if value is not None]

        def run(*tensors):
            sink: list = []
            for block in self.blocks:
                block.stats_sink = sink
            try:
                out = self._forward(**dict(zip(names, tensors)))
            finally:
                for block in self.blocks:
                    block.stats_sink = None
            return (out, *(t for pair in sink for t in pair))

        out, *stats = checkpoint(run, *(inputs[name] for name in names), use_reentrant=False)
        for i, block in enumerate(self.blocks):
            _update_running(block.bn, stats[2 * i].detach(), stats[2 * i + 1].detach())
        return out

    def _forward(self, rows=None, row_ids=None, voxels=None, windows=None, tile_occ=None):
        """The tile stage (the blocks on tile rows and their scatter, or the
        dense input's preparation), then the dense tail. At tracing level 2
        each stage is a span (``forward.voxel.tiles`` / ``.dense``) and its
        output a mark, so that the backward opens ``backward.voxel.dense``
        and then ``backward.voxel.tiles``."""
        with tracing.span("forward.voxel.tiles", level=2):
            x, mask, dense_from = self._tile_stage(rows, row_ids, voxels, windows, tile_occ)
        x = tracing.mark(x, "backward.voxel.tiles", level=2)
        with tracing.span("forward.voxel.dense", level=2):
            out = self._dense_tail(x, mask, dense_from)
        return tracing.mark(out, "backward.voxel.dense", level=2)

    def _tile_stage(self, rows, row_ids, voxels, windows, tile_occ):
        """→ (x, mask or None, index of the first dense block) on the grid
        the dense tail starts from."""
        if voxels is not None:
            return self._dense_input(voxels)
        if not self.masked_bn:
            # Windowed rows are tile-sparse input: only the masked
            # (submanifold) semantics makes that restriction exact.
            raise ValueError("windowed voxel input requires masked_bn=true")
        if windows is not None:
            return self._full_windowed_tiles(windows, tile_occ)
        if rows is None or row_ids is None or rows.ndim != 3 or row_ids.ndim != 2:
            raise ValueError(
                "compact windowed input must be per-sample: rows (B, k, s³) + ids (B, k); "
                f"got {None if rows is None else tuple(rows.shape)} / "
                f"{None if row_ids is None else tuple(row_ids.shape)}"
            )
        batch, k = rows.shape[:2]
        x_t, m_t, dense_from, grid = self._row_blocks(rows.reshape(batch * k, -1))
        t = x_t.shape[1]
        ids = row_ids.to(torch.int32).contiguous()
        kernels = self.use_kernels
        x = scatter_tiles(x_t.reshape(batch, k, t, t, t, -1), ids, grid, kernels)
        mask = scatter_tiles(m_t.reshape(batch, k, t, t, t, 1), ids, grid, kernels)
        return x, mask, dense_from

    def _row_blocks(self, rows):
        """Blocks 1(-2) on packed window rows (R, s³) → (tiles, tile masks,
        index of the first dense block, the tiles' grid)."""
        for halo in (1, 3):
            if (_TILE + 2 * halo) ** 3 == rows.shape[-1]:
                break
        else:
            raise ValueError(
                f"windowed rows have {rows.shape[-1]} voxels; expected 10³ "
                "(halo 1) or 14³ (halo 3)"
            )
        valid = dict(use_kernels=self.use_kernels, explicit_dgrad=self.explicit_dgrad)
        s = _TILE + 2 * halo
        x_t, m_full = unpack_windowed_rows(rows.reshape(-1, s, s, s), self.compute_dtype)
        if halo == 1:
            m_t = m_full[:, 1:-1, 1:-1, 1:-1]
            x_t, m_t = self.blocks[0](x_t, m_t, **valid)
            return x_t, m_t, 1, self.voxel_size // 2
        mz1 = m_full[:, 1:-1, 1:-1, 1:-1]
        ms1 = F.pad(m_full[:, 3:-3, 3:-3, 3:-3], (0, 0, 2, 2, 2, 2, 2, 2))
        x_t, m_p = self.blocks[0](x_t, mz1, ms1, **valid)
        m2 = m_p[:, 1:-1, 1:-1, 1:-1]
        x_t, m_t = self.blocks[1](x_t, m2, **valid)
        return x_t, m_t, 2, self.voxel_size // 4

    def _full_windowed_tiles(self, windows, tile_occ):
        """The ``windowed`` transfer: take the active rows under the static
        budget, run them as the compact rows, scatter by global id."""
        tg3 = (self.voxel_size // _TILE) ** 3
        n_rows = windows.shape[0]
        batch = n_rows // tg3
        ids = compact_ids(tile_occ.reshape(-1) > 0,
                          tile_budget(self.tile_budget_frac, batch, tg3))
        valid = ids < n_rows
        rows = torch.where(valid[:, None], windows[torch.where(valid, ids, 0).long()], 0)
        x_t, m_t, dense_from, grid = self._row_blocks(rows)
        kernels = self.use_kernels
        x = scatter_tiles_global_autograd(x_t, ids, batch, grid, kernels)
        mask = scatter_tiles_global_autograd(m_t, ids, batch, grid, kernels)
        return x, mask, dense_from

    def _dense_input(self, voxels):
        """The dense-input plan's tile stage: the sparse blocks on the
        input's active tiles, then dense masked blocks; without
        ``masked_bn``, the padded input for five dense all-site blocks."""
        D = self.voxel_size
        if voxels.ndim != 5 or voxels.shape[1:4] != (D, D, D):
            raise ValueError(f"expected {D}^3 grids, got {tuple(voxels.shape[1:4])}")
        x = voxels.to(self.compute_dtype)
        if not self.masked_bn:
            return F.pad(x[..., :3], (0, 1)).contiguous(), None, 0
        if x.shape[-1] == 4:
            mask = x[..., 3:]
        else:
            # No occupancy channel: any nonzero RGB (an occupied pure-black
            # voxel reads as empty — feed 4-channel batches for exactness).
            mask = (voxels[..., :3] != 0).any(dim=-1, keepdim=True).to(self.compute_dtype)
        x = F.pad(x[..., :3], (0, 1)).contiguous()  # the zero pad channel
        mask = mask.contiguous()
        batch = x.shape[0]
        n_sparse = min(self.tile_sparse_blocks, 3) if self.tile_sparse else 0
        kernels = self.use_kernels
        if n_sparse:
            tg3 = (D // _TILE) ** 3
            ids = active_tile_ids(mask, _TILE, tile_budget(self.tile_budget_frac, batch, tg3))
        grid = D
        for i in range(n_sparse):
            tile = _TILE >> i  # the tile edge at this block's input grid
            x_t = gather_tiles_autograd(x, ids, tile, 1, kernels)
            m_t = gather_tiles_autograd(mask, ids, tile, 0, kernels)
            x_t, m_t = self.blocks[i](x_t, m_t, use_kernels=kernels,
                                      explicit_dgrad=self.explicit_dgrad)
            grid //= 2
            x = scatter_tiles_global_autograd(x_t, ids, batch, grid, kernels)
            mask = scatter_tiles_global_autograd(m_t, ids, batch, grid, kernels)
        return x, mask, n_sparse

    def _dense_tail(self, x, mask, dense_from: int):
        """Dense SAME-conv blocks from ``dense_from`` on, masked unless
        ``mask`` is None, then the head."""
        for block in self.blocks[dense_from:]:
            if mask is None:
                x = block(x, padding=1, use_kernels=self.use_kernels)
            else:
                x, mask = block(x, mask, padding=1, use_kernels=self.use_kernels)
        x = self.head(x.reshape(x.shape[0], -1))
        return l2_normalize(x.float())

"""Helpers of the tile-sparse voxel path (the port's copies of
``tricolo_tpu.ops.tile_sparse``'s helpers).

Host side (numpy): per-sample and total active-tile counts of a packed
batch, the windowed_compact row budget and the windowed halo. Device side
(torch): the static global tile budget and
``active_tile_ids``, the ascending compaction of the active tiles that the
dense-input plan and the full ``windowed`` transfer run on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def host_sample_tile_counts(flat_u32: np.ndarray, voxel_size: int, tile: int = 8):
    """Per-sample active-tile counts of a packed (B, N) host batch."""
    counts = []
    tg = voxel_size // tile
    for row in flat_u32:
        sites = row[row != np.uint32(0xFFFFFFFF)]
        x = (sites >> 16) & 0xFF
        y = (sites >> 8) & 0xFF
        z = sites & 0xFF
        tid = ((x // tile) * tg + (y // tile)) * tg + (z // tile)
        counts.append(len(np.unique(tid)))
    return counts


def host_tile_count(flat_u32: np.ndarray, voxel_size: int, tile: int = 8) -> int:
    """Total active tiles of a packed host batch (the trainer's canary)."""
    return int(sum(host_sample_tile_counts(flat_u32, voxel_size, tile)))


def sample_tile_budget(budget, tg3: int, max_tiles: int | None = None) -> int:
    """Per-sample windowed_compact row budget k: an explicit int, or
    ``"auto"``/None = the split's measured max per-sample tile count (no
    truncation possible). Floor 8, clamped to tg³."""
    if isinstance(budget, (int, float)) and not isinstance(budget, bool):
        k = int(budget)
        if k <= 0:
            raise ValueError(f"tile_budget must be positive, got {budget}")
    else:
        if max_tiles is None:
            raise ValueError(
                "tile_budget='auto' needs the split's measured max per-sample "
                "tile count (dataset.max_voxel_tiles)"
            )
        k = int(max_tiles)
    return min(max(8, k), tg3)


def windowed_halo(tile_sparse_blocks: int) -> int:
    """Row halo from the encoder's sparse depth: ≥2 blocks need each tile's
    full block-2 input support (14³ rows, halo 3); 1 block needs 10³."""
    return 3 if int(tile_sparse_blocks) >= 2 else 1


def tile_budget(frac: float, batch: int, tg3: int) -> int:
    """The static global active-tile budget: ceil(frac·batch·tg³/256)·256,
    clamped to the batch's tile count. One definition for the dense-input
    plan, the full-windowed row take and the trainer's canary."""
    budget = -(-int(frac * batch * tg3) // 256) * 256
    return min(budget, batch * tg3)


def _tile_occupancy(mask: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, D, D, D[, 1]) mask → (B, tg, tg, tg) bool: tile holds an active site."""
    if mask.ndim == 5:
        mask = mask[..., 0]
    B, D = mask.shape[0], mask.shape[1]
    tg = D // tile
    tiled = mask.reshape(B, tg, tile, tg, tile, tg, tile) > 0
    return tiled.any(dim=6).any(dim=4).any(dim=2)


def compact_ids(flags: torch.Tensor, budget: int) -> torch.Tensor:
    """Ascending indices of the true entries of a 1-D bool tensor, the first
    ``budget`` of them, padded with ``flags.numel()``: ``jnp.nonzero(size=
    budget, fill_value=n)``. A cumsum and a scatter on the device — no
    host synchronisation. Returns (budget,) int32."""
    n = flags.numel()
    pos = torch.cumsum(flags.to(torch.int32), dim=0) - 1
    slot = torch.where(flags & (pos < budget), pos, budget).long()
    out = torch.full((budget + 1,), n, dtype=torch.int32, device=flags.device)
    # Every kept entry has its own slot; the rest share the trash slot.
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=flags.device))
    return out[:budget]


def active_tile_ids(mask: torch.Tensor, tile: int, budget: int) -> torch.Tensor:
    """(budget,) int32 ascending global ids (b·tg³ + (tz·tg + ty)·tg + tx) of
    the tiles holding ≥ 1 active site, padded with B·tg³. A batch with more
    active tiles than ``budget`` keeps its lowest ids."""
    return compact_ids(_tile_occupancy(mask, tile).reshape(-1), budget)

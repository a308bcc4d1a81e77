"""Host-side helpers of the tile-sparse voxel path (the port's copies of
``tricolo_tpu.ops.tile_sparse``'s numpy helpers)."""

from __future__ import annotations

import numpy as np


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

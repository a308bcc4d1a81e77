"""The reference's own view of a batch, from the raw items.

The items are the traffic generator's: tokens, uint8 views and packed u32
voxel sites (c0<<16 | c1<<8 | c2) with RGB words (r | g<<8 | b<<16 |
occupied<<24). From them this module works out again what the program's
loader and device preparation derive:

* which items a train batch holds: the loader's epoch order, a
  ``default_rng((seed, epoch))`` permutation of the epoch's indices, each
  index cycling over the distinct items, batches in order, the tail dropped;
* the dense grid of a batch (RGB / 255 and the occupancy) for the model;
* the windowed_compact transfer: each sample's active 8³ tiles in
  ascending id ((t0·tg + t1)·tg + t2), at most k of them, k the largest
  tile count of any item (at least 8, at most tg³), ids past a sample's
  count tg³; and each tile's row, the 14³ window (halo 3) of packed RGB
  words around it, zeros past the grid and in padding rows.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 8
HALO = 3


def batch_items(seed: int, epoch: int, length: int, n_items: int, batch: int,
                index: int) -> np.ndarray:
    order = np.random.default_rng((seed, epoch)).permutation(length)
    return order[index * batch:(index + 1) * batch] % n_items


def decode(flat: np.ndarray):
    return (flat >> 16) & 0xFF, (flat >> 8) & 0xFF, flat & 0xFF


def packed_grid(items: list, D: int, device) -> torch.Tensor:
    """(B, D, D, D) int32: each site's packed RGB word, 0 elsewhere."""
    grid = torch.zeros(len(items), D ** 3, dtype=torch.int32)
    for b, item in enumerate(items):
        c0, c1, c2 = decode(item["voxel_flat"].astype(np.int64))
        idx = torch.from_numpy((c0 * D + c1) * D + c2)
        grid[b, idx] = torch.from_numpy(item["voxel_rgb"].view(np.int32))
    return grid.reshape(len(items), D, D, D).to(device)


def dense_voxels(grid: torch.Tensor):
    """(rgb (B, D, D, D, 3) float in [0, 1], occupied (B, D, D, D) float)."""
    rgb = torch.stack([(grid >> s) & 0xFF for s in (0, 8, 16)], dim=-1).float() / 255.0
    return rgb, ((grid >> 24) & 1).float()


def tile_ids(item: dict, D: int) -> np.ndarray:
    tg = D // TILE
    c0, c1, c2 = (c.astype(np.int64) // TILE for c in decode(item["voxel_flat"]))
    return np.unique((c0 * tg + c1) * tg + c2)


def rows_budget(all_items: list, D: int) -> int:
    tg3 = (D // TILE) ** 3
    return min(max(8, max(len(tile_ids(it, D)) for it in all_items)), tg3)


def windowed_rows(grid: torch.Tensor, items: list, D: int, k: int):
    """(rows (B, k, 14³) int32, ids (B, k) int32) of the windowed_compact
    transfer."""
    tg = D // TILE
    s = TILE + 2 * HALO
    ids = torch.full((len(items), k), tg ** 3, dtype=torch.int32)
    for b, item in enumerate(items):
        t = torch.from_numpy(tile_ids(item, D)[:k].astype(np.int32))
        ids[b, :len(t)] = t
    ids = ids.to(grid.device)
    padded = torch.nn.functional.pad(grid, (HALO,) * 6)
    windows = padded.unfold(1, s, TILE).unfold(2, s, TILE).unfold(3, s, TILE)
    valid = ids < tg ** 3
    safe = torch.where(valid, ids, 0).long()
    b = torch.arange(len(items), device=grid.device)[:, None].expand_as(safe)
    rows = windows[b, safe // (tg * tg), (safe // tg) % tg, safe % tg]
    rows = torch.where(valid[..., None, None, None], rows, 0)
    return rows.reshape(len(items), k, s ** 3), ids

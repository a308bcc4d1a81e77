"""Batch preparation: host-side voxel packing/windowing and device unpack.

Host side (runs in the loader's prefetch thread): ``densify_on_host``,
``windowed_on_host`` and ``windowed_compact_on_host`` produce exactly the
arrays of their ``tricolo_tpu.data.device_prep`` namesakes through the C++
sweeps of the host loader (``tricolo_tpu_torch.native``, built from
``csrc/host_loader.cpp``). Beside each stands its numpy formulation,
``*_plain``: the tests' reference, used by nothing on the main path.
``pack_sparse_voxels`` packs one sample in numpy.

Device side (torch): ``normalize_images``, ``densify_voxels``,
``unpack_dense_voxels``, ``unpack_windowed_rows`` and
``prepare_device_batch``, which the eval and train steps call on the
device. torch's ``uint32`` supports few operations, so packed words travel
as ``int32`` tensors holding the same bits. Bits 25-31 of a packed *RGB*
word are always zero, so shifts and masks on its int32 view give the u32
answers. A packed *site* word is different: its padding sentinel
``0xFFFFFFFF`` is −1 in the view, and right shifts of it are arithmetic,
so ``densify_voxels`` tests for the sentinel before it decodes x/y/z.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .datasets import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, CLIP_KEYS

VOXEL_PAD_SENTINEL = np.uint32(0xFFFFFFFF)
# Byte 3 of a packed RGB word flags the site as occupied (alpha>0).
VOXEL_OCCUPIED_BIT = np.uint32(1 << 24)


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., H, W, 3) uint8 → normalized float with CLIP statistics."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=dtype, device=images_u8.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=dtype, device=images_u8.device)
    x = images_u8.to(dtype) / 255.0
    return (x - mean) / std


def unpack_windowed_rows(rows: torch.Tensor, dtype=torch.float32):
    """Packed window rows (int32 view of the u32 words) →
    (rgb0 (..., 4) float, mask (..., 1) float).

    Channel 3 of ``rgb0`` is the zero pad channel of the Cin=4 block-1 conv
    (its weights are zero), not the occupancy bit; the occupancy bit is
    returned separately as the mask.
    """
    if rows.dtype != torch.int32:
        raise TypeError(f"packed rows must be an int32 view, got {rows.dtype}")
    x = torch.stack(
        [
            (rows & 0xFF).to(dtype) / 255.0,
            ((rows >> 8) & 0xFF).to(dtype) / 255.0,
            ((rows >> 16) & 0xFF).to(dtype) / 255.0,
            torch.zeros(rows.shape, dtype=dtype, device=rows.device),
        ],
        dim=-1,
    )
    mask = ((rows >> 24) & 0x1).to(dtype)[..., None]
    return x, mask


def unpack_dense_voxels(grid: torch.Tensor, dtype=torch.float32, with_mask: bool = False):
    """Dense packed-RGB grid (B, D, D, D) (int32 view of the u32 words) →
    (B, D, D, D, 3) float RGB/255, plus a 4th channel with ``with_mask``:
    the 0/1 occupancy flag of bit 24 (an occupied pure-black voxel is
    occupied)."""
    if grid.dtype != torch.int32:
        raise TypeError(f"packed grid must be an int32 view, got {grid.dtype}")
    channels = [
        (grid & 0xFF).to(dtype) / 255.0,
        ((grid >> 8) & 0xFF).to(dtype) / 255.0,
        ((grid >> 16) & 0xFF).to(dtype) / 255.0,
    ]
    if with_mask:
        channels.append(((grid >> 24) & 0x1).to(dtype))
    return torch.stack(channels, dim=-1)


def densify_voxels(flat: torch.Tensor, rgb: torch.Tensor, voxel_size: int,
                   dtype=torch.float32, with_mask: bool = False):
    """Packed sparse batch (int32 views of the (B, N) u32 site and RGB
    words) → dense (B, D, D, D, 3 or 4) float grid on the device.

    Each site's RGB word is set into a flat per-sample buffer of D³ slots
    plus N trash slots; a padding word (−1 in the view) goes to its own
    trash slot, which the final slice drops, and an index past the batch
    buffer goes to one extra slot — the drop rule of the JAX package's
    ``.at[].set``. Sites are unique, so the set is deterministic. Input data:
    no gradient."""
    if flat.dtype != torch.int32 or rgb.dtype != torch.int32:
        raise TypeError("packed site and RGB words must be int32 views")
    batch, n_points = flat.shape
    d3 = voxel_size**3
    stride = d3 + n_points
    pad = flat == -1  # the 0xFFFFFFFF sentinel, before any shift
    x = ((flat >> 16) & 0xFF).long()
    y = ((flat >> 8) & 0xFF).long()
    z = (flat & 0xFF).long()
    local = (x * voxel_size + y) * voxel_size + z
    point = torch.arange(n_points, device=flat.device)[None, :]
    local = torch.where(pad, d3 + point, local)
    idx = (torch.arange(batch, device=flat.device)[:, None] * stride + local).reshape(-1)
    total = batch * stride
    idx = torch.where(idx < total, idx, total)
    grid = torch.zeros(total + 1, dtype=torch.int32, device=flat.device)
    grid[idx] = rgb.reshape(-1)
    grid = grid[:total].reshape(batch, stride)[:, :d3]
    grid = grid.reshape(batch, voxel_size, voxel_size, voxel_size)
    return unpack_dense_voxels(grid, dtype, with_mask)


def prepare_device_batch(batch: dict, voxel_size: int, dtype=torch.float32) -> dict:
    """Expand a device batch (``inference.to_device_batch``) into the
    tensors TriCoLoNet consumes, as the JAX package's namesake does inside
    its jitted steps: tokens and the precached CLIP features (float32)
    pass through; images are normalised; the
    windowed transfers' packed rows pass through (the encoder unpacks them
    after its row take); a dense packed grid is unpacked and packed sites
    are densified into ``voxels`` (B, D, D, D, 4: RGB and the occupancy
    channel the masked encoder splits off)."""
    out: dict = {"tokens": batch["tokens"]}
    if "images" in batch:
        out["images"] = normalize_images(batch["images"], dtype)
    if "voxel_windows" in batch:
        out["voxel_windows"] = batch["voxel_windows"]
        out["voxel_tile_occ"] = batch["voxel_tile_occ"]
    elif "voxel_rows" in batch:
        out["voxel_rows"] = batch["voxel_rows"]
        out["voxel_row_ids"] = batch["voxel_row_ids"]
    elif "voxel_grid" in batch:
        out["voxels"] = unpack_dense_voxels(batch["voxel_grid"], dtype, with_mask=True)
    elif "voxel_flat" in batch:
        out["voxels"] = densify_voxels(batch["voxel_flat"], batch["voxel_rgb"], voxel_size,
                                       dtype, with_mask=True)
    for key in CLIP_KEYS:
        if key in batch:
            out[key] = batch[key]
    return out


def pack_sparse_voxels(coords: np.ndarray, feats: np.ndarray, n_pad: int):
    """One sample's sorted-unique (N, 3) uint8 coords + (N, 3) uint8 RGB →
    (flat (n_pad,) u32 with 0xFFFFFFFF padding, rgb (n_pad,) u32)."""
    n = min(coords.shape[0], n_pad)
    c = coords[:n].astype(np.uint32)
    f = feats[:n].astype(np.uint32)
    flat = np.full(n_pad, VOXEL_PAD_SENTINEL, dtype=np.uint32)
    rgb = np.zeros(n_pad, dtype=np.uint32)
    flat[:n] = (c[:, 0] * 256 + c[:, 1]) * 256 + c[:, 2]
    rgb[:n] = f[:, 0] | (f[:, 1] << 8) | (f[:, 2] << 16) | VOXEL_OCCUPIED_BIT
    return flat, rgb


def densify_on_host(flat_u32: np.ndarray, rgb_u32: np.ndarray, voxel_size: int):
    """Packed sparse (B, N) → dense (B, D, D, D) u32 RGB words on the host
    (the ``dense`` transfer's collation), by the C++ sweep."""
    return native.packed_to_dense(flat_u32, rgb_u32, voxel_size)


def densify_on_host_plain(flat_u32: np.ndarray, rgb_u32: np.ndarray, voxel_size: int):
    """numpy version of ``densify_on_host``. Slot D³ swallows padding and
    out-of-range coordinates."""
    batch = flat_u32.shape[0]
    d3 = voxel_size**3
    x = (flat_u32 >> 16) & 0xFF
    y = (flat_u32 >> 8) & 0xFF
    z = flat_u32 & 0xFF
    local = (x.astype(np.int64) * voxel_size + y.astype(np.int64)) * voxel_size + z.astype(
        np.int64
    )
    grid = np.zeros((batch, d3 + 1), np.uint32)
    out_of_range = (x >= voxel_size) | (y >= voxel_size) | (z >= voxel_size)
    local = np.where((flat_u32 == VOXEL_PAD_SENTINEL) | out_of_range, d3, local)
    np.put_along_axis(grid, local, rgb_u32, axis=1)
    return grid[:, :d3].reshape(batch, voxel_size, voxel_size, voxel_size)


def _site_windows(flat_u32: np.ndarray, voxel_size: int, tile: int, halo: int):
    """Per-site home tile, neighbour window per axis and validity.

    A site lands in its home tile's window and, along each axis where it
    sits within ``halo`` of the tile edge, in the neighbour's halo — up to
    8 windows in all (the ``pick`` loop of the callers)."""
    tg = voxel_size // tile
    v = np.stack(
        [(flat_u32 >> 16) & 0xFF, (flat_u32 >> 8) & 0xFF, flat_u32 & 0xFF]
    ).astype(np.int64)
    valid = (flat_u32 != VOXEL_PAD_SENTINEL) & (v < voxel_size).all(axis=0)
    home = v // tile
    mod = v % tile
    nbr = np.where(
        (mod < halo) & (home > 0),
        home - 1,
        np.where((mod >= tile - halo) & (home + 1 < tg), home + 1, -1),
    )
    return v, valid, home, nbr


def _window_picks(v, valid, home, nbr, tile: int, halo: int):
    """Yield (window (3, B, N), selected (B, N), local flat offset) for each
    of the 8 home/neighbour combinations."""
    s = tile + 2 * halo
    for pick in range(8):
        use_nbr = np.array([(pick >> 2) & 1, (pick >> 1) & 1, pick & 1], bool)
        w = np.where(use_nbr.reshape(3, 1, 1), nbr, home)
        sel = valid & (w >= 0).all(axis=0)
        local = v - (w * tile - halo)
        yield w, sel, (local[0] * s + local[1]) * s + local[2]


def windowed_on_host(
    flat_u32: np.ndarray,
    rgb_u32: np.ndarray,
    voxel_size: int,
    tile: int = 8,
    halo: int = 1,
):
    """Packed sparse (B, N) → ((B·tg³, s³) u32 window rows, (B·tg³,) u8
    per-tile occupancy), s = tile + 2·halo, by the C++ sweep."""
    return native.packed_to_windowed(flat_u32, rgb_u32, voxel_size, tile, halo)


def windowed_on_host_plain(
    flat_u32: np.ndarray,
    rgb_u32: np.ndarray,
    voxel_size: int,
    tile: int = 8,
    halo: int = 1,
):
    """numpy version of ``windowed_on_host``."""
    batch = flat_u32.shape[0]
    tg = voxel_size // tile
    tg3, s3 = tg**3, (tile + 2 * halo) ** 3
    rows = np.zeros(batch * tg3 * s3, np.uint32)
    occ = np.zeros(batch * tg3, np.uint8)
    b_idx = np.broadcast_to(np.arange(batch, dtype=np.int64)[:, None], flat_u32.shape)
    v, valid, home, nbr = _site_windows(flat_u32, voxel_size, tile, halo)
    occ[(b_idx * tg3 + (home[0] * tg + home[1]) * tg + home[2])[valid]] = 1
    for w, sel, local in _window_picks(v, valid, home, nbr, tile, halo):
        idx = (b_idx * tg3 + (w[0] * tg + w[1]) * tg + w[2]) * s3 + local
        np.put(rows, idx[sel], rgb_u32[sel])
    return rows.reshape(batch * tg3, s3), occ


def windowed_compact_on_host(
    flat_u32: np.ndarray,
    rgb_u32: np.ndarray,
    voxel_size: int,
    k: int,
    tile: int = 8,
    halo: int = 1,
):
    """Per-sample compacted windows: rows for only each sample's active
    tiles, by the C++ sweep.

    Returns (rows (B, k, s³) u32, local_ids (B, k) i32, counts (B,) i32):
    each sample's first ``k`` active tiles in ascending tile-id order, zero
    rows / tg³-sentinel ids as padding, ``counts`` the total active tiles
    (count > k means truncation).
    """
    return native.packed_to_windowed_compact(flat_u32, rgb_u32, voxel_size, k, tile, halo)


def windowed_compact_on_host_plain(
    flat_u32: np.ndarray,
    rgb_u32: np.ndarray,
    voxel_size: int,
    k: int,
    tile: int = 8,
    halo: int = 1,
):
    """numpy version of ``windowed_compact_on_host``: writes the compact
    rows directly through a per-sample tile → row map instead of
    materialising every window."""
    batch = flat_u32.shape[0]
    tg = voxel_size // tile
    tg3, s3 = tg**3, (tile + 2 * halo) ** 3
    b_idx = np.broadcast_to(np.arange(batch, dtype=np.int64)[:, None], flat_u32.shape)
    v, valid, home, nbr = _site_windows(flat_u32, voxel_size, tile, halo)
    occ = np.zeros((batch, tg3), bool)
    occ[b_idx[valid], ((home[0] * tg + home[1]) * tg + home[2])[valid]] = True

    rows = np.zeros((batch, k, s3), np.uint32)
    local_ids = np.full((batch, k), tg3, np.int32)
    counts = occ.sum(axis=1).astype(np.int32)
    row_of = np.full((batch, tg3), -1, np.int64)
    for b in range(batch):
        (ids,) = np.nonzero(occ[b])
        ids = ids[:k]
        local_ids[b, : len(ids)] = ids
        row_of[b, ids] = np.arange(len(ids))
    flat_rows = rows.reshape(-1)
    for w, sel, local in _window_picks(v, valid, home, nbr, tile, halo):
        wid = np.where(sel, (w[0] * tg + w[1]) * tg + w[2], 0)
        j = row_of[b_idx, wid]
        sel = sel & (j >= 0)
        np.put(flat_rows, ((b_idx * k + j) * s3 + local)[sel], rgb_u32[sel])
    return rows, local_ids, counts

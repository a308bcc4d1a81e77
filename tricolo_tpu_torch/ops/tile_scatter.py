"""Tile → grid scatter: kernel K2, per-sample and global.

``scatter_tiles_ps`` places each sample's compacted tiles at their grid
positions on a zero background — the windowed_compact handoff from the
voxel encoder's tile-sparse blocks 1-2 to its dense blocks 3-5.
``scatter_tiles_global`` does the same for tiles keyed by global ids
(b·tg³ + local id) — the handoff after each sparse block of the dense-input
plan and of the full ``windowed`` transfer. On a CUDA tensor each launches
its entry of the hand-written kernel ``csrc/tile_scatter.cu`` (it replaces
the TPU kernel ``tricolo_tpu/ops/_graveyard/dma_tiles.py::_scatter_kernel``)
or raises; on a CPU tensor it runs its plain version
(``scatter_tiles_ps_plain``, ``scatter_tiles_global_plain``), the torch
forms of ``tricolo_tpu.ops.tile_sparse._transpose_scatter_ps`` and
``scatter_tiles``. A pure copy, so kernel and plain version agree bit for
bit, and every ``scatter_layout`` of the JAX package computes the same
function. ``scatter_tiles`` and ``scatter_tiles_global_autograd`` wrap them
in autograd Functions whose backward is the tile gather out of ``dy``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing as _tracing
from .. import work as _work
from . import _build


def _check(tiles, local_ids, grid):
    if tiles.ndim != 6 or tiles.shape[2] != tiles.shape[3] or tiles.shape[2] != tiles.shape[4]:
        raise ValueError(f"expected (B, k, t, t, t, C) tiles, got {tuple(tiles.shape)}")
    B, k, t = tiles.shape[:3]
    if local_ids.shape != (B, k):
        raise ValueError(f"local_ids must be {(B, k)}, got {tuple(local_ids.shape)}")
    if grid % t:
        raise ValueError(f"grid {grid} is not a multiple of the tile edge {t}")


def scatter_tiles_ps_plain(tiles, local_ids, grid: int):
    """Plain PyTorch version: rows into a tile-major buffer (padding ids go
    to per-sample trash rows), then a transpose to (B, G, G, G, C)."""
    _check(tiles, local_ids, grid)
    B, k, t = tiles.shape[:3]
    C = tiles.shape[-1]
    tg = grid // t
    n = tg**3
    stride = n + k
    ids = local_ids.long()
    j = torch.arange(k, device=tiles.device)[None, :]
    safe = torch.where((ids >= 0) & (ids < n), ids, n + j)
    flat_idx = (torch.arange(B, device=tiles.device)[:, None] * stride + safe).reshape(-1)
    buf = torch.zeros((B * stride, t**3 * C), dtype=tiles.dtype, device=tiles.device)
    buf[flat_idx] = tiles.reshape(B * k, -1)
    t8 = buf.reshape(B, stride, -1)[:, :n].reshape(B, tg, tg, tg, t, t, t, C)
    return t8.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, grid, grid, grid, C)


@functools.cache
def _lib():
    lib = _build.load("tile_scatter")
    for fn in (lib.tile_scatter, lib.tile_scatter_global):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch_plan(batch: int, rows: int, tile: int, grid: int, channels: int,
                elem_bytes: int, *tensors) -> int:
    """K2's copy width in bytes: the widest vector that divides a tile's
    x-run (tile·C·elem bytes) and the addresses of ``tensors`` (the tiles;
    the grid is a fresh allocation, aligned). Raises where the kernel's
    32-bit tile, row and z-plane math would wrap."""
    tg = grid // tile
    if (batch * tg**3 >= 2**31 or rows >= 2**31 or batch * grid >= 2**31
            or tile * grid * grid * channels * elem_bytes >= 2**31):
        raise ValueError(
            f"the tile scatter takes fewer than 2^31 tiles, rows and z-plane bytes; got "
            f"{batch}·{tg}³ tiles, {rows} rows, a {grid}² × {channels} grid"
        )
    return _build.vector_bytes(tile * channels * elem_bytes, *tensors)


def work(valid_rows: int, tile: int, channels: int, elem_bytes: int, ids: int, batch: int,
         grid: int) -> tuple[int, int]:
    """(bytes, flops) of one K2 call, either entry, as PERF.md §6 bounds
    it: the ``valid_rows`` tile rows whose id lies in the grid read once
    (padding rows never), the ``ids`` int32 ids read, the (batch, grid³,
    channels) grid written; no FLOPs."""
    return (valid_rows * tile**3 + batch * grid**3) * channels * elem_bytes + ids * 4, 0


def scatter_tiles_ps(tiles, local_ids, grid: int):
    """(B, k, t, t, t, C) tiles + (B, k) int32 local ids (``(tz·tg + ty)·tg
    + tx``; ids outside [0, tg³) are padding) → (B, G, G, G, C), zeros where
    no tile lands. K2 on CUDA."""
    if tiles.device.type == "cpu":
        return scatter_tiles_ps_plain(tiles, local_ids, grid)
    if tiles.device.type != "cuda":
        raise ValueError(f"scatter_tiles_ps runs on cuda or cpu tensors, got {tiles.device}")
    _check(tiles, local_ids, grid)
    if tiles.element_size() not in (2, 4):
        raise TypeError(f"scatter_tiles_ps copies 2- or 4-byte elements, got {tiles.dtype}")
    if local_ids.dtype != torch.int32:
        raise TypeError(f"local_ids must be int32, got {local_ids.dtype}")
    if local_ids.device != tiles.device or not (
        tiles.is_contiguous() and local_ids.is_contiguous()
    ):
        raise ValueError("scatter_tiles_ps needs contiguous inputs on one device")
    B, k, t = tiles.shape[:3]
    C = tiles.shape[-1]
    tg = grid // t
    vec = launch_plan(B, B * k, t, grid, C, tiles.element_size(), tiles)
    out = torch.empty((B, grid, grid, grid, C), dtype=tiles.dtype, device=tiles.device)
    inv = torch.empty(B * tg**3, dtype=torch.int32, device=tiles.device)
    valid = functools.partial(_work.valid_ids, local_ids, tg**3)
    with torch.cuda.device(tiles.device), _work.launch("scatter_tiles_ps", work, valid, t, C,
                                                       tiles.element_size(), B * k, B, grid):
        status = _lib().tile_scatter(
            tiles.data_ptr(), local_ids.data_ptr(), inv.data_ptr(), out.data_ptr(),
            B, k, t, tg, C, tiles.element_size(), vec,
            torch.cuda.current_stream(tiles.device).cuda_stream,
        )
    _build.check(status, "tile_scatter")
    _tracing.count("launches.scatter_tiles_ps")
    return out


def gather_tiles_ps(dy, local_ids, tile: int):
    """The scatter's backward: ``d_tiles[b, j]`` = the (t, t, t, C) region of
    ``dy[b]`` at local tile id ``local_ids[b, j]``, zeros for padding ids.
    Plain torch indexing, as the JAX package leaves this gather to XLA (the
    autodiff of ``_transpose_scatter_ps``)."""
    B, G = dy.shape[0], dy.shape[1]
    C = dy.shape[-1]
    tg = G // tile
    n = tg**3
    k = local_ids.shape[1]
    rows = (
        dy.reshape(B, tg, tile, tg, tile, tg, tile, C)
        .permute(0, 1, 3, 5, 2, 4, 6, 7)
        .reshape(B, n, tile**3 * C)
    )
    ids = local_ids.long()
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0)
    out = torch.gather(rows, 1, safe[..., None].expand(B, k, rows.shape[-1]))
    out = torch.where(valid[..., None], out, 0)
    return out.reshape(B, k, tile, tile, tile, C)


class _ScatterTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, local_ids, grid, use_kernel):
        ctx.save_for_backward(local_ids)
        ctx.tile = tiles.shape[2]
        op = scatter_tiles_ps if use_kernel else scatter_tiles_ps_plain
        return op(tiles, local_ids, grid)

    @staticmethod
    def backward(ctx, dy):
        (local_ids,) = ctx.saved_tensors
        return gather_tiles_ps(dy, local_ids, ctx.tile), None, None, None


def scatter_tiles(tiles, local_ids, grid: int, use_kernel: bool = True):
    """Differentiable ``scatter_tiles_ps`` (K2 forward, tile-gather
    backward); ``use_kernel=False`` runs the plain version on any device.
    The ids carry no gradient."""
    return _ScatterTiles.apply(tiles, local_ids, grid, use_kernel)


# ------------------------------------------------------------ global ids


def _check_global(tiles, ids, batch, grid):
    if tiles.ndim != 5 or not (tiles.shape[1] == tiles.shape[2] == tiles.shape[3]):
        raise ValueError(f"expected (T, t, t, t, C) tiles, got {tuple(tiles.shape)}")
    if ids.shape != (tiles.shape[0],):
        raise ValueError(f"ids must be ({tiles.shape[0]},), got {tuple(ids.shape)}")
    if grid % tiles.shape[1]:
        raise ValueError(f"grid {grid} is not a multiple of the tile edge {tiles.shape[1]}")
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")


def scatter_tiles_global_plain(tiles, ids, batch: int, grid: int):
    """Plain PyTorch version: rows into a tile-major (B·tg³ + T) buffer
    (padding ids go to per-row trash rows), then a transpose to
    (B, G, G, G, C)."""
    _check_global(tiles, ids, batch, grid)
    T, t = tiles.shape[:2]
    C = tiles.shape[-1]
    tg = grid // t
    n = batch * tg**3
    ids = ids.long()
    safe = torch.where((ids >= 0) & (ids < n), ids, n + torch.arange(T, device=tiles.device))
    buf = torch.zeros((n + T, t**3 * C), dtype=tiles.dtype, device=tiles.device)
    buf[safe] = tiles.reshape(T, -1)
    t8 = buf[:n].reshape(batch, tg, tg, tg, t, t, t, C)
    return t8.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(batch, grid, grid, grid, C)


def scatter_tiles_global(tiles, ids, batch: int, grid: int):
    """(T, t, t, t, C) tiles + (T,) int32 unique global ids (b·tg³ + (tz·tg
    + ty)·tg + tx; ids outside [0, B·tg³) are padding and are dropped) →
    (B, G, G, G, C), zeros where no tile lands. K2's global entry on CUDA."""
    if tiles.device.type == "cpu":
        return scatter_tiles_global_plain(tiles, ids, batch, grid)
    if tiles.device.type != "cuda":
        raise ValueError(f"scatter_tiles_global runs on cuda or cpu tensors, got {tiles.device}")
    _check_global(tiles, ids, batch, grid)
    if tiles.element_size() not in (2, 4):
        raise TypeError(f"scatter_tiles_global copies 2- or 4-byte elements, got {tiles.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.device != tiles.device or not (tiles.is_contiguous() and ids.is_contiguous()):
        raise ValueError("scatter_tiles_global needs contiguous inputs on one device")
    T, t = tiles.shape[:2]
    C = tiles.shape[-1]
    tg = grid // t
    vec = launch_plan(batch, T, t, grid, C, tiles.element_size(), tiles)
    out = torch.empty((batch, grid, grid, grid, C), dtype=tiles.dtype, device=tiles.device)
    inv = torch.empty(batch * tg**3, dtype=torch.int32, device=tiles.device)
    valid = functools.partial(_work.valid_ids, ids, batch * tg**3)
    with torch.cuda.device(tiles.device), _work.launch("scatter_tiles_global", work, valid, t, C,
                                                       tiles.element_size(), T, batch, grid):
        status = _lib().tile_scatter_global(
            tiles.data_ptr(), ids.data_ptr(), inv.data_ptr(), out.data_ptr(),
            batch, T, t, tg, C, tiles.element_size(), vec,
            torch.cuda.current_stream(tiles.device).cuda_stream,
        )
    _build.check(status, "tile_scatter_global")
    _tracing.count("launches.scatter_tiles_global")
    return out


def gather_tiles_global(dy, ids, tile: int):
    """The global scatter's backward: row ``r`` = the (t, t, t, C) region of
    ``dy`` at global tile id ``ids[r]``, zeros for padding ids (the autodiff
    of ``tricolo_tpu.ops.tile_sparse.scatter_tiles``)."""
    B, G = dy.shape[0], dy.shape[1]
    C = dy.shape[-1]
    tg = G // tile
    n = B * tg**3
    rows = (
        dy.reshape(B, tg, tile, tg, tile, tg, tile, C)
        .permute(0, 1, 3, 5, 2, 4, 6, 7)
        .reshape(n, tile**3 * C)
    )
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    out = rows[torch.where(valid, ids, 0)]
    out = torch.where(valid[:, None], out, 0)
    return out.reshape(ids.shape[0], tile, tile, tile, C)


class _ScatterTilesGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, ids, batch, grid, use_kernel):
        ctx.save_for_backward(ids)
        ctx.tile = tiles.shape[1]
        op = scatter_tiles_global if use_kernel else scatter_tiles_global_plain
        return op(tiles, ids, batch, grid)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        return gather_tiles_global(dy, ids, ctx.tile), None, None, None, None


def scatter_tiles_global_autograd(tiles, ids, batch: int, grid: int, use_kernel: bool = True):
    """Differentiable ``scatter_tiles_global`` (K2 forward, tile-gather
    backward); ``use_kernel=False`` runs the plain version on any device.
    The ids carry no gradient."""
    return _ScatterTilesGlobal.apply(tiles, ids, batch, grid, use_kernel)

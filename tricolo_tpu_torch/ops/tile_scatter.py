"""Per-sample tile → grid scatter: kernel K2.

``scatter_tiles_ps`` places each sample's compacted tiles at their grid
positions on a zero background — the handoff from the voxel encoder's
tile-sparse blocks 1-2 to its dense blocks 3-5. On a CUDA tensor it
launches the hand-written kernel ``csrc/tile_scatter.cu`` (it replaces the
TPU kernel ``tricolo_tpu/ops/_graveyard/dma_tiles.py::_scatter_kernel``) or
raises; on a CPU tensor it runs ``scatter_tiles_ps_plain``, the torch form
of ``tricolo_tpu.ops.tile_sparse._transpose_scatter_ps``. A pure copy, so
kernel and plain version agree bit for bit. ``scatter_tiles`` wraps it in
an autograd Function whose backward is the tile gather out of ``dy``.
"""

from __future__ import annotations

import ctypes

import torch

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


def _lib():
    lib = _build.load("tile_scatter")
    lib.tile_scatter.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.tile_scatter.restype = ctypes.c_int
    return lib


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
    inv = torch.empty(B * tg**3, dtype=torch.int32, device=tiles.device)
    out = torch.empty((B, grid, grid, grid, C), dtype=tiles.dtype, device=tiles.device)
    with torch.cuda.device(tiles.device):
        status = _lib().tile_scatter(
            tiles.data_ptr(), local_ids.data_ptr(), inv.data_ptr(), out.data_ptr(),
            B, k, t, tg, C, tiles.element_size(),
            torch.cuda.current_stream(tiles.device).cuda_stream,
        )
    _build.check(status, "tile_scatter")
    scatter_tiles_ps.launches += 1
    return out


scatter_tiles_ps.launches = 0


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

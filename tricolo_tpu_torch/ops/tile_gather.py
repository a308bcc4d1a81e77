"""Halo'd tile gather from a dense grid by global tile id: kernel K7.

``gather_tiles`` cuts the (tile + 2·halo)³ window of every listed 8³-grid
tile out of a channels-last grid — the input of each sparse block of the
dense-input tile-sparse voxel plan. On a CUDA tensor it launches the
hand-written kernel ``csrc/tile_gather.cu`` (it replaces the TPU kernel
``tricolo_tpu/ops/_graveyard/dma_tiles.py::_gather_kernel``) or raises; on
a CPU tensor it runs ``gather_tiles_plain``, a pad plus an index in plain
PyTorch. A pure copy, so kernel and plain version agree bit for bit.

``gather_tiles_autograd`` wraps it in an autograd Function. The JAX
package has no Pallas backward here: its VJP
(``tricolo_tpu.ops.tile_sparse._gather_bwd``) is a unique-row scatter of
``dy`` onto the window grid plus the linear transpose of the windowing, an
overlap-add. ``gather_tiles_grad`` is that
transpose in plain PyTorch, one axis at a time, in a fixed order — no
atomics, deterministic.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import tracing as _tracing
from .. import work as _work
from . import _build


def _check(x, ids, tile, halo):
    if x.ndim != 5 or not (x.shape[1] == x.shape[2] == x.shape[3]):
        raise ValueError(f"expected (B, D, D, D, C) grid, got {tuple(x.shape)}")
    if ids.ndim != 1:
        raise ValueError(f"ids must be (T,), got {tuple(ids.shape)}")
    D = x.shape[1]
    if tile <= 0 or D % tile:
        raise ValueError(f"grid {D} is not a multiple of the tile edge {tile}")
    if halo < 0 or tile + 2 * halo > D:
        raise ValueError(f"halo {halo} must be >= 0 with tile + 2·halo <= {D}")


def _decode(ids, batch, tg):
    """(valid, b, tz, ty, tx) of (T,) global ids as int64 tensors."""
    n = batch * tg**3
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0)
    b, r = safe // tg**3, safe % tg**3
    return valid, b, r // (tg * tg), (r // tg) % tg, r % tg


def gather_tiles_plain(x, ids, tile: int, halo: int = 0):
    """Plain PyTorch version: pad the grid by ``halo``, index every window,
    zero the padding ids' tiles."""
    _check(x, ids, tile, halo)
    B, D = x.shape[0], x.shape[1]
    s = tile + 2 * halo
    valid, b, tz, ty, tx = _decode(ids, B, D // tile)
    xp = F.pad(x, (0, 0) + (halo, halo) * 3)
    ar = torch.arange(s, device=x.device)
    out = xp[
        b[:, None, None, None],
        (tz * tile)[:, None, None, None] + ar[None, :, None, None],
        (ty * tile)[:, None, None, None] + ar[None, None, :, None],
        (tx * tile)[:, None, None, None] + ar[None, None, None, :],
    ]
    return torch.where(valid[:, None, None, None, None], out, 0)


@functools.cache
def _lib():
    lib = _build.load("tile_gather")
    lib.tile_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.tile_gather.restype = ctypes.c_int
    return lib


# A block of the kernel has 256 threads, each copying four vectors at a
# time; it has template instantiations for the dense plan's four (tile,
# halo) forms, and every other form runs the generic one.
_THREADS, _UNROLL = 256, 4
FIXED_FORMS = ((8, 1), (8, 0), (4, 1), (4, 0))


class GatherPlan(NamedTuple):
    vec_bytes: int  # copy width: divides gcd(tile, halo)·C·elem and x's, out's addresses
    tiles_per_block: int  # output tiles a block (1 to 256): about four vectors a thread
    fixed: bool  # (tile, halo) is one of FIXED_FORMS


def launch_plan(batch: int, grid: int, channels: int, tile: int, halo: int,
                elem_bytes: int, *tensors) -> GatherPlan:
    """K7's plan: the widest copy (16, 8, 4 or 2 bytes) that divides
    gcd(tile, halo)·C·elem bytes — every window row's start and halo edge,
    in the grid and in the output, then falls on a vector — and the
    addresses of ``tensors`` (x, out); as many output tiles a block as make
    about four vectors a thread; the template form of (tile, halo). Raises
    where the kernel's 32-bit tile ids or a block's vector index would
    wrap."""
    s = tile + 2 * halo
    tile_bytes = s**3 * channels * elem_bytes
    if batch * (grid // tile) ** 3 >= 2**31 or tile_bytes >= 2**31:
        raise ValueError(
            f"gather_tiles takes fewer than 2^31 tiles in the grid and bytes a tile; got "
            f"{batch}·{grid // tile}³ tiles of {tile_bytes} bytes"
        )
    vec = _build.vector_bytes(math.gcd(tile, halo) * channels * elem_bytes, *tensors)
    units = tile_bytes // vec
    return GatherPlan(vec, max(1, min(_THREADS, _THREADS * _UNROLL // units)),
                      (tile, halo) in FIXED_FORMS)


def work(active: int, tile: int, halo: int, channels: int, elem_bytes: int, ids: int):
    """(bytes, flops) of one K7 call as PERF.md §6 bounds it: the ``ids``
    windows of s³ sites (s = tile + 2·halo) written, the int32 ids read,
    and the ``active`` tiles' interiors read once (halo sites are re-reads
    of neighbours; padding ids read nothing); no FLOPs."""
    s = tile + 2 * halo
    return (ids * s**3 + active * tile**3) * channels * elem_bytes + ids * 4, 0


def gather_tiles(x, ids, tile: int, halo: int = 0):
    """(T, s, s, s, C) windows, s = tile + 2·halo, of the tiles ``ids`` (T,)
    int32 global ids (b·tg³ + (tz·tg + ty)·tg + tx; ids outside [0, B·tg³)
    give zero tiles) of ``x`` (B, D, D, D, C); sites outside the grid read
    zero. K7 on CUDA."""
    if x.device.type == "cpu":
        return gather_tiles_plain(x, ids, tile, halo)
    if x.device.type != "cuda":
        raise ValueError(f"gather_tiles runs on cuda or cpu tensors, got {x.device}")
    _check(x, ids, tile, halo)
    if x.element_size() not in (2, 4):
        raise TypeError(f"gather_tiles copies 2- or 4-byte elements, got {x.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.device != x.device or not (x.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_tiles needs contiguous inputs on one device")
    B, D, C = x.shape[0], x.shape[1], x.shape[-1]
    T, s = ids.shape[0], tile + 2 * halo
    out = torch.empty((T, s, s, s, C), dtype=x.dtype, device=x.device)
    plan = launch_plan(B, D, C, tile, halo, x.element_size(), x, out)
    active = functools.partial(_work.valid_ids, ids, B * (D // tile) ** 3)
    with torch.cuda.device(x.device), _work.launch("gather_tiles", work, active, tile, halo, C,
                                                   x.element_size(), T):
        status = _lib().tile_gather(
            x.data_ptr(), ids.data_ptr(), out.data_ptr(), T, B, D, C, tile, halo,
            x.element_size(), plan.vec_bytes, plan.tiles_per_block, int(plan.fixed),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "tile_gather")
    _tracing.count("launches.gather_tiles")
    return out


def _fold_axis(w, axis: int, tile: int, halo: int):
    """Transpose of one axis's windowing: (…, tg, s, …) windows at ``axis``
    → (…, tg·tile, …). Window k's centre lands on tile k, its left halo on
    the end of tile k−1 and its right halo on the start of tile k+1; halo
    cells that fall outside the grid are dropped."""
    if halo == 0:
        return w.flatten(axis, axis + 1)
    tg = w.shape[axis]
    out = w.narrow(axis + 1, halo, tile).clone()
    left = w.narrow(axis + 1, 0, halo).narrow(axis, 1, tg - 1)
    right = w.narrow(axis + 1, halo + tile, halo).narrow(axis, 0, tg - 1)
    out.narrow(axis, 0, tg - 1).narrow(axis + 1, tile - halo, halo).add_(left)
    out.narrow(axis, 1, tg - 1).narrow(axis + 1, 0, halo).add_(right)
    return out.flatten(axis, axis + 1)


def gather_tiles_grad(dy, ids, tile: int, halo: int, batch: int, grid: int):
    """The gather's backward: ``dy`` (T, s, s, s, C) → dx (B, G, G, G, C).
    Active rows go to their tile's window (padding ids to discarded trash
    rows; ids are unique), then each axis's overlapping windows fold back
    onto the grid."""
    if halo > tile:
        raise NotImplementedError(f"the overlap-add takes halo <= tile, got {halo} > {tile}")
    T, s, C = dy.shape[0], dy.shape[1], dy.shape[-1]
    tg = grid // tile
    n = batch * tg**3
    ids = ids.long()
    safe = torch.where((ids >= 0) & (ids < n), ids, n + torch.arange(T, device=dy.device))
    rows = dy.new_zeros((n + T, s, s, s, C))
    rows[safe] = dy
    w = rows[:n].reshape(batch, tg, tg, tg, s, s, s, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    for axis in (5, 3, 1):  # (B, tg, s, tg, s, tg, s, C): fold the last axis first
        w = _fold_axis(w, axis, tile, halo)
    return w.contiguous()


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, tile, halo, use_kernel):
        ctx.save_for_backward(ids)
        ctx.geometry = (tile, halo, x.shape[0], x.shape[1])
        op = gather_tiles if use_kernel else gather_tiles_plain
        return op(x, ids, tile, halo)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        return gather_tiles_grad(dy, ids, *ctx.geometry), None, None, None, None


def gather_tiles_autograd(x, ids, tile: int, halo: int = 0, use_kernel: bool = True):
    """Differentiable ``gather_tiles`` (K7 forward, overlap-add backward);
    ``use_kernel=False`` runs the plain version on any device. The ids
    carry no gradient."""
    return _GatherTiles.apply(x, ids, tile, halo, use_kernel)

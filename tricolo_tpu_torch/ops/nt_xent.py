"""Blocked online-softmax NT-Xent: kernels K4, K5 and K6.

The plain loss (``losses/nt_xent.py``) materialises the (B, B) logits
twice; these kernels (``csrc/nt_xent.cu``) stream them tile by tile so
nothing O(B²) reaches device memory. They replace the Pallas TPU kernels of
``tricolo_tpu/ops/nt_xent_pallas.py``:

* ``nt_xent_fwd`` (K4, ``_fwd_kernel``) — per row of zi the diagonal logit
  and the logsumexp of ``zi·zjᵀ/τ`` → (B, 2);
* ``nt_xent_fwd_pair`` (K4 for both directions, as the JAX ``_fwd`` calls
  it twice) — from one pass over ``zi·zjᵀ/τ`` its diagonal and its row and
  column logsumexps → (B, 3); K4 alone is this kernel without the column
  statistics;
* ``nt_xent_bwd_rows`` (K5, ``_bwd_kernel``) — ``(P − I)·zj·s``;
* ``nt_xent_bwd_cols`` (K6, ``_bwd_cols_kernel``) — ``(P − I)ᵀ·zi·s``;
* ``nt_xent_bwd`` (K5 + K6 in one launch) — both terms of one operand's
  gradient from one pass over its logits, as the JAX ``_bwd`` adds them;

with ``P = exp(logits − lse)`` recomputed from the saved logsumexps and
``s`` f32 device tensors (the loss cotangent times the direction's weight
over τ·B). On a CUDA tensor each wrapper launches its kernel or raises; on
a CPU tensor it runs its ``*_plain`` version, explicit torch formulas over
the materialised logits. The sums run in another order, so kernel and
plain version agree to f32 rounding, not bit for bit.

``blocked_nt_xent_loss`` is the counterpart of ``pallas_nt_xent_loss``: L2
normalisation in torch, then an autograd Function with the JAX
``_fwd``/``_bwd`` composition (one pair launch forward, two two-term
launches backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import tracing as _tracing
from .. import work as _work
from ..models.common import l2_normalize
from . import _build


def _logits(zi, zj, inv_tau):
    return (zi @ zj.T) * inv_tau


def nt_xent_fwd_plain(zi, zj, inv_tau: float):
    """(B, 2): [:, 0] the diagonal logits, [:, 1] the row logsumexps."""
    logits = _logits(zi, zj, inv_tau)
    return torch.stack([logits.diagonal(), torch.logsumexp(logits, dim=1)], dim=1)


def nt_xent_fwd_pair_plain(zi, zj, inv_tau: float):
    """(B, 3): the diagonal logits and the row and column logsumexps of one
    logits matrix; the column ones are the row logsumexps of zj·ziᵀ/τ."""
    logits = _logits(zi, zj, inv_tau)
    return torch.stack([logits.diagonal(), torch.logsumexp(logits, dim=1),
                        torch.logsumexp(logits, dim=0)], dim=1)


def _coeff(zi, zj, lse, inv_tau):
    logits = _logits(zi, zj, inv_tau)
    eye = torch.eye(zi.shape[0], dtype=logits.dtype, device=logits.device)
    return torch.exp(logits - lse[:, None]) - eye


def nt_xent_bwd_rows_plain(zi, zj, lse, scale, inv_tau: float):
    """dzi = (P − I)·zj·scale, P over the rows of zi·zjᵀ/τ."""
    return (_coeff(zi, zj, lse, inv_tau) @ zj) * scale


def nt_xent_bwd_cols_plain(zj, zi, lse, scale, inv_tau: float):
    """dzj = (P − I)ᵀ·zi·scale, P over the rows of zi·zjᵀ/τ (lse per zi row)."""
    return (_coeff(zi, zj, lse, inv_tau).T @ zi) * scale


def nt_xent_bwd_plain(own, oth, lse_row, lse_col, scales, inv_tau: float):
    """Both terms of one operand's gradient: ``nt_xent_bwd_rows_plain(own,
    oth, lse_row, scales[0]) + nt_xent_bwd_cols_plain(own, oth, lse_col,
    scales[1])``, i.e. Σ_c [s_row·(exp(l_rc − lse_row[r]) − δ_rc) +
    s_col·(exp(l_rc − lse_col[c]) − δ_rc)]·oth_c with l = own·othᵀ/τ."""
    return (nt_xent_bwd_rows_plain(own, oth, lse_row, scales[0:1], inv_tau)
            + nt_xent_bwd_cols_plain(own, oth, lse_col, scales[1:2], inv_tau))


# An H100's SMs: the kernels take their large tiles once these fill the card.
_SMS = 132
# The forward's logits tiles (rows, columns), largest first.
_FWD_TILES = ((128, 128), (64, 64), (16, 32))


class FwdPlan(NamedTuple):
    bm: int  # logits tile rows
    bn: int  # logits tile columns
    col_tiles: int  # grid x
    row_tiles: int  # grid y
    scratch: int  # f32 elements of the tiles' (max, sum) partials


def fwd_launch_plan(B: int, pair: bool) -> FwdPlan:
    """The forward's grid of bm × bn logits tiles over the full D: the
    largest tile whose ⌈B/bm⌉·⌈B/bn⌉ blocks fill the card, else the
    smallest (B = 128: 8 × 4 = 32 blocks of 16 × 32). Each block writes a
    (max, sum) pair per row for its column tile and, for the pair, per
    column for its row tile: the scratch holds 2·B·(col_tiles [+
    row_tiles]) floats. Past 65535 row tiles (grid y) the plan raises."""
    for bm, bn in _FWD_TILES:
        if -(-B // bm) * -(-B // bn) >= _SMS:
            break
    col_tiles, row_tiles = -(-B // bn), -(-B // bm)
    if row_tiles > 65535:
        raise ValueError(f"the NT-Xent forward takes at most 65535 row tiles, got B = {B}")
    return FwdPlan(bm, bn, col_tiles, row_tiles,
                   2 * B * (col_tiles + (row_tiles if pair else 0)))


def bwd_launch_plan(B: int, D: int) -> tuple[int, int]:
    """(ds, wm) of the backward kernel on (B, D) operands. A cluster of
    D/ds blocks shares each row tile, a block a ds-wide slice of D (128
    where it divides D, else 64); the row tile is 64 rows (wm = 4 warps
    deep, 256 threads) once ⌈B/64⌉·D/ds blocks fill the card, else 16 rows
    (wm = 1, 64 threads) so that a small batch still spreads over the SMs
    (B = 128, D = 512: 8 row tiles × 4 = 32 blocks)."""
    ds = 128 if D % 128 == 0 else 64
    wm = 4 if -(-B // 64) * (D // ds) >= _SMS else 1
    if -(-B // (16 * wm)) > 65535:
        raise ValueError(f"the NT-Xent backward takes at most 65535 row tiles, got B = {B}")
    return ds, wm


def _check(zi, zj, *rest):
    if zi.ndim != 2 or zi.shape != zj.shape:
        raise ValueError(f"expected two (B, D) operands, got {tuple(zi.shape)}/{tuple(zj.shape)}")
    B, D = zi.shape
    if D % 64 or D > 512:
        raise ValueError(f"the NT-Xent kernels take D a multiple of 64 up to 512, got {D}")
    for t in (zi, zj, *rest):
        if t.dtype != torch.float32:
            raise TypeError(f"the NT-Xent kernels take float32, got {t.dtype}")
        if t.device != zi.device or not t.is_contiguous():
            raise ValueError("the NT-Xent kernels need contiguous inputs on one device")
    if zi.data_ptr() % 16 or zj.data_ptr() % 16:
        raise ValueError("the NT-Xent kernels read the (B, D) operands 16 bytes at a time: "
                         "they must start 16-byte aligned")
    return B, D


@functools.cache
def _lib():
    lib = _build.load("nt_xent")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("nt_xent_fwd", "nt_xent_fwd_pair"):
        getattr(lib, name).argtypes = [ptr] * 4 + [i32, i32, f32, i32, ptr]
    lib.nt_xent_bwd.argtypes = [ptr] * 6 + [i32, i32, f32, i32, i32, ptr]
    for name in ("nt_xent_bwd_rows", "nt_xent_bwd_cols"):
        getattr(lib, name).argtypes = [ptr] * 5 + [i32, i32, f32, i32, i32, ptr]
    for name in ("nt_xent_fwd", "nt_xent_fwd_pair", "nt_xent_bwd", "nt_xent_bwd_rows",
                 "nt_xent_bwd_cols"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def work(entry: str, B: int, D: int) -> tuple[int, int]:
    """(bytes, flops) of one call of ``entry`` (a wrapper's name) on (B, D)
    f32 operands, as PERF.md §6 bounds them: the operands, the
    logsumexps and scales read once, the output written once; 2·B²·D FLOPs
    a forward (the pair's column statistics reuse its logits), 4·B²·D a
    backward (one logits and one coefficient product, the two-term entry
    included)."""
    operands = 2 * B * D * 4
    if entry in ("nt_xent_fwd", "nt_xent_fwd_pair"):
        return operands + B * (3 if entry == "nt_xent_fwd_pair" else 2) * 4, 2 * B * B * D
    if entry not in ("nt_xent_bwd", "nt_xent_bwd_rows", "nt_xent_bwd_cols"):
        raise ValueError(f"unknown NT-Xent entry {entry!r}")
    lses = 2 if entry == "nt_xent_bwd" else 1
    return operands + lses * (B + 1) * 4 + B * D * 4, 4 * B * B * D


def _device(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")


def _fwd(wrapper, zi, zj, inv_tau, pair):
    name = wrapper.__name__
    _device(zi, name)
    B, D = _check(zi, zj)
    plan = fwd_launch_plan(B, pair)
    out = torch.empty((B, 3 if pair else 2), dtype=torch.float32, device=zi.device)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=zi.device)
    with torch.cuda.device(zi.device), _work.launch(name, work, name, B, D):
        status = getattr(_lib(), name)(
            zi.data_ptr(), zj.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, D,
            float(inv_tau), plan.bm, torch.cuda.current_stream(zi.device).cuda_stream,
        )
    _build.check(status, name)
    _tracing.count("launches." + name)
    return out


def nt_xent_fwd(zi, zj, inv_tau: float):
    """(B, 2) [diagonal logit, logsumexp] per row of zi; K4 on CUDA (the
    pair kernel without its column statistics). zi, zj (B, D) f32
    contiguous, D a multiple of 64 up to 512."""
    if zi.device.type == "cpu":
        return nt_xent_fwd_plain(zi, zj, inv_tau)
    return _fwd(nt_xent_fwd, zi, zj, inv_tau, pair=False)


def nt_xent_fwd_pair(zi, zj, inv_tau: float):
    """(B, 3) [diagonal logit, row logsumexp, column logsumexp] of
    zi·zjᵀ/τ (``nt_xent_fwd_pair_plain``): both directions of the loss from
    one pass over the logits, on CUDA one launch."""
    if zi.device.type == "cpu":
        return nt_xent_fwd_pair_plain(zi, zj, inv_tau)
    return _fwd(nt_xent_fwd_pair, zi, zj, inv_tau, pair=True)


def _bwd(wrapper, own, oth, lses, scales, inv_tau):
    name = wrapper.__name__
    _device(own, name)
    B, D = _check(own, oth, *lses, scales)
    if any(t.shape != (B,) for t in lses) or scales.numel() != len(lses):
        raise ValueError(f"{name}: each lse must be ({B},), with one scale per lse")
    ds, wm = bwd_launch_plan(B, D)
    out = torch.empty_like(own)
    with torch.cuda.device(own.device), _work.launch(name, work, name, B, D):
        status = getattr(_lib(), name)(
            own.data_ptr(), oth.data_ptr(), *(t.data_ptr() for t in lses), scales.data_ptr(),
            out.data_ptr(), B, D, float(inv_tau), ds, wm,
            torch.cuda.current_stream(own.device).cuda_stream,
        )
    _build.check(status, name)
    _tracing.count("launches." + name)
    return out


def nt_xent_bwd(own, oth, lse_row, lse_col, scales, inv_tau: float):
    """Both backward terms of one operand (``nt_xent_bwd_plain``) in one
    launch, the logits computed once. own, oth (B, D) f32; lse_row,
    lse_col (B,) f32; scales a two-element f32 tensor (s_row, s_col)."""
    if own.device.type == "cpu":
        return nt_xent_bwd_plain(own, oth, lse_row, lse_col, scales, inv_tau)
    return _bwd(nt_xent_bwd, own, oth, (lse_row, lse_col), scales, inv_tau)


def nt_xent_bwd_rows(zi, zj, lse, scale, inv_tau: float):
    """dzi = (P − I)·zj·scale with P = exp(zi·zjᵀ/τ − lse[:, None]); K5 on
    CUDA (the backward kernel with its row term alone). lse (B,) f32;
    scale a one-element f32 tensor."""
    if zi.device.type == "cpu":
        return nt_xent_bwd_rows_plain(zi, zj, lse, scale, inv_tau)
    return _bwd(nt_xent_bwd_rows, zi, zj, (lse,), scale, inv_tau)


def nt_xent_bwd_cols(zj, zi, lse, scale, inv_tau: float):
    """dzj = (P − I)ᵀ·zi·scale with P = exp(zi·zjᵀ/τ − lse[:, None]); K6 on
    CUDA (the backward kernel with its column term alone). lse (B,) f32 per
    row of zi; scale a one-element f32 tensor."""
    if zj.device.type == "cpu":
        return nt_xent_bwd_cols_plain(zj, zi, lse, scale, inv_tau)
    return _bwd(nt_xent_bwd_cols, zj, zi, (lse,), scale, inv_tau)


class _BlockedNTXent(torch.autograd.Function):
    """α·La + (1 − α)·Lb on L2-normalised (B, D) f32 embeddings, where
    La = mean(lse − diag) of zis·zjsᵀ/τ and Lb of zjs·zisᵀ/τ: Lb's
    logsumexps are the column logsumexps of La's logits, its diagonal the
    same, so one pass over those logits gives both."""

    @staticmethod
    def forward(ctx, zis, zjs, temperature, alpha, use_kernels):
        inv_tau = 1.0 / temperature
        fwd = nt_xent_fwd_pair if use_kernels else nt_xent_fwd_pair_plain
        out = fwd(zis, zjs, inv_tau)
        lse_a, lse_b = out[:, 1].contiguous(), out[:, 2].contiguous()
        loss_a = torch.mean(lse_a - out[:, 0])
        loss_b = torch.mean(lse_b - out[:, 0])
        ctx.save_for_backward(zis, zjs, lse_a, lse_b)
        ctx.inv_tau, ctx.alpha, ctx.use_kernels = inv_tau, alpha, use_kernels
        return alpha * loss_a + (1.0 - alpha) * loss_b

    @staticmethod
    def backward(ctx, ct):
        zis, zjs, lse_a, lse_b = ctx.saved_tensors
        inv_tau, alpha, batch = ctx.inv_tau, ctx.alpha, zis.shape[0]
        bwd = nt_xent_bwd if ctx.use_kernels else nt_xent_bwd_plain
        ct = ct.float().reshape(1)
        scale_a = ct * alpha * inv_tau / batch
        scale_b = ct * (1.0 - alpha) * inv_tau / batch
        d_zis = bwd(zis, zjs, lse_a, lse_b, torch.cat([scale_a, scale_b]), inv_tau)
        d_zjs = bwd(zjs, zis, lse_b, lse_a, torch.cat([scale_b, scale_a]), inv_tau)
        return d_zis, d_zjs, None, None, None


def blocked_nt_xent_loss(zis, zjs, temperature: float = 0.1, alpha_weight: float = 0.25,
                         norm: bool = True, use_kernels: bool = True):
    """Twin of ``losses.nt_xent_loss`` on the blocked kernels (the port of
    ``pallas_nt_xent_loss``): f32, L2 normalisation in torch, the O(B²)
    work in the pair forward and the two-term backward. ``use_kernels=False``
    runs their plain versions."""
    zis, zjs = zis.float(), zjs.float()
    if norm:
        zis, zjs = l2_normalize(zis), l2_normalize(zjs)
    return _BlockedNTXent.apply(zis.contiguous(), zjs.contiguous(), float(temperature),
                                float(alpha_weight), use_kernels)

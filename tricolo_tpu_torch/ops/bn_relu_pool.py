"""Masked eval BatchNorm → ReLU → zero → MaxPool(2³): kernel K1.

``bn_relu_pool`` is the voxel encoder's per-block epilogue at eval time
(all five blocks). On a CUDA tensor it launches the hand-written kernel
``csrc/bn_relu_pool.cu`` (it replaces the TPU kernel
``tricolo_tpu/ops/fused_bn_pool.py::_fwd_kernel``) or raises; on a CPU
tensor it runs ``bn_relu_pool_plain``, the same function in plain PyTorch
(the torch form of ``masked_inference_bn_relu_pool2``). The kernel repeats
the plain version's rounding step for step, so the two agree bit for bit.

``fold_bn`` folds the running statistics into per-channel ``mul``/``add``
exactly as the JAX package's ``_muladd`` does: f32 fold, then one cast to
the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fold_bn(scale, bias, mean, var, eps: float, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as y·mul + add: mul = γ·rsqrt(var+ε), add = β − mean·γ·rsqrt(var+ε),
    folded in f32 and cast to ``dtype``."""
    invstd = torch.rsqrt(var.float() + eps)
    scale32 = scale.float()
    mul = (scale32 * invstd).to(dtype)
    add = (bias.float() - mean.float() * scale32 * invstd).to(dtype)
    return mul, add


def _check(y, mul, add, zero_mask, stats_mask):
    if y.ndim != 5:
        raise ValueError(f"expected (N, D, H, W, C) activations, got {tuple(y.shape)}")
    N, D, H, W, C = y.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"spatial dims must be even for 2³ pooling, got {tuple(y.shape)}")
    if mul.shape != (C,) or add.shape != (C,):
        raise ValueError(f"mul/add must be ({C},), got {tuple(mul.shape)}/{tuple(add.shape)}")
    for name, m in (("zero_mask", zero_mask), ("stats_mask", stats_mask)):
        if m.shape != (N, D, H, W, 1):
            raise ValueError(f"{name} must be {(N, D, H, W, 1)}, got {tuple(m.shape)}")


def bn_relu_pool_plain(y, mul, add, zero_mask, stats_mask=None, want_idx=False):
    """Plain PyTorch version: a = relu(y·mul + add)·zero_mask, then the 2³
    window max of ``a`` and of ``stats_mask`` (and the first argmax)."""
    stats_mask = zero_mask if stats_mask is None else stats_mask
    _check(y, mul, add, zero_mask, stats_mask)
    N, D, H, W, C = y.shape
    a = torch.relu(y * mul + add) * zero_mask
    win = (
        a.reshape(N, D // 2, 2, H // 2, 2, W // 2, 2, C)
        .permute(0, 1, 3, 5, 7, 2, 4, 6)
        .reshape(N, D // 2, H // 2, W // 2, C, 8)
    )
    pooled_mask = stats_mask.reshape(N, D // 2, 2, H // 2, 2, W // 2, 2, 1).amax(
        dim=(2, 4, 6)
    )
    if not want_idx:
        return win.amax(dim=-1), pooled_mask
    # torch.max returns the first maximal index: r = dd·4 + hh·2 + ww.
    pooled, idx = win.max(dim=-1)
    return pooled, pooled_mask, idx.to(torch.uint8)


def _lib():
    lib = _build.load("bn_relu_pool")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"bn_relu_pool_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def bn_relu_pool(y, mul, add, zero_mask, stats_mask=None, want_idx=False):
    """(pooled, pooled_mask[, idx]) of masked BN-ReLU-pool; K1 on CUDA.

    y (N, D, H, W, C) channels-last, bf16 or f32, D/H/W even; mul/add (C,)
    and masks (N, D, H, W, 1) in y's dtype; ``stats_mask=None`` means
    ``zero_mask``. idx is uint8, the first max in scan order.
    """
    if y.device.type == "cpu":
        return bn_relu_pool_plain(y, mul, add, zero_mask, stats_mask, want_idx)
    if y.device.type != "cuda":
        raise ValueError(f"bn_relu_pool runs on cuda or cpu tensors, got {y.device}")
    stats_mask = zero_mask if stats_mask is None else stats_mask
    _check(y, mul, add, zero_mask, stats_mask)
    if y.dtype not in _DTYPES:
        raise TypeError(f"bn_relu_pool takes float32 or bfloat16, got {y.dtype}")
    for t in (y, mul, add, zero_mask, stats_mask):
        if t.dtype != y.dtype or t.device != y.device or not t.is_contiguous():
            raise ValueError(
                "bn_relu_pool needs contiguous inputs of y's dtype on y's device"
            )
    N, D, H, W, C = y.shape
    pooled = torch.empty((N, D // 2, H // 2, W // 2, C), dtype=y.dtype, device=y.device)
    pooled_mask = torch.empty((N, D // 2, H // 2, W // 2, 1), dtype=y.dtype, device=y.device)
    idx = (
        torch.empty(pooled.shape, dtype=torch.uint8, device=y.device) if want_idx else None
    )
    fn = getattr(_lib(), f"bn_relu_pool_{_DTYPES[y.dtype]}")
    with torch.cuda.device(y.device):
        status = fn(
            y.data_ptr(), mul.data_ptr(), add.data_ptr(), zero_mask.data_ptr(),
            stats_mask.data_ptr(), pooled.data_ptr(), pooled_mask.data_ptr(),
            idx.data_ptr() if want_idx else None,
            N, D // 2, H // 2, W // 2, C,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(status, "bn_relu_pool")
    bn_relu_pool.launches += 1
    return (pooled, pooled_mask, idx) if want_idx else (pooled, pooled_mask)


bn_relu_pool.launches = 0

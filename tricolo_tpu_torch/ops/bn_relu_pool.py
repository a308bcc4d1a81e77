"""BatchNorm → ReLU [→ zero] → MaxPool(2³): kernels K1 and K3, masked and
unmasked.

``bn_relu_pool`` (K1) is the voxel encoder's per-block epilogue: BN folded
to ``y·mul + add``, ReLU, zero, window max (and first argmax). On a CUDA
tensor it launches the hand-written kernel ``csrc/bn_relu_pool.cu`` (it
replaces the TPU kernel ``tricolo_tpu/ops/fused_bn_pool.py::_fwd_kernel``)
or raises; on a CPU tensor it runs ``bn_relu_pool_plain``, the same
function in plain PyTorch (the torch form of
``masked_inference_bn_relu_pool2``). With ``zero_mask=None`` it is the
unmasked entry ``bn_relu_pool_unmasked``, the Pallas ``_fwd_kernel``'s own
function (the torch form of ``inference_bn_relu_pool`` and of
``fused_bn_relu_pool``'s forward): no mask in, no pooled mask out.

``bn_relu_pool_bwd`` (K3) is the full-resolution pass of the train-mode
backward, ``dy = route(ga by idx) + (B + C·ẑ)·stats_mask``: the CUDA kernel
``csrc/bn_relu_pool_bwd.cu`` (it replaces ``fused_bn_pool::_dy_kernel``)
or, on a CPU tensor, ``bn_relu_pool_bwd_plain`` (the torch form of the dy
line of ``_masked_hybrid2_bwd``). With ``stats_mask=None`` it is the
unmasked entry ``bn_relu_pool_bwd_unmasked`` (the dy line of
``_hybrid_bwd``). Both kernels repeat their plain version's rounding step
for step, so each pair agrees bit for bit.

``masked_bn_relu_pool_train`` is the masked train-mode op, the counterpart
of ``masked_hybrid_bn_relu_pool2`` (two masks) and
``masked_hybrid_bn_relu_pool`` (one mask): masked f32 batch statistics, K1
with the argmax index, and a backward whose pooled-resolution pieces are
plain torch (as the JAX package leaves them to XLA) around K3.
``bn_relu_pool_train`` is the unmasked one, the counterpart of
``fused_bn_relu_pool`` and ``hybrid_bn_relu_pool``: all-site statistics
(``batch_stats``, JAX's ``_stats``), K1's unmasked entry with idx, the same
pooled-resolution pieces with n = N·D·H·W, then K3's unmasked entry. JAX's
two forms round dy differently in bf16 (the Pallas ``_dy_kernel`` works in
the input dtype, ``_hybrid_bwd`` in f32 with one cast); the port follows
the hybrid.

``fold_bn`` folds statistics into per-channel ``mul``/``add`` exactly as
the JAX package's ``_muladd`` does: f32 fold (γ, β widened from the
parameter dtype, f32 or bf16), then one cast to the compute dtype. The
kernels never see γ, β: their launch plans and bodies are the same for
either parameter dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing as _tracing
from .. import work as _work
from ..parallel.collectives import sum_over_ranks
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
        if m is not None and m.shape != (N, D, H, W, 1):
            raise ValueError(f"{name} must be {(N, D, H, W, 1)}, got {tuple(m.shape)}")


def bn_relu_pool_plain(y, mul, add, zero_mask=None, stats_mask=None, want_idx=False):
    """Plain PyTorch version: a = relu(y·mul + add)·zero_mask, then the 2³
    window max of ``a`` and of ``stats_mask`` (and the first argmax):
    (pooled, pooled_mask[, idx]). ``zero_mask=None`` is the unmasked form,
    a = relu(y·mul + add): pooled, or (pooled, idx)."""
    masked = zero_mask is not None
    if masked:
        stats_mask = zero_mask if stats_mask is None else stats_mask
    elif stats_mask is not None:
        raise ValueError("stats_mask needs a zero_mask")
    _check(y, mul, add, zero_mask, stats_mask)
    N, D, H, W, C = y.shape
    a = torch.relu(y * mul + add)
    if masked:
        a = a * zero_mask
    win = (
        a.reshape(N, D // 2, 2, H // 2, 2, W // 2, 2, C)
        .permute(0, 1, 3, 5, 7, 2, 4, 6)
        .reshape(N, D // 2, H // 2, W // 2, C, 8)
    )
    if want_idx:
        # torch.max returns the first maximal index: r = dd·4 + hh·2 + ww.
        pooled, idx = win.max(dim=-1)
        extra = (idx.to(torch.uint8),)
    else:
        pooled, extra = win.amax(dim=-1), ()
    if not masked:
        return (pooled, *extra) if want_idx else pooled
    pooled_mask = stats_mask.reshape(N, D // 2, 2, H // 2, 2, W // 2, 2, 1).amax(
        dim=(2, 4, 6)
    )
    return (pooled, pooled_mask, *extra)


@functools.cache
def _lib():
    lib = _build.load("bn_relu_pool")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"bn_relu_pool_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def launch_plan(shape, elem_bytes: int, *tensors) -> int:
    """K1's channels a thread: the widest vector (16, 8, 4 or 2 bytes) that
    divides a site's C·elem bytes and the addresses of ``tensors`` (y, mul,
    add; the outputs are fresh allocations, aligned), in elements. Raises
    where the kernel's 32-bit site and thread math would wrap."""
    N, D, H, W, C = shape
    vec = _build.vector_bytes(C * elem_bytes, *tensors) // elem_bytes
    sites = N * D * H * W
    if sites >= 2**31 or sites // 8 * (C // vec) >= 2**31:
        raise ValueError(
            f"bn_relu_pool takes fewer than 2^31 sites and threads, got {tuple(shape)}"
        )
    return vec


def work(kernel: str, shape, elem_bytes: int, masks: int, want_idx: bool = False):
    """(bytes, flops) of one ``kernel`` call, "K1" or "K3", on y of
    ``shape`` (N, D, H, W, C) with ``masks`` distinct (N, D, H, W, 1) masks
    (0 unmasked, 1, or 2: K1's zero and statistics masks), as PERF.md §6
    bounds it: K1 reads y and the masks and writes the pooled values (and
    the pooled mask when masked, the uint8 argmax with ``want_idx``); K3
    reads y, ga, idx and the statistics mask and writes dy. The (C,)
    vectors are not counted; no FLOPs (both are memory-bound)."""
    N, D, H, W, C = shape
    sites = N * D * H * W
    pooled = sites // 8
    if kernel == "K1":
        nbytes = (sites * C + masks * sites + pooled * C + (pooled if masks else 0)) * elem_bytes
        return nbytes + (pooled * C if want_idx else 0), 0
    if kernel == "K3":
        return (2 * sites * C + pooled * C + min(masks, 1) * sites) * elem_bytes + pooled * C, 0
    raise ValueError(f"kernel must be K1 or K3, got {kernel!r}")


def _launch_k1(y, mul, add, zero_mask, stats_mask, want_idx):
    """Check K1's inputs and launch it; masks None for the unmasked entry."""
    name = "bn_relu_pool" if zero_mask is not None else "bn_relu_pool_unmasked"
    _check(y, mul, add, zero_mask, stats_mask)
    if y.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {y.dtype}")
    for t in (y, mul, add, zero_mask, stats_mask):
        if t is not None and (t.dtype != y.dtype or t.device != y.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} needs contiguous inputs of y's dtype on y's device")
    N, D, H, W, C = y.shape
    vec = launch_plan(y.shape, y.element_size(), y, mul, add)
    pooled = torch.empty((N, D // 2, H // 2, W // 2, C), dtype=y.dtype, device=y.device)
    pooled_mask = None
    if zero_mask is not None:
        pooled_mask = torch.empty((N, D // 2, H // 2, W // 2, 1), dtype=y.dtype,
                                  device=y.device)
    idx = (
        torch.empty(pooled.shape, dtype=torch.uint8, device=y.device) if want_idx else None
    )
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_lib(), f"bn_relu_pool_{_DTYPES[y.dtype]}")
    masks = 0 if zero_mask is None else 1 if stats_mask is zero_mask else 2
    with torch.cuda.device(y.device), _work.launch(name, work, "K1", y.shape, y.element_size(),
                                                   masks, want_idx):
        status = fn(
            y.data_ptr(), mul.data_ptr(), add.data_ptr(), ptr(zero_mask), ptr(stats_mask),
            pooled.data_ptr(), ptr(pooled_mask), ptr(idx),
            N, D // 2, H // 2, W // 2, C, vec,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(status, name)
    return pooled, pooled_mask, idx


def _on_cuda(y, name):
    if y.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {y.device}")


def bn_relu_pool(y, mul, add, zero_mask=None, stats_mask=None, want_idx=False):
    """(pooled, pooled_mask[, idx]) of masked BN-ReLU-pool; K1 on CUDA.

    y (N, D, H, W, C) channels-last, bf16 or f32, D/H/W even; mul/add (C,)
    and masks (N, D, H, W, 1) in y's dtype; ``stats_mask=None`` means
    ``zero_mask``. idx is uint8, the first max in scan order.
    ``zero_mask=None`` runs the unmasked entry, ``bn_relu_pool_unmasked``.
    """
    if zero_mask is None:
        if stats_mask is not None:
            raise ValueError("stats_mask needs a zero_mask")
        return bn_relu_pool_unmasked(y, mul, add, want_idx)
    if y.device.type == "cpu":
        return bn_relu_pool_plain(y, mul, add, zero_mask, stats_mask, want_idx)
    _on_cuda(y, "bn_relu_pool")
    stats_mask = zero_mask if stats_mask is None else stats_mask
    pooled, pooled_mask, idx = _launch_k1(y, mul, add, zero_mask, stats_mask, want_idx)
    _tracing.count("launches.bn_relu_pool")
    return (pooled, pooled_mask, idx) if want_idx else (pooled, pooled_mask)


def bn_relu_pool_unmasked(y, mul, add, want_idx=False):
    """pooled (or (pooled, idx)) of all-site BN-ReLU-pool, relu(y·mul +
    add) then the 2³ window max: K1's unmasked entry on CUDA, the Pallas
    ``_fwd_kernel``'s function. Inputs as for ``bn_relu_pool``."""
    if y.device.type == "cpu":
        return bn_relu_pool_plain(y, mul, add, want_idx=want_idx)
    _on_cuda(y, "bn_relu_pool_unmasked")
    pooled, _, idx = _launch_k1(y, mul, add, None, None, want_idx)
    _tracing.count("launches.bn_relu_pool_unmasked")
    return (pooled, idx) if want_idx else pooled


# ------------------------------------------------------------------ K3


def _check_bwd(y, ga, idx, stats_mask, vectors):
    if y.ndim != 5 or any(s % 2 for s in y.shape[1:4]):
        raise ValueError(f"expected (N, D, H, W, C) with even D/H/W, got {tuple(y.shape)}")
    N, D, H, W, C = y.shape
    pooled = (N, D // 2, H // 2, W // 2, C)
    if ga.shape != pooled or idx.shape != pooled:
        raise ValueError(f"ga/idx must be {pooled}, got {tuple(ga.shape)}/{tuple(idx.shape)}")
    if stats_mask is not None and stats_mask.shape != (N, D, H, W, 1):
        raise ValueError(f"stats_mask must be {(N, D, H, W, 1)}, got {tuple(stats_mask.shape)}")
    for v in vectors:
        if v.shape != (C,):
            raise ValueError(f"per-channel vectors must be ({C},), got {tuple(v.shape)}")


def bn_relu_pool_bwd_plain(y, ga, idx, stats_mask, bcoef, ccoef, invstd, sub):
    """Plain PyTorch version: ``ga`` routed to each window's member ``idx``
    (a one-hot over the 8 members), plus ``(bcoef + ccoef·ẑ)·stats_mask``
    with ``ẑ = y·invstd − sub``, in f32, one cast to y's dtype. The f32
    work runs in place on one scratch tensor (same rounding per op).
    ``stats_mask=None`` is the unmasked form: no mask product."""
    _check_bwd(y, ga, idx, stats_mask, (bcoef, ccoef, invstd, sub))
    N, D, H, W, C = y.shape
    members = torch.arange(8, device=y.device, dtype=torch.uint8)
    routed = torch.where(idx[..., None] == members, ga[..., None], 0).to(y.dtype)
    routed = (
        routed.reshape(N, D // 2, H // 2, W // 2, C, 2, 2, 2)
        .permute(0, 1, 5, 2, 6, 3, 7, 4)
        .reshape(N, D, H, W, C)
    )
    t = y.to(torch.float32, copy=True)
    t.mul_(invstd).sub_(sub)
    t.mul_(ccoef).add_(bcoef)
    if stats_mask is not None:
        t.mul_(stats_mask)
    t.add_(routed)
    return t.to(y.dtype)


@functools.cache
def _lib_bwd():
    lib = _build.load("bn_relu_pool_bwd")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"bn_relu_pool_bwd_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def bwd_launch_plan(shape, elem_bytes: int, values=(), idx=None, vectors=()) -> tuple[int, bool]:
    """K3's (channels a thread, 64-bit index math). Channels a thread: the
    most, up to 16 bytes of y's dtype, that divide C and whose bytes divide
    the addresses of ``values`` (y, ga, dy), whose count divides that of
    ``idx`` (a byte a channel) and whose f32 bytes, up to 16, divide those
    of ``vectors`` (bcoef, ccoef, invstd, sub). 64-bit index math where the
    sites or the threads (one a pooled cell and channel vector) reach 2^31.
    Raises where an extent does not fit the kernel's 32-bit int."""
    N, D, H, W, C = shape
    if max(D, H, W, C) >= 2**31:
        raise ValueError(f"bn_relu_pool_bwd takes D, H, W and C below 2^31, got {tuple(shape)}")
    vec = 16 // elem_bytes
    while vec > 1 and not (
        C % vec == 0
        and all(t.data_ptr() % (vec * elem_bytes) == 0 for t in values)
        and (idx is None or idx.data_ptr() % vec == 0)
        and all(v.data_ptr() % min(16, 4 * vec) == 0 for v in vectors)
    ):
        vec //= 2
    sites = N * D * H * W
    return vec, sites >= 2**31 or sites // 8 * (C // vec) >= 2**31


def _launch_k3(y, ga, idx, stats_mask, vectors, name):
    """Check K3's inputs and launch it; ``stats_mask=None`` for the unmasked
    entry."""
    _check_bwd(y, ga, idx, stats_mask, vectors)
    if y.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {y.dtype}")
    if ga.dtype != y.dtype or (stats_mask is not None and stats_mask.dtype != y.dtype) \
            or idx.dtype != torch.uint8:
        raise TypeError("ga and stats_mask must have y's dtype, idx must be uint8")
    if any(v.dtype != torch.float32 for v in vectors):
        raise TypeError("bcoef/ccoef/invstd/sub must be float32")
    for t in (y, ga, idx, stats_mask, *vectors):
        if t is not None and (t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"{name} needs contiguous inputs on y's device")
    N, D, H, W, C = y.shape
    dy = torch.empty_like(y)
    vec, wide = bwd_launch_plan(y.shape, y.element_size(), (y, ga, dy), idx, vectors)
    fn = getattr(_lib_bwd(), f"bn_relu_pool_bwd_{_DTYPES[y.dtype]}")
    with torch.cuda.device(y.device), _work.launch(name, work, "K3", y.shape, y.element_size(),
                                                   int(stats_mask is not None)):
        status = fn(
            y.data_ptr(), ga.data_ptr(), idx.data_ptr(),
            None if stats_mask is None else stats_mask.data_ptr(),
            *(v.data_ptr() for v in vectors),
            dy.data_ptr(), N, D // 2, H // 2, W // 2, C, vec, int(wide),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(status, name)
    return dy


def bn_relu_pool_bwd(y, ga, idx, stats_mask, bcoef, ccoef, invstd, sub):
    """Full-resolution dy of the masked BN → ReLU → pool backward; K3 on CUDA.

    y (N, D, H, W, C) bf16 or f32; ga (pooled shape) and stats_mask
    (N, D, H, W, 1) in y's dtype; idx (pooled shape) uint8 from K1;
    bcoef/ccoef/invstd/sub (C,) f32. Returns dy in y's dtype.
    ``stats_mask=None`` runs the unmasked entry, ``bn_relu_pool_bwd_unmasked``.
    """
    if stats_mask is None:
        return bn_relu_pool_bwd_unmasked(y, ga, idx, bcoef, ccoef, invstd, sub)
    if y.device.type == "cpu":
        return bn_relu_pool_bwd_plain(y, ga, idx, stats_mask, bcoef, ccoef, invstd, sub)
    _on_cuda(y, "bn_relu_pool_bwd")
    dy = _launch_k3(y, ga, idx, stats_mask, (bcoef, ccoef, invstd, sub), "bn_relu_pool_bwd")
    _tracing.count("launches.bn_relu_pool_bwd")
    return dy


def bn_relu_pool_bwd_unmasked(y, ga, idx, bcoef, ccoef, invstd, sub):
    """Full-resolution dy of the all-site BN → ReLU → pool backward,
    ``route(ga by idx) + bcoef + ccoef·ẑ``: K3's unmasked entry on CUDA, the
    Pallas ``_dy_kernel``'s function (rounded as ``_hybrid_bwd``). Inputs as
    for ``bn_relu_pool_bwd``."""
    if y.device.type == "cpu":
        return bn_relu_pool_bwd_plain(y, ga, idx, None, bcoef, ccoef, invstd, sub)
    _on_cuda(y, "bn_relu_pool_bwd_unmasked")
    dy = _launch_k3(y, ga, idx, None, (bcoef, ccoef, invstd, sub),
                    "bn_relu_pool_bwd_unmasked")
    _tracing.count("launches.bn_relu_pool_bwd_unmasked")
    return dy


# ------------------------------------------------------- train-mode op

_SITE_DIMS = (0, 1, 2, 3)


def masked_stats(y, stats_mask, eps: float, group=None):
    """(mean, var, invstd, count) over the ``stats_mask`` sites, in f32 —
    the JAX package's ``_masked_stats``: count = max(Σm, 1), the biased
    variance Σy²m/count − mean², clipped at 0. With a process ``group``
    the sums Σy·m, Σy²·m and Σm are all-reduced first: the statistics of
    the global batch, as pjit computes them."""
    m = stats_mask.float()
    ym = y.float() * m
    total = ym.sum(dim=_SITE_DIMS)
    ym.mul_(y)  # y²·m (exactly square(y)·m: m is 0 or 1)
    total_sq = ym.sum(dim=_SITE_DIMS)
    del ym
    total, total_sq, sites = sum_over_ranks((total, total_sq, m.sum()), group)
    count = torch.clamp(sites, min=1.0)
    mean = total / count
    var = torch.clamp(total_sq / count - mean.square(), min=0.0)
    return mean, var, torch.rsqrt(var + eps), count


_SLAB_ELEMS = 1 << 26  # f32 elements batch_stats widens at once (256 MB)


def batch_stats(y, eps: float, group=None):
    """(mean, var, invstd, n) over every site in f32 — the JAX package's
    ``_stats``: mean of y, the biased variance E[y²] − mean² clipped at 0,
    rsqrt(var + eps), over n sites. y is widened and squared in f32 one
    slab of the batch at a time, so no whole f32 copy of y exists (4.3 GB
    at the flagship's block 1). With a process ``group`` Σy, Σy² and n are
    all-reduced first (the global batch's statistics)."""
    n = float(y.numel() // y.shape[-1])
    per_sample = max(1, y[0].numel())
    total = torch.zeros(y.shape[-1], dtype=torch.float32, device=y.device)
    total_sq = torch.zeros_like(total)
    for slab in y.split(max(1, _SLAB_ELEMS // per_sample)):
        s = slab.to(torch.float32, copy=True)
        total += s.sum(dim=_SITE_DIMS)
        total_sq += s.mul_(s).sum(dim=_SITE_DIMS)
        del s
    if group is not None:
        total, total_sq, n = sum_over_ranks((total, total_sq, total.new_tensor(n)), group)
    mean = total / n
    var = torch.clamp(total_sq / n - mean.square(), min=0.0)
    return mean, var, torch.rsqrt(var + eps), n


def _pooled_pieces(g_out, g_mean, g_var, pooled, scale, bias, invstd, count, dtype,
                   group=None):
    """The backward's pooled-resolution pieces (``_bwd_pieces`` /
    ``_hybrid_bwd``): dγ, dβ from the argmax record — a live pooled cell's
    argmax site is relu-positive (and unmasked), where m = γ·ẑ + β — the
    routed cotangent ga = A·g·[m > 0] in ``dtype``, and the f32 per-channel
    B and C of dy = route(ga) + B + C·ẑ, over ``count`` sites. With a
    process ``group`` B and C come from dβ, dγ and the statistics'
    cotangents summed over the ranks (``count`` is then the global one);
    the returned dγ, dβ stay the rank's own sums, which the gradient
    reduction adds up."""
    g32 = g_out.float() * (pooled > 0)
    scale32 = scale.float()
    safe = torch.where(scale32 == 0.0, 1.0, scale32)
    zmax = (pooled.float() - bias.float()) / safe
    zmax = torch.where(scale32 == 0.0, 0.0, zmax)
    dbeta = g32.sum(dim=_SITE_DIMS)
    dgamma = (g32 * zmax).sum(dim=_SITE_DIMS)
    sum_beta, sum_gamma = dbeta, dgamma
    if group is not None:
        g_mean = torch.zeros_like(dbeta) if g_mean is None else g_mean.float()
        g_var = torch.zeros_like(dbeta) if g_var is None else g_var.float()
        sum_beta, sum_gamma, g_mean, g_var = sum_over_ranks((dbeta, dgamma, g_mean, g_var),
                                                            group)
    a32 = scale32 * invstd
    b32 = -a32 * sum_beta / count
    c32 = -a32 * sum_gamma / count
    if g_mean is not None:
        b32 = b32 + g_mean / count
    if g_var is not None:
        c32 = c32 + 2.0 * g_var / (count * invstd)
    ga = (g32 * a32).to(dtype).contiguous()
    return dgamma, dbeta, ga, b32.contiguous(), c32.contiguous()


class _MaskedBNReLUPoolTrain(torch.autograd.Function):
    """Forward: masked statistics → fold → K1 (with argmax). Backward: the
    pooled-resolution pieces of ``_masked_hybrid2_bwd`` in plain torch, then
    K3. Saves y, idx, pooled, the stats mask and the f32 statistics — not
    the full-resolution activation the JAX package keeps: idx routes."""

    @staticmethod
    def forward(ctx, y, scale, bias, stats_mask, zero_mask, eps, use_kernels, group):
        mean, var, invstd, count = masked_stats(y, stats_mask, eps, group)
        mul, add = fold_bn(scale, bias, mean, var, eps, y.dtype)
        fwd = bn_relu_pool if use_kernels else bn_relu_pool_plain
        pooled, pooled_mask, idx = fwd(y, mul, add, zero_mask, stats_mask, want_idx=True)
        ctx.save_for_backward(y, idx, pooled, stats_mask, scale, bias, mean, invstd, count)
        ctx.use_kernels, ctx.group = use_kernels, group
        ctx.mark_non_differentiable(pooled_mask)
        return pooled, mean, var, pooled_mask

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var, _g_pmask):
        y, idx, pooled, stats_mask, scale, bias, mean, invstd, count = ctx.saved_tensors
        dgamma, dbeta, ga, b32, c32 = _pooled_pieces(
            g_out, g_mean, g_var, pooled, scale, bias, invstd, count, y.dtype, ctx.group)
        bwd = bn_relu_pool_bwd if ctx.use_kernels else bn_relu_pool_bwd_plain
        dy = bwd(y, ga, idx, stats_mask, b32, c32, invstd.contiguous(),
                 (mean * invstd).contiguous())
        return dy, dgamma.to(scale.dtype), dbeta.to(bias.dtype), None, None, None, None, None


def masked_bn_relu_pool_train(y, scale, bias, stats_mask, zero_mask=None, eps: float = 1e-5,
                              use_kernels: bool = True, group=None):
    """Train-mode masked BN (batch statistics) → ReLU → zero → MaxPool(2³).

    y (N, D, H, W, C) bf16 or f32 channels-last; scale/bias (C,) in the
    parameter dtype, f32 or bf16 (used widened to f32; dγ, dβ come back in
    their dtype, as ``fused_bn_pool``'s backward casts them);
    masks (N, D, H, W, 1) in y's dtype; ``zero_mask=None`` means
    ``stats_mask`` (the single-mask blocks). Returns (pooled, mean, var,
    pooled_mask) with f32 mean and biased var over the ``stats_mask``
    sites. Differentiable in y, scale and bias. ``use_kernels=False`` runs
    the kernels' plain versions on any device. With a process ``group``
    the statistics are the global batch's (``masked_stats``) and the
    backward's per-channel sums too; each rank's dγ, dβ stay its own.
    """
    zero_mask = stats_mask if zero_mask is None else zero_mask
    _check(y, scale, bias, zero_mask, stats_mask)
    return _MaskedBNReLUPoolTrain.apply(y, scale, bias, stats_mask, zero_mask, eps,
                                        use_kernels, group)


class _BNReLUPoolTrain(torch.autograd.Function):
    """Forward: all-site statistics → fold → K1's unmasked entry (with
    argmax), as ``fused_bn_relu_pool``'s ``_fwd``. Backward: the
    pooled-resolution pieces over n = N·D·H·W sites in plain torch, then
    K3's unmasked entry. Saves y, idx, pooled and the f32 statistics."""

    @staticmethod
    def forward(ctx, y, scale, bias, eps, use_kernels, group):
        mean, var, invstd, count = batch_stats(y, eps, group)
        mul, add = fold_bn(scale, bias, mean, var, eps, y.dtype)
        fwd = bn_relu_pool_unmasked if use_kernels else bn_relu_pool_plain
        pooled, idx = fwd(y, mul, add, want_idx=True)
        ctx.save_for_backward(y, idx, pooled, scale, bias, mean, invstd)
        ctx.count, ctx.use_kernels, ctx.group = count, use_kernels, group
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        y, idx, pooled, scale, bias, mean, invstd = ctx.saved_tensors
        dgamma, dbeta, ga, b32, c32 = _pooled_pieces(
            g_out, g_mean, g_var, pooled, scale, bias, invstd, ctx.count, y.dtype, ctx.group)
        vectors = (b32, c32, invstd.contiguous(), (mean * invstd).contiguous())
        if ctx.use_kernels:
            dy = bn_relu_pool_bwd_unmasked(y, ga, idx, *vectors)
        else:
            dy = bn_relu_pool_bwd_plain(y, ga, idx, None, *vectors)
        return dy, dgamma.to(scale.dtype), dbeta.to(bias.dtype), None, None, None


def bn_relu_pool_train(y, scale, bias, eps: float = 1e-5, use_kernels: bool = True,
                       group=None):
    """Train-mode all-site BN (batch statistics) → ReLU → MaxPool(2³), the
    counterpart of ``fused_bn_relu_pool`` / ``hybrid_bn_relu_pool``.

    y (N, D, H, W, C) bf16 or f32 channels-last; scale/bias (C,) f32 or
    bf16, as for ``masked_bn_relu_pool_train``. Returns (pooled, mean, var) with f32 mean and biased var over every
    site. Differentiable in y, scale and bias (and through mean and var).
    ``use_kernels=False`` runs the kernels' plain versions on any device.
    ``group``: as for ``masked_bn_relu_pool_train``.
    """
    _check(y, scale, bias, None, None)
    return _BNReLUPoolTrain.apply(y, scale, bias, eps, use_kernels, group)

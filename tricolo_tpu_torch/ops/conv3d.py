"""3-D VALID convolutions whose backward is not autograd's own: kernels K8
(input gradient) and K9 (weight gradient), and the explicit form (opt-in).

Each runs the forward as ``F.conv3d`` VALID (cuDNN on the card) and takes
the gradient it does not replace from cuDNN's ``convolution_backward``.

* ``conv3d_valid_kernel_dgrad`` — the VALID 3³ tile convolutions the voxel
  encoder trains (block 2 on the window rows, the dense plan's tile-sparse
  blocks): the input gradient is ``conv3d_valid_dgrad``, which on a CUDA
  tensor launches the hand-written kernel ``csrc/conv3d_dgrad.cu`` (K8) or
  raises, and on a CPU tensor runs ``conv3d_valid_dgrad_plain``, cuDNN's /
  ATen's own ``convolution_backward`` for the input alone. K8 replaces no
  TPU kernel: the JAX package leaves the convolution to XLA, and the port
  added K8 because cuDNN's heuristic picked a direct dgrad kernel that ran
  at about 2,000 times its bound (the source's header). K8 takes bf16 and
  the forms ``FORMS``; f32 sums, one cast, like cuDNN's. ``ConvBlock``
  takes this route only where K8 can run (``takes_kernel_dgrad``).
* ``conv3d_valid_kernel_wgrad`` — block 1's VALID 3³ convolution (4 → 32
  channels on the window rows and the dense plan's first tile-sparse
  block), whose input is data: the weight gradient is
  ``conv3d_valid_wgrad``, which on a CUDA tensor launches
  ``csrc/conv3d_wgrad.cu`` (K9) or raises, and on a CPU tensor runs
  ``conv3d_valid_wgrad_plain``, ``convolution_backward`` for the weight
  alone. K9 replaces no TPU kernel either: cuDNN's pick for it ran at
  about 2% of its memory bound (the source's header). K9 takes bf16 and
  the forms ``WGRAD_FORMS``; f32 sums, one cast. ``ConvBlock`` takes this
  route only where K9 can run (``takes_kernel_wgrad``). The two kernels'
  forms are disjoint, so no convolution needs both.
* ``conv3d_valid_explicit_dgrad`` — port of
  ``tricolo_tpu.ops.conv3d.conv3d_valid_explicit_dgrad``
  (``model.modules.VoxelCNNEncoder.explicit_dgrad``, default off): the
  input gradient as a forward convolution, ``dy`` padded by k−1 on every
  spatial edge, convolved with the spatially flipped, in/out-swapped
  kernel. Mathematically identical; reduction order may differ in the last
  bits.
"""

from __future__ import annotations

import ctypes
import functools
import torch
import torch.nn.functional as F

from .. import tracing as _tracing
from .. import work as _work
from . import _build

_STRIDE, _PAD, _DILATION = [1, 1, 1], [0, 0, 0], [1, 1, 1]


def _input_grad(dy, x, w):
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, _STRIDE, _PAD, _DILATION, False, [0, 0, 0], 1, [True, False, False],
    )[0]


def _weight_grad(dy, x, w):
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, _STRIDE, _PAD, _DILATION, False, [0, 0, 0], 1, [False, True, False],
    )[1]


def _explicit_dgrad(dy, x, w):
    kd, kh, kw = w.shape[2:]
    padded = F.pad(dy, (kw - 1, kw - 1, kh - 1, kh - 1, kd - 1, kd - 1))
    return F.conv3d(padded, w.flip((2, 3, 4)).transpose(0, 1))


def _kernel_dgrad(dy, x, w):
    return conv3d_valid_dgrad(dy.contiguous(memory_format=torch.channels_last_3d), w)


def _kernel_wgrad(dy, x, w):
    return conv3d_valid_wgrad(dy, x)


class _ValidConv3d(torch.autograd.Function):
    """``F.conv3d`` VALID whose input and weight gradients are the given
    functions of (dy, x, w)."""

    @staticmethod
    def forward(ctx, x, w, dgrad, wgrad):
        ctx.save_for_backward(x, w)
        ctx.dgrad, ctx.wgrad = dgrad, wgrad
        return F.conv3d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = ctx.dgrad(dy, x, w) if ctx.needs_input_grad[0] else None
        dw = ctx.wgrad(dy, x, w) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def _apply(x, w, dgrad, wgrad):
    """Under autocast both operands are cast to the autocast dtype first,
    as ``F.conv3d`` would."""
    device = x.device.type
    if torch.is_autocast_enabled(device):
        dtype = torch.get_autocast_dtype(device)
        x, w = x.to(dtype), w.to(dtype)
    with torch.autocast(device, enabled=False):
        return _ValidConv3d.apply(x, w, dgrad, wgrad)


def conv3d_valid_explicit_dgrad(x, w):
    """VALID stride-1 conv, x (N, Cin, D, H, W) × w (Cout, Cin, kd, kh, kw),
    whose input gradient is an explicit forward conv."""
    return _apply(x, w, _explicit_dgrad, _weight_grad)


def conv3d_valid_kernel_dgrad(x, w):
    """VALID stride-1 conv, x (N, Cin, S, S, S) × w (Cout, Cin, 3, 3, 3),
    whose input gradient is ``conv3d_valid_dgrad`` (K8 on CUDA)."""
    return _apply(x, w, _kernel_dgrad, _weight_grad)


def conv3d_valid_kernel_wgrad(x, w):
    """VALID stride-1 conv, x (N, 4, S, S, S) × w (32, 4, 3, 3, 3), whose
    weight gradient is ``conv3d_valid_wgrad`` (K9 on CUDA)."""
    return _apply(x, w, _input_grad, _kernel_wgrad)


def _check(dy, w):
    if dy.ndim != 5 or w.ndim != 5 or dy.shape[1] != w.shape[0]:
        raise ValueError(f"expected dy (R, Cout, d, d, d) and w (Cout, Cin, k, k, k), got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    if not (dy.shape[2] == dy.shape[3] == dy.shape[4]) or not (w.shape[2] == w.shape[3]
                                                               == w.shape[4]):
        raise ValueError(f"expected cubic dy and w, got {tuple(dy.shape)} and {tuple(w.shape)}")
    return dy.shape[0], dy.shape[2] + w.shape[2] - 1


def conv3d_valid_dgrad_plain(dy, w):
    """Plain version: the input gradient of a VALID stride-1 conv, dy (R,
    Cout, d, d, d) × w (Cout, Cin, k, k, k) → dx (R, Cin, S, S, S), S = d +
    k − 1, as ``convolution_backward`` computes it alone (the input is
    needed for its shape only)."""
    rows, size = _check(dy, w)
    x = torch.empty((rows, w.shape[1], size, size, size), dtype=dy.dtype, device=dy.device,
                    memory_format=torch.channels_last_3d)
    return _input_grad(dy, x, w)


# (S, Cin, Cout): block 2 of the window rows and of the dense plan; the dense
# plan's third tile-sparse block.
FORMS = ((6, 32, 64), (4, 64, 128))


# (S, Cin, Cout): block 1 on the halo-3 window rows; block 1 on halo-1 rows
# and on the dense plan's first tile-sparse block.
WGRAD_FORMS = ((14, 4, 32), (10, 4, 32))


def _in_forms(forms, dtype, x_shape, w_shape) -> bool:
    return (dtype == torch.bfloat16 and len(x_shape) == len(w_shape) == 5
            and tuple(w_shape[2:]) == (3, 3, 3) and x_shape[2] == x_shape[3] == x_shape[4]
            and (x_shape[2], w_shape[1], w_shape[0]) in forms)


def has_form(dtype, x_shape, w_shape) -> bool:
    """Whether K8 takes the input gradient of a VALID conv of x (R, Cin, S,
    S, S) × w (Cout, Cin, 3, 3, 3) computed in ``dtype``: bf16 and (S, Cin,
    Cout) one of ``FORMS``."""
    return _in_forms(FORMS, dtype, x_shape, w_shape)


def has_wgrad_form(dtype, x_shape, w_shape) -> bool:
    """Whether K9 takes the weight gradient of that conv: bf16 and (S, Cin,
    Cout) one of ``WGRAD_FORMS``."""
    return _in_forms(WGRAD_FORMS, dtype, x_shape, w_shape)


def _compute_dtype(x):
    return torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else x.dtype


def takes_kernel_dgrad(x, w) -> bool:
    """Whether the VALID conv of ``x`` and ``w`` routes through
    ``conv3d_valid_kernel_dgrad``: its input needs a gradient, it runs on
    CUDA, and K8 has its form in its compute dtype (``has_form``). Every
    other conv keeps autograd's input gradient: the CPU, an f32-compute
    step, a width (``ef_dim``) K8 is not built for."""
    if not (x.requires_grad and torch.is_grad_enabled()) or x.device.type != "cuda":
        return False
    return has_form(_compute_dtype(x), x.shape, w.shape)


def takes_kernel_wgrad(x, w) -> bool:
    """Whether the VALID conv of ``x`` and ``w`` routes through
    ``conv3d_valid_kernel_wgrad``: its weight needs a gradient, it runs on
    CUDA, and K9 has its form in its compute dtype (``has_wgrad_form``),
    whether or not its input needs one. Every other conv keeps cuDNN's
    weight gradient: the CPU, an f32-compute step, another width."""
    if not (w.requires_grad and torch.is_grad_enabled()) or x.device.type != "cuda":
        return False
    return has_wgrad_form(_compute_dtype(x), x.shape, w.shape)


def _chunk(cout: int) -> int:
    """Input channels a block of ``csrc/conv3d_dgrad.cu`` (its ``Form::CC``):
    27 taps × Cout × chunk bf16 = 110,592 bytes of weights."""
    return 32 if cout == 64 else 16


def pack_weight(w):
    """w (Cout, Cin, 3, 3, 3) → the kernel's fragment-major order: per
    channel chunk, tap, 8-channel group and pair of k16 steps, 32 lanes of
    16 bytes, lane = 4·g + t holding channel 8·group + g at k = 16·step +
    8·j + 2·t + e for (step in the pair, j, e) — the B fragments of
    ``mma.m16n8k16`` (row = k, column = channel)."""
    cout, cin = w.shape[:2]
    chunk = _chunk(cout)
    parts = w.reshape(cout // 32, 2, 2, 4, 2, cin // chunk, chunk // 8, 8, 27)
    # (pair, step, j, t, e, chunk, group, g, tap) → (chunk, tap, group, pair, g, t, step, j, e)
    return parts.permute(5, 8, 6, 0, 7, 3, 1, 2, 4).contiguous()


@functools.cache
def _lib():
    lib = _build.load("conv3d_dgrad")
    lib.conv3d_dgrad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.conv3d_dgrad.restype = ctypes.c_int
    return lib


@functools.cache
def _wgrad_lib():
    lib = _build.load("conv3d_wgrad")
    lib.conv3d_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.conv3d_wgrad.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def work(rows: int, size: int, cin: int, cout: int):
    """(bytes, flops) of one K8 or K9 call as PERF.md §6 bounds it, bf16:
    K8 reads dy and the weights and writes dx once, K9 reads dy and x and
    writes the weights once — the same bytes; 2 flops for each true
    product, taps past the edges not counted."""
    d = size - 2
    nbytes = rows * (d**3 * cout + size**3 * cin) * 2 + 27 * cin * cout * 2
    return nbytes, 2 * rows * d**3 * 27 * cin * cout


def conv3d_valid_dgrad(dy, w):
    """dx (R, Cin, S, S, S), channels-last-3d (the permute of an NDHWC
    tensor), of dy (R, Cout, S−2, S−2, S−2), the channels-last-3d view of
    an NDHWC buffer, and w (Cout, Cin, 3, 3, 3). K8 on CUDA (bf16, the
    forms of ``FORMS``); the plain version on the CPU."""
    if dy.device.type == "cpu":
        return conv3d_valid_dgrad_plain(dy, w)
    if dy.device.type != "cuda":
        raise ValueError(f"conv3d_valid_dgrad runs on cuda or cpu tensors, got {dy.device}")
    rows, size = _check(dy, w)
    cout, cin = w.shape[:2]
    if w.shape[2] != 3 or (size, cin, cout) not in FORMS:
        raise ValueError(f"conv3d_valid_dgrad has no form (S, Cin, Cout) = {(size, cin, cout)} "
                         f"with 3³ taps; it takes {FORMS}")
    if dy.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_valid_dgrad takes bf16, got {dy.dtype} and {w.dtype}")
    if w.device != dy.device:
        raise ValueError("conv3d_valid_dgrad needs dy and w on one device")
    if not dy.is_contiguous(memory_format=torch.channels_last_3d) or dy.data_ptr() % 16:
        raise ValueError("dy must be the channels-last-3d view of a 16-byte aligned NDHWC buffer")
    dx = torch.empty((rows, size, size, size, cin), dtype=dy.dtype, device=dy.device)
    if rows:
        packed = pack_weight(w)
        with torch.cuda.device(dy.device), _work.launch("conv3d_valid_dgrad", work, rows, size,
                                                        cin, cout):
            status = _lib().conv3d_dgrad(
                dy.data_ptr(), packed.data_ptr(), dx.data_ptr(), rows, size, cin, cout,
                torch.cuda.current_stream(dy.device).cuda_stream,
            )
        _build.check(status, "conv3d_dgrad")
        _tracing.count("launches.conv3d_valid_dgrad")
    return dx.permute(0, 4, 1, 2, 3)


def conv3d_valid_wgrad_plain(dy, x):
    """Plain version: the weight gradient of a VALID stride-1 conv, dy (R,
    Cout, d, d, d) and x (R, Cin, S, S, S) → dw (Cout, Cin, k, k, k), k = S
    − d + 1, as ``convolution_backward`` computes it alone (the weight is
    needed for its shape only)."""
    if dy.ndim != 5 or x.ndim != 5 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"expected dy (R, Cout, d, d, d) and x (R, Cin, S, S, S), got "
                         f"{tuple(dy.shape)} and {tuple(x.shape)}")
    k = x.shape[2] - dy.shape[2] + 1
    w = torch.empty((dy.shape[1], x.shape[1], k, k, k), dtype=dy.dtype, device=dy.device)
    return _weight_grad(dy, x, w)


def conv3d_valid_wgrad(dy, x):
    """dw (32, 4, 3, 3, 3) of dy (R, 32, S−2, S−2, S−2) and x (R, 4, S, S,
    S), each the channels-last-3d view of an NDHWC buffer (as autograd
    hands them to the convolution's backward). K9 on CUDA (bf16, the forms
    of ``WGRAD_FORMS``); the plain version on the CPU."""
    if dy.device.type == "cpu":
        return conv3d_valid_wgrad_plain(dy, x)
    if dy.device.type != "cuda":
        raise ValueError(f"conv3d_valid_wgrad runs on cuda or cpu tensors, got {dy.device}")
    if dy.ndim != 5 or x.ndim != 5 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"expected dy (R, Cout, d, d, d) and x (R, Cin, S, S, S), got "
                         f"{tuple(dy.shape)} and {tuple(x.shape)}")
    rows, cin, size = x.shape[:3]
    cout = dy.shape[1]
    if (tuple(x.shape[2:]) != (size,) * 3 or tuple(dy.shape[2:]) != (size - 2,) * 3
            or (size, cin, cout) not in WGRAD_FORMS):
        raise ValueError(f"conv3d_valid_wgrad has no form (S, Cin, Cout) = {(size, cin, cout)} "
                         f"with 3³ taps for dy {tuple(dy.shape)}; it takes {WGRAD_FORMS}")
    if dy.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_valid_wgrad takes bf16, got {dy.dtype} and {x.dtype}")
    if x.device != dy.device:
        raise ValueError("conv3d_valid_wgrad needs dy and x on one device")
    for name, t in (("dy", dy), ("x", x)):
        if not t.is_contiguous(memory_format=torch.channels_last_3d) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be the channels-last-3d view of a 16-byte aligned "
                             "NDHWC buffer")
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=dy.dtype, device=dy.device)
    if not rows:
        return dw.zero_()
    blocks = _sm_count(dy.device.index if dy.device.index is not None
                       else torch.cuda.current_device())
    partial = torch.empty((blocks, dw.numel()), dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device), _work.launch("conv3d_valid_wgrad", work, rows, size, cin,
                                                    cout):
        status = _wgrad_lib().conv3d_wgrad(
            dy.data_ptr(), x.data_ptr(), partial.data_ptr(), dw.data_ptr(), rows, size, cin,
            cout, blocks, torch.cuda.current_stream(dy.device).cuda_stream,
        )
    _build.check(status, "conv3d_wgrad")
    _tracing.count("launches.conv3d_valid_wgrad")
    return dw

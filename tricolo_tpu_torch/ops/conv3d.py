"""3-D VALID convolutions whose input gradient is not autograd's own: kernel
K8, and the explicit form (opt-in).

Both run the forward as ``F.conv3d`` VALID (cuDNN on the card) and take the
weight gradient from cuDNN's ``convolution_backward``; they differ in the
input gradient.

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


def _weight_grad(dy, x, w):
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, _STRIDE, _PAD, _DILATION, False, [0, 0, 0], 1, [False, True, False],
    )[1]


def _explicit_dgrad(dy, w):
    kd, kh, kw = w.shape[2:]
    padded = F.pad(dy, (kw - 1, kw - 1, kh - 1, kh - 1, kd - 1, kd - 1))
    return F.conv3d(padded, w.flip((2, 3, 4)).transpose(0, 1))


def _kernel_dgrad(dy, w):
    return conv3d_valid_dgrad(dy.contiguous(memory_format=torch.channels_last_3d), w)


class _ValidConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dgrad):
        ctx.save_for_backward(x, w)
        ctx.dgrad = dgrad
        return F.conv3d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = ctx.dgrad(dy, w) if ctx.needs_input_grad[0] else None
        dw = _weight_grad(dy, x, w) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _apply(x, w, dgrad):
    """Under autocast both operands are cast to the autocast dtype first,
    as ``F.conv3d`` would."""
    device = x.device.type
    if torch.is_autocast_enabled(device):
        dtype = torch.get_autocast_dtype(device)
        x, w = x.to(dtype), w.to(dtype)
    with torch.autocast(device, enabled=False):
        return _ValidConv3d.apply(x, w, dgrad)


def conv3d_valid_explicit_dgrad(x, w):
    """VALID stride-1 conv, x (N, Cin, D, H, W) × w (Cout, Cin, kd, kh, kw),
    whose input gradient is an explicit forward conv."""
    return _apply(x, w, _explicit_dgrad)


def conv3d_valid_kernel_dgrad(x, w):
    """VALID stride-1 conv, x (N, Cin, S, S, S) × w (Cout, Cin, 3, 3, 3),
    whose input gradient is ``conv3d_valid_dgrad`` (K8 on CUDA)."""
    return _apply(x, w, _kernel_dgrad)


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
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, _STRIDE, _PAD, _DILATION, False, [0, 0, 0], 1, [True, False, False],
    )[0]


# (S, Cin, Cout): block 2 of the window rows and of the dense plan; the dense
# plan's third tile-sparse block.
FORMS = ((6, 32, 64), (4, 64, 128))


def has_form(dtype, x_shape, w_shape) -> bool:
    """Whether K8 takes the input gradient of a VALID conv of x (R, Cin, S,
    S, S) × w (Cout, Cin, 3, 3, 3) computed in ``dtype``: bf16 and (S, Cin,
    Cout) one of ``FORMS``."""
    return (dtype == torch.bfloat16 and len(x_shape) == len(w_shape) == 5
            and tuple(w_shape[2:]) == (3, 3, 3) and x_shape[2] == x_shape[3] == x_shape[4]
            and (x_shape[2], w_shape[1], w_shape[0]) in FORMS)


def takes_kernel_dgrad(x, w) -> bool:
    """Whether the VALID conv of ``x`` and ``w`` routes through
    ``conv3d_valid_kernel_dgrad``: its input needs a gradient, it runs on
    CUDA, and K8 has its form in its compute dtype (``has_form``). Every
    other conv keeps autograd's input gradient: the CPU, an f32-compute
    step, a width (``ef_dim``) K8 is not built for."""
    if not (x.requires_grad and torch.is_grad_enabled()) or x.device.type != "cuda":
        return False
    dtype = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else x.dtype
    return has_form(dtype, x.shape, w.shape)


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


def work(rows: int, size: int, cin: int, cout: int):
    """(bytes, flops) of one K8 call as PERF.md §6 bounds it: dy read and
    dx written once, the weights read once (bf16); 2 flops for each true
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

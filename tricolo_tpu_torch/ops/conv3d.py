"""3-D VALID convolution with an explicitly formulated input gradient (opt-in).

Port of ``tricolo_tpu.ops.conv3d.conv3d_valid_explicit_dgrad``
(``model.modules.VoxelCNNEncoder.explicit_dgrad``, default off). The forward
is ``F.conv3d`` VALID. The backward writes the input gradient as a forward
convolution — ``dy`` padded by k−1 on every spatial edge, convolved with
the spatially flipped, in/out-swapped kernel — instead of the transposed
("dgrad") convolution autograd would call, and takes the weight gradient
from cuDNN's own ``convolution_backward``. Mathematically identical;
reduction order may differ in the last bits. Convolutions stay cuDNN, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _ValidConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kd, kh, kw = w.shape[2:]
        dx = None
        if ctx.needs_input_grad[0]:
            padded = F.pad(dy, (kw - 1, kw - 1, kh - 1, kh - 1, kd - 1, kd - 1))
            dx = F.conv3d(padded, w.flip((2, 3, 4)).transpose(0, 1))
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                dy, x, w, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1,
                [False, True, False],
            )[1]
        return dx, dw


def conv3d_valid_explicit_dgrad(x, w):
    """VALID stride-1 conv, x (N, Cin, D, H, W) × w (Cout, Cin, kd, kh, kw),
    whose input gradient is an explicit forward conv. Under autocast both
    operands are cast to the autocast dtype first, as ``F.conv3d`` would."""
    device = x.device.type
    if torch.is_autocast_enabled(device):
        dtype = torch.get_autocast_dtype(device)
        x, w = x.to(dtype), w.to(dtype)
    with torch.autocast(device, enabled=False):
        return _ValidConv3d.apply(x, w)

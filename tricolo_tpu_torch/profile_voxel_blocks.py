"""Per-block timing of the voxel encoder's convolution and BN-ReLU-pool on
the GPU.

    python -m tricolo_tpu_torch.profile_voxel_blocks [--iters 20]
        [--batch-size 128] [--blocks N] [--device cuda|cpu]

The port's twin of ``scripts/profile_voxel_blocks.py``, over the same five
dense blocks at the flagship shapes (``BLOCKS``: 64³ 3→32 … 4³ 256→512),
bf16, SAME 3³ convolution, channels-last, seeded inputs. Columns, each the
median of 3 loops of ``--iters`` calls ending in a CUDA synchronize, per
call, in ms:

* ``conv_fwd``; ``conv_dw``: the forward + weight gradient less the
  forward, as the JAX script takes it;
* BN-ReLU-pool (train-mode batch statistics over every site) forward and
  forward + backward three ways: ``compose`` — torch's composition
  ``F.batch_norm`` → ``relu`` → ``max_pool3d`` (in place of JAX's
  ``reference_bn_relu_pool``); ``plain`` — ``ops.bn_relu_pool_train(...,
  use_kernels=False)``; ``kernel`` — ``ops.bn_relu_pool_train`` through
  K1's and K3's unmasked entries (the port's one op where the JAX package
  has ``fused_bn_relu_pool`` and ``hybrid_bn_relu_pool``);
* ``block_fwd_bwd``: the block (the convolution, then the kernel op)
  forward + backward into the weight, γ and β.

Every backward is of the JAX script's surrogate ``sum(out * out.detach())``
(in f32). ``launches`` counts each kernel column's K1/K3 launches in one
call. Prints one JSON line: ``{"blocks": [...], "iters", "batch_size",
"card"}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from .profile_step import counted, loop_ms

BLOCKS = [  # (D, Cin, Cout) of each ConvBlock at voxel_size=64, ef_dim=32
    (64, 3, 32),
    (32, 32, 64),
    (16, 64, 128),
    (8, 128, 256),
    (4, 256, 512),
]
FORMS = ("compose", "plain", "kernel")


def conv(w, x):
    """SAME 3³ convolution of channels-last x (N, C, D, H, W)."""
    return F.conv3d(x, w, padding=1)


def bn_relu_pool(form: str, y, scale, bias):
    """Train-mode BN → ReLU → MaxPool(2³) of y (N, C, D, H, W), channels
    last, by ``form`` (module docstring); the pooled values as (N, D/2,
    H/2, W/2, C)."""
    from .ops import bn_relu_pool_train

    if form == "compose":
        z = F.batch_norm(y, None, None, scale, bias, training=True, eps=1e-5)
        return F.max_pool3d(F.relu(z), 2).permute(0, 2, 3, 4, 1)
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return bn_relu_pool_train(y.permute(0, 2, 3, 4, 1), scale, bias,
                              use_kernels=form == "kernel")[0]


def surrogate(out):
    out = out.float()
    return (out * out.detach()).sum()


def block_backward(form: str, w, scale, bias, x):
    """The block, conv then ``bn_relu_pool(form)``, forward and the
    surrogate's backward into ``.grad`` of those of w, scale, bias that
    require it."""
    surrogate(bn_relu_pool(form, conv(w, x), scale, bias)).backward()


def block_inputs(B: int, D: int, cin: int, cout: int, device, dtype=torch.bfloat16,
                 seed: int = 0):
    """Seeded x (B, cin, D, D, D) channels-last and w (cout, cin, 3, 3, 3)
    in ``dtype``; γ = 1 and β = 0 in f32, as the JAX script's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, D, D, D, cin), generator=gen, device=device).to(dtype)
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=device) * 0.05
    return (x.permute(0, 4, 1, 2, 3), w.to(dtype).contiguous(memory_format=torch.channels_last_3d),
            torch.ones(cout, device=device), torch.zeros(cout, device=device))


def profile_block(B: int, D: int, cin: int, cout: int, device, iters: int) -> dict:
    x, w, scale, bias = block_inputs(B, D, cin, cout, device)
    row: dict = {"block": f"{D}^3 {cin}->{cout}", "launches": {}}
    row["conv_fwd"] = loop_ms(lambda: conv(w, x), iters, device)
    wg = w.clone().requires_grad_(True)

    def conv_dw():
        wg.grad = None
        surrogate(conv(wg, x)).backward()

    row["conv_dw"] = loop_ms(conv_dw, iters, device) - row["conv_fwd"]
    with torch.no_grad():
        y = conv(w, x)
    yg = y.detach().requires_grad_(True)
    sg, bg = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    for form in FORMS:
        fwd = lambda form=form: bn_relu_pool(form, y, scale, bias)  # noqa: E731

        def fwd_bwd(form=form):
            yg.grad = sg.grad = bg.grad = None
            surrogate(bn_relu_pool(form, yg, sg, bg)).backward()

        with torch.no_grad():
            row["launches"][f"{form}_fwd"] = counted(fwd, device)
        row[f"{form}_fwd"] = loop_ms(torch.no_grad()(fwd), iters, device)
        row["launches"][f"{form}_fwd_bwd"] = counted(fwd_bwd, device)
        row[f"{form}_fwd_bwd"] = loop_ms(fwd_bwd, iters, device)
    del yg, y

    def block():
        wg.grad = sg.grad = bg.grad = None
        block_backward("kernel", wg, sg, bg, x)

    row["launches"]["block_fwd_bwd"] = counted(block, device)
    row["block_fwd_bwd"] = loop_ms(block, iters, device)
    return row


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.profile_voxel_blocks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="calls a timed loop")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--voxel-size", type=int, default=64,
                    help="block 1's grid (the blocks halve it in turn)")
    ap.add_argument("--blocks", type=int, default=len(BLOCKS), help="the first N blocks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from .bench import card_name
    from .inference import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.iters < 1:
        raise ValueError("--iters must be at least 1")
    blocks = [(args.voxel_size >> i, cin, cout)
              for i, (_, cin, cout) in enumerate(BLOCKS[:args.blocks])]
    rows = []
    for D, cin, cout in blocks:
        rows.append(profile_block(args.batch_size, D, cin, cout, device, args.iters))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"blocks": rows, "iters": args.iters, "batch_size": args.batch_size,
                      "card": card_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

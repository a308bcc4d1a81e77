"""``tricolo_tpu_torch.profile_voxel_blocks`` against the JAX package's
``scripts/profile_voxel_blocks.py``.

* The CLI on the CPU at a tiny size (batch 2, blocks 16³, 8³ and 4³): one
  JSON line with every column of every block; no kernel launches on CPU
  tensors.
* One block's forward + backward — SAME conv, train-mode BN → ReLU →
  MaxPool(2³), the surrogate ``sum(out * stop_gradient(out))`` — through
  the kernel path's plain version (``ops.bn_relu_pool_train(...,
  use_kernels=False)``) and through torch's composition equals JAX's
  ``jax.grad(block)`` over ``reference_bn_relu_pool`` (its l.93-97) in f32,
  within 1e-4 of each gradient's max (weight, γ, β).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
COLUMNS = ["conv_fwd", "conv_dw", "compose_fwd", "compose_fwd_bwd", "plain_fwd",
           "plain_fwd_bwd", "kernel_fwd", "kernel_fwd_bwd", "block_fwd_bwd"]
TOL = 1e-4


def test_cli_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    args = ["--device", "cpu", "--iters", "1", "--batch-size", "2", "--voxel-size", "16",
            "--blocks", "3"]
    proc = subprocess.run([sys.executable, "-m", "tricolo_tpu_torch.profile_voxel_blocks",
                           *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert [b["block"] for b in out["blocks"]] == ["16^3 3->32", "8^3 32->64", "4^3 64->128"]
    for block in out["blocks"]:
        assert all(np.isfinite(block[c]) for c in COLUMNS), block
        assert block["launches"] == {c: {} for c in COLUMNS[2:]}
    assert out["card"] == "cpu" and out["batch_size"] == 2


def _jax_block_grads(x, w, scale, bias):
    import jax.numpy as jnp

    from tricolo_tpu.ops.fused_bn_pool import reference_bn_relu_pool

    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NDHWC", "DHWIO", "NDHWC"))

    def conv(wt, xx):
        return jax.lax.conv_general_dilated(xx, wt, (1, 1, 1), "SAME", dimension_numbers=dn)

    def block(wt, s, b, xx):  # scripts/profile_voxel_blocks.py l.93-97
        out, _, _ = reference_bn_relu_pool(conv(wt, xx), s, b)
        return jnp.sum(out.astype(jnp.float32) * jax.lax.stop_gradient(out.astype(jnp.float32)))

    grads = jax.jit(jax.grad(block, argnums=(0, 1, 2)))(*map(jnp.asarray, (w, scale, bias, x)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", ["plain", "compose"])
def test_block_grads_match_jax(form):
    from tricolo_tpu_torch.profile_voxel_blocks import block_backward

    rng = np.random.default_rng(0)
    B, D, cin, cout = 2, 8, 4, 8
    x = rng.standard_normal((B, D, D, D, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.random(cout) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.3).astype(np.float32)
    ref = _jax_block_grads(x, w, scale, bias)

    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    tw = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous().requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    block_backward(form, tw, ts, tb, tx)
    got = [tw.grad.permute(2, 3, 4, 1, 0).numpy(), ts.grad.numpy(), tb.grad.numpy()]
    for name, g, r in zip(("weight", "gamma", "beta"), got, ref):
        err = float(np.abs(g - r).max())
        assert err <= TOL * float(np.abs(r).max()), (form, name, err)

"""Bytes and floors of the voxel kernels K1, K2 and K3 (``voxel_kernels_roofline``).

A frozen copy of the ``work(...)`` formulas of
``tricolo_tpu_torch/ops/bn_relu_pool.py`` (K1, K3) and
``ops/tile_scatter.py`` (K2), so that a later change to the program cannot
move the yardstick, and the launches a windowed_compact train step of the
masked encoder makes with them:

* K1 (BN-ReLU-pool forward, with the argmax): reads y and its masks,
  writes the pooled values, the pooled mask and the uint8 argmax;
* K3 (its backward): reads y, the pooled cotangent, the argmax and the
  statistics mask, writes dy;
* K2 (tile → grid scatter): reads the valid tile rows and the ids once,
  writes the dense grid.

None does arithmetic worth counting, so a launch's floor is its bytes over
the H100's 3.35 TB/s. Block 1 runs on the (B·k, 12³, ef) rows with two
masks, block 2 on (B·k, 4³, 2ef) with one, K2 places (B, k, 2³, 2ef) tiles
and their mask on the D/4 grid, blocks 3-5 run dense on D/4, D/8, D/16.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# The device functions of each kernel (csrc/*.cu), matched in trace names.
SYMBOLS = {
    "K1": ("::bn_relu_pool_kernel",),
    "K2": ("::scatter_pass_kernel", "::inverse_kernel", "::inverse_global_kernel"),
    "K3": ("::bn_relu_pool_bwd_kernel",),
}


def k1_bytes(shape, elem: int, masks: int, want_idx: bool = True) -> int:
    N, D, H, W, C = shape
    sites = N * D * H * W
    pooled = sites // 8
    nbytes = (sites * C + masks * sites + pooled * C + (pooled if masks else 0)) * elem
    return nbytes + (pooled * C if want_idx else 0)


def k3_bytes(shape, elem: int, masks: int) -> int:
    N, D, H, W, C = shape
    sites = N * D * H * W
    pooled = sites // 8
    return (2 * sites * C + pooled * C + min(masks, 1) * sites) * elem + pooled * C


def k2_bytes(valid_rows: int, tile: int, channels: int, elem: int, ids: int, batch: int,
             grid: int) -> int:
    return (valid_rows * tile**3 + batch * grid**3) * channels * elem + ids * 4


def step_bytes(B: int, k: int, valid_rows: int, D: int, ef: int, z: int, elem: int = 2) -> int:
    """Bytes of one step's K1, K2 and K3 launches (module docstring)."""
    blocks = [((B * k, 12, 12, 12, ef), 2), ((B * k, 4, 4, 4, 2 * ef), 1)]
    g = D // 4
    for c in (4 * ef, 8 * ef, z):
        blocks.append(((B, g, g, g, c), 1))
        g //= 2
    total = sum(k1_bytes(shape, elem, masks) + k3_bytes(shape, elem, 1)
                for shape, masks in blocks)
    for channels in (2 * ef, 1):
        total += k2_bytes(valid_rows, 2, channels, elem, B * k, B, D // 4)
    return total


def label(name: str) -> str | None:
    for kernel, keys in SYMBOLS.items():
        if any(key in name for key in keys):
            return kernel
    return None

"""The port's CUDA kernels and their wrappers, without JAX.

On the CPU: the plain versions' edge cases and the wrappers' dispatch
(CPU tensors take the plain version and launch nothing). On a card
(``-m cuda``): each kernel against its plain version, bit-exact in f32 and
bf16, and the wrappers' refusals — a CUDA tensor never falls back to the
plain version. Run the card tests with

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops import (  # noqa: E402
    bn_relu_pool,
    bn_relu_pool_plain,
    fold_bn,
    scatter_tiles_ps,
    scatter_tiles_ps_plain,
)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _k1_inputs(shape, seed, dtype, device, two_masks):
    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    y = rng.integers(-16, 17, shape) / 8.0  # exact ties in every window
    mask = (rng.random((N, D, H, W, 1)) < 0.6).astype(np.float32)
    mask[:, :2, :2, :2] = 0.0  # all-zero windows
    stats = (rng.random(mask.shape) < 0.4) * mask
    bn = [rng.uniform(0.5, 1.5, C), rng.normal(0, 0.3, C), rng.normal(0, 0.3, C),
          rng.uniform(0.5, 2.0, C)]
    to = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    mul, add = fold_bn(*map(to, bn), 1e-5, dtype)
    smask = to(stats).to(dtype) if two_masks else None
    return to(y).to(dtype), mul, add, to(mask).to(dtype), smask


def _k2_inputs(B, k, C, grid, seed, dtype, device):
    rng = np.random.default_rng(seed)
    tg3 = (grid // 2) ** 3
    ids = np.full((B, k), tg3, np.int32)
    for b in range(B - 1):  # the last sample has no tile
        n = int(rng.integers(1, k + 1))
        ids[b, :n] = np.sort(rng.choice(tg3, n, replace=False))
    tiles = torch.tensor(rng.normal(size=(B, k, 2, 2, 2, C)), dtype=dtype, device=device)
    return tiles, torch.tensor(ids, device=device)


# ---------------------------------------------------------------- CPU


def test_first_max_index_and_zero_windows():
    y = torch.zeros(1, 2, 2, 2, 1)
    y[0, 1, 0, 1, 0] = 2.0  # r = 5
    y[0, 1, 1, 1, 0] = 2.0  # r = 7, a later tie
    ones = torch.ones(1, 2, 2, 2, 1)
    pooled, _, idx = bn_relu_pool_plain(y, torch.ones(1), torch.zeros(1), ones, want_idx=True)
    assert pooled.item() == 2.0 and idx.item() == 5
    pooled, pmask, idx = bn_relu_pool_plain(
        y, torch.ones(1), torch.zeros(1), ones * 0, want_idx=True
    )
    assert pooled.item() == 0.0 and pmask.item() == 0.0 and idx.item() == 0


def test_cpu_tensors_take_the_plain_version():
    from tricolo_tpu_torch import ops

    ops.reset_launches()
    args = _k1_inputs((2, 4, 4, 4, 8), 0, torch.float32, "cpu", True)
    for a, b in zip(bn_relu_pool(*args, want_idx=True), bn_relu_pool_plain(*args, want_idx=True)):
        assert torch.equal(a, b)
    tiles, ids = _k2_inputs(3, 5, 4, 8, 0, torch.float32, "cpu")
    assert torch.equal(scatter_tiles_ps(tiles, ids, 8), scatter_tiles_ps_plain(tiles, ids, 8))
    assert ops.launches() == {"bn_relu_pool": 0, "scatter_tiles_ps": 0}


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="even"):
        bn_relu_pool(torch.zeros(1, 3, 2, 2, 4), torch.ones(4), torch.zeros(4),
                     torch.ones(1, 3, 2, 2, 1))
    with pytest.raises(ValueError, match="mul/add"):
        bn_relu_pool(torch.zeros(1, 2, 2, 2, 4), torch.ones(3), torch.zeros(4),
                     torch.ones(1, 2, 2, 2, 1))
    tiles = torch.zeros(2, 3, 2, 2, 2, 4)
    with pytest.raises(ValueError, match="local_ids"):
        scatter_tiles_ps(tiles, torch.zeros(2, 4, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="multiple"):
        scatter_tiles_ps(tiles, torch.zeros(2, 3, dtype=torch.int32), 7)


def test_wrappers_reject_other_devices():
    y = torch.zeros(1, 2, 2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn_relu_pool(y, torch.ones(4, device="meta"), torch.zeros(4, device="meta"),
                     torch.ones(1, 2, 2, 2, 1, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        scatter_tiles_ps(torch.zeros(1, 1, 2, 2, 2, 4, device="meta"),
                         torch.zeros(1, 1, dtype=torch.int32, device="meta"), 8)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,two", [((64, 12, 12, 12, 32), True), ((64, 4, 4, 4, 64), False),
                  ((8, 16, 16, 16, 128), False), ((8, 4, 4, 4, 512), False)]
)
def test_cuda_bn_relu_pool_matches_plain(dtype, shape, two):
    _need_cuda()
    args = _k1_inputs(shape, 4, getattr(torch, dtype), "cuda", two)
    for want_idx in (False, True):
        before = bn_relu_pool.launches
        got = bn_relu_pool(*args, want_idx=want_idx)
        torch.cuda.synchronize()
        assert bn_relu_pool.launches == before + 1
        for a, b in zip(got, bn_relu_pool_plain(*args, want_idx=want_idx)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 1])
def test_cuda_scatter_tiles_matches_plain(dtype, C):
    _need_cuda()
    tiles, ids = _k2_inputs(16, 40, C, 16, C, getattr(torch, dtype), "cuda")
    before = scatter_tiles_ps.launches
    got = scatter_tiles_ps(tiles, ids, 16)
    torch.cuda.synchronize()
    assert scatter_tiles_ps.launches == before + 1
    assert torch.equal(got, scatter_tiles_ps_plain(tiles, ids, 16))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_instead_of_falling_back():
    _need_cuda()
    y, mul, add, mask, _ = _k1_inputs((2, 4, 4, 4, 8), 1, torch.float32, "cuda", False)
    with pytest.raises(ValueError, match="contiguous"):
        bn_relu_pool(y.transpose(1, 2), mul, add, mask.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn_relu_pool(y.half(), mul.half(), add.half(), mask.half())
    tiles, ids = _k2_inputs(2, 3, 4, 8, 1, torch.float32, "cuda")
    with pytest.raises(TypeError, match="int32"):
        scatter_tiles_ps(tiles, ids.long(), 8)

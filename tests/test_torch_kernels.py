"""The port's CUDA kernels and their wrappers, without JAX.

On the CPU: the plain versions' edge cases (K1's and K3's unmasked forms
included), the wrappers' dispatch (CPU tensors take the plain version and
launch nothing) and the launch plans of
K1 and K2 (vector width from shapes and addresses, the guards of their
32-bit index math), of K3 (channels a thread, 64-bit index math) and K7
(copy width, tiles a block, template form, its guards) and of the NT-Xent
forward (logits tile, grid, scratch) and backward (row tile and D slice). On a card (``-m cuda``): each kernel
against its plain version — K1-K3 (masked and unmasked entries), K7 and
both K2 entries bit-exact in f32 and bf16, K4-K6, the pair forward and the two-term backward (f32 sums in
another order) within ``NT_XENT_TOL · max|plain|``, the forward also
bit-identical from launch to launch — and the wrappers' refusals: a CUDA
tensor never falls back to the plain version.
Run the card tests with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops import (  # noqa: E402
    bn_relu_pool,
    bn_relu_pool_bwd,
    bn_relu_pool_bwd_plain,
    bn_relu_pool_bwd_unmasked,
    bn_relu_pool_plain,
    bn_relu_pool_unmasked,
    fold_bn,
    gather_tiles,
    gather_tiles_plain,
    nt_xent_bwd,
    nt_xent_bwd_cols,
    nt_xent_bwd_cols_plain,
    nt_xent_bwd_plain,
    nt_xent_bwd_rows,
    nt_xent_bwd_rows_plain,
    nt_xent_fwd,
    nt_xent_fwd_pair,
    nt_xent_fwd_pair_plain,
    nt_xent_fwd_plain,
    scatter_tiles_global,
    scatter_tiles_global_plain,
    scatter_tiles_ps,
    scatter_tiles_ps_plain,
)

# K4-K6 against their plain versions: the logits' 512-term dot products and
# the B-term sums run in another order (errors ~1e-6 relative per logit,
# carried through exp by at most |logit| <= 1/τ = 10).
NT_XENT_TOL = 1e-4
INV_TAU = 10.0


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


def _k3_inputs(shape, seed, dtype, device):
    """y quantized (exact values in bf16), random ga/idx/mask, f32 vectors."""
    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    pooled = (N, D // 2, H // 2, W // 2, C)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    y = f32(rng.integers(-16, 17, shape) / 8.0).to(dtype)
    ga = f32(rng.normal(size=pooled)).to(dtype)
    idx = torch.tensor(rng.integers(0, 8, pooled), dtype=torch.uint8, device=device)
    mask = f32(rng.random((N, D, H, W, 1)) < 0.5).to(dtype)
    vectors = [f32(rng.normal(size=C)) for _ in range(3)] + [f32(rng.uniform(0.5, 2, C))]
    b, c, sub, inv = vectors
    return y, ga, idx, mask, b, c, inv, sub


def _nt_inputs(B, D, seed, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, B, D))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    zi, zj = (torch.tensor(a, dtype=torch.float32, device=device) for a in z)
    lse = nt_xent_fwd_plain(zi, zj, INV_TAU)[:, 1].contiguous()
    scale = torch.tensor([0.75 * INV_TAU / B], dtype=torch.float32, device=device)
    return zi, zj, lse, scale


def _nt_bwd_inputs(B, D, seed, device):
    """Unit-norm operands and both directions' logsumexps shifted by
    N(0, 0.1) noise, so that even B = 1 has non-zero coefficients."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, B, D))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    zi, zj = (torch.tensor(a, dtype=torch.float32, device=device) for a in z)
    noise = torch.tensor(rng.normal(0, 0.1, (2, B)), dtype=torch.float32, device=device)
    lse_a = (nt_xent_fwd_plain(zi, zj, INV_TAU)[:, 1] + noise[0]).contiguous()
    lse_b = (nt_xent_fwd_plain(zj, zi, INV_TAU)[:, 1] + noise[1]).contiguous()
    return zi, zj, lse_a, lse_b


def _k2_inputs(B, k, C, grid, seed, dtype, device, t=2):
    rng = np.random.default_rng(seed)
    tg3 = (grid // t) ** 3
    ids = np.full((B, k), tg3, np.int32)
    for b in range(B - 1):  # the last sample has no tile
        n = int(rng.integers(1, min(k, tg3) + 1))
        ids[b, :n] = np.sort(rng.choice(tg3, n, replace=False))
    tiles = torch.tensor(rng.normal(size=(B, k, t, t, t, C)), dtype=dtype, device=device)
    return tiles, torch.tensor(ids, device=device)


def _global_ids(B, tg3, n, rng):
    """n ascending unique global ids over B·tg³ tiles holding the first and
    the last tile of the grid (edge windows), then 3 padding ids."""
    inner = rng.choice(np.arange(1, B * tg3 - 1), n - 2, replace=False)
    ids = np.sort(np.concatenate([[0, B * tg3 - 1], inner]))
    return np.concatenate([ids, np.full(3, B * tg3)]).astype(np.int32)


def _k7_inputs(B, D, C, tile, seed, dtype, device):
    rng = np.random.default_rng(seed)
    tg3 = (D // tile) ** 3
    ids = _global_ids(B, tg3, max(2, min(B * tg3 // 2, 40)), rng)
    x = torch.tensor(rng.normal(size=(B, D, D, D, C)), dtype=dtype, device=device)
    return x, torch.tensor(ids, device=device)


def _k2g_inputs(B, G, C, t, seed, dtype, device):
    rng = np.random.default_rng(seed)
    tg3 = (G // t) ** 3
    ids = _global_ids(B, tg3, max(2, min(B * tg3 // 2, 40)), rng)
    tiles = torch.tensor(rng.normal(size=(len(ids), t, t, t, C)), dtype=dtype, device=device)
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
    args = _k3_inputs((2, 4, 4, 4, 8), 0, torch.float32, "cpu")
    assert torch.equal(bn_relu_pool_bwd(*args), bn_relu_pool_bwd_plain(*args))
    zi, zj, lse, scale = _nt_inputs(40, 64, 0, "cpu")
    assert torch.equal(nt_xent_fwd(zi, zj, INV_TAU), nt_xent_fwd_plain(zi, zj, INV_TAU))
    assert torch.equal(nt_xent_fwd_pair(zi, zj, INV_TAU),
                       nt_xent_fwd_pair_plain(zi, zj, INV_TAU))
    assert torch.equal(nt_xent_bwd_rows(zi, zj, lse, scale, INV_TAU),
                       nt_xent_bwd_rows_plain(zi, zj, lse, scale, INV_TAU))
    assert torch.equal(nt_xent_bwd_cols(zj, zi, lse, scale, INV_TAU),
                       nt_xent_bwd_cols_plain(zj, zi, lse, scale, INV_TAU))
    scales = torch.cat([scale, -scale])
    assert torch.equal(nt_xent_bwd(zi, zj, lse, lse, scales, INV_TAU),
                       nt_xent_bwd_plain(zi, zj, lse, lse, scales, INV_TAU))
    x, gids = _k7_inputs(2, 16, 4, 8, 0, torch.float32, "cpu")
    assert torch.equal(gather_tiles(x, gids, 8, 1), gather_tiles_plain(x, gids, 8, 1))
    tiles, gids = _k2g_inputs(2, 16, 4, 2, 0, torch.float32, "cpu")
    assert torch.equal(scatter_tiles_global(tiles, gids, 2, 16),
                       scatter_tiles_global_plain(tiles, gids, 2, 16))
    y, mul, add = _k1_inputs((2, 4, 4, 4, 8), 1, torch.float32, "cpu", False)[:3]
    assert torch.equal(bn_relu_pool_unmasked(y, mul, add), bn_relu_pool_plain(y, mul, add))
    for a, b in zip(bn_relu_pool(y, mul, add, want_idx=True),
                    bn_relu_pool_plain(y, mul, add, want_idx=True)):
        assert torch.equal(a, b)
    y, ga, idx, _, *vectors = _k3_inputs((2, 4, 4, 4, 8), 1, torch.float32, "cpu")
    assert torch.equal(bn_relu_pool_bwd_unmasked(y, ga, idx, *vectors),
                       bn_relu_pool_bwd(y, ga, idx, None, *vectors))
    assert set(ops.launches().values()) == {0} and len(ops.launches()) == 12


def test_unmasked_plain_is_the_all_ones_masked_form():
    """K1's and K3's unmasked plain forms equal the masked ones at an
    all-ones mask bit for bit (a product by 1 changes no value), in f32 and
    bf16; K1's returns no pooled mask."""
    for dtype in (torch.float32, torch.bfloat16):
        y, mul, add, mask, _ = _k1_inputs((2, 4, 6, 4, 8), 2, dtype, "cpu", False)
        ones = torch.ones_like(mask)
        pooled, idx = bn_relu_pool_plain(y, mul, add, want_idx=True)
        ref, pmask, ref_idx = bn_relu_pool_plain(y, mul, add, ones, want_idx=True)
        assert torch.equal(pooled, ref) and torch.equal(idx, ref_idx)
        assert torch.equal(bn_relu_pool_plain(y, mul, add), ref) and bool((pmask == 1).all())
        y, ga, idx, mask, *vectors = _k3_inputs((2, 4, 6, 4, 8), 2, dtype, "cpu")
        assert torch.equal(bn_relu_pool_bwd_plain(y, ga, idx, None, *vectors),
                           bn_relu_pool_bwd_plain(y, ga, idx, torch.ones_like(mask), *vectors))


def test_bwd_plain_routes_to_the_argmax_member():
    """K3's plain version: ga lands on window member idx (r = dd·4 + hh·2 +
    ww), every site gets (b + c·ẑ)·mask."""
    y = torch.zeros(1, 2, 2, 2, 1)
    ga = torch.full((1, 1, 1, 1, 1), 3.0)
    idx = torch.full((1, 1, 1, 1, 1), 5, dtype=torch.uint8)
    mask = torch.ones(1, 2, 2, 2, 1)
    one, zero = torch.ones(1), torch.zeros(1)
    dy = bn_relu_pool_bwd_plain(y, ga, idx, mask, one * 0.5, zero, one, zero)
    expected = torch.full((1, 2, 2, 2, 1), 0.5)
    expected[0, 1, 0, 1, 0] += 3.0
    assert torch.equal(dy, expected)
    mask[0, 0, 0, 0] = 0
    dy = bn_relu_pool_bwd_plain(y, ga, idx, mask, one * 0.5, zero, one, zero)
    assert dy[0, 0, 0, 0, 0] == 0 and dy[0, 1, 0, 1, 0] == 3.5


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


def test_tile_wrappers_reject_bad_shapes():
    x = torch.zeros(1, 8, 8, 8, 4)
    with pytest.raises(ValueError, match="multiple"):
        gather_tiles(x, torch.zeros(2, dtype=torch.int32), 3, 1)
    with pytest.raises(ValueError, match="halo"):
        gather_tiles(x, torch.zeros(2, dtype=torch.int32), 4, 3)
    with pytest.raises(ValueError, match=r"\(T,\)"):
        gather_tiles(x, torch.zeros(2, 1, dtype=torch.int32), 4, 1)
    tiles = torch.zeros(3, 2, 2, 2, 4)
    with pytest.raises(ValueError, match="ids must be"):
        scatter_tiles_global(tiles, torch.zeros(4, dtype=torch.int32), 1, 8)
    with pytest.raises(ValueError, match="multiple"):
        scatter_tiles_global(tiles, torch.zeros(3, dtype=torch.int32), 1, 7)


def test_wrappers_reject_other_devices():
    y = torch.zeros(1, 2, 2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn_relu_pool(y, torch.ones(4, device="meta"), torch.zeros(4, device="meta"),
                     torch.ones(1, 2, 2, 2, 1, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        scatter_tiles_ps(torch.zeros(1, 1, 2, 2, 2, 4, device="meta"),
                         torch.zeros(1, 1, dtype=torch.int32, device="meta"), 8)
    args = _k3_inputs((1, 2, 2, 2, 4), 0, torch.float32, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn_relu_pool_bwd(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn_relu_pool_unmasked(y, torch.ones(4, device="meta"), torch.zeros(4, device="meta"))
    y3, ga, idx, _, *vectors = (t.to("meta") for t in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn_relu_pool_bwd_unmasked(y3, ga, idx, *vectors)
    with pytest.raises(ValueError, match="stats_mask needs a zero_mask"):
        bn_relu_pool(y, torch.ones(4, device="meta"), torch.zeros(4, device="meta"),
                     stats_mask=torch.ones(1, 2, 2, 2, 1, device="meta"))
    x, ids = (t.to("meta") for t in _k7_inputs(1, 8, 4, 4, 0, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather_tiles(x, ids, 4, 1)
    tiles, ids = (t.to("meta") for t in _k2g_inputs(1, 8, 4, 2, 0, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        scatter_tiles_global(tiles, ids, 1, 8)
    zi, zj, lse, scale = (t.to("meta") for t in _nt_inputs(8, 64, 0, "cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        nt_xent_fwd(zi, zj, INV_TAU)
    with pytest.raises(ValueError, match="cuda or cpu"):
        nt_xent_fwd_pair(zi, zj, INV_TAU)
    with pytest.raises(ValueError, match="cuda or cpu"):
        nt_xent_bwd_rows(zi, zj, lse, scale, INV_TAU)
    with pytest.raises(ValueError, match="cuda or cpu"):
        nt_xent_bwd_cols(zj, zi, lse, scale, INV_TAU)
    with pytest.raises(ValueError, match="cuda or cpu"):
        nt_xent_bwd(zi, zj, lse, lse, torch.cat([scale, scale]), INV_TAU)


def _shifted(t, elems):
    """A contiguous copy of ``t`` that starts ``elems`` elements past an
    aligned address."""
    flat = torch.zeros(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize(
    "t,C,dtype,shift,want",
    [(2, 64, "bfloat16", 0, 16), (4, 32, "bfloat16", 0, 16), (1, 128, "float32", 0, 16),
     (4, 1, "bfloat16", 0, 8), (2, 1, "bfloat16", 0, 4), (2, 1, "float32", 0, 8),
     (1, 1, "bfloat16", 0, 2), (1, 3, "float32", 0, 4), (2, 3, "bfloat16", 0, 4),
     (2, 64, "bfloat16", 1, 2), (2, 64, "bfloat16", 4, 8), (2, 64, "float32", 1, 4),
     (2, 64, "float32", 2, 8)],
)
def test_scatter_launch_plan_vector_width(t, C, dtype, shift, want):
    """K2's copy width: the widest of 16/8/4/2 bytes dividing the tile's
    x-run (t·C·elem) and the tiles' address."""
    from tricolo_tpu_torch.ops.tile_scatter import launch_plan

    tiles = _shifted(torch.zeros(3, t, t, t, C, dtype=getattr(torch, dtype)), shift)
    assert launch_plan(2, 3, t, 4 * t, C, tiles.element_size(), tiles) == want


@pytest.mark.parametrize(
    "C,dtype,shift,want",
    [(32, "bfloat16", 0, 8), (64, "bfloat16", 0, 8), (512, "float32", 0, 4),
     (8, "float32", 0, 4), (3, "bfloat16", 0, 1), (3, "float32", 0, 1), (4, "bfloat16", 0, 4),
     (2, "float32", 0, 2), (6, "bfloat16", 0, 2), (32, "bfloat16", 1, 1),
     (32, "bfloat16", 2, 2), (32, "float32", 2, 2)],
)
def test_pool_launch_plan_channels_a_thread(C, dtype, shift, want):
    """K1's channels a thread: 8 bf16 or 4 f32 (16 bytes) where C and the
    addresses of y, mul and add allow, narrower down to one channel."""
    from tricolo_tpu_torch.ops.bn_relu_pool import launch_plan

    y = _shifted(torch.zeros(1, 2, 2, 2, C, dtype=getattr(torch, dtype)), shift)
    mul = torch.ones(C, dtype=y.dtype)
    assert launch_plan(y.shape, y.element_size(), y, mul, mul) == want


@pytest.mark.parametrize(
    "plan,over,under",
    [("pool", ((2**28, 2, 2, 2, 32), 2), ((2**27, 2, 2, 2, 32), 2)),  # 2^31 sites
     # 2^27 sites: 2^31 threads of 4 f32 channels
     ("pool", ((2**21, 4, 4, 4, 512), 4), ((2**20, 4, 4, 4, 512), 4)),
     # per-sample or global: 2^22·8³ tiles
     ("scatter", (2**22, 1, 4, 32, 32, 2), (2**21, 1, 4, 32, 32, 2)),
     ("scatter", (128, 2**31, 2, 16, 64, 2), (128, 2**31 - 1, 2, 16, 64, 2)),  # rows
     # a 4-plane slab of a 2048² × 128 f32 grid holds 2^33 bytes
     ("scatter", (1, 1, 4, 2048, 128, 4), (1, 1, 4, 512, 128, 4))],
)
def test_launch_plans_refuse_32bit_overflow(plan, over, under):
    """Each kernel's 32-bit index math has a guard in its wrapper's launch
    plan; just below it the plan passes."""
    from tricolo_tpu_torch.ops.bn_relu_pool import launch_plan as pool_plan
    from tricolo_tpu_torch.ops.tile_scatter import launch_plan as scatter_plan

    fn = pool_plan if plan == "pool" else scatter_plan
    with pytest.raises(ValueError, match="2\\^31"):
        fn(*over)
    assert fn(*under) >= 1


@pytest.mark.parametrize(
    "C,dtype,shift,idx_shift,vec_shift,want",
    [(32, "bfloat16", 0, 0, 0, 8), (64, "bfloat16", 0, 0, 0, 8), (512, "bfloat16", 0, 0, 0, 8),
     (512, "float32", 0, 0, 0, 4), (12, "bfloat16", 0, 0, 0, 4), (12, "float32", 0, 0, 0, 4),
     (8, "float32", 0, 0, 0, 4), (4, "bfloat16", 0, 0, 0, 4), (6, "bfloat16", 0, 0, 0, 2),
     (3, "float32", 0, 0, 0, 1), (32, "bfloat16", 1, 0, 0, 1), (32, "bfloat16", 2, 0, 0, 2),
     (32, "bfloat16", 4, 0, 0, 4), (32, "float32", 2, 0, 0, 2), (32, "bfloat16", 0, 2, 0, 2),
     (32, "bfloat16", 0, 4, 0, 4), (32, "bfloat16", 0, 0, 1, 1), (32, "bfloat16", 0, 0, 2, 2)],
)
def test_pool_bwd_launch_plan_channels_a_thread(C, dtype, shift, idx_shift, vec_shift, want):
    """K3's channels a thread: 8 bf16 or 4 f32 (16 bytes) where C and the
    addresses of y, ga and dy (VE elements), idx (VE bytes) and the f32
    vectors (up to 16 bytes) allow, narrower down to one channel."""
    from tricolo_tpu_torch.ops.bn_relu_pool import bwd_launch_plan

    dt = getattr(torch, dtype)
    y = _shifted(torch.zeros(1, 2, 2, 2, C, dtype=dt), shift)
    ga = torch.zeros(1, 1, 1, 1, C, dtype=dt)
    idx = _shifted(torch.zeros(1, 1, 1, 1, C, dtype=torch.uint8), idx_shift)
    vectors = [torch.zeros(C), _shifted(torch.zeros(C), vec_shift)]
    vec, wide = bwd_launch_plan(y.shape, y.element_size(), (y, ga, torch.empty_like(y)), idx,
                                vectors)
    assert (vec, wide) == (want, False)
    assert C % vec == 0


@pytest.mark.parametrize(
    "shape,elem,want",
    [((2**28 - 1, 2, 2, 2, 32), 2, (8, False)),  # just below 2^31 sites
     ((2**28, 2, 2, 2, 32), 2, (8, True)),  # 2^31 sites: 64-bit offsets
     ((2**21, 4, 4, 4, 512), 4, (4, True)),  # 2^31 threads of 4 f32 channels
     ((2**21 - 1, 4, 4, 4, 512), 4, (4, False)),
     ((1, 2**31, 2, 2, 8), 2, None), ((1, 2, 2, 2, 2**31), 2, None)],  # an extent past int
)
def test_pool_bwd_launch_plan_index_width(shape, elem, want):
    """K3 switches to 64-bit index math where the sites or the threads (a
    pooled cell and channel vector each) reach 2^31, and refuses extents
    that do not fit the kernel's int."""
    from tricolo_tpu_torch.ops.bn_relu_pool import bwd_launch_plan

    if want is None:
        with pytest.raises(ValueError, match="2\\^31"):
            bwd_launch_plan(shape, elem)
        return
    assert bwd_launch_plan(shape, elem) == want


@pytest.mark.parametrize(
    "tile,halo,C,dtype,shift,want",
    [(8, 1, 4, "bfloat16", 0, (8, 1, True)),  # x1: ten 8-byte copies a row
     (8, 0, 1, "bfloat16", 0, (16, 16, True)),  # mask1: one 16-byte copy a row
     (4, 1, 32, "bfloat16", 0, (16, 1, True)),  # x2
     (4, 0, 1, "bfloat16", 0, (8, 64, True)),  # mask2: 64 tiles of 16 vectors a block
     (8, 1, 4, "float32", 0, (16, 1, True)), (4, 0, 1, "float32", 0, (16, 64, True)),
     (8, 0, 1, "float32", 0, (16, 8, True)), (8, 2, 4, "bfloat16", 0, (16, 1, False)),
     (2, 1, 32, "bfloat16", 0, (16, 4, False)), (2, 0, 4, "bfloat16", 0, (16, 256, False)),
     (4, 1, 3, "bfloat16", 0, (2, 1, True)), (4, 1, 3, "float32", 0, (4, 1, True)),
     (6, 3, 5, "float32", 0, (4, 1, False)), (8, 0, 1, "bfloat16", 1, (2, 2, True)),
     (8, 0, 1, "bfloat16", 4, (8, 8, True)), (4, 1, 32, "bfloat16", 2, (4, 1, True))],
)
def test_gather_launch_plan(tile, halo, C, dtype, shift, want):
    """K7's plan: the widest copy dividing gcd(tile, halo)·C·elem bytes and
    the grid's address, tiles a block for about four vectors a thread, and the
    template form for the dense plan's four (tile, halo); any other runs
    the generic form."""
    from tricolo_tpu_torch.ops.tile_gather import launch_plan

    x = _shifted(torch.zeros(1, 2 * tile, 2 * tile, 2 * tile, C, dtype=getattr(torch, dtype)),
                 shift)
    plan = launch_plan(1, 2 * tile, C, tile, halo, x.element_size(), x)
    assert tuple(plan) == want
    s = tile + 2 * halo
    units = s**3 * C * x.element_size() // plan.vec_bytes
    assert plan.tiles_per_block * units <= max(1024, units)


@pytest.mark.parametrize(
    "over,under",
    [((2**22, 32, 1, 4, 0, 2), (2**22 - 1, 32, 1, 4, 0, 2)),  # 2^31 tiles in the grid
     ((1, 1024, 2**11, 64, 0, 4), (1, 1024, 2**10, 64, 0, 4))],  # 2^31 bytes a tile
)
def test_gather_launch_plan_refuses_32bit_overflow(over, under):
    """K7's tile ids and its per-block vector index are 32-bit: its plan
    refuses grids of 2^31 tiles and tiles of 2^31 bytes."""
    from tricolo_tpu_torch.ops.tile_gather import launch_plan

    with pytest.raises(ValueError, match="2\\^31"):
        launch_plan(*over)
    assert launch_plan(*under).vec_bytes in (8, 16)


@pytest.mark.parametrize(
    "B,D,want",
    [(128, 512, (128, 1)), (2000, 512, (128, 1)), (2500, 512, (128, 4)),
     (8192, 512, (128, 4)), (8192, 128, (128, 1)), (8192, 64, (64, 1)),
     (100, 192, (64, 1)), (8192, 192, (64, 4)), (4 * 2**20 + 1, 64, None)],
)
def test_nt_xent_bwd_launch_plan(B, D, want):
    """The backward's D slice (128 where it divides D, else 64) and row
    tile (64 rows once the blocks fill 132 SMs, else 16): B = 128, D = 512
    spreads over 32 blocks; past 65535 row tiles the plan raises."""
    from tricolo_tpu_torch.ops.nt_xent import bwd_launch_plan

    if want is None:
        with pytest.raises(ValueError, match="65535"):
            bwd_launch_plan(B, D)
        return
    ds, wm = bwd_launch_plan(B, D)
    assert (ds, wm) == want
    blocks = (D // ds) * -(-B // (16 * wm))
    assert blocks >= 32 or B < 128
    if wm == 4:
        assert -(-B // 64) * (D // ds) >= 132


@pytest.mark.parametrize(
    "B,want",
    [(1, (16, 32, 1, 1)), (17, (16, 32, 1, 2)), (128, (16, 32, 4, 8)), (512, (16, 32, 16, 32)),
     (1000, (64, 64, 16, 16)), (1500, (128, 128, 12, 12)), (8192, (128, 128, 64, 64)),
     (128 * 65535, (128, 128, 65535, 65535)), (128 * 65535 + 1, None)],
)
@pytest.mark.parametrize("pair", [True, False])
def test_nt_xent_fwd_launch_plan(B, pair, want):
    """The forward's logits tile: 128 × 128 once its grid fills the 132 SMs,
    else 64 × 64 if that fills them, else 16 × 32 (B = 128: 32 blocks). The
    scratch holds a (max, sum) per row for each column tile and, for the
    pair, per column for each row tile: 8 MB at B = 8192. Past 65535 row
    tiles (the grid's y limit) the plan raises."""
    from tricolo_tpu_torch.ops.nt_xent import fwd_launch_plan

    if want is None:
        with pytest.raises(ValueError, match="65535"):
            fwd_launch_plan(B, pair)
        return
    plan = fwd_launch_plan(B, pair)
    assert (plan.bm, plan.bn, plan.col_tiles, plan.row_tiles) == want
    assert plan.col_tiles * plan.bn >= B > (plan.col_tiles - 1) * plan.bn
    assert plan.row_tiles * plan.bm >= B > (plan.row_tiles - 1) * plan.bm
    assert plan.scratch == 2 * B * (plan.col_tiles + (plan.row_tiles if pair else 0))
    blocks = plan.col_tiles * plan.row_tiles
    assert blocks >= 32 or B < 128
    if plan.bm > 16:
        assert blocks >= 132
    if B == 8192 and pair:
        assert plan.scratch * 4 == 8 * 2**20


# ---------------------------------------------------------------- card



def _launches(kernel) -> int:
    """The kernel's launches so far (``ops.launches``)."""
    from tricolo_tpu_torch import ops

    return ops.launches()[kernel.__name__]

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,two", [((64, 12, 12, 12, 32), True), ((64, 4, 4, 4, 64), False),
                  ((8, 16, 16, 16, 128), False), ((8, 4, 4, 4, 512), False),
                  ((64, 8, 8, 8, 32), False)]
)
def test_cuda_bn_relu_pool_matches_plain(dtype, shape, two):
    _need_cuda()
    args = _k1_inputs(shape, 4, getattr(torch, dtype), "cuda", two)
    for want_idx in (False, True):
        before = _launches(bn_relu_pool)
        got = bn_relu_pool(*args, want_idx=want_idx)
        torch.cuda.synchronize()
        assert _launches(bn_relu_pool) == before + 1
        for a, b in zip(got, bn_relu_pool_plain(*args, want_idx=want_idx)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("C", [3, 8, 32, 64, 512])
def test_cuda_bn_relu_pool_every_channel_plan(C, two, dtype):
    """K1 at channel counts that take 16-byte, narrower and one-channel
    plans, one and two masks, idx off and on; quantized inputs hold ties,
    the masks all-zero windows."""
    _need_cuda()
    args = _k1_inputs((3, 4, 6, 4, C), C, getattr(torch, dtype), "cuda", two)
    for want_idx in (False, True):
        got = bn_relu_pool(*args, want_idx=want_idx)
        torch.cuda.synchronize()
        for a, b in zip(got, bn_relu_pool_plain(*args, want_idx=want_idx)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [1, 2])
def test_cuda_bn_relu_pool_unaligned_view(dtype, shift):
    """Activations and mul starting 1 or 2 elements past an aligned
    address take a narrower plan and stay exact."""
    _need_cuda()
    y, mul, add, zmask, smask = _k1_inputs((2, 4, 4, 4, 32), 6, getattr(torch, dtype), "cuda",
                                           True)
    view, mul_view = _shifted(y, shift), _shifted(mul, shift)
    assert view.data_ptr() % 16
    for want_idx in (False, True):
        got = bn_relu_pool(view, mul_view, add, zmask, smask, want_idx=want_idx)
        for a, b in zip(got, bn_relu_pool_plain(y, mul, add, zmask, smask, want_idx=want_idx)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 8, 32, 64, 512])
def test_cuda_bn_relu_pool_unmasked_matches_plain(dtype, C):
    """K1's unmasked entry, idx off and on, against its plain version at
    channel counts that take every plan; its own counter steps, the masked
    one does not."""
    _need_cuda()
    y, mul, add = _k1_inputs((3, 4, 6, 4, C), C + 1, getattr(torch, dtype), "cuda", False)[:3]
    for want_idx in (False, True):
        before, masked = _launches(bn_relu_pool_unmasked), _launches(bn_relu_pool)
        got = bn_relu_pool(y, mul, add, want_idx=want_idx)
        torch.cuda.synchronize()
        assert _launches(bn_relu_pool_unmasked) == before + 1
        assert _launches(bn_relu_pool) == masked
        ref = bn_relu_pool_plain(y, mul, add, want_idx=want_idx)
        for a, b in zip(got if want_idx else [got], ref if want_idx else [ref]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64, 32), (8, 16, 16, 16, 128), (3, 4, 2, 6, 6)])
def test_cuda_bn_relu_pool_bwd_unmasked_matches_plain(dtype, shape):
    _need_cuda()
    y, ga, idx, _, *vectors = _k3_inputs(shape, 7, getattr(torch, dtype), "cuda")
    before = _launches(bn_relu_pool_bwd_unmasked)
    got = bn_relu_pool_bwd(y, ga, idx, None, *vectors)
    torch.cuda.synchronize()
    assert _launches(bn_relu_pool_bwd_unmasked) == before + 1
    assert torch.equal(got, bn_relu_pool_bwd_plain(y, ga, idx, None, *vectors))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 1])
def test_cuda_scatter_tiles_matches_plain(dtype, C):
    _need_cuda()
    tiles, ids = _k2_inputs(16, 40, C, 16, C, getattr(torch, dtype), "cuda")
    before = _launches(scatter_tiles_ps)
    got = scatter_tiles_ps(tiles, ids, 16)
    torch.cuda.synchronize()
    assert _launches(scatter_tiles_ps) == before + 1
    assert torch.equal(got, scatter_tiles_ps_plain(tiles, ids, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(64, 12, 12, 12, 32), (64, 4, 4, 4, 64), (8, 16, 16, 16, 128),
              (8, 4, 4, 4, 512), (3, 4, 2, 6, 6)]
)
def test_cuda_bn_relu_pool_bwd_matches_plain(dtype, shape):
    _need_cuda()
    args = _k3_inputs(shape, 5, getattr(torch, dtype), "cuda")
    before = _launches(bn_relu_pool_bwd)
    got = bn_relu_pool_bwd(*args)
    torch.cuda.synchronize()
    assert _launches(bn_relu_pool_bwd) == before + 1
    assert torch.equal(got, bn_relu_pool_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("C", [4, 8, 12, 32, 512, 3])
@pytest.mark.parametrize("spatial", [(4, 6, 4), (2, 6, 10), (6, 2, 14)])
def test_cuda_bn_relu_pool_bwd_every_channel_plan(C, masked, dtype, spatial):
    """K3 at each channels-a-thread plan (8/4/2/1 bf16, 4/2/1 f32), masked
    and unmasked, with odd pooled extents (3 and 5, 1 and 7)."""
    _need_cuda()
    y, ga, idx, mask, *vectors = _k3_inputs((3, *spatial, C), C + 11, getattr(torch, dtype),
                                            "cuda")
    mask = mask if masked else None
    got = bn_relu_pool_bwd(y, ga, idx, mask, *vectors)
    torch.cuda.synchronize()
    assert torch.equal(got, bn_relu_pool_bwd_plain(y, ga, idx, mask, *vectors))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which,shift", [("values", 1), ("values", 2), ("values", 4),
                                         ("idx", 1), ("idx", 2), ("vectors", 1),
                                         ("vectors", 2)])
def test_cuda_bn_relu_pool_bwd_unaligned_view(dtype, which, shift):
    """Views that start past an aligned address take a narrower plan and
    stay exact: y and ga, idx, or one f32 vector shifted by ``shift``
    elements."""
    from tricolo_tpu_torch.ops.bn_relu_pool import bwd_launch_plan

    _need_cuda()
    y, ga, idx, mask, b, c, inv, sub = _k3_inputs((2, 4, 6, 4, 32), 13, getattr(torch, dtype),
                                                  "cuda")
    if which == "values":
        y, ga = _shifted(y, shift), _shifted(ga, shift)
    elif which == "idx":
        idx = _shifted(idx, shift)
    else:
        sub = _shifted(sub, shift)
    vec, _ = bwd_launch_plan(y.shape, y.element_size(), (y, ga), idx, (b, c, inv, sub))
    shifted_bytes = shift * {"values": y.element_size(), "idx": 1, "vectors": 4}[which]
    assert (vec < 16 // y.element_size()) == (shifted_bytes % 16 != 0)
    for m in (mask, None):
        got = bn_relu_pool_bwd(y, ga, idx, m, b, c, inv, sub)
        torch.cuda.synchronize()
        assert torch.equal(got, bn_relu_pool_bwd_plain(y, ga, idx, m, b, c, inv, sub))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_cuda_bn_relu_pool_bwd_wide_index_path(dtype, masked):
    """K3's 64-bit index form (grid-stride loop, 64-bit divisions), asked
    for through the C entry at a small shape, equals the plain version."""
    from tricolo_tpu_torch.ops.bn_relu_pool import _DTYPES, _lib_bwd, bwd_launch_plan

    _need_cuda()
    y, ga, idx, mask, *vectors = _k3_inputs((3, 6, 4, 10, 32), 17, getattr(torch, dtype),
                                            "cuda")
    mask = mask if masked else None
    dy = torch.empty_like(y)
    vec, wide = bwd_launch_plan(y.shape, y.element_size(), (y, ga, dy), idx, vectors)
    assert not wide
    fn = getattr(_lib_bwd(), f"bn_relu_pool_bwd_{_DTYPES[y.dtype]}")
    status = fn(y.data_ptr(), ga.data_ptr(), idx.data_ptr(),
                None if mask is None else mask.data_ptr(), *(v.data_ptr() for v in vectors),
                dy.data_ptr(), 3, 3, 2, 5, 32, vec, 1, torch.cuda.current_stream().cuda_stream)
    assert status == 0
    torch.cuda.synchronize()
    assert torch.equal(dy, bn_relu_pool_bwd_plain(y, ga, idx, mask, *vectors))


@pytest.mark.cuda
@pytest.mark.parametrize("B,D", [(128, 512), (100, 128), (8192, 512)])
def test_cuda_nt_xent_matches_plain(B, D):
    _need_cuda()
    zi, zj, lse, scale = _nt_inputs(B, D, B, "cuda")
    pairs = [
        (nt_xent_fwd, nt_xent_fwd_plain, (zi, zj, INV_TAU)),
        (nt_xent_fwd_pair, nt_xent_fwd_pair_plain, (zi, zj, INV_TAU)),
        (nt_xent_bwd_rows, nt_xent_bwd_rows_plain, (zi, zj, lse, scale, INV_TAU)),
        (nt_xent_bwd_cols, nt_xent_bwd_cols_plain, (zj, zi, lse, scale, INV_TAU)),
    ]
    for kernel, plain, args in pairs:
        before = _launches(kernel)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        ref = plain(*args)
        err = (got - ref).abs().max().item()
        assert err <= NT_XENT_TOL * ref.abs().max().item(), (kernel.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 192, 512])
@pytest.mark.parametrize("B", [1, 17, 129, 1000, 2500])
def test_cuda_nt_xent_fwd_pair_matches_plain(B, D):
    """The pair forward and K4 alone against their plain versions at every
    logits tile (16 × 32, 64 × 64, 128 × 128) and ragged B. Two launches
    give bit-identical outputs (fixed-order merges, no atomics), K4 alone
    is bit for bit the pair's first two columns (the same kernel without
    the column statistics), and each launch steps its own counter by one."""
    _need_cuda()
    zi, zj, _, _ = _nt_inputs(B, D, B + D, "cuda")
    outs = {}
    for kernel, plain in ((nt_xent_fwd_pair, nt_xent_fwd_pair_plain),
                          (nt_xent_fwd, nt_xent_fwd_plain)):
        before = _launches(kernel)
        got, again = kernel(zi, zj, INV_TAU), kernel(zi, zj, INV_TAU)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 2
        assert torch.equal(got, again), kernel.__name__
        ref = plain(zi, zj, INV_TAU)
        err = (got - ref).abs().max().item()
        assert err <= NT_XENT_TOL * ref.abs().max().item(), (kernel.__name__, err)
        outs[kernel.__name__] = got
    assert torch.equal(outs["nt_xent_fwd"], outs["nt_xent_fwd_pair"][:, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 512])
@pytest.mark.parametrize("B", [1, 20, 100, 128, 2500, 8192])
def test_cuda_nt_xent_bwd_matches_plain(B, D):
    """The two-term backward against its plain version at every launch
    plan (16- and 64-row tiles, clusters of 1-4 blocks on 64- or 128-wide D
    slices, ragged B): both terms, each alone (a zero scale), negative
    scales, the operands swapped (d_zjs); then K5 and K6 on the same
    inputs. Each launch steps its own counter by one."""
    _need_cuda()
    zi, zj, lse_a, lse_b = _nt_bwd_inputs(B, D, B + D, "cuda")
    s = INV_TAU / B

    def scales(*values):
        return torch.tensor(values, dtype=torch.float32, device="cuda")

    cases = [(nt_xent_bwd, nt_xent_bwd_plain, (zi, zj, lse_a, lse_b, sc, INV_TAU))
             for sc in (scales(0.25 * s, 0.75 * s), scales(0.25 * s, 0.0),
                        scales(0.0, 0.75 * s), scales(-0.7 * s, -0.3 * s))]
    cases += [
        (nt_xent_bwd, nt_xent_bwd_plain, (zj, zi, lse_b, lse_a, scales(0.75 * s, 0.25 * s),
                                          INV_TAU)),
        (nt_xent_bwd_rows, nt_xent_bwd_rows_plain, (zi, zj, lse_a, scales(0.25 * s), INV_TAU)),
        (nt_xent_bwd_cols, nt_xent_bwd_cols_plain, (zj, zi, lse_a, scales(-0.5 * s), INV_TAU)),
    ]
    for kernel, plain, args in cases:
        before = _launches(kernel)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        ref = plain(*args)
        err = (got - ref).abs().max().item()
        assert err <= NT_XENT_TOL * ref.abs().max().item(), (kernel.__name__, args[-2], err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,D,C,tile,halo",
    [(3, 32, 4, 8, 1), (3, 32, 1, 8, 0), (3, 16, 32, 4, 1), (3, 16, 1, 4, 0),
     (2, 8, 32, 2, 1), (2, 8, 4, 2, 0), (2, 16, 3, 4, 1), (2, 16, 4, 8, 2)],
)
def test_cuda_gather_tiles_matches_plain(dtype, B, D, C, tile, halo):
    """K7 at every halo/tile/channel case, on windows at the grid's edges
    and on padding ids; C = 3 runs 2-byte or 4-byte copies."""
    _need_cuda()
    x, ids = _k7_inputs(B, D, C, tile, B * D + C, getattr(torch, dtype), "cuda")
    before = _launches(gather_tiles)
    got = gather_tiles(x, ids, tile, halo)
    torch.cuda.synchronize()
    assert _launches(gather_tiles) == before + 1
    ref = gather_tiles_plain(x, ids, tile, halo)
    assert torch.equal(got, ref)
    assert (ref[-3:] == 0).all() and (ref[:-3] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gather_tiles_unaligned_view(dtype):
    """A grid view that starts 2 bytes past an aligned address takes the
    narrowest copy and stays exact."""
    _need_cuda()
    x, ids = _k7_inputs(2, 16, 32, 4, 9, getattr(torch, dtype), "cuda")
    flat = torch.cat([torch.zeros(1, dtype=x.dtype, device="cuda"), x.reshape(-1)])
    view = flat[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    assert torch.equal(gather_tiles(view, ids, 4, 1), gather_tiles_plain(x, ids, 4, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 4, 32])
@pytest.mark.parametrize("tile,halo,generic", [(8, 1, False), (8, 0, False), (4, 1, False),
                                               (4, 0, False), (8, 1, True), (4, 0, True),
                                               (2, 3, False), (6, 2, False)])
def test_cuda_gather_tiles_every_form(dtype, C, tile, halo, generic):
    """K7 at its four template forms, the same shapes through the generic
    instantiation, and two generic (tile, halo) (halo past the tile; a tile
    edge of 6), on windows at the grid's edges and invalid ids: negative,
    one past the grid, and INT32_MAX, which must give zero tiles."""
    from tricolo_tpu_torch.ops.tile_gather import _lib, launch_plan

    _need_cuda()
    D = 4 * tile
    x, ids = _k7_inputs(2, D, C, tile, D + C, getattr(torch, dtype), "cuda")
    n = 2 * 4**3
    ids = torch.cat([ids, torch.tensor([-1, n, -(2**31), 2**31 - 1], dtype=torch.int32,
                                       device="cuda")])
    ref = gather_tiles_plain(x, ids, tile, halo)
    assert (ref[-7:] == 0).all()
    if not generic:
        got = gather_tiles(x, ids, tile, halo)
    else:
        s = tile + 2 * halo
        got = torch.empty((ids.shape[0], s, s, s, C), dtype=x.dtype, device="cuda")
        plan = launch_plan(2, D, C, tile, halo, x.element_size(), x, got)
        assert plan.fixed
        status = _lib().tile_gather(
            x.data_ptr(), ids.data_ptr(), got.data_ptr(), ids.shape[0], 2, D, C, tile, halo,
            x.element_size(), plan.vec_bytes, plan.tiles_per_block, 0,
            torch.cuda.current_stream().cuda_stream)
        assert status == 0
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,G,C,t", [(3, 32, 32, 4), (3, 32, 1, 4), (3, 16, 64, 2),
                                     (3, 16, 1, 2), (2, 8, 128, 1)])
def test_cuda_scatter_tiles_global_matches_plain(dtype, B, G, C, t):
    _need_cuda()
    tiles, ids = _k2g_inputs(B, G, C, t, G + C, getattr(torch, dtype), "cuda")
    before = _launches(scatter_tiles_global)
    got = scatter_tiles_global(tiles, ids, B, G)
    torch.cuda.synchronize()
    assert _launches(scatter_tiles_global) == before + 1
    assert torch.equal(got, scatter_tiles_global_plain(tiles, ids, B, G))


def _scatter_case(entry, C, t, seed, dtype):
    """(kernel, plain, inputs) of one K2 entry on a 4t-edge grid of 3
    samples: 10 rows a sample (per-sample) or 40 global ids + 3 padding."""
    if entry == "per_sample":
        tiles, ids = _k2_inputs(3, 10, C, 4 * t, seed, dtype, "cuda", t)
        return scatter_tiles_ps, scatter_tiles_ps_plain, (tiles, ids, 4 * t)
    tiles, ids = _k2g_inputs(3, 4 * t, C, t, seed, dtype, "cuda")
    return scatter_tiles_global, scatter_tiles_global_plain, (tiles, ids, 3, 4 * t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 3, 32, 64, 128])
@pytest.mark.parametrize("entry", ["per_sample", "global"])
def test_cuda_scatter_tiles_every_vector_plan(entry, C, t, dtype):
    """Both K2 entries at every channel count and tile edge the voxel plans
    hand over (t = 1 is the third sparse block's): x-runs of 2 to 1024
    bytes, copies of 2 to 16 bytes."""
    _need_cuda()
    kernel, plain, args = _scatter_case(entry, C, t, 100 * t + C, getattr(torch, dtype))
    before = _launches(kernel)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _launches(kernel) == before + 1
    ref = plain(*args)
    assert torch.equal(got, ref)
    assert (ref == 0).any() and (ref != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["per_sample", "global"])
def test_cuda_scatter_tiles_unaligned_view(entry, dtype):
    """Tiles starting one element past an aligned address take the
    narrowest copy and stay exact."""
    _need_cuda()
    kernel, plain, args = _scatter_case(entry, 64, 2, 3, getattr(torch, dtype))
    view = _shifted(args[0], 1)
    assert view.data_ptr() % 16
    assert torch.equal(kernel(view, *args[1:]), plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_tiles_empty_cases(dtype):
    """All-padding ids (past the grid and negative), no rows (k = 0,
    T = 0) and no samples (B = 0): zero grids of the right shape."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tiles = torch.ones((2, 3, 2, 2, 2, 32), dtype=dt, device="cuda")
    ids = torch.tensor([[64, -1, 70], [-5, 64, 99]], dtype=torch.int32, device="cuda")
    out = scatter_tiles_ps(tiles, ids, 8)
    assert torch.equal(out, scatter_tiles_ps_plain(tiles, ids, 8))
    assert out.shape == (2, 8, 8, 8, 32) and not out.any()
    out = scatter_tiles_ps(tiles[:, :0].contiguous(), ids[:, :0].contiguous(), 8)
    assert out.shape == (2, 8, 8, 8, 32) and not out.any()
    assert scatter_tiles_ps(tiles[:0], ids[:0], 8).shape == (0, 8, 8, 8, 32)
    gtiles = tiles.reshape(6, 2, 2, 2, 32)
    gids = torch.tensor([128, -1, 200, 128, -7, 1000], dtype=torch.int32, device="cuda")
    out = scatter_tiles_global(gtiles, gids, 2, 8)
    assert torch.equal(out, scatter_tiles_global_plain(gtiles, gids, 2, 8))
    assert out.shape == (2, 8, 8, 8, 32) and not out.any()
    out = scatter_tiles_global(gtiles[:0], gids[:0], 2, 8)
    assert out.shape == (2, 8, 8, 8, 32) and not out.any()
    assert scatter_tiles_global(gtiles, gids, 0, 8).shape == (0, 8, 8, 8, 32)
    torch.cuda.synchronize()


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
    y, ga, idx, mask, b, c, inv, sub = _k3_inputs((2, 4, 4, 4, 8), 1, torch.float32, "cuda")
    with pytest.raises(TypeError, match="uint8"):
        bn_relu_pool_bwd(y, ga, idx.long(), mask, b, c, inv, sub)
    x, ids = _k7_inputs(2, 8, 4, 4, 1, torch.float32, "cuda")
    with pytest.raises(TypeError, match="int32"):
        gather_tiles(x, ids.long(), 4, 1)
    with pytest.raises(TypeError, match="2- or 4-byte"):
        gather_tiles(x.double(), ids, 4, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gather_tiles(x.transpose(1, 2), ids, 4, 1)
    tiles, ids = _k2g_inputs(2, 8, 4, 2, 1, torch.float32, "cuda")
    with pytest.raises(TypeError, match="int32"):
        scatter_tiles_global(tiles, ids.long(), 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_tiles_global(tiles.transpose(1, 2), ids, 2, 8)
    zi, zj, lse, scale = _nt_inputs(64, 96, 1, "cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        nt_xent_fwd(zi, zj, INV_TAU)
    with pytest.raises(ValueError, match="multiple of 64"):
        nt_xent_fwd_pair(zi, zj, INV_TAU)
    zi, zj, lse, scale = _nt_inputs(64, 128, 1, "cuda")
    with pytest.raises(TypeError, match="float32"):
        nt_xent_bwd_rows(zi.double(), zj.double(), lse, scale, INV_TAU)
    scales = torch.cat([scale, scale])
    with pytest.raises(TypeError, match="float32"):
        nt_xent_bwd(zi.double(), zj.double(), lse, lse, scales, INV_TAU)
    with pytest.raises(ValueError, match="contiguous"):
        nt_xent_bwd(zi.t().contiguous().t(), zj, lse, lse, scales, INV_TAU)
    with pytest.raises(ValueError, match="aligned"):
        nt_xent_bwd(_shifted(zi, 1), zj, lse, lse, scales, INV_TAU)
    with pytest.raises(TypeError, match="float32"):
        nt_xent_fwd_pair(zi.double(), zj.double(), INV_TAU)
    with pytest.raises(ValueError, match="contiguous"):
        nt_xent_fwd_pair(zi, zj.t().contiguous().t(), INV_TAU)
    with pytest.raises(ValueError, match="aligned"):
        nt_xent_fwd_pair(zi, _shifted(zj, 2), INV_TAU)
    with pytest.raises(ValueError, match="one scale per lse"):
        nt_xent_bwd(zi, zj, lse, lse, scale, INV_TAU)
    for D in (96, 576):
        zi, zj, lse, scale = _nt_inputs(64, D, 1, "cuda")
        with pytest.raises(ValueError, match="multiple of 64"):
            nt_xent_bwd(zi, zj, lse, lse, torch.cat([scale, scale]), INV_TAU)
        with pytest.raises(ValueError, match="multiple of 64"):
            nt_xent_bwd_cols(zj, zi, lse, scale, INV_TAU)

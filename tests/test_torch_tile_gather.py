"""Kernel K7 (halo'd tile gather by global id), K2's global entry and the
device compaction of active tiles: the plain PyTorch versions against the
JAX package's ``tile_sparse.gather_tiles`` / ``scatter_tiles`` /
``active_tile_ids`` and the Pallas ``dma_gather_tiles`` /
``dma_scatter_tiles`` (interpret mode).

The copies are exact: every forward comparison is bit-for-bit, in f32 and
bf16 (both sides round the same f32 data to bf16). The gather's backward
sums up to 8 overlapping halo cells in another order than XLA's
``linear_transpose``: atol 1e-6 in f32. The scatter's backward is a copy:
exact. The CUDA kernels are held against the plain versions in
``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops import (  # noqa: E402
    gather_tiles_autograd,
    gather_tiles_plain,
    scatter_tiles_global_autograd,
    scatter_tiles_global_plain,
)
from tricolo_tpu_torch.ops import tile_sparse as ts  # noqa: E402

DTYPES = {"float32": (torch.float32, "float32"), "bfloat16": (torch.bfloat16, "bfloat16")}


def teardown_module(module):
    # Interpret-mode pallas_call state: clear it as the repo's Pallas test
    # modules do.
    jax.clear_caches()


def _ids(B, tg3, n, seed):
    """n ascending unique global ids holding the grid's first and last tile
    (windows on the edges), then 3 padding ids (B·tg³)."""
    rng = np.random.default_rng(seed)
    inner = rng.choice(np.arange(1, B * tg3 - 1), n - 2, replace=False)
    ids = np.sort(np.concatenate([[0, B * tg3 - 1], inner]))
    return np.concatenate([ids, np.full(3, B * tg3)]).astype(np.int32)


def _pair(a, dtype):
    """The same f32 data as a torch tensor and a jax array of ``dtype``."""
    import jax.numpy as jnp

    torch_dtype, jax_dtype = DTYPES[dtype]
    return torch.from_numpy(a).to(torch_dtype), jnp.asarray(a).astype(jax_dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


GATHER_CASES = [  # (B, D, C, tile, halo)
    (2, 16, 4, 8, 1), (2, 16, 1, 8, 0), (2, 16, 32, 4, 1),
    (2, 8, 1, 4, 0), (2, 8, 32, 2, 1), (2, 8, 4, 2, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,C,tile,halo", GATHER_CASES)
def test_gather_plain_matches_jax_gather_tiles(dtype, B, D, C, tile, halo):
    from tricolo_tpu.ops.tile_sparse import gather_tiles as jax_gather

    x = np.random.default_rng(D + C).normal(size=(B, D, D, D, C)).astype(np.float32)
    ids = _ids(B, (D // tile) ** 3, 6, seed=tile)
    xt, xj = _pair(x, dtype)
    got = gather_tiles_plain(xt, torch.from_numpy(ids), tile, halo)
    ref = jax.jit(jax_gather, static_argnums=(2, 3))(xj, ids, tile, halo)
    assert got.dtype == DTYPES[dtype][0] and got.shape == ref.shape
    np.testing.assert_array_equal(_np(got), _np(ref.astype("float32")))
    assert (_np(got)[-3:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,C,tile,halo", [(2, 16, 4, 8, 1), (2, 8, 32, 2, 1),
                                             (2, 8, 1, 4, 0)])
def test_gather_plain_matches_pallas_dma_gather(dtype, B, D, C, tile, halo):
    from tricolo_tpu.ops._graveyard.dma_tiles import dma_gather_tiles

    x = np.random.default_rng(C).normal(size=(B, D, D, D, C)).astype(np.float32)
    ids = _ids(B, (D // tile) ** 3, 5, seed=C)  # 8 rows: one Pallas group
    xt, xj = _pair(x, dtype)
    ref = dma_gather_tiles(xj, ids, tile, halo, group=8, interpret=True)
    got = gather_tiles_plain(xt, torch.from_numpy(ids), tile, halo)
    np.testing.assert_array_equal(_np(got), _np(ref.astype("float32")))


@pytest.mark.parametrize("B,D,C,tile,halo", [(2, 16, 4, 8, 1), (2, 16, 8, 4, 1),
                                             (2, 8, 4, 2, 1), (2, 8, 4, 4, 0)])
def test_gather_grad_matches_jax_autodiff(B, D, C, tile, halo):
    """The overlap-add backward equals ``jax.grad`` through ``gather_tiles``
    (its unique-row scatter + ``linear_transpose`` VJP)."""
    import jax.numpy as jnp

    from tricolo_tpu.ops.tile_sparse import gather_tiles as jax_gather

    rng = np.random.default_rng(tile + halo)
    x = rng.normal(size=(B, D, D, D, C)).astype(np.float32)
    ids = _ids(B, (D // tile) ** 3, 8, seed=3)
    s = tile + 2 * halo
    g = rng.normal(size=(len(ids), s, s, s, C)).astype(np.float32)
    ref = jax.jit(jax.grad(lambda v: jnp.sum(jax_gather(v, ids, tile, halo) * g)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (gather_tiles_autograd(xt, torch.from_numpy(ids), tile, halo) * torch.from_numpy(g)).sum(
    ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert (xt.grad.numpy() != 0).any()


def _mask(B, D, seed, density):
    rng = np.random.default_rng(seed)
    m = (rng.random((B, D, D, D, 1)) < density).astype(np.float32)
    m[0] = 0.0  # an empty sample
    return m


@pytest.mark.parametrize("tile,budget", [(8, 16), (4, 128), (4, 7), (2, 256)])
def test_active_tile_ids_match_jax(tile, budget):
    """Ascending ids with B·tg³ padding; a small budget keeps the lowest
    ids (``jnp.nonzero(size=…)``'s truncation)."""
    import jax.numpy as jnp

    from tricolo_tpu.ops import tile_sparse as jts

    mask = _mask(3, 16, tile, 0.002)
    ref = np.asarray(jax.jit(jts.active_tile_ids, static_argnums=(1, 2))(
        jnp.asarray(mask), tile, budget))
    got = ts.active_tile_ids(torch.from_numpy(mask), tile, budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    need = int(jts.tile_counts(jnp.asarray(mask[..., 0]), tile).sum())
    assert (need > budget) == bool((got < 3 * (16 // tile) ** 3).all())


@pytest.mark.parametrize("frac,batch,tg3", [(0.5, 128, 512), (0.5, 2, 64), (0.013, 7, 512),
                                            (1.0, 3, 8)])
def test_tile_budget_matches_jax(frac, batch, tg3):
    from tricolo_tpu.ops.tile_sparse import tile_budget

    assert ts.tile_budget(frac, batch, tg3) == tile_budget(frac, batch, tg3)


def test_host_tile_count_matches_jax():
    from tricolo_tpu.data.datasets import SyntheticDataset
    from tricolo_tpu.ops.tile_sparse import host_tile_count
    from test_torch_data import jax_cfg

    ds = SyntheticDataset(jax_cfg(), "val")
    flat = np.full((3, ds.max_voxel_points), 0xFFFFFFFF, np.uint32)
    for i in range(3):
        item = ds[2 * i]
        flat[i, : len(item["voxel_flat"])] = item["voxel_flat"]
    assert ts.host_tile_count(flat, 32) == host_tile_count(flat, 32) > 0


SCATTER_CASES = [(2, 64, 8), (4, 32, 16), (2, 1, 8)]  # (t, C, grid): lines at t·C ≥ 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["transpose", "lines", "hybrid"])
@pytest.mark.parametrize("t,C,grid", SCATTER_CASES)
def test_scatter_global_plain_matches_jax_scatter_tiles(dtype, layout, t, C, grid):
    """Every JAX layout computes the same function as the plain version."""
    from tricolo_tpu.ops.tile_sparse import scatter_tiles as jax_scatter

    B = 3
    ids = _ids(B, (grid // t) ** 3, 7, seed=C)
    tiles = np.random.default_rng(t * C).normal(size=(len(ids), t, t, t, C)).astype(np.float32)
    tt, tj = _pair(tiles, dtype)
    ref = jax.jit(jax_scatter, static_argnums=(2, 3, 4))(tj, ids, B, grid, layout)
    got = scatter_tiles_global_plain(tt, torch.from_numpy(ids), B, grid)
    np.testing.assert_array_equal(_np(got), _np(ref.astype("float32")))
    assert (_np(got) == 0).any() and (_np(got) != 0).any()


@pytest.mark.parametrize("t,C,grid", [(2, 64, 8), (2, 1, 8)])
def test_scatter_global_plain_matches_pallas_dma_scatter(t, C, grid):
    from tricolo_tpu.ops._graveyard.dma_tiles import dma_scatter_tiles

    B = 3
    ids = _ids(B, (grid // t) ** 3, 5, seed=t + C)  # 8 rows: one Pallas group
    tiles = np.random.default_rng(C).normal(size=(len(ids), t, t, t, C)).astype(np.float32)
    ref = dma_scatter_tiles(tiles, ids, B, grid, group=8, interpret=True)
    got = scatter_tiles_global_plain(torch.from_numpy(tiles), torch.from_numpy(ids), B, grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["transpose", "lines"])
@pytest.mark.parametrize("t,C,grid", [(2, 64, 8), (4, 32, 16)])
def test_scatter_global_grad_matches_jax_autodiff(layout, t, C, grid):
    """The autograd Function's backward (the row gather out of dy, zeros for
    padding ids) equals ``jax.grad`` through ``scatter_tiles``."""
    import jax.numpy as jnp

    from tricolo_tpu.ops.tile_sparse import scatter_tiles as jax_scatter

    B = 3
    ids = _ids(B, (grid // t) ** 3, 7, seed=1)
    rng = np.random.default_rng(C)
    tiles = rng.normal(size=(len(ids), t, t, t, C)).astype(np.float32)
    g = rng.normal(size=(B, grid, grid, grid, C)).astype(np.float32)
    ref = jax.jit(jax.grad(lambda v: jnp.sum(jax_scatter(v, ids, B, grid, layout=layout) * g)))(
        jnp.asarray(tiles))
    x = torch.tensor(tiles, requires_grad=True)
    (scatter_tiles_global_autograd(x, torch.from_numpy(ids), B, grid) * torch.from_numpy(g)
     ).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    assert np.all(x.grad.numpy()[-3:] == 0)


def test_gather_scatter_round_trip():
    """Scattering the halo-0 tiles of every active tile rebuilds a grid that
    is zero outside them."""
    B, D, tile = 2, 16, 4
    mask = torch.from_numpy(_mask(B, D, 5, 0.01))
    x = torch.randn(B, D, D, D, 3) * mask
    ids = ts.active_tile_ids(mask, tile, 64)
    back = scatter_tiles_global_plain(gather_tiles_plain(x, ids, tile, 0), ids, B, D)
    assert torch.equal(back, x)

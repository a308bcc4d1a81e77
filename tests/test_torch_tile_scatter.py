"""Kernel K2 (per-sample tile → grid scatter): the plain PyTorch version
against the JAX package's ``scatter_tiles_ps`` (every layout) and the
Pallas ``dma_scatter_tiles`` (interpret mode). A pure copy: every
comparison is exact. The CUDA kernel is held against the plain version in
``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops.tile_scatter import scatter_tiles_ps_plain  # noqa: E402


def teardown_module(module):
    jax.clear_caches()


def _inputs(B, k, t, C, grid, seed, dtype=np.float32):
    """Tiles + ascending per-sample local ids with tg³ padding (one sample
    has no tile at all)."""
    rng = np.random.default_rng(seed)
    tg3 = (grid // t) ** 3
    ids = np.full((B, k), tg3, np.int32)
    for b in range(B - 1):
        n = int(rng.integers(1, k + 1))
        ids[b, :n] = np.sort(rng.choice(tg3, n, replace=False))
    tiles = rng.normal(size=(B, k, t, t, t, C)).astype(dtype)
    return tiles, ids


@pytest.mark.parametrize("layout", ["transpose", "lines", "hybrid"])
@pytest.mark.parametrize("t,C,grid", [(2, 64, 8), (2, 1, 8), (4, 32, 16)])
def test_plain_matches_scatter_tiles_ps(layout, t, C, grid):
    from tricolo_tpu.ops.tile_sparse import scatter_tiles_ps as jax_scatter

    tiles, ids = _inputs(3, 6, t, C, grid, seed=t * C)
    ref = np.asarray(jax_scatter(tiles, ids, grid, layout=layout))
    got = scatter_tiles_ps_plain(torch.from_numpy(tiles), torch.from_numpy(ids), grid)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy() == 0).any() and (got.numpy() != 0).any()


@pytest.mark.parametrize("t,C,grid", [(2, 64, 8), (2, 1, 8)])
def test_plain_matches_pallas_dma_scatter(t, C, grid):
    from tricolo_tpu.ops._graveyard.dma_tiles import dma_scatter_tiles

    B, k = 3, 8
    tiles, ids = _inputs(B, k, t, C, grid, seed=7 + C)
    tg3 = (grid // t) ** 3
    global_ids = np.where(
        ids < tg3, ids + np.arange(B, dtype=np.int32)[:, None] * tg3, B * tg3
    ).reshape(-1)
    ref = np.asarray(
        dma_scatter_tiles(tiles.reshape(B * k, t, t, t, C), global_ids, B, grid,
                          group=8, interpret=True)
    )
    got = scatter_tiles_ps_plain(torch.from_numpy(tiles), torch.from_numpy(ids), grid)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("t,C,grid", [(2, 64, 8), (4, 32, 16)])
def test_scatter_grad_matches_jax_autodiff(t, C, grid):
    """The autograd Function's backward (the tile gather out of dy, zeros
    for padding ids) equals ``jax.grad`` through ``scatter_tiles_ps``."""
    import jax.numpy as jnp

    from tricolo_tpu.ops.tile_sparse import scatter_tiles_ps as jax_scatter
    from tricolo_tpu_torch.ops.tile_scatter import scatter_tiles

    tiles, ids = _inputs(3, 6, t, C, grid, seed=11 + C)
    g = np.random.default_rng(5).normal(size=(3, grid, grid, grid, C)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jax_scatter(x, ids, grid, layout="transpose") * g))(
        jnp.asarray(tiles)
    )
    x = torch.tensor(tiles, requires_grad=True)
    (scatter_tiles(x, torch.from_numpy(ids), grid) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    padding = ids >= (grid // t) ** 3
    assert padding.any() and np.all(x.grad.numpy()[padding] == 0)

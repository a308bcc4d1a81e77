"""Solid-ellipsoid voxel samples: the representative occupancy for timing.

The port's copy of ``__graft_entry__.ellipsoid_sample``: real solid
voxelizations occupy a compact region (~10% of sites, ~15-30% of 8³
tiles), which uniform random scatter misrepresents. Site count targets ~80%
of ``n_points``; centre and aspect jitter stay inside the grid.
"""

from __future__ import annotations

import numpy as np

from .device_prep import pack_sparse_voxels


def ellipsoid_sample(rng: np.random.Generator, voxel_size: int, n_points: int):
    """One solid-ellipsoid sample as packed (flat, rgb) u32 rows of length
    ``n_points``."""
    D = voxel_size
    z, y, x = np.ogrid[0:D, 0:D, 0:D]
    base_r = (n_points * 0.8 * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    c = rng.uniform(0.35 * D, 0.65 * D, 3)
    r = base_r * rng.uniform(0.9, 1.1, 3)

    def solid(r):
        return (
            ((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((x - c[2]) / r[2]) ** 2
        ) <= 1.0

    m = solid(r)
    if int(m.sum()) > n_points:
        # Shrink a draw whose aspect jitter overflows the padded budget.
        m = solid(r * (0.98 * n_points / int(m.sum())) ** (1.0 / 3.0))
    coords = np.argwhere(m).astype(np.uint8)
    feats = rng.integers(0, 256, (len(coords), 3), dtype=np.uint8)
    return pack_sparse_voxels(coords, feats, n_points)

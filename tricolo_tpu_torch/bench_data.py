"""The benchmarks' data: the flagship Tri(I+V) configuration and its
synthetic solid-ellipsoid batches.

The port's copy of ``__graft_entry__._flagship_cfg`` and ``_host_batch``,
and of ``scripts/bench_loader._EllipsoidDataset``:

* ``flagship_cfg(tiny=False, extra=None)`` — Tri(I+V) (BiGRU, MVCNN over
  ResNet18, VoxelCNN) on the synthetic preset in bf16 compute, 64³ voxels
  and 6 views of 128² (``tiny``: 32³, 2 views of 32²). Size keys go in
  through ``extra`` (``load_config`` overrides), so interpolations such as
  the voxel encoder's ``${data.voxel_size}`` resolve to them.
* ``host_batch(cfg, n_points, seed)`` — one batch in the loader's packed
  contract (tokens, uint8 views, packed voxel sites) of solid ellipsoids
  (``data/ellipsoid.py``): the same arrays, bit for bit, as the JAX
  function's for the same arguments.
* ``EllipsoidDataset(cfg, n_items, length, n_points)`` — ``n_items``
  distinct ellipsoid items in the ``GeneralDataset`` item contract, cycled
  to ``length``, for the loader-included benchmark.
"""

from __future__ import annotations

import numpy as np

from .config import load_config
from .data.device_prep import VOXEL_PAD_SENTINEL
from .data.ellipsoid import ellipsoid_sample


def flagship_cfg(tiny: bool = False, extra: list | None = None):
    """The flagship Tri(I+V) config, ``extra`` overrides applied last."""
    if tiny:
        sizes = ["data.voxel_size=32", "data.image_size=32", "data.num_views=2"]
    else:
        sizes = ["data.voxel_size=64", "data.image_size=128", "data.num_views=6"]
    return load_config(
        [
            "data=synthetic",
            "model.image_encoder=MVCNNEncoder",
            "model.voxel_encoder=VoxelCNNEncoder",
            "precision.compute_dtype=bfloat16",
            "data.batch_size=8",
            *sizes,
            *(extra or []),
        ]
    )


def host_batch(cfg, n_points: int = 2048, seed: int = 0) -> dict:
    """``data.batch_size`` solid ellipsoids (~0.8·``n_points`` sites each)
    with random 16-token captions and random views: tokens (B, 16) int32,
    images (B, V, H, W, 3) uint8, voxel_flat / voxel_rgb (B, n_points) u32."""
    d = cfg.data
    rng = np.random.default_rng(seed)
    b = d.batch_size
    flat = np.empty((b, n_points), np.uint32)
    rgb = np.empty((b, n_points), np.uint32)
    for i in range(b):
        flat[i], rgb[i] = ellipsoid_sample(rng, d.voxel_size, n_points)
    return {
        "tokens": rng.integers(1, d.vocab_size, (b, 16)).astype(np.int32),
        "images": rng.integers(
            0, 256, (b, d.num_views, d.image_size, d.image_size, 3), dtype=np.uint8
        ),
        "voxel_flat": flat,
        "voxel_rgb": rgb,
    }


class EllipsoidDataset:
    """In-memory items at the flagship's sizes: ``n_items`` distinct solid
    ellipsoids with captions and views, drawn from one seed-0 stream,
    cycled to ``length`` (a batch costs what distinct data would, without
    an epoch of views in memory)."""

    def __init__(self, cfg, n_items: int, length: int, n_points: int):
        d = cfg.data
        rng = np.random.default_rng(0)
        self.max_voxel_points = n_points
        self.length = length
        self.items = []
        for i in range(n_items):
            flat, rgb = ellipsoid_sample(rng, d.voxel_size, n_points)
            sites = flat != VOXEL_PAD_SENTINEL
            self.items.append(
                {
                    "model_id": f"synthetic_{i:04d}",
                    "category": "synthetic",
                    "tokens": rng.integers(1, d.vocab_size, 16).astype(np.int32),
                    "images": rng.integers(
                        0, 256, (d.num_views, d.image_size, d.image_size, 3), dtype=np.uint8
                    ),
                    # collate reads each item's sites unpadded
                    "voxel_flat": flat[sites],
                    "voxel_rgb": rgb[sites],
                }
            )

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        return self.items[i % len(self.items)]

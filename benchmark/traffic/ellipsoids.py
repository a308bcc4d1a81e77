"""Training traffic of solid ellipsoids with captions and views.

The one generator of the training mixes. A mix file (``traffic/<name>.json``)
gives its parameters:

* ``distinct_items`` shapes, cycled to ``epoch_items`` a loader epoch (the
  loader reshuffles the whole epoch with its seed);
* ``site_share``: the occupied share of the D³ grid of each shape, the
  ``distinct_items`` mid-quantiles ((i + ½)/n) of a ``log_uniform`` or
  ``uniform`` law over [low, high];
* ``centre`` and ``radius_jitter``: each ellipsoid's centre is uniform in
  [lo·D, hi·D]³ and its three radii are jittered by factors in the given
  range, then rescaled so that the volume keeps the item's share;
* ``shape_seed``: the one stream the centres and jitter come from. The
  shapes, and so every sample's active tiles, the windowed_compact rows k
  and the step's work, are the same for every run seed;
* ``caption_tokens``: caption lengths at the mid-quantiles of a
  ``log_normal`` law (median, sigma) clipped to [min, max], padded with 0
  to ``max_tokens`` (the configuration's), as the Text2Shape loader pads.

The run seed draws what does not change the work: which item gets which
caption length, the token ids (1 ≤ id < vocab), the colours of the sites
and the uint8 views. It is the frozen arithmetic of
``tricolo_tpu_torch/data/ellipsoid.py`` (solid ellipsoid, packed u32 site
and RGB words), made in bulk on the host.
"""

from __future__ import annotations

import statistics

import numpy as np

OCCUPIED = np.uint32(1 << 24)
PAD_MULTIPLE = 512
LEVELS = 5  # the voxel encoder's blocks: active sites at D, D/2, ..., D/16


def mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def site_shares(law: dict, n: int) -> np.ndarray:
    q = mid_quantiles(n)
    lo, hi = float(law["low"]), float(law["high"])
    if law["law"] == "log_uniform":
        return lo * (hi / lo) ** q
    if law["law"] == "uniform":
        return lo + (hi - lo) * q
    raise ValueError(f"unknown site_share law {law['law']!r}")


def caption_lengths(law: dict, n: int) -> np.ndarray:
    if law["law"] != "log_normal":
        raise ValueError(f"unknown caption_tokens law {law['law']!r}")
    unit = statistics.NormalDist()
    mu, sigma = np.log(float(law["median"])), float(law["sigma"])
    lengths = [np.exp(mu + sigma * unit.inv_cdf(float(q))) for q in mid_quantiles(n)]
    return np.clip(np.rint(lengths), law["min"], law["max"]).astype(np.int64)


def ellipsoid_coords(D: int, share: float, centre: np.ndarray, jitter: np.ndarray) -> np.ndarray:
    """(n, 3) int sites of a solid ellipsoid of ``share``·D³ volume, in
    lexicographic (c0, c1, c2) order."""
    base = (share * D**3 * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    r = base * jitter / np.prod(jitter) ** (1.0 / 3.0)
    lo = np.maximum(np.floor(centre - r).astype(int), 0)
    hi = np.minimum(np.ceil(centre + r).astype(int) + 1, D)
    a, b, c = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    inside = (((a - centre[0]) / r[0]) ** 2 + ((b - centre[1]) / r[1]) ** 2
              + ((c - centre[2]) / r[2]) ** 2) <= 1.0
    return np.argwhere(inside) + lo


def active_counts(coords: np.ndarray, D: int) -> np.ndarray:
    """Active sites of one sample at each block's input grid (D, D/2, ...):
    the distinct sites after each 2³ pooling. Level 3 (D/8) counts the 8³
    tiles."""
    out = np.empty(LEVELS, np.int64)
    out[0] = len(coords)  # distinct already
    for level in range(1, LEVELS):
        g = D >> level
        c = coords >> level
        grid = np.zeros(g ** 3, bool)
        grid[(c[:, 0] * g + c[:, 1]) * g + c[:, 2]] = True
        out[level] = int(grid.sum())
    return out


class TrafficDataset:
    """The loader's item contract (``tricolo_tpu_torch.data.datasets``):
    ``len``, ``[i]`` (cycled over the distinct items), ``max_voxel_points``
    and ``max_voxel_tiles``. ``active_sites[i]`` is item i's active sites at
    each voxel block (the FLOP count's input; level 3 counts its 8³ tiles)."""

    def __init__(self, items: list, length: int, max_voxel_points: int,
                 max_voxel_tiles: int, active_sites: np.ndarray):
        self.items = items
        self.length = length
        self.max_voxel_points = max_voxel_points
        self.max_voxel_tiles = max_voxel_tiles
        self.active_sites = active_sites

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        return self.items[i % len(self.items)]

    def item_index(self, model_id: str) -> int:
        return int(model_id.rsplit("_", 1)[1])


def generate(spec: dict, sizes: dict, seed: int, distinct_items: int | None = None,
             epoch_items: int | None = None) -> TrafficDataset:
    """The mix's dataset for ``seed`` at the configuration's ``sizes``
    (``voxel_size``, ``image_size``, ``num_views``, ``vocab_size``,
    ``max_tokens``, ``voxel``, ``image``). ``distinct_items`` /
    ``epoch_items`` override the file's (the CPU tests' tiny runs)."""
    n = int(distinct_items or spec["distinct_items"])
    length = int(epoch_items or spec["epoch_items"])
    D, T = int(sizes["voxel_size"]), int(sizes["max_tokens"])
    content = np.random.default_rng([seed, 20])
    lengths = content.permutation(caption_lengths(spec["caption_tokens"], n))
    tokens = content.integers(1, int(sizes["vocab_size"]), (n, T)).astype(np.int32)
    tokens[np.arange(T)[None, :] >= lengths[:, None]] = 0
    images = None
    if sizes["image"]:
        V, S = int(sizes["num_views"]), int(sizes["image_size"])
        images = np.frombuffer(content.bytes(n * V * S * S * 3), np.uint8).reshape(n, V, S, S, 3)
    items, active = [], np.zeros((n, LEVELS), np.int64)
    flats: list = [(None, None)] * n
    if sizes["voxel"]:
        shapes = np.random.default_rng(int(spec["shape_seed"]))
        lo, hi = spec["centre"]
        centres = shapes.uniform(lo * D, hi * D, (n, 3))
        jitter = shapes.uniform(*spec["radius_jitter"], (n, 3))
        shares = site_shares(spec["site_share"], n)
        coords = [ellipsoid_coords(D, shares[i], centres[i], jitter[i]) for i in range(n)]
        every = np.concatenate(coords).astype(np.uint32)
        colours = np.frombuffer(content.bytes(3 * len(every)), np.uint8).reshape(-1, 3)
        colours = colours.astype(np.uint32)
        flat = (every[:, 0] * 256 + every[:, 1]) * 256 + every[:, 2]
        rgb = colours[:, 0] | (colours[:, 1] << 8) | (colours[:, 2] << 16) | OCCUPIED
        ends = np.cumsum([len(c) for c in coords])[:-1]
        flats = list(zip(np.split(flat, ends), np.split(rgb, ends)))
        for i, c in enumerate(coords):
            active[i] = active_counts(c, D)
    for i in range(n):
        item = {"model_id": f"shape_{i:05d}", "category": "synthetic", "tokens": tokens[i]}
        if images is not None:
            item["images"] = images[i]
        if flats[i][0] is not None:
            item["voxel_flat"], item["voxel_rgb"] = flats[i]
        items.append(item)
    most = int(active[:, 0].max()) if sizes["voxel"] else 1
    max_points = max(PAD_MULTIPLE, -(-most // PAD_MULTIPLE) * PAD_MULTIPLE)
    return TrafficDataset(items, length, max_points, int(max(active[:, 3].max(), 1)), active)

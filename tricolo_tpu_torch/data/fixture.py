"""A Text2Shape-C13-shaped collection written from a seed: the split maps,
the per-model npz files of the preprocess schema and the ShapeNet OBJs,
for runs of the C13/128³ path (train, test, mesh F1) where the real
downloads are absent.

Layout under ``root`` (what ``data=text2shape_c13
data.dataset_root_path=<root>`` reads, and ``calculate_f1``'s
``+shapenet_root``)::

    text2shape-data/c13/preprocessed/exp_data/{train,val,test}_map.json
    text2shape-data/c13/preprocessed/exp_data/<category>/<model_id>.npz
    text2shape-data/ShapeNetCore.v2/<category>/<model_id>/models/model_normalized.obj

Each model is one solid ellipsoid (after ``data/ellipsoid.py``): a centre
and radii in the unit cube, voxelised at every size of ``voxel_sizes`` as a
(4, D, D, D) uint8 RGBA member ``voxel{D}`` (alpha 255 where the voxel
centre lies inside; RGB a seeded model colour with a gradient along the
first axis), and its surface as a triangulated sphere scaled by the radii
in the OBJ. The views are seeded uint8 (V, 3, 224, 224) blocks (8×8-pixel
cells), not renders. Captions are seeded token ids below the C13 vocabulary's
3968.
The 13 categories are the ShapeNet synsets of the C13 split.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

C13_CATEGORIES = (
    "02691156", "02828884", "02933112", "02958343", "03001627", "03211117", "03636649",
    "03691459", "04090263", "04256520", "04379243", "04401088", "04530566",
)
SPLITS = ("train", "val", "test")
VOCAB_SIZE = 3968  # data=text2shape_c13


def exp_data_dir(root: str) -> str:
    return os.path.join(root, "text2shape-data", "c13", "preprocessed", "exp_data")


def shapenet_dir(root: str) -> str:
    return os.path.join(root, "text2shape-data", "ShapeNetCore.v2")


def ellipsoid_rgba(centre: np.ndarray, radii: np.ndarray, color: np.ndarray,
                   d: int) -> np.ndarray:
    """(4, d, d, d) uint8 RGBA grid of the solid ellipsoid (unit-cube
    ``centre`` and ``radii``): the voxels whose centres lie inside."""
    p = (np.arange(d) + 0.5) / d
    x, y, z = np.ix_(p, p, p)
    q = ((x - centre[0]) / radii[0]) ** 2 + ((y - centre[1]) / radii[1]) ** 2 \
        + ((z - centre[2]) / radii[2]) ** 2
    inside = q <= 1.0
    grid = np.zeros((4, d, d, d), np.uint8)
    ramp = np.clip(color[:, None] + 96.0 * (p[None, :] - centre[0]) / radii[0], 0, 255)
    for ch in range(3):
        grid[ch] = np.where(inside, ramp[ch].astype(np.uint8)[:, None, None], 0)
    grid[3] = np.where(inside, 255, 0)
    return grid


def ellipsoid_obj(centre: np.ndarray, radii: np.ndarray, n_lat: int = 12,
                  n_lon: int = 24) -> str:
    """OBJ text of the ellipsoid's surface: a UV sphere (two poles,
    ``n_lat - 1`` rings of ``n_lon`` vertices), scaled by ``radii`` about
    ``centre``, in coordinates centred on the unit cube's centre."""
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, n_lat):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append((np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                          np.cos(theta)))
    verts.append((0.0, 0.0, -1.0))
    v = np.asarray(verts) * radii + centre - 0.5

    def ring(i, j):  # 1-based OBJ index of ring i (1..n_lat-1), column j
        return 2 + (i - 1) * n_lon + j % n_lon

    faces = [(1, ring(1, j), ring(1, j + 1)) for j in range(n_lon)]
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, e = ring(i + 1, j + 1), ring(i + 1, j)
            faces += [(a, e, c), (a, c, b)]
    south = len(verts)
    faces += [(south, ring(n_lat - 1, j + 1), ring(n_lat - 1, j)) for j in range(n_lon)]
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def _write_model(job: dict) -> None:
    os.makedirs(os.path.dirname(job["npz"]), exist_ok=True)
    rng = np.random.default_rng(job["seed"])
    arrays = {f"voxel{d}": ellipsoid_rgba(job["centre"], job["radii"], job["color"], d)
              for d in job["voxel_sizes"]}
    cells = rng.integers(0, 256, (job["num_views"], 3, 28, 28), dtype=np.uint8)
    arrays["images"] = np.repeat(np.repeat(cells, 8, axis=2), 8, axis=3)
    np.savez_compressed(job["npz"], **arrays)
    os.makedirs(os.path.dirname(job["obj"]), exist_ok=True)
    with open(job["obj"], "w") as f:
        f.write(ellipsoid_obj(job["centre"], job["radii"]))


def write_c13_fixture(root: str, models_per_category: int = 8, categories: int = 13,
                      captions_per_model: int = 3, voxel_sizes=(32, 64, 128),
                      num_views: int = 6, seed: int = 0) -> dict:
    """Write the collection under ``root``; returns {split: [(category,
    model_id), ...]}. Of each category's models, the last two are the val
    and test models, the rest train."""
    if not 0 < categories <= len(C13_CATEGORIES):
        raise ValueError(f"categories must be in [1, {len(C13_CATEGORIES)}], got {categories}")
    if models_per_category < 3:
        raise ValueError(f"a category needs 3 models (train, val, test), got "
                         f"{models_per_category}")
    rng = np.random.default_rng(seed)
    exp_data, shapenet = exp_data_dir(root), shapenet_dir(root)
    splits: dict = {s: [] for s in SPLITS}
    rows: dict = {s: [] for s in SPLITS}
    jobs = []
    for category in C13_CATEGORIES[:categories]:
        base = rng.uniform(0.18, 0.32)
        for m in range(models_per_category):
            model_id = "".join(rng.choice(list("0123456789abcdef"), 32))
            radii = base * rng.uniform(0.8, 1.2, 3)
            centre = rng.uniform(0.5 - (0.48 - radii), 0.5 + (0.48 - radii))
            jobs.append({"npz": os.path.join(exp_data, category, f"{model_id}.npz"),
                         "obj": os.path.join(shapenet, category, model_id, "models",
                                             "model_normalized.obj"),
                         "centre": centre, "radii": radii,
                         "color": rng.uniform(40, 215, 3), "seed": int(rng.integers(2**31)),
                         "voxel_sizes": tuple(voxel_sizes), "num_views": num_views})
            split = ("val" if m == models_per_category - 2 else
                     "test" if m == models_per_category - 1 else "train")
            splits[split].append((category, model_id))
            for _ in range(captions_per_model):
                tokens = rng.integers(1, VOCAB_SIZE, int(rng.integers(6, 25))).tolist()
                rows[split].append({"model_id": model_id, "category": category,
                                    "caption": " ".join(f"w{t}" for t in tokens),
                                    "tokens": tokens})
    with ThreadPoolExecutor(max_workers=8) as pool:  # numpy and zlib release the GIL
        list(pool.map(_write_model, jobs))
    for split in SPLITS:
        with open(os.path.join(exp_data, f"{split}_map.json"), "w") as f:
            json.dump(rows[split], f)
    return splits

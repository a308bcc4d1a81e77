"""Mesh-retrieval F1: surface sampling + bidirectional nearest neighbours.

The port of ``tricolo_tpu.evaluation.f1_mesh`` (the reference's post-hoc
calculate_f1.py): for each ``nearest.jsonl`` row, load the ground-truth and
the top-1 retrieved ShapeNet OBJs, scale both by the factor that makes the
GT's longest bounding-box edge 10 ("gt-10"), sample 10k points uniformly
(area-weighted) from each surface with an on-disk per-model point cache,
and compute F1@0.1 = 2PR/(P+R+eps), P and R the percentages of pred→gt
and gt→pred nearest-neighbour distances under the threshold. The mean F1
over the queries is the number the paper reports.

Surface sampling is numpy on the host with the same ``default_rng(0)``
draws, so the points equal the JAX package's bit for bit. The
nearest-neighbour search runs on the device (``cuda`` unless the caller
passes ``device``; without a GPU it raises, as ``inference.resolve_device``
does): brute force over 2048-row chunks of one set against the whole
other set. It sums the squared coordinate differences directly in f32
instead of the JAX package's expansion |a|² − 2a·bᵀ + |b|²: at gt-10
scale the squared norms reach ~75 while the threshold's own d² is 0.01,
so the expansion in f32 leaves ~1e-5 of d² (and with TF32 ~5e-2) and
flips rare threshold decisions; the direct sum is within a few f32 ulps
of d² itself and uses no matrix product, so no TF32 setting reaches it.

Replicated quirk: the point cache is keyed by model id only, so a model's
cached points keep whichever scale they were first written with.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..inference import resolve_device

THRESHOLDS = (0.1,)
NUM_SAMPLES = 10000
SCALE_TARGET = 10.0
EPS = 1e-8
CHUNK = 2048


def sample_points_on_mesh(
    vertices: np.ndarray, faces: np.ndarray, num_samples: int, rng=None
) -> np.ndarray:
    """Uniform surface sampling: area-weighted triangles + barycentric."""
    rng = rng or np.random.default_rng(0)
    tri = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(cross, axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    choice = rng.choice(len(faces), size=num_samples, p=areas / total)
    # Uniform barycentric via the sqrt trick.
    r1 = np.sqrt(rng.random(num_samples))
    r2 = rng.random(num_samples)
    a, b, c = tri[choice, 0], tri[choice, 1], tri[choice, 2]
    pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + (r1 * r2)[:, None] * c
    return pts.astype(np.float32)


def gt_scale_factor(gt_vertices: np.ndarray, target: float = SCALE_TARGET) -> float:
    """gt-<target> rule: longest GT bbox edge → target length."""
    extent = gt_vertices.max(axis=0) - gt_vertices.min(axis=0)
    return float(target / extent.max())


def min_dists(a: np.ndarray, b: np.ndarray, device=None, chunk: int = CHUNK) -> np.ndarray:
    """For each row of ``a`` (N, 3): the distance to its nearest neighbour in
    ``b`` (M, 3), float32, searched on ``device`` (None: cuda)."""
    device = resolve_device(device)
    a_t = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    b_t = torch.as_tensor(np.ascontiguousarray(b, np.float32), device=device)
    if a_t.ndim != 2 or b_t.ndim != 2 or a_t.shape[1] != 3 or b_t.shape[1] != 3:
        raise ValueError(f"point sets must be (N, 3), got {tuple(a_t.shape)} and "
                         f"{tuple(b_t.shape)}")
    if b_t.shape[0] == 0:
        raise ValueError("nearest neighbours in an empty point set")
    bx, by, bz = (coord.contiguous() for coord in b_t.T)
    d2_min = torch.empty(a_t.shape[0], dtype=torch.float32, device=device)
    for start in range(0, a_t.shape[0], chunk):
        block = a_t[start : start + chunk]
        d2 = (block[:, 0:1] - bx).square_()
        d2 += (block[:, 1:2] - by).square_()
        d2 += (block[:, 2:3] - bz).square_()
        d2_min[start : start + chunk] = d2.amin(dim=1)
    return d2_min.sqrt_().cpu().numpy()


def f1_between_point_sets(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    thresholds=THRESHOLDS,
    eps: float = EPS,
    device=None,
) -> dict[float, float]:
    """F1@t between two sampled point sets (percent-scaled P/R)."""
    pred_to_gt = min_dists(pred_points, gt_points, device)
    gt_to_pred = min_dists(gt_points, pred_points, device)
    result = {}
    for t in thresholds:
        precision = 100.0 * float((pred_to_gt < t).mean())
        recall = 100.0 * float((gt_to_pred < t).mean())
        result[t] = (2.0 * precision * recall) / (precision + recall + eps)
    return result


class PointCache:
    """Per-model sampled-point cache (``point_cache/{model_id}.npy``)."""

    def __init__(self, cache_dir: str = "point_cache"):
        self.cache_dir = cache_dir

    def path(self, model_id: str) -> str:
        return os.path.join(self.cache_dir, f"{model_id}.npy")

    def has(self, model_id: str) -> bool:
        return os.path.exists(self.path(model_id))

    def get_or_sample(
        self,
        model_id: str,
        obj_path: str,
        scale: float,
        num_samples: int = NUM_SAMPLES,
        mesh: tuple | None = None,
    ) -> np.ndarray:
        """``mesh`` = already-parsed (vertices, faces), avoiding a second
        OBJ parse when the caller loaded the file for the scale factor."""
        if self.has(model_id):
            return np.load(self.path(model_id))
        if mesh is None:
            from ..data.render import load_obj

            mesh = load_obj(obj_path)
        vertices, faces = mesh
        points = sample_points_on_mesh(vertices * scale, faces, num_samples)
        os.makedirs(self.cache_dir, exist_ok=True)
        np.save(self.path(model_id), points)
        return points


def obj_path(shapenet_root: str, category: str, model_id: str) -> str:
    """A ShapeNetCore.v2 model's mesh file."""
    return os.path.join(shapenet_root, category, model_id, "models", "model_normalized.obj")


def mesh_f1_for_query(
    gt_id: str,
    pred_id: str,
    model_to_category: dict[str, str],
    shapenet_root: str,
    cache: PointCache,
    threshold: float = 0.1,
    device=None,
) -> float:
    """F1@threshold between the GT mesh and the top-1 retrieved mesh."""
    from ..data.render import load_obj

    gt_path = obj_path(shapenet_root, model_to_category[gt_id], gt_id)
    pred_path = obj_path(shapenet_root, model_to_category[pred_id], pred_id)
    gt_mesh = None
    if cache.has(gt_id) and cache.has(pred_id):
        scale = 1.0  # cached points already carry their scale (quirk noted above)
    else:
        gt_mesh = load_obj(gt_path)
        scale = gt_scale_factor(gt_mesh[0])
    gt_points = cache.get_or_sample(gt_id, gt_path, scale, mesh=gt_mesh)
    pred_points = cache.get_or_sample(pred_id, pred_path, scale)
    return f1_between_point_sets(pred_points, gt_points, (threshold,), device=device)[threshold]


def run_f1_over_nearest(
    nearest_path: str,
    val_map_path: str,
    shapenet_root: str,
    cache_dir: str = "point_cache",
    threshold: float = 0.1,
    device=None,
) -> float:
    """Mean top-1 mesh F1 over all evaluable nearest.jsonl rows, the
    nearest-neighbour searches on ``device`` (None: cuda)."""
    device = resolve_device(device)
    with open(val_map_path) as f:
        model_to_category = {r["model_id"]: r["category"] for r in json.load(f)}

    with open(nearest_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]

    def obj_exists(model_id):
        return os.path.exists(obj_path(shapenet_root, model_to_category[model_id], model_id))

    cache = PointCache(cache_dir)
    scores = []
    for row in rows:
        gt_id = row["groundtruth"].rsplit("-", 1)[0]
        pred_id = row["retrieved_models"][0]
        if gt_id not in model_to_category or pred_id not in model_to_category:
            continue
        # Skip rows whose GT *or* retrieved mesh is unavailable — one
        # missing OBJ must not abort a long evaluation sweep. When either
        # mesh still needs sampling, the GT OBJ is also required for the
        # gt-10 scale factor. Read row by row: earlier rows fill the cache.
        gt_ok = cache.has(gt_id) or obj_exists(gt_id)
        pred_ok = cache.has(pred_id) or obj_exists(pred_id)
        needs_sampling = not (cache.has(gt_id) and cache.has(pred_id))
        if not (gt_ok and pred_ok) or (needs_sampling and not obj_exists(gt_id)):
            continue
        scores.append(mesh_f1_for_query(gt_id, pred_id, model_to_category, shapenet_root,
                                        cache, threshold, device))
    if not scores:
        raise ValueError("no evaluable queries found in nearest.jsonl")
    return float(np.mean(scores))

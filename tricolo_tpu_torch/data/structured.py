"""Structured synthetic dataset: captions *determine* shape attributes.

The port's copy of ``tricolo_tpu.data.structured`` (numpy only; same
seeds, same draws, same numbers). Every caption describes its model's
attributes (primitive, size, color, aspect, vertical position), so a
text-shape embedding that learns the correspondence ranks the right models
highly and a broken one cannot: the retrieval metrics carry signal, unlike
``SyntheticDataset``'s random tokens against random shapes.

* each model is a solid colored primitive voxelized into the D³ grid —
  5 shapes × 3 sizes × 8 colors × 3 aspects × 3 vertical positions = 1080
  distinct attribute tuples, sampled without replacement;
* captions are templated word sequences over a fixed vocabulary mentioning
  all five attributes in template-dependent order;
* images are axis-aligned orthographic color projections of the grid,
  nearest-upsampled to ``image_size``.

Deterministic per (split, ``data.structured_seed``): one
``default_rng((structured_seed, split_salt))`` draws the tuples, then per
model its color jitter and its template offset. The items follow the
port's ``_SplitDataset`` contract.
"""

from __future__ import annotations

import numpy as np

from .datasets import _resolve_voxel_budget, _SplitDataset, dense_rgba_to_packed

SHAPES = ("sphere", "box", "cylinder", "pyramid", "torus")
SIZES = ("small", "medium", "large")
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 60),
    "blue": (50, 70, 220),
    "yellow": (230, 210, 50),
    "purple": (160, 60, 200),
    "cyan": (60, 200, 210),
    "orange": (235, 140, 40),
    "white": (235, 235, 235),
}
ASPECTS = ("even", "tall", "flat")
VPOS = ("bottom", "middle", "top")

_SIZE_RADIUS = {"small": 0.11, "medium": 0.18, "large": 0.27}  # × D
_ASPECT_SCALE = {
    "even": (1.0, 1.0, 1.0),
    "tall": (0.72, 0.72, 1.45),
    "flat": (1.22, 1.22, 0.55),
}
_VPOS_CENTER = {"bottom": 0.32, "middle": 0.5, "top": 0.68}  # × D (z)

# Fixed vocabulary: id = 1 + index (0 is padding, the BiGRU padding_idx).
VOCAB = (
    list(SHAPES) + list(SIZES) + list(COLORS) + list(ASPECTS) + list(VPOS)
    + ["a", "the", "is", "and", "colored", "near", "shaped", "object", "sits", "at",
       "it", "this", "placed", "proportioned"]
)
WORD_TO_ID = {w: i + 1 for i, w in enumerate(VOCAB)}

_TEMPLATES = (
    "a {size} {color} {shape} {aspect} proportioned near the {vpos}",
    "the {color} {shape} is {size} and {aspect} placed at the {vpos}",
    "this {aspect} {size} object is a {shape} colored {color} near the {vpos}",
    "a {shape} shaped object {color} colored {size} and {aspect} sits at the {vpos}",
)


def caption_words(attrs: dict, template_idx: int) -> list[str]:
    return _TEMPLATES[template_idx % len(_TEMPLATES)].format(**attrs).split()


def voxelize_primitive(attrs: dict, voxel_size: int, rng: np.random.Generator) -> np.ndarray:
    """(4, D, D, D) uint8 RGBA grid of one solid colored primitive."""
    D = voxel_size
    r = _SIZE_RADIUS[attrs["size"]] * D
    sx, sy, sz = _ASPECT_SCALE[attrs["aspect"]]
    cz = _VPOS_CENTER[attrs["vpos"]] * D
    cz = float(np.clip(cz, r * sz + 1, D - r * sz - 1))  # keep it inside the grid
    cx = cy = D / 2.0
    x, y, z = np.ogrid[0:D, 0:D, 0:D]
    u = (x - cx) / sx
    v = (y - cy) / sy
    w = (z - cz) / sz
    shape = attrs["shape"]
    if shape == "sphere":
        mask = u * u + v * v + w * w <= r * r
    elif shape == "box":
        b = 0.8 * r
        mask = (np.abs(u) <= b) & (np.abs(v) <= b) & (np.abs(w) <= b)
    elif shape == "cylinder":
        mask = (u * u + v * v <= (0.8 * r) ** 2) & (np.abs(w) <= r)
    elif shape == "pyramid":
        taper = np.clip((r - w) / (2.0 * r), 0.0, 1.0)  # apex at +z
        mask = (np.abs(u) + np.abs(v) <= 1.6 * r * taper) & (np.abs(w) <= r)
    elif shape == "torus":
        ring = np.sqrt(u * u + v * v) - 0.7 * r
        mask = ring * ring + w * w <= (0.35 * r) ** 2
    else:
        raise ValueError(shape)
    base = np.asarray(COLORS[attrs["color"]], np.int16)
    grid = np.zeros((4, D, D, D), np.uint8)
    n = int(mask.sum())
    jitter = rng.integers(-25, 26, (3, n), dtype=np.int16)
    rgb = np.clip(base[:, None] + jitter, 1, 255).astype(np.uint8)
    for c in range(3):
        grid[c][mask] = rgb[c]
    grid[3][mask] = 255
    return grid


def project_views(rgba: np.ndarray, image_size: int, num_views: int) -> np.ndarray:
    """Axis-aligned orthographic color projections → (V, S, S, 3) uint8:
    along each axis the first occupied voxel gives the pixel (white
    background), nearest-resampled to ``image_size``; view i is axis i % 3."""
    D = rgba.shape[1]
    occ = rgba[3] > 0
    views = []
    for axis in range(3):
        first = np.argmax(occ, axis=axis)
        any_hit = occ.any(axis=axis)
        img = np.full((D, D, 3), 255, np.uint8)
        take = list(np.indices((D, D)))
        take.insert(axis, first)
        for c in range(3):
            img[..., c] = np.where(any_hit, rgba[c][tuple(take)], 255)
        views.append(img)
    scale_idx = (np.arange(image_size) * D) // image_size
    views = [v[scale_idx][:, scale_idx] for v in views]
    return np.stack([views[i % 3] for i in range(num_views)])


class StructuredSyntheticDataset(_SplitDataset):
    """Attribute-grounded synthetic split in the ``_SplitDataset`` contract."""

    def __init__(self, cfg, split: str):
        data = cfg.data
        self.voxel_size = data.voxel_size
        max_tokens = data.get("max_tokens", 24)
        num_models = data.get("num_models", 100)
        captions_per_model = data.get("captions_per_model", 3)
        if data.vocab_size <= len(VOCAB):
            raise ValueError(f"structured vocab needs vocab_size > {len(VOCAB)}")
        split_salt = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        rng = np.random.default_rng((int(data.get("structured_seed", 0)), split_salt))

        combos = [
            {"shape": sh, "size": sz, "color": co, "aspect": a, "vpos": vp}
            for sh in SHAPES for sz in SIZES for co in COLORS for a in ASPECTS for vp in VPOS
        ]
        if num_models > len(combos):
            raise ValueError(f"num_models={num_models} exceeds {len(combos)} attribute tuples")
        picks = rng.choice(len(combos), size=num_models, replace=False)

        self.language_data = []
        self.vision_data = {}
        for m, pick in enumerate(picks):
            attrs = combos[int(pick)]
            model_id = f"{split}_struct_{m:04d}"
            rgba = voxelize_primitive(attrs, self.voxel_size, rng)
            flat, rgb = dense_rgba_to_packed(rgba)
            images = project_views(rgba, data.image_size, data.num_views)
            self.vision_data[("structured", model_id)] = {"flat": flat, "rgb": rgb,
                                                          "images": images}
            template_offset = int(rng.integers(0, len(_TEMPLATES)))
            for c in range(captions_per_model):
                words = caption_words(attrs, template_offset + c)
                tokens = np.zeros(max_tokens, np.int32)
                ids = [WORD_TO_ID[w] for w in words][:max_tokens]
                tokens[: len(ids)] = ids
                self.language_data.append({"model_id": model_id, "category": "structured",
                                           "tokens": tokens, "text": " ".join(words)})
        self.max_voxel_points = _resolve_voxel_budget(cfg, self.vision_data, split)

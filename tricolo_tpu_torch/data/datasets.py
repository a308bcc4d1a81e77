"""Split datasets: caption maps + per-model vision data, loaded into RAM.

The port's copy of ``tricolo_tpu.data.datasets`` (same item contract, same
seeds, same numbers): a split is a list of captions, each pointing at one
model's vision data. Items stay uint8/packed on the host — images
(V, H, W, 3) uint8 NHWC, voxels as packed u32 site words
(``voxel_flat``: x<<16 | y<<8 | z, sorted; ``voxel_rgb``: r | g<<8 | b<<16
| occupancy bit 24) — and the float work happens on the device
(data/device_prep.py).

``SyntheticDataset`` is the CPU/GPU-runnable fixture,
``StructuredSyntheticDataset`` (``structured.py``) the one whose captions
determine their shapes; ``GeneralDataset``
reads the Text2Shape ``{split}_map.json`` + per-model ``.npz`` layout: each
model's npz with numpy, its RGBA grid packed by the host loader's C++ sweep
(``dense_rgba_to_packed``; the numpy version is ``dense_rgba_to_packed_plain``),
over ``data.num_workers`` threads. With a CLIP head configured, items also
carry the model's precached CLIP features (``clip_embeddings_img``,
``clip_embeddings_text``: (768,) float32) — ``GeneralDataset`` reads them
from ``clip_embeddings_{split}.npz`` (or the reference's ``.pth``) under
``data.exp_data_root_path``, ``SyntheticDataset`` draws them — and with the
CLIP text head ``GeneralDataset`` tokenizes captions with the CLIP BPE.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from .. import native

# CLIP normalization stats (reference general_dataset.py:87-89).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

_VOXEL_PAD_MULTIPLE = 512
_TILE = 8


def _pad_target(n: int) -> int:
    """Per-split padded voxel budget: a multiple of 512, at least 512."""
    return max(
        _VOXEL_PAD_MULTIPLE,
        -(-n // _VOXEL_PAD_MULTIPLE) * _VOXEL_PAD_MULTIPLE,
    )


def _resolve_voxel_budget(cfg, vision_data: dict, split: str) -> int:
    """Split max occupied-site count, optionally capped by
    ``data.voxel_max_points`` (warns when the cap truncates)."""
    data_max = max((v["flat"].shape[0] for v in vision_data.values()), default=1)
    cap = cfg.data.get("voxel_max_points")
    budget = _pad_target(min(cap, data_max) if cap else data_max)
    if cap and cap < data_max:
        clipped = sum(1 for v in vision_data.values() if v["flat"].shape[0] > budget)
        if clipped:
            import warnings

            warnings.warn(
                f"voxel_max_points={cap} truncates {clipped}/{len(vision_data)} "
                f"models in split '{split}' (split max {data_max} occupied "
                "sites); truncation keeps the first sites in flat-grid order. "
                "Set data.voxel_max_points=null for exact batches.",
                stacklevel=3,
            )
    return budget


def max_voxel_tiles(vision_data: dict, voxel_size: int) -> int:
    """Split max per-sample active 8³-tile count — the fitted
    windowed_compact row budget (``tile_budget="auto"``)."""
    tg = voxel_size // _TILE
    worst = 1
    for v in vision_data.values():
        flat = v["flat"]
        if flat.shape[0] == 0:
            continue
        x = (flat >> np.uint32(16)) & np.uint32(0xFF)
        y = (flat >> np.uint32(8)) & np.uint32(0xFF)
        z = flat & np.uint32(0xFF)
        tid = ((x // _TILE).astype(np.int64) * tg + y // _TILE) * tg + z // _TILE
        worst = max(worst, len(np.unique(tid)))
    return worst


CLIP_KEYS = ("clip_embeddings_img", "clip_embeddings_text")


def uses_clip(cfg) -> bool:
    """Whether the config has a CLIP head, which reads precached features."""
    return (cfg.model.text_encoder == "CLIPTextEncoder"
            or cfg.model.image_encoder == "CLIPImageEncoder")


def _load_clip_cache(path_base: str) -> dict | None:
    """``{model_id: {"img", "text"}}`` float32 from ``path_base + ".npz"``
    (the extractor's, keys ``{model_id}/{kind}``) or, failing that,
    ``path_base + ".pth"`` (the reference's nested dict of tensors); None
    when neither exists."""
    npz_path = path_base + ".npz"
    if os.path.exists(npz_path):
        cache: dict[str, dict[str, np.ndarray]] = {}
        with np.load(npz_path) as data:
            for key in data.files:
                model_id, kind = key.rsplit("/", 1)
                cache.setdefault(model_id, {})[kind] = data[key].astype(np.float32)
        return cache
    pth_path = path_base + ".pth"
    if os.path.exists(pth_path):
        import torch

        raw = torch.load(pth_path, map_location="cpu", weights_only=True)
        return {mid: {k: np.asarray(v, dtype=np.float32) for k, v in entry.items()}
                for mid, entry in raw.items()}
    return None


class _SplitDataset:
    """Shared item contract (``tricolo_tpu`` GeneralDataset.__getitem__):
    the CLIP features ride along when the model's vision entry holds them,
    and ``clip_tokenizer`` (set with the CLIP text head) replaces the
    caption's tokens with its CLIP BPE ids."""

    language_data: list
    vision_data: dict
    voxel_size: int
    clip_tokenizer = None

    def __len__(self) -> int:
        return len(self.language_data)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        lang = self.language_data[idx]
        vision = self.vision_data[(lang["category"], lang["model_id"])]
        item = {
            "model_id": lang["model_id"],
            "category": lang["category"],
            "tokens": lang["tokens"] if self.clip_tokenizer is None
            else self.clip_tokenizer(lang["text"]),
            "images": vision["images"],
            "voxel_flat": vision["flat"],
            "voxel_rgb": vision["rgb"],
        }
        for key in CLIP_KEYS:
            if key in vision:
                item[key] = vision[key]
        return item

    @property
    def max_voxel_tiles(self) -> int:
        cached = getattr(self, "_max_voxel_tiles", None)
        if cached is None:
            cached = self._max_voxel_tiles = max_voxel_tiles(
                self.vision_data, self.voxel_size
            )
        return cached


def dense_rgba_to_packed(dense_voxel: np.ndarray):
    """Dense (4, D, D, D) RGBA grid → packed (flat, rgb) u32 site words
    (the occupied sites in site order), by the C++ sweep."""
    return native.dense_rgba_to_packed(dense_voxel)


def dense_rgba_to_packed_plain(dense_voxel: np.ndarray):
    """numpy version of ``dense_rgba_to_packed``."""
    alpha = dense_voxel[3]
    sites = np.nonzero(alpha.reshape(-1))[0].astype(np.uint32)
    d = dense_voxel.shape[1]
    x = (sites // (d * d)).astype(np.uint32)
    rem = sites % (d * d)
    y = (rem // d).astype(np.uint32)
    z = (rem % d).astype(np.uint32)
    flat = (x * 256 + y) * 256 + z
    rgb_channels = dense_voxel[:3].reshape(3, -1)[:, sites].astype(np.uint32)
    rgb = (
        rgb_channels[0]
        | (rgb_channels[1] << 8)
        | (rgb_channels[2] << 16)
        | np.uint32(1 << 24)
    )
    return flat, rgb


def _resize_views_bicubic(views_chw: np.ndarray, size: int) -> np.ndarray:
    """(V, 3, H, W) uint8 → (V, size, size, 3) uint8, bicubic + antialias
    (torchvision Resize(size, BICUBIC, antialias=True) semantics)."""
    if views_chw.shape[-1] == size and views_chw.shape[-2] == size:
        return np.ascontiguousarray(views_chw.transpose(0, 2, 3, 1))
    import torch
    import torch.nn.functional as F

    t = torch.from_numpy(np.ascontiguousarray(views_chw)).to(torch.float32)
    out = F.interpolate(t, size=(size, size), mode="bicubic", antialias=True)
    out = out.round().clamp(0, 255).to(torch.uint8).numpy()
    return np.ascontiguousarray(out.transpose(0, 2, 3, 1))


class GeneralDataset(_SplitDataset):
    """One Text2Shape split in RAM (caption map + per-model npz). Each
    unique model loads once (``_load_model``), over ``data.num_workers``
    threads when it is > 1: numpy's npz inflate and the C++ packing
    release the GIL, so the threads overlap. With a CLIP head, a model
    found in the split's CLIP cache carries its features; with the CLIP
    text head, captions are CLIP-tokenized (context 77), which needs the
    BPE merges file (``TRICOLO_CLIP_BPE``; FileNotFoundError here without
    it)."""

    def __init__(self, cfg, split: str):
        data = cfg.data
        if cfg.model.text_encoder == "CLIPTextEncoder":
            from ..clip.tokenizer import ClipTokenizer

            self.clip_tokenizer = ClipTokenizer()
        self.clip_cache = None
        if uses_clip(cfg):
            self.clip_cache = _load_clip_cache(
                os.path.join(data.exp_data_root_path, f"clip_embeddings_{split}"))
        self.data_cfg = data
        self.voxel_size = data.voxel_size
        max_tokens = data.get("max_tokens", 96)
        with open(data.get(f"{split}_lang_data_path")) as f:
            raw_rows = json.load(f)
        self.language_data = []
        keys: dict[tuple, None] = {}  # unique (category, model_id), in order
        for row in raw_rows:
            key = (row["category"], row["model_id"])
            tokens = np.zeros(max_tokens, np.int32)
            arr = np.asarray(row["tokens"], np.int32)[:max_tokens]
            tokens[: arr.shape[0]] = arr
            self.language_data.append(
                {
                    "model_id": row["model_id"],
                    "category": row["category"],
                    "tokens": tokens,
                    "text": row["caption"].strip(),
                }
            )
            keys.setdefault(key)
        workers = int(data.get("num_workers", 0) or 0)
        if workers > 1 and len(keys) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                entries = list(pool.map(self._load_model, keys))
        else:
            entries = [self._load_model(key) for key in keys]
        self.vision_data = dict(zip(keys, entries))
        self.max_voxel_points = _resolve_voxel_budget(cfg, self.vision_data, split)

    def _load_model(self, key: tuple) -> dict:
        """One model's packed voxels and resized views from its npz."""
        category, model_id = key
        data = self.data_cfg
        with np.load(os.path.join(data.exp_data_root_path, category, f"{model_id}.npz")) as npz:
            flat, rgb = dense_rgba_to_packed(npz[f"voxel{self.voxel_size}"])
            stored = npz["images"]
        sub = np.round(np.linspace(0, len(stored) - 1, data.num_views)).astype(int)
        entry = {"flat": flat, "rgb": rgb,
                 "images": _resize_views_bicubic(stored[sub], data.image_size)}
        if self.clip_cache is not None and model_id in self.clip_cache:
            entry["clip_embeddings_img"] = self.clip_cache[model_id]["img"]
            entry["clip_embeddings_text"] = self.clip_cache[model_id]["text"]
        return entry


class SyntheticDataset(_SplitDataset):
    """Deterministic random data in the GeneralDataset item contract —
    draw for draw the same numbers as ``tricolo_tpu``'s SyntheticDataset."""

    def __init__(self, cfg, split: str):
        data = cfg.data
        self.voxel_size = data.voxel_size
        max_tokens = data.get("max_tokens", 16)
        num_models = data.get("num_models", 12)
        captions_per_model = data.get("captions_per_model", 3)
        vocab = data.vocab_size
        rng = np.random.default_rng({"train": 0, "val": 1, "test": 2}.get(split, 3))
        clip = uses_clip(cfg)

        self.language_data = []
        self.vision_data = {}
        d = np.uint32(self.voxel_size)
        for m in range(num_models):
            model_id = f"{split}_model_{m:04d}"
            n_points = int(rng.integers(32, 256))
            sites = np.sort(
                rng.choice(self.voxel_size**3, size=n_points, replace=False)
            ).astype(np.uint32)
            x, y, z = sites // (d * d), (sites // d) % d, sites % d
            flat = (x * 256 + y) * 256 + z
            feats = rng.integers(0, 256, (n_points, 3), dtype=np.uint32)
            rgb = (
                feats[:, 0] | (feats[:, 1] << 8) | (feats[:, 2] << 16)
                | np.uint32(1 << 24)
            )
            images = rng.integers(
                0, 256,
                (data.num_views, data.image_size, data.image_size, 3),
                dtype=np.uint8,
            )
            entry = {"flat": flat.astype(np.uint32), "rgb": rgb.astype(np.uint32),
                     "images": images}
            if clip:  # the CLIP heads' stand-in features (captions keep int tokens)
                entry["clip_embeddings_img"] = rng.standard_normal(768).astype(np.float32)
                entry["clip_embeddings_text"] = rng.standard_normal(768).astype(np.float32)
            self.vision_data[("synthetic", model_id)] = entry
            for c in range(captions_per_model):
                length = int(rng.integers(4, max_tokens))
                tokens = np.zeros(max_tokens, dtype=np.int32)
                tokens[:length] = rng.integers(1, vocab, length)
                self.language_data.append(
                    {
                        "model_id": model_id,
                        "category": "synthetic",
                        "tokens": tokens,
                        "text": f"synthetic caption {m}-{c}",
                    }
                )
        self.max_voxel_points = _resolve_voxel_budget(cfg, self.vision_data, split)


from .structured import StructuredSyntheticDataset  # noqa: E402 (it subclasses _SplitDataset)

_DATASETS = {
    "Text2ShapeChairTable": GeneralDataset,
    "Text2ShapeC13": GeneralDataset,
    "GeneralDataset": GeneralDataset,
    "Synthetic": SyntheticDataset,
    "StructuredSynthetic": StructuredSyntheticDataset,
}


def build_dataset(cfg, split: str):
    """Resolve ``cfg.data.dataset`` by name."""
    name = cfg.data.dataset
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_DATASETS)}")
    return _DATASETS[name](cfg, split)

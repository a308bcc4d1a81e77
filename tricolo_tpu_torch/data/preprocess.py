"""Offline preprocessing pipeline (the reference's preprocess_all_data.py).

The port's copy of ``tricolo_tpu.data.preprocess``. Per split: (1) build
``{split}_map.json`` caption rows from the Text2Shape caption pickles + vocab
json; (2) render ``num_views`` views per OBJ (the software rasterizer of
``render.py``) as JPEGs; (3) pack per-model ``.npz`` files holding
voxel32/voxel64/voxel128 as (4, D, D, D) uint8 (decoded from the solid NRRD
archives) plus the views read back from the JPEGs as (V, 3, 224, 224)
uint8: the npz schema ``GeneralDataset`` reads, member for member the JAX
package's. Writing and reading the JPEGs needs Pillow, imported where it
is used.

Parallelism: a process pool over models (the reference's ``+cpu_workers``).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np

from . import nrrd
from .render import IMAGE_SIZE, render_one_obj

VOXEL_SIZES = (32, 64, 128)


def create_model_id_caption_mapping(
    caption_file_path: str,
    id_word_file_path: str,
    output_json_path: str,
    ignored_models: list[str],
) -> tuple:
    """Caption pickle + vocab json → `{split}_map.json` rows.

    Pickle schema (Text2Shape release): {"caption_tuples": [(token_ids,
    category, nrrd_filename), ...]}; vocab json holds "idx_to_word". Rows
    carry the detokenized caption (pad id 0 terminates) and the raw token
    ids; `{category}/{model_id}` entries in ``ignored_models`` are skipped
    (reference preprocess_all_data.py:16-41).
    """
    with open(caption_file_path, "rb") as f:
        caption_data = pickle.load(f)
    with open(id_word_file_path) as f:
        vocab = json.load(f)
    idx_to_word = vocab["idx_to_word"]
    ignored = set(ignored_models or [])

    rows = []
    seen_models: dict[tuple, bool] = {}
    for token_ids, category, nrrd_name in caption_data["caption_tuples"]:
        model_id = str(nrrd_name).split(".")[0]
        if f"{category}/{model_id}" in ignored:
            continue
        words = []
        for idx in token_ids:
            if idx == 0:  # pad terminates the caption
                break
            words.append(idx_to_word[str(int(idx))])
        rows.append(
            {
                "model_id": model_id,
                "category": category,
                "caption": " ".join(words).replace("\n", ""),
                "tokens": np.asarray(token_ids).tolist(),
            }
        )
        seen_models.setdefault((category, model_id), True)

    os.makedirs(os.path.dirname(output_json_path) or ".", exist_ok=True)
    with open(output_json_path, "w") as f:
        json.dump(rows, f, indent=2)
    return tuple(seen_models.keys())


def read_solid_voxels(data_root_path: str, model_id: str, voxel_size: int) -> np.ndarray:
    """Decode one solid-voxel NRRD grid (4, D, D, D) uint8 RGBA."""
    path = os.path.join(
        data_root_path,
        f"nrrd_256_filter_div_{voxel_size}_solid",
        model_id,
        f"{model_id}.nrrd",
    )
    grid, _ = nrrd.read(path)
    return np.ascontiguousarray(grid)


def pack_npz(
    category_model_id: tuple,
    data_root_path: str,
    img_root_path: str,
    output_root_path: str,
    num_views: int,
):
    """Write `exp_data/{category}/{model_id}.npz` with voxels + views."""
    from PIL import Image

    category, model_id = category_model_id
    os.makedirs(os.path.join(output_root_path, category), exist_ok=True)

    arrays = {
        f"voxel{size}": read_solid_voxels(data_root_path, model_id, size)
        for size in VOXEL_SIZES
    }
    views = np.empty((num_views, 3, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8)
    for i in range(num_views):
        img_path = os.path.join(img_root_path, category, model_id, f"{i}.jpg")
        views[i] = np.asarray(Image.open(img_path)).transpose(2, 0, 1)
    arrays["images"] = views

    np.savez_compressed(
        os.path.join(output_root_path, category, f"{model_id}.npz"), **arrays
    )


def _run_pool(fn, items, workers: int, desc: str):
    print(f"{desc} ({len(items)} models, {workers} workers)")
    if workers <= 1:
        for item in items:
            fn(item)
        return
    # spawn: the parent may hold threads (PyTorch's), which fork does not copy.
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        # Materialize to propagate worker exceptions.
        list(pool.map(fn, items, chunksize=1))


def preprocess_all(cfg, cpu_workers: int = 8, splits=("train", "val", "test")):
    """Full pipeline (reference preprocess_all_data.py:109-155)."""
    for split in splits:
        print(f"==> Processing {split} split ...")
        map_path = cfg.data.get(f"{split}_lang_data_path")

        if cfg.data.dataset == "Text2ShapeChairTable":
            models = create_model_id_caption_mapping(
                os.path.join(cfg.data.dataset_path, f"processed_captions_{split}.p"),
                os.path.join(cfg.data.dataset_path, "shapenet.json"),
                map_path,
                cfg.data.ignored_models,
            )
        else:
            # c13 ships its map jsons; collect unique models from them.
            with open(map_path) as f:
                rows = json.load(f)
            seen: dict[tuple, bool] = {}
            for row in rows:
                seen.setdefault((row["category"], row["model_id"]), True)
            models = tuple(seen.keys())

        img_root = os.path.join(cfg.data.dataset_path, "preprocessed", "multiview_imgs")
        shapenet_root = os.path.join(
            os.path.dirname(cfg.data.dataset_path), "ShapeNetCore.v2"
        )
        _run_pool(
            partial(
                render_one_obj,
                obj_model_root_path=shapenet_root,
                output_root_path=img_root,
                num_views=cfg.data.num_views,
            ),
            models,
            cpu_workers,
            "Render multi-view images",
        )
        _run_pool(
            partial(
                pack_npz,
                data_root_path=cfg.data.dataset_path,
                img_root_path=img_root,
                output_root_path=cfg.data.exp_data_root_path,
                num_views=cfg.data.num_views,
            ),
            models,
            cpu_workers,
            "Pack npz files",
        )

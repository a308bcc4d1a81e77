"""The CPU tests' tiny sizes."""

from __future__ import annotations

import copy

# Voxels 32³, views 2 of 64², batch 16, 32 distinct items an epoch of 64:
# big enough that ResNet18's BatchNorms see more than a handful of values.
TINY = {"model": {"voxel_size": 32, "image_size": 64, "num_views": 2},
        "train": {"batch_size": 16},
        "port": ["data.voxel_size=32", "data.image_size=64", "data.num_views=2"],
        "items": (32, 64)}


def tiny(dtype: str = "bfloat16") -> dict:
    out = copy.deepcopy(TINY)
    out["port"].append(f"precision.compute_dtype={dtype}")
    return out

"""Mesh-F1 CLI of the PyTorch port over a ``nearest.jsonl`` retrieval dump.

    python -m tricolo_tpu_torch.calculate_f1 \\
        +nearest_path=nearest.jsonl \\
        +val_map_path=data/text2shape-data/shapenet/preprocessed/exp_data/val_map.json \\
        +shapenet_root=data/text2shape-data/ShapeNetCore.v2 \\
        [+point_cache_dir=point_cache]

The twin of the JAX package's ``calculate_f1.py``, with the same keys and
defaults: prints the mean top-1 mesh F1@0.1 over the evaluable queries
(``evaluation/f1_mesh.py``). The nearest-neighbour search runs on the GPU;
``+device=cpu`` runs it on the CPU instead.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None):
    from .config import load_config
    from .evaluation.f1_mesh import run_f1_over_nearest

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    mean_f1 = run_f1_over_nearest(
        nearest_path=cfg.get("nearest_path", "nearest.jsonl"),
        val_map_path=cfg.get(
            "val_map_path",
            "data/text2shape-data/shapenet/preprocessed/exp_data/val_map.json",
        ),
        shapenet_root=cfg.get("shapenet_root", "data/text2shape-data/ShapeNetCore.v2"),
        cache_dir=cfg.get("point_cache_dir", "point_cache"),
        device=cfg.get("device", None),
    )
    print(mean_f1)
    return mean_f1


if __name__ == "__main__":
    main()

"""Preprocessing CLI of the PyTorch port.

    python -m tricolo_tpu_torch.preprocess data=text2shape_chair_table +cpu_workers=8

The twin of the JAX package's ``preprocess.py``, with the same flags:
builds the caption maps, renders the multi-view images (the software
rasterizer of ``data/render.py``) and packs the per-model npz files
(``data/preprocess.py``). Host-only (numpy), no GPU; writing and reading
the view JPEGs needs Pillow.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None):
    from .config import load_config
    from .data.preprocess import preprocess_all

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    preprocess_all(cfg, cpu_workers=int(cfg.get("cpu_workers", 8)))


if __name__ == "__main__":
    main()

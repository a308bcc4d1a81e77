"""CLIP feature-cache entry point of the PyTorch port.

    python -m tricolo_tpu_torch.extract_clip_feats data=text2shape_chair_table \\
        data.image_size=224 model.modules.clip_model=/path/to/clip-vit-large-patch14

The port's twin of the JAX package's ``extract_clip_feats.py``: it loads
the *local* HuggingFace CLIP checkpoint directory ``model.modules.clip_model``
(nothing is downloaded; none ships with the repository), tokenizes the
captions with the CLIP BPE (``TRICOLO_CLIP_BPE``), and writes
``clip_embeddings_{split}.npz`` for the train, val and test splits under
``data.exp_data_root_path``. CLIP runs on the host's CPU.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> list[str]:
    """Write the three caches; their paths."""
    from .clip.extract import TransformersClipBackend, extract_clip_features
    from .clip.tokenizer import ClipTokenizer
    from .config import load_config
    from .data import build_dataset

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg.data.image_size != 224:
        print("Error: Please set data.image_size to 224 for CLIP extraction.")
        raise SystemExit(0)
    backend = TransformersClipBackend(cfg.model.modules.clip_model)
    tokenizer = ClipTokenizer()
    paths = []
    for split in ("train", "val", "test"):
        out = os.path.join(cfg.data.exp_data_root_path, f"clip_embeddings_{split}.npz")
        extract_clip_features(build_dataset(cfg, split), backend, out, tokenizer=tokenizer)
        print(f"saved {out}")
        paths.append(out)
    return paths


if __name__ == "__main__":
    main()

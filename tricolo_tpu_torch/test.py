"""Test entry point of the PyTorch port.

    python -m tricolo_tpu_torch.test data=text2shape_chair_table \\
        experiment_name=tri model.voxel_encoder=VoxelCNNEncoder \\
        +ckpt_path=output/.../training/epoch=19.ckpt

Loads the checkpoint — the port's, a bare ``state_dict`` or the JAX
package's msgpack file — without the disabled encoders' entries, embeds
the ``inference.split`` split, prints "RR@1 RR@5 NDCG@5 MRR", writes
``nearest.jsonl`` in the CWD and ``output.p`` under
``inference.output_dir`` (the JAX package's pickle: either package's eval
CLI reads it). Runs on the GPU; ``+device=cpu`` runs on the CPU instead.
Under ``parallel.multiprocess=true`` (torchrun or the ``parallel.*`` rank
keys, as for the train CLI) every rank tests the whole split and rank 0
prints and writes.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None):
    import torch

    from .config import load_config, resolve_interpolations
    from .data import DataModule
    from .training import Trainer

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg.experiment_name is None:
        cfg.experiment_name = "default"
        resolve_interpolations(cfg)
    ckpt_path = cfg.get("ckpt_path", None)
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise AssertionError("Error: Checkpoint path does not exists.")
    os.makedirs(cfg.inference.output_dir, exist_ok=True)
    trainer = Trainer(cfg, device=cfg.get("device", None))
    try:
        return trainer.test(DataModule(cfg), ckpt_path)
    finally:
        if trainer.world is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

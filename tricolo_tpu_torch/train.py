"""Training entry point of the PyTorch port.

    python -m tricolo_tpu_torch.train data=text2shape_chair_table \\
        experiment_name=tri model.image_encoder=MVCNNEncoder \\
        model.voxel_encoder=VoxelCNNEncoder

Same override grammar as the JAX package's ``train.py`` (``a.b=v``
overrides, ``+a.b=v`` adds, ``data=<preset>`` selects the data group). Runs
on the GPU; ``+device=cpu`` runs on the CPU instead. Writes
``{experiment_output_path}/training/epoch={N}.pt`` (a ``torch.save``d
state_dict), which ``python -m tricolo_tpu_torch.serve +ckpt_path=...``
serves. Resuming (``ckpt_name``, ``+auto_resume``) is not ported yet.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> str:
    from .config import load_config, resolve_interpolations
    from .data import DataModule
    from .training import Trainer

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg.ckpt_name is not None or cfg.get("auto_resume", False):
        raise SystemExit("resuming a run is not ported yet (ckpt_name / +auto_resume)")
    if cfg.experiment_name is None:
        cfg.experiment_name = "default"
        resolve_interpolations(cfg)
    os.makedirs(cfg.experiment_output_path, exist_ok=True)

    trainer = Trainer(cfg, device=cfg.get("device", None))
    path = trainer.fit(DataModule(cfg))
    print(f"checkpoint: {path}")
    return path


if __name__ == "__main__":
    main()

"""Training entry point of the PyTorch port.

    python -m tricolo_tpu_torch.train data=text2shape_chair_table \\
        experiment_name=tri model.image_encoder=MVCNNEncoder \\
        model.voxel_encoder=VoxelCNNEncoder

Same override grammar as the JAX package's ``train.py`` (``a.b=v``
overrides, ``+a.b=v`` adds, ``data=<preset>`` selects the data group). Runs
on the GPU; ``+device=cpu`` runs on the CPU instead. Checkpoints land in
``{experiment_output_path}/training`` (``epoch=N.ckpt`` top-k by
``checkpoint_monitor``, ``last.ckpt``, ``checkpoints.json``), the metrics
log in ``metrics.jsonl`` beside them. ``ckpt_name=<file>`` resumes from
that file of the training dir; ``+auto_resume=true`` from its newest
``epoch=N.ckpt``, or starts afresh when there is none.

The CLIP-head configurations train over precached CLIP features
(``python -m tricolo_tpu_torch.extract_clip_feats``):

    python -m tricolo_tpu_torch.train data=text2shape_chair_table \
        experiment_name=clip model.text_encoder=CLIPTextEncoder \
        model.image_encoder=CLIPImageEncoder \
        model.voxel_encoder=VoxelCNNEncoder data.image_size=224

As in the reference, ``CLIPImageEncoder`` needs ``data.image_size=224``.

Data parallel, one process per GPU, ``data.batch_size`` the global batch:

    torchrun --nproc_per_node=4 -m tricolo_tpu_torch.train <overrides> \
        parallel.multiprocess=true

or, without torchrun, the rank triple as keys in each of N processes:
``parallel.multiprocess=true parallel.coordinator_address=host:port
parallel.num_processes=N parallel.process_id=<rank>``. Rank 0 writes the
checkpoints and the metrics log.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> str | None:
    """Train; the best checkpoint's path (the last save's when top-k
    saving is off, None when nothing was saved or on a rank other than 0)."""
    import torch

    from .config import load_config, resolve_interpolations
    from .data import DataModule
    from .training import Trainer
    from .training.checkpoint import latest_checkpoint

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg.model.image_encoder == "CLIPImageEncoder" and cfg.data.image_size != 224:
        print("Error: Please set data.image_size to 224 when using CLIPImageEncoder.")
        raise SystemExit(0)
    if cfg.experiment_name is None:
        cfg.experiment_name = "default"
        resolve_interpolations(cfg)
    os.makedirs(cfg.experiment_output_path, exist_ok=True)

    training_dir = os.path.join(cfg.experiment_output_path, "training")
    ckpt_path = None
    if cfg.ckpt_name is not None:
        ckpt_path = os.path.join(training_dir, cfg.ckpt_name)
        if not os.path.exists(ckpt_path):
            raise AssertionError("Error: Checkpoint path does not exists.")
    elif cfg.get("auto_resume", False):
        ckpt_path = latest_checkpoint(training_dir)
        if ckpt_path:
            print(f"auto_resume: resuming from {ckpt_path}")

    trainer = Trainer(cfg, device=cfg.get("device", None))
    try:
        manager = trainer.fit(DataModule(cfg), resume_ckpt=ckpt_path)
    finally:
        if trainer.world is not None:
            torch.distributed.destroy_process_group()
    if not trainer.is_main:
        return None
    path = manager.best_path
    if path is None and manager.save_last:
        path = os.path.join(manager.dirpath, "last.ckpt")
    print(f"checkpoint: {path}")
    return path


if __name__ == "__main__":
    main()

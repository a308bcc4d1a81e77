"""Host-side training orchestration.

Port of ``tricolo_tpu.training.Trainer.fit``: the epoch loop over the train
step (``lr_for_epoch``, then ``set_epoch``, then the steps), validation on
the JAX cadence (every ``trainer.check_val_every_n_epoch`` epochs and after
the last) with the retrieval metrics printed as ``epoch N: RR@1=… …``, and
at the end one checkpoint: ``torch.save`` of the model's state_dict as
``{checkpoint_monitor.dirpath}/epoch={N}.pt``, the format
``RetrievalServer.from_checkpoint`` reads — so training feeds serving.

With ``model.modules.MVCNNEncoder.pretrained_path`` set, the image
backbone starts from that ``save_pretrained`` npz instead of its random
init, as in the JAX ``Trainer.init_state``.

Before the first epoch, ``_check_tile_budget`` warns when the first
train batch holds more active tiles than the static tile budget of the
device-side compactions (the dense-input plan, the full windowed transfer)
— those batches lose their highest tiles.

Not ported yet: top-k checkpoint retention, async saves, resume, the
metrics logger and validation losses.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

from ..convert import jax_to_torch
from ..evaluation import compute_metrics
from ..inference import collect_embeddings, resolve_device, to_device_batch
from ..models.resnet import load_pretrained
from ..models.tricolo_net import TriCoLoNet
from ..ops.tile_sparse import host_tile_count, tile_budget
from .optim import lr_for_epoch, make_optimizer
from .steps import make_train_step


class Trainer:
    """``Trainer(cfg, device=None).fit(data_module)`` → checkpoint path.

    Runs on ``cuda`` unless ``device`` names another device; raises without
    a GPU unless asked for the CPU. Weights are initialised from
    ``cfg.train_seed``. ``train_step`` is the step function ``fit`` calls
    (``step(device_batch, lr) -> loss_dict``); ``metrics`` holds the last
    validation's retrieval metrics.
    """

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        torch.manual_seed(cfg.train_seed)
        self.model = TriCoLoNet.from_config(cfg).to(self.device)
        self._graft_pretrained_backbone()
        self.optimizer = make_optimizer(cfg, self.model)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)
        self.metrics = None
        self._timers: dict[str, float] = defaultdict(float)

    def _graft_pretrained_backbone(self) -> None:
        """Copy the ``pretrained_path`` npz over the image backbone (the JAX
        trainer's ``_graft_pretrained_backbone``): names and layouts through
        ``convert.jax_to_torch``, values in the backbone's dtype. A key the
        backbone lacks raises KeyError, a shape mismatch ValueError."""
        path = self.cfg.model.modules.MVCNNEncoder.get("pretrained_path")
        if not path or self.cfg.model.image_encoder != "MVCNNEncoder":
            return
        params, stats = load_pretrained(path)
        converted = jax_to_torch({"image_encoder": {"backbone": params}},
                                 {"image_encoder": {"backbone": stats}})
        target = self.model.state_dict()
        with torch.no_grad():
            for key, value in converted.items():
                if key.endswith("num_batches_tracked"):  # not in the file
                    continue
                if key not in target:
                    raise KeyError(f"pretrained key {key!r} not in model")
                if target[key].shape != value.shape:
                    raise ValueError(f"pretrained {key} shape {tuple(value.shape)} != model "
                                     f"{tuple(target[key].shape)}")
                target[key].copy_(value.to(target[key].dtype))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_tile_budget(self, loader) -> None:
        """Warn when the tile-sparse budget looks too small for the data.

        The dense-input plan and the full windowed transfer keep at most
        ``tile_budget(tile_budget_frac, B, tg³)`` active tiles a batch and
        drop the highest-index ones past it; one real batch's exact tile
        count is a cheap canary. windowed_compact is the loader's concern
        (``tile_budget=auto`` cannot truncate; an explicit budget follows
        ``data.tile_overflow``), and its batches fall through here."""
        cfg = self.cfg
        voxel_cfg = cfg.model.modules.VoxelCNNEncoder
        transfer = str(cfg.data.get("voxel_transfer", "windowed_compact"))
        windowed = transfer.startswith("windowed")
        if cfg.model.voxel_encoder is None or not voxel_cfg.get("masked_bn", False):
            return
        if not (voxel_cfg.get("tile_sparse", False) or windowed) or transfer == "windowed_compact":
            return
        sample = loader.peek()
        voxel_size = cfg.data.voxel_size
        tg = voxel_size // 8
        if "voxel_tile_occ" in sample:
            batch = sample["voxel_tile_occ"].shape[0] // tg**3
            need = int(np.asarray(sample["voxel_tile_occ"]).sum())
        elif "voxel_flat" in sample:
            batch = len(sample["voxel_flat"])
            need = host_tile_count(sample["voxel_flat"], voxel_size)
        elif "voxel_grid" in sample:
            grid = np.asarray(sample["voxel_grid"])
            batch = grid.shape[0]
            tiled = grid.reshape(batch, tg, 8, tg, 8, tg, 8)
            need = int(np.any(tiled != 0, axis=(2, 4, 6)).sum())
        else:
            return
        frac = float(voxel_cfg.get("tile_budget_frac", 0.5))
        budget = tile_budget(frac, batch, tg**3)
        if need > budget:
            warnings.warn(
                f"tile_sparse budget {budget} (tile_budget_frac={frac}) is smaller "
                f"than the {need} active tiles in the first batch — highest-index "
                "tiles will be dropped. Raise model.modules.VoxelCNNEncoder."
                "tile_budget_frac.",
                stacklevel=2,
            )

    def fit(self, data_module) -> str:
        cfg = self.cfg
        np.random.seed(cfg.train_seed)
        tic = time.perf_counter()
        data_module.setup("fit")
        self._timers["data_load"] += time.perf_counter() - tic
        train_loader = data_module.train_loader()
        val_loader = data_module.val_loader()
        self._check_tile_budget(train_loader)
        val_every = cfg.trainer.check_val_every_n_epoch
        last = cfg.trainer.max_epochs - 1
        for epoch in range(cfg.trainer.max_epochs):
            lr = lr_for_epoch(cfg, epoch)
            train_loader.set_epoch(epoch)
            tic = time.perf_counter()
            for batch in train_loader:
                self.train_step(to_device_batch(batch, self.device), lr)
            self._sync()
            self._timers["train"] += time.perf_counter() - tic

            if (epoch + 1) % val_every == 0 or epoch == last:
                tic = time.perf_counter()
                embeddings = collect_embeddings(self.model, val_loader, self.device)
                self.metrics = compute_metrics(embeddings, nearest_path=None)
                summary = self.metrics.summary("val_eval/")
                print(f"epoch {epoch}: " + " ".join(
                    f"{k.split('/')[-1]}={v:.2f}" for k, v in summary.items()))
                self._timers["validate"] += time.perf_counter() - tic

        tic = time.perf_counter()
        ckpt_dir = cfg.checkpoint_monitor.dirpath
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"epoch={last}.pt")
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, path)
        self._timers["checkpoint"] += time.perf_counter() - tic

        if cfg.trainer.profiler == "simple":
            total = sum(self._timers.values()) or 1.0
            print("\nProfiler (simple) — wall clock by phase:")
            for phase, seconds in sorted(self._timers.items(), key=lambda kv: -kv[1]):
                print(f"  {phase:<12} {seconds:8.2f}s  {100 * seconds / total:5.1f}%")
        return path

"""Host-side training orchestration: fit, resume, test.

Port of ``tricolo_tpu.training.Trainer``:

* ``fit(data_module, resume_ckpt=None)`` — the epoch loop over the train
  step (``lr_for_epoch``, ``set_epoch``, the steps; on CUDA the loaders
  pin their batches for ``non_blocking`` copies) with a metrics-logger
  row (train losses and ``lr``) every ``trainer.log_every_n_steps`` steps;
  validation every ``trainer.check_val_every_n_epoch`` epochs and after the
  last, printed as ``epoch N: RR@1=… …`` and logged as ``val_eval/*`` plus
  the ``val_loss/*`` losses; a ``CheckpointManager`` save on
  ``checkpoint_monitor.every_n_epochs`` when validation has just run (on
  the async writer with ``checkpoint_monitor.async_save``, flushed before
  ``fit`` returns). Returns the manager (``best_path``).
* ``load_state(path, for_inference=False)`` — any checkpoint
  ``checkpoint.load_checkpoint`` reads; resuming restores the weights, BN
  statistics, Adam moments and step, and ``fit`` continues at epoch + 1.
* ``test(data_module, ckpt_path)`` — the reference test path: the pruned
  load, the split's embeddings, the metrics printed with ``nearest.jsonl``
  in the CWD, and ``output.p`` (the JAX package's pickle) under
  ``inference.output_dir``.

``trainer.profiler=xplane`` wraps the epochs in a ``torch.profiler``
trace written under ``{logger.save_dir}/xplane``, as the JAX package's
``profile_trace`` does with ``jax.profiler``; the file is PyTorch's own
Chrome trace (``*.pt.trace.json``, for Perfetto or chrome://tracing), not
an XPlane protobuf, with the port's spans (``tracing``: the fit's phases,
the loader's prefetch thread, the copy, each step's forward, loss,
backward and optimizer) merged into it on its clock.

Under ``parallel.multiprocess=true`` (``tricolo_tpu_torch.parallel``)
every rank runs this loop on its stripe of each global batch, with the
process group brought up before the model is placed, parameters checked
equal across ranks, then placed by ``parallel.param_sharding``
(``parallel.shard_model``: replicated, or FSDP shards), and the step of
``make_train_step(world=...)``. Under FSDP the checkpoints hold full
tensors (``state`` gathers them; ``load_state`` keeps each rank's shard),
so a file is a replicated run's and resumes under either mode. Rank 0
alone owns ``metrics.jsonl``, the checkpoints, the async writer, the trace
and the printed lines; the other ranks run the same loop with null sinks.
Validation is process-local (every rank embeds the whole split in eval
mode, no collectives), and a resume loads the same checkpoint on every
rank. The dense-input plan's tile budget is reckoned from the local batch,
so a 2-rank run equals one process where no rank truncates.

With ``model.modules.MVCNNEncoder.pretrained_path`` set, the image
backbone starts from that ``save_pretrained`` npz instead of its random
init, as in the JAX ``Trainer.init_state``. Before the first epoch,
``_check_tile_budget`` warns when the first train batch holds more active
tiles than the static tile budget of the device-side compactions (the
dense-input plan, the full windowed transfer).
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

from .. import tracing
from ..convert import jax_to_torch
from ..evaluation import compute_metrics, compute_metrics_on_device, write_nearest_info
from ..inference import collect_embeddings, resolve_device, to_device_batch
from ..losses import make_loss_fn
from ..models.resnet import load_pretrained
from ..models.tricolo_net import TriCoLoNet
from ..ops.tile_sparse import host_tile_count, tile_budget
from ..parallel import (
    attach,
    broadcast_state,
    check_parallel_config,
    default_device,
    maybe_initialize,
    shard_model,
)
from ..parallel.sharding_rules import gathered, placed_like
from .checkpoint import (
    AsyncCheckpointWriter,
    CheckpointManager,
    load_checkpoint,
    prune_disabled_encoders,
)
from .logger import MetricsLogger
from .optim import lr_for_epoch, make_optimizer
from .steps import dropout_generator, make_train_step


@contextlib.contextmanager
def profile_trace(log_dir: str | None, device: torch.device, name: str = "fit",
                  spans: bool = True):
    """A ``torch.profiler`` trace of the block (host, and the card on CUDA)
    exported as a Chrome trace ``{name}.<ns>.pt.trace.json`` under
    ``log_dir``; a no-op without one. With ``spans``, tracing is on for the
    block and the port's spans of every thread are merged into the trace
    (``tracing.merge_into``); without, the block runs as it is."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    if not spans:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.{time.time_ns()}.pt.trace.json"))
        return
    was_on = tracing.enabled()
    if not was_on:  # on already: keep its level
        tracing.enable()
    try:
        with profile(activities=activities) as prof:
            tracing.anchor()
            yield
    finally:
        if not was_on:
            tracing.disable()
    path = os.path.join(log_dir, f"{name}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    tracing.merge_into(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
    if not was_on:
        tracing.clear()


class _NullLogger:
    """Metrics sink of the ranks other than 0: no files."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class _NullManager:
    """Checkpoint sink of the ranks other than 0 (rank 0 owns the files)."""

    best_path = None

    def save(self, *args, **kwargs) -> None:
        pass

    def wait(self) -> None:
        pass


class Trainer:
    """``Trainer(cfg, device=None).fit(data_module)`` → ``CheckpointManager``.

    Runs on ``cuda`` unless ``device`` names another device; raises without
    a GPU unless asked for the CPU. Under ``parallel.multiprocess`` the
    default device is the rank's GPU (``parallel.default_device``) and
    ``backend`` may override the process group's (NCCL on CUDA, gloo on
    the CPU); ``world`` is the rank's ``parallel.World`` (None in one
    process) and ``is_main`` whether it is rank 0. Weights are initialised
    from ``cfg.train_seed``. ``train_step`` is the step function ``fit`` calls
    (``step(device_batch, lr, generator) -> loss_dict``, the generator from
    ``dropout_generator(train_seed, step)``); ``step`` counts the steps
    taken; ``metrics`` holds the last validation's retrieval metrics;
    ``timers`` the seconds ``fit`` spent by phase (``data_load``, ``train``
    — loader iteration and steps —, ``validate``, ``checkpoint``), the
    lengths of its ``fit.<phase>`` spans (``tracing``; timed whether
    tracing is on or not), printed after the fit with
    ``trainer.profiler=simple``. ``trainer.profiler=xplane`` turns tracing
    on for the fit and writes its spans into the trace (``profile_trace``).
    """

    def __init__(self, cfg, device=None, backend: str | None = None):
        self.cfg = cfg
        self.device = resolve_device(default_device(cfg, device))
        self.world = maybe_initialize(cfg, self.device, backend=backend)
        check_parallel_config(cfg, self.world)
        self.is_main = self.world is None or self.world.rank == 0
        torch.manual_seed(cfg.train_seed)
        self.model = TriCoLoNet.from_config(cfg).to(self.device)
        self._graft_pretrained_backbone()
        if self.world is not None:
            attach(self.model, self.world)
            broadcast_state(self.model, self.world)  # compares full tensors: before sharding
        shard_model(self.model, self.world, cfg.parallel.get("param_sharding", "replicated"))
        self.optimizer = make_optimizer(cfg, self.model)
        self.train_step = make_train_step(self.model, self.optimizer, cfg, world=self.world)
        self.val_loss = make_loss_fn(cfg)
        self.step = 0
        self.metrics = None
        self.phase_s: dict[str, float] = defaultdict(float)

    @property
    def timers(self) -> dict[str, float]:
        """Seconds by phase of ``fit``, from its ``fit.<phase>`` spans."""
        return {name.removeprefix("fit."): s for name, s in self.phase_s.items()}

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

    # -- state ------------------------------------------------------------

    def state(self) -> dict:
        """The live train state a checkpoint holds: ``{"model", "optimizer",
        "step"}`` (the state_dicts share the tensors the steps update).
        Under FSDP each sharded tensor is gathered whole, a collective that
        every rank makes here in the same order, so the state is, key for
        key and dtype for dtype, a replicated run's."""
        return {"model": gathered(self.model.state_dict()),
                "optimizer": gathered(self.optimizer.state_dict()), "step": self.step}

    def load_state(self, ckpt_path: str, for_inference: bool = False) -> int | None:
        """Restore a checkpoint of any format ``load_checkpoint`` reads; the
        saved epoch. ``for_inference`` loads the weights alone, without the
        disabled encoders' entries; otherwise the Adam moments and the step
        come back too, and a weights-only file raises ValueError."""
        names = [name for name, _ in self.model.named_parameters()]
        payload = load_checkpoint(ckpt_path, None if for_inference else names)
        state_dict = payload["model"]
        if for_inference:
            state_dict = prune_disabled_encoders(state_dict, self.cfg)
        live = self.model.state_dict()  # under FSDP, each rank keeps its shard
        self.model.load_state_dict({k: placed_like(v, live[k]) if k in live else v
                                    for k, v in state_dict.items()})
        if not for_inference:
            if payload["epoch"] is None:
                raise ValueError(f"{ckpt_path} holds weights only; it cannot resume a run")
            state = payload["optimizer"]["state"] if payload["optimizer"] else {}
            params = [p for group in self.optimizer.param_groups for p in group["params"]]
            state = {i: {k: placed_like(v, params[i]) if k != "step" else v
                         for k, v in entry.items()} for i, entry in state.items()}
            self.optimizer.load_state_dict(
                {"state": state, "param_groups": self.optimizer.state_dict()["param_groups"]})
            self.step = int(payload["step"])
        return payload["epoch"]

    # -- fit --------------------------------------------------------------

    def fit(self, data_module, resume_ckpt: str | None = None) -> CheckpointManager:
        cfg = self.cfg
        np.random.seed(cfg.train_seed)
        with tracing.span("fit.data_load", totals=self.phase_s):
            data_module.setup("fit")
        pin = self.device.type == "cuda"  # non_blocking copies from pinned batches
        train_loader = data_module.train_loader(pin_memory=pin)
        val_loader = data_module.val_loader(pin_memory=pin)

        monitor = cfg.checkpoint_monitor
        writer = None
        manager = _NullManager()
        if self.is_main:
            writer = AsyncCheckpointWriter() if monitor.get("async_save", False) else None
            manager = CheckpointManager(monitor.dirpath, monitor=monitor.monitor,
                                        mode=monitor.mode, save_top_k=monitor.save_top_k,
                                        save_last=bool(monitor.get("save_last", False)),
                                        writer=writer)
        start_epoch = 0
        if resume_ckpt is not None:
            start_epoch = self.load_state(resume_ckpt) + 1
        self._check_tile_budget(train_loader)
        logger = MetricsLogger(cfg) if self.is_main else _NullLogger()
        try:
            trace = cfg.trainer.profiler == "xplane" and self.is_main
            with profile_trace(os.path.join(logger.save_dir, "xplane") if trace else None,
                               self.device):
                self._fit_epochs(train_loader, val_loader, logger, manager, start_epoch)
            with tracing.span("fit.checkpoint", totals=self.phase_s):
                manager.wait()  # the async writes land before fit returns
        finally:
            if writer is not None:
                writer.close()
                manager.writer = None  # later saves by the caller run synchronously
            logger.close()

        if cfg.trainer.profiler == "simple" and self.is_main:
            total = sum(self.timers.values()) or 1.0
            print("\nProfiler (simple) — wall clock by phase:")
            for phase, seconds in sorted(self.timers.items(), key=lambda kv: -kv[1]):
                print(f"  {phase:<12} {seconds:8.2f}s  {100 * seconds / total:5.1f}%")
        return manager

    def _fit_epochs(self, train_loader, val_loader, logger, manager, start_epoch: int) -> None:
        cfg = self.cfg
        log_every = cfg.trainer.log_every_n_steps
        val_every = cfg.trainer.check_val_every_n_epoch
        # Saving needs a fresh monitored metric, so it happens only on
        # validation epochs: a cadence more frequent than validation
        # degenerates to it, a sparser one skips validation epochs; 0/null
        # falls back to the validation cadence.
        ckpt_every = cfg.checkpoint_monitor.get("every_n_epochs", None) or val_every
        last = cfg.trainer.max_epochs - 1
        for epoch in range(start_epoch, cfg.trainer.max_epochs):
            lr = lr_for_epoch(cfg, epoch)
            train_loader.set_epoch(epoch)
            with tracing.span("fit.train", totals=self.phase_s):
                for batch in train_loader:
                    tracing.set_step(self.step)
                    loss_dict = self.train_step(
                        to_device_batch(batch, self.device), lr,
                        dropout_generator(cfg.train_seed, self.step, self.device))
                    self.step += 1
                    if self.step % log_every == 0:
                        logger.log({**{k: float(v) for k, v in loss_dict.items()}, "lr": lr},
                                   self.step, epoch)
                self._sync()

            if (epoch + 1) % val_every == 0 or epoch == last:
                with tracing.span("fit.validate", totals=self.phase_s):
                    embeddings, val_losses = collect_embeddings(
                        self.model, val_loader, self.device, loss_fn=self.val_loss)
                    nearest = (os.path.join(logger.save_dir, "nearest.jsonl") if self.is_main
                               else None)
                    self.metrics = self._run_retrieval_eval(embeddings, nearest_path=nearest)
                    summary = self.metrics.summary("val_eval/")
                    logger.log({**summary, **val_losses}, self.step, epoch)
                    if self.is_main:
                        print(f"epoch {epoch}: " + " ".join(
                            f"{k.split('/')[-1]}={v:.2f}" for k, v in summary.items()))

                if (epoch + 1) % ckpt_every == 0 or epoch == last:
                    with tracing.span("fit.checkpoint", totals=self.phase_s):
                        manager.save(self.state(), epoch, {**summary, **val_losses})

    # -- evaluation -------------------------------------------------------

    def _run_retrieval_eval(self, embeddings: dict, nearest_path: str | None,
                            print_results: bool = False):
        """The numpy pipeline, or with ``inference.device_eval`` its twin on
        the trainer's device."""
        if not self.cfg.inference.get("device_eval", False):
            return compute_metrics(embeddings, nearest_path=nearest_path,
                                   print_results=print_results)
        metrics, top_k, top_sims, label_to_model_id = compute_metrics_on_device(
            embeddings, self.device)
        if nearest_path:
            write_nearest_info(embeddings["caption_embedding_tuples"], top_k, top_sims,
                               label_to_model_id, path=nearest_path)
        if print_results:
            metrics.print_results()
        return metrics

    def test(self, data_module, ckpt_path: str):
        """The reference test path: load → embed the split → metrics →
        artifacts. Returns the metrics (None without
        ``inference.evaluate``). Every rank of a multi-process world tests
        the whole split; rank 0 alone prints and writes the artifacts."""
        cfg = self.cfg
        np.random.seed(cfg.test_seed)
        data_module.setup("test")
        loader = data_module.test_loader(pin_memory=self.device.type == "cuda")
        self.load_state(ckpt_path, for_inference=True)
        embeddings, _ = collect_embeddings(self.model, loader, self.device)
        metrics = None
        if cfg.inference.evaluate:
            # nearest.jsonl lands in the CWD, as upstream writes it.
            metrics = self._run_retrieval_eval(
                embeddings, nearest_path="nearest.jsonl" if self.is_main else None,
                print_results=self.is_main)
        if cfg.inference.save_predictions and self.is_main:
            os.makedirs(cfg.inference.output_dir, exist_ok=True)
            out_path = os.path.join(cfg.inference.output_dir, "output.p")
            with open(out_path, "wb") as f:
                pickle.dump(embeddings, f)
            print(f"\nPredictions saved at {out_path}")
        return metrics

"""Checkpoints: one ``torch.save`` file a save, top-k retention by a metric.

Port of ``tricolo_tpu.training.checkpoint``, with its file names and its
retention semantics (Lightning's ModelCheckpoint as the reference
configures it: monitor ``val_eval/RR@5``, mode max, top 3, every 2 epochs):

* ``save_checkpoint`` writes ``{"model": state_dict, "optimizer":
  optimizer.state_dict(), "step", "epoch", "extra": {"metrics": …}}`` to a
  temp file and ``os.replace``\\ s it, so a preemption never leaves a
  truncated ``epoch=N.ckpt``;
* ``CheckpointManager`` keeps the top ``save_top_k`` by ``monitor``
  (0 disables, −1 keeps all), ``last.ckpt`` with ``save_last``, and the
  ``checkpoints.json`` index; ``AsyncCheckpointWriter`` runs its file
  effects on one ordered worker thread, from a ``snapshot_state`` clone
  taken on the device (``optimizer.step()`` updates the live tensors in
  place, as JAX's donation reuses its buffers);
* ``load_checkpoint`` reads the port's payload, a bare ``state_dict``
  (``torch.save(model.state_dict())``) and the JAX package's msgpack
  checkpoints, telling them apart by content: a torch zip starts with
  ``PK``, a flax file with a msgpack map.
"""

from __future__ import annotations

import json
import os
import queue
import threading

import torch

from ..convert import jax_checkpoint_to_torch
from .jax_checkpoint import is_msgpack_map, load_jax_checkpoint

__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointManager",
    "latest_checkpoint",
    "load_checkpoint",
    "prune_disabled_encoders",
    "save_checkpoint",
    "snapshot_state",
]


def _map_tensors(node, fn):
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {key: _map_tensors(value, fn) for key, value in node.items()}
    if isinstance(node, list):
        return [_map_tensors(value, fn) for value in node]
    return node


def snapshot_state(state: dict) -> dict:
    """Device-side clone of a train state (``{"model", "optimizer",
    "step"}``) for an async save: the worker thread then reads the clone
    while the next steps update the live tensors."""
    return _map_tensors(state, torch.clone)


class AsyncCheckpointWriter:
    """One ordered worker thread for checkpoint filesystem effects.

    The training loop submits closures (copy to host and write, stale-file
    removal, index update) and continues; the worker runs them in
    submission order, so top-k retention is the synchronous path's. An
    exception is kept and raised again on the next ``submit`` or ``wait``,
    so a full disk fails the run instead of dropping checkpoints.
    """

    def __init__(self):
        self._queue: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._queue.get()
            if fn is None:
                self._queue.task_done()
                return
            try:
                if self._error is None:
                    fn()
            except BaseException as e:  # noqa: BLE001 — raised again on submit/wait
                self._error = e
            finally:
                self._queue.task_done()

    def _check(self):
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from error

    def submit(self, fn):
        self._check()
        self._queue.put(fn)

    def wait(self):
        """Block until every submitted write has completed; re-raise errors."""
        self._queue.join()
        self._check()

    def close(self):
        self.wait()
        self._queue.put(None)
        self._thread.join()


def save_checkpoint(path: str, state: dict, epoch: int, extra: dict | None = None) -> None:
    """Write a train state (``{"model", "optimizer", "step"}``) and its
    epoch to ``path`` atomically (temp file, then ``os.replace``)."""
    payload = {
        "model": _map_tensors(state["model"], lambda t: t.detach().cpu()),
        "optimizer": _map_tensors(state["optimizer"], lambda t: t.detach().cpu()),
        "step": int(state["step"]),
        "epoch": int(epoch),
        "extra": extra or {},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, param_names: list[str] | None = None) -> dict:
    """Any checkpoint the port reads → ``{"model", "optimizer", "step",
    "epoch", "extra"}`` on the CPU.

    A port payload comes back as saved; a bare state_dict with
    ``optimizer``, ``step`` and ``epoch`` None; a JAX checkpoint through
    ``convert.jax_checkpoint_to_torch`` (its Adam moments only with
    ``param_names``, the optimizer's parameter order)."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj.get("model"), dict):
            return obj
        return {"model": obj, "optimizer": None, "step": None, "epoch": None, "extra": {}}
    if is_msgpack_map(head):
        return jax_checkpoint_to_torch(load_jax_checkpoint(path), param_names)
    raise ValueError(f"{path}: neither a torch checkpoint nor a JAX (msgpack) checkpoint")


def prune_disabled_encoders(state_dict: dict, cfg) -> dict:
    """Drop the ``image_encoder.`` / ``voxel_encoder.`` entries of encoders
    the config turns off, before a test-time load (reference test.py:20-28)."""
    dropped = [name for name, kind in (("image_encoder.", cfg.model.image_encoder),
                                       ("voxel_encoder.", cfg.model.voxel_encoder))
               if kind is None]
    return {k: v for k, v in state_dict.items() if not k.startswith(tuple(dropped))}


def latest_checkpoint(dirpath: str) -> str | None:
    """Newest surviving ``epoch=N.ckpt`` in a training dir, or None — what
    ``+auto_resume=true`` resumes from. Top-k retention may have deleted
    the newest save; resuming from the newest survivor retrains the epochs
    since, which is always correct."""
    if not os.path.isdir(dirpath):
        return None
    best: tuple[int, str] | None = None
    for name in os.listdir(dirpath):
        if name.startswith("epoch=") and name.endswith(".ckpt"):
            try:
                epoch = int(name[len("epoch="):-len(".ckpt")])
            except ValueError:
                continue
            if best is None or epoch > best[0]:
                best = (epoch, name)
    return os.path.join(dirpath, best[1]) if best else None


class CheckpointManager:
    """Top-k retention by a monitored metric (mode max or min)."""

    def __init__(self, dirpath: str, monitor: str = "val_eval/RR@5", mode: str = "max",
                 save_top_k: int = 3, save_last: bool = False,
                 writer: AsyncCheckpointWriter | None = None):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.writer = writer
        self._index_path = os.path.join(dirpath, "checkpoints.json")
        self._entries: list[dict] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._entries = json.load(f)["entries"]

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def _effect(self, fn):
        """Run a filesystem effect inline, or enqueue it on the writer.
        Retention decisions are made here, from host-side scores; only the
        effects are deferred, in order, so async and sync runs leave the
        same directory."""
        if self.writer is None:
            fn()
        else:
            self.writer.submit(fn)

    def wait(self):
        """Flush pending async writes (nothing to do when synchronous)."""
        if self.writer is not None:
            self.writer.wait()

    def save(self, state: dict, epoch: int, metrics: dict[str, float]) -> str | None:
        """Save if the monitored score makes the top-k; the path or None.

        ``save_top_k`` 0 disables top-k saving and −1 keeps all;
        ``save_last`` also rewrites ``last.ckpt`` at every save
        opportunity, outside the top-k set."""
        # With a writer, snapshot once and only if something is written;
        # the clone is taken before save() returns.
        snapshot = [state if self.writer is None else None]

        def snap():
            if snapshot[0] is None:
                snapshot[0] = snapshot_state(state)
            return snapshot[0]

        if self.save_last:
            last_path = os.path.join(self.dirpath, "last.ckpt")
            self._effect(lambda s=snap(): save_checkpoint(last_path, s, epoch,
                                                          extra={"metrics": metrics}))
        if self.save_top_k == 0:
            return None
        if self.monitor not in metrics:
            raise KeyError(
                f"checkpoint monitor {self.monitor!r} not among logged metrics "
                f"{sorted(metrics)} — set checkpoint_monitor.monitor to one of these")
        score = float(metrics[self.monitor])
        if 0 < self.save_top_k <= len(self._entries):
            worst = min if self.mode == "max" else max
            if not self._better(score, worst(self._entries, key=lambda e: e["score"])["score"]):
                return None

        path = os.path.join(self.dirpath, f"epoch={epoch}.ckpt")
        self._effect(lambda s=snap(): save_checkpoint(path, s, epoch, extra={"metrics": metrics}))
        self._entries = [e for e in self._entries if e["path"] != path]
        self._entries.append({"path": path, "score": score, "epoch": epoch})
        # Best first, so best_path is right in either mode.
        self._entries.sort(key=lambda e: e["score"], reverse=self.mode == "max")
        if self.save_top_k > 0:
            stale_paths = [e["path"] for e in self._entries[self.save_top_k:]]

            def prune(paths=stale_paths):
                for stale in paths:
                    if os.path.exists(stale):
                        os.remove(stale)

            self._effect(prune)
            self._entries = self._entries[: self.save_top_k]

        index_payload = {"monitor": self.monitor, "entries": list(self._entries)}

        def write_index(payload=index_payload):
            with open(self._index_path, "w") as f:
                json.dump(payload, f, indent=2)

        self._effect(write_index)
        return path

    @property
    def best_path(self) -> str | None:
        return self._entries[0]["path"] if self._entries else None

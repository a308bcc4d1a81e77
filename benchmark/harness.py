"""One run of a training cell: set-up, the compared steps, the window, the
per-layer readings and the check against the reference.

The window is the port's training loop as ``Trainer.fit`` runs it, without
validation or saves: ``data.loader.DataModule.train_loader`` (the
``BatchIterator`` with its prefetch thread and the C++ collate sweeps, into
pinned memory on CUDA) over the traffic's in-memory dataset,
``inference.to_device_batch`` (``non_blocking`` copies), and the step of
``training.make_train_step`` with ``training.dropout_generator`` a step,
on ``models.TriCoLoNet.from_config`` with ``training.make_optimizer``. The
loop is closed: it takes the next batch when the iterator yields one.

Set-up builds that one model, optimizer, step and batch stream, loads the
benchmark's seeded weights, and drives the first ``compared_steps`` steps
through the window's own call and feed; what they leave (losses, the
first step's embeddings, the first gradient as Adam holds it, the change
of every leaf and running statistic, the first device batch) is what the
reference is compared with after the window. The same stream and step then
run the window.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from tricolo_tpu_torch.config import load_config
from tricolo_tpu_torch.data.loader import DataModule
from tricolo_tpu_torch.inference import autocast, prepare_inputs, to_device_batch
from tricolo_tpu_torch.losses import make_loss_fn, pairwise_losses
from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
from tricolo_tpu_torch.training import dropout_generator, make_optimizer, make_train_step

from . import weights as seeded
from .metrics import _flops, _kernel_work, _trace
from .reference import batch as ref_batch
from .reference.model import identity, param_specs, running, trainable
from .reference.precision import fp8
from .reference.train import follow

TOTAL = "train_loss/total_loss"
ANNOTATION = "benchmark.traced_steps"
TRACE_SECONDS = 2.0  # device time the traced steps cover
TIMED_CALLS = 10
# The port config keys that must hold the configuration file's widths.
WIDTH_KEYS = {
    "vocab_size": "data.vocab_size", "embed_dim": "model.modules.BiGRUEncoder.embed_dim",
    "gru_hidden": "model.modules.BiGRUEncoder.hidden_dim", "out_dim": "model.out_dim",
    "num_views": "data.num_views", "image_size": "data.image_size",
    "image_z_dim": "model.modules.MVCNNEncoder.z_dim", "voxel_size": "data.voxel_size",
    "ef_dim": "model.modules.VoxelCNNEncoder.ef_dim",
    "voxel_z_dim": "model.modules.VoxelCNNEncoder.z_dim",
}


def cfg_get(cfg, dotted: str):
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


class Run:
    """A cell's run on ``device``. ``tiny`` (the CPU tests) merges smaller
    sizes into the configuration: ``model`` / ``train`` entries, extra
    ``port`` overrides and the traffic's ``items`` (distinct, epoch)."""

    def __init__(self, cell, seed: int, device, tiny: dict | None = None):
        tiny = tiny or {}
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.m = {**cell.config["model"], **tiny.get("model", {})}
        self.hyper = {**cell.config["train"], **tiny.get("train", {})}
        self.B = int(self.hyper["batch_size"])
        overrides = [*cell.config["port_overrides"], *tiny.get("port", []),
                     f"data.batch_size={self.B}"]
        self.cfg = load_config(overrides)
        self.cfg.train_seed = self.seed
        for key, dotted in WIDTH_KEYS.items():
            if (key != "voxel_size" or self.m["voxel"]) and cfg_get(self.cfg, dotted) != self.m[key]:
                raise ValueError(f"{dotted}={cfg_get(self.cfg, dotted)} differs from the "
                                 f"configuration's {key}={self.m[key]}")
        self.items = tiny.get("items", (None, None))
        self.specs = param_specs(self.m)
        self.lr = float(self.cfg.optimizer.lr)
        self.taken = 0
        self.waits: list = []
        self.window_items: list = []
        self.window_losses: list = []
        self.trace_report = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        cell, dev = self.cell, self.device
        tic = time.perf_counter()
        self.dataset = cell.generator().generate(cell.traffic, self.m, self.seed, *self.items)
        self.setup_phases = {"traffic_s": time.perf_counter() - tic}
        tic = time.perf_counter()
        w0 = seeded.make(self.specs, self.seed, dev)
        with torch.device("meta"):
            model = TriCoLoNet.from_config(self.cfg)
        self.model = model.to_empty(device=dev)
        self.model.load_state_dict(w0, strict=True)
        self.optimizer = make_optimizer(self.cfg, self.model)
        self.step = make_train_step(self.model, self.optimizer, self.cfg)
        data = DataModule(self.cfg)
        data.train_set = self.dataset
        self.loader = data.train_loader(pin_memory=dev.type == "cuda")
        self.stream = self._batches()
        self.setup_phases["model_s"] = time.perf_counter() - tic
        tic = time.perf_counter()
        self._compared_steps(w0)
        self.setup_phases["compared_steps_s"] = time.perf_counter() - tic
        del w0

    def _batches(self):
        epoch = 0
        while True:
            self.loader.set_epoch(epoch)
            yield from self.loader
            epoch += 1

    def _one_step(self, host: dict, keep: bool = False):
        batch = to_device_batch(host, self.device)
        if keep:  # the device batch the step gets, for the batch check
            self.first_batch = {"model_id": list(host["model_id"]),
                                **{k: v.cpu() for k, v in batch.items()}}
        out = self.step(batch, self.lr, dropout_generator(self.seed, self.taken, self.device))
        self.taken += 1
        return out

    def _compared_steps(self, w0: dict) -> None:
        names, stats = trainable(self.specs), running(self.specs)
        state = self.model.state_dict()
        emb, hooks = {}, []

        def keep(key):
            def hook(module, args, out):  # returns None: the output stays the step's
                emb[key] = out.detach().float().cpu()
            return hook

        for key, module in (("text", self.model.text_encoder), ("image", self.model.image_encoder),
                            ("voxel", self.model.voxel_encoder)):
            if module is not None:
                hooks.append(module.register_forward_hook(keep(key)))
        losses, grad = [], {}
        b1 = self.hyper["betas"][0]
        for t in range(int(self.hyper["compared_steps"])):
            losses.append(self._one_step(next(self.stream), keep=t == 0)[TOTAL])
            if t == 0:
                for h in hooks:
                    h.remove()
                params = dict(self.model.named_parameters())
                moments = [self.optimizer.state[params[n]]["exp_avg"] for n in names]
                norms = torch.stack(torch._foreach_norm(moments)).cpu() / (1.0 - b1)
                grad = dict(zip(names, norms.tolist()))
        keys = names + stats
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(
            [state[n].float() for n in keys], [w0[n].float() for n in keys]))).cpu()
        self.readings = {"loss": torch.stack(losses).cpu().tolist(), "emb": emb, "grad": grad,
                         "change": dict(zip(keys, change.tolist()))}

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> None:
        dev = self.device
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            host = next(self.stream)
            self.waits.append(time.perf_counter() - tw)
            self.window_items.append(host["model_id"])
            self.window_losses.append(self._one_step(host)[TOTAL])
            self.last_host = host
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        self.window_s = time.perf_counter() - t0
        self.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        self.steps = len(self.window_losses)
        self.failed = int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def active_sites(self, model_ids: list) -> list:
        idx = [self.dataset.item_index(i) for i in model_ids]
        return self.dataset.active_sites[idx].sum(axis=0).tolist()

    def step_flops(self, model_ids: list) -> float:
        active = self.active_sites(model_ids) if self.m["voxel"] else None
        return _flops.step(self.m, self.B, active)

    # -- the traced steps -----------------------------------------------------
    def trace(self) -> dict:
        """Profiles a few more steps (about ``TRACE_SECONDS`` of them) and
        reads the trace; the trace file is deleted once read."""
        if self.trace_report is not None:
            return self.trace_report
        from torch.profiler import ProfilerActivity, profile, record_function

        n = int(min(30, max(3, round(TRACE_SECONDS * self.steps / self.window_s))))
        tg3 = (self.m["voxel_size"] // 8) ** 3
        valid = []
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if self.device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            with record_function(ANNOTATION):
                for _ in range(n):
                    host = next(self.stream)
                    if "voxel_row_ids" in host:
                        valid.append(int((host["voxel_row_ids"] < tg3).sum()))
                    self._one_step(host)
                sync(self.device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                report = _trace.analyse(json.load(f), ANNOTATION)
        report["steps"] = n
        report["valid_rows"] = valid
        self.trace_report = report
        return report

    def kernel_floor_s(self) -> float:
        """The traced steps' K1-K3 floor (``_kernel_work``)."""
        report = self.trace()
        k = int(self.first_batch["voxel_row_ids"].shape[1])
        total = sum(_kernel_work.step_bytes(self.B, k, rows, self.m["voxel_size"],
                                            self.m["ef_dim"], self.m["voxel_z_dim"])
                    for rows in report["valid_rows"])
        return total / _kernel_work.HBM_BYTES_PER_S

    # -- per-encoder timings ----------------------------------------------------
    def encoder_ms(self, kind: str) -> float | None:
        """Median ms of ``TIMED_CALLS`` forward + backward calls of one
        encoder on the window's last batch, each between CUDA events, after
        one untimed call: ``profile_step``'s surrogate loss sum(out · out.detach())."""
        encoder = {"image": self.model.image_encoder, "voxel": self.model.voxel_encoder}[kind]
        if encoder is None:
            return None
        inputs = prepare_inputs(self.model, to_device_batch(self.last_host, self.device))
        model = self.model

        def call():
            encoder.train()
            encoder.zero_grad(set_to_none=True)
            with autocast(model, self.device.type):
                if kind == "image":
                    out = encoder(inputs["images"])
                else:
                    out = encoder(inputs["voxel_rows"], inputs["voxel_row_ids"])
            out = out.float()
            (out * out.detach()).sum().backward()

        return timed_ms(call, self.device)

    def loss_ms(self) -> float:
        """Median ms of the configuration's NT-Xent pairs, forward +
        backward, on seeded unit (B, out_dim) f32 embeddings."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        keys = ["text_features", "image_features"] + (["voxel_features"] if self.m["voxel"] else [])
        emb = {k: torch.nn.functional.normalize(
            torch.randn(self.B, self.m["out_dim"], generator=gen, device=self.device), dim=1)
            for k in keys}
        loss_pair = make_loss_fn(self.cfg)

        def call():
            leaves = {k: v.clone().requires_grad_(True) for k, v in emb.items()}
            pairwise_losses(loss_pair, leaves, "t")["t/total_loss"].backward()

        return timed_ms(call, self.device)

    # -- the check --------------------------------------------------------------
    def close(self) -> None:
        """Stops the loader's thread and frees the program's state."""
        self.stream.close()
        for name in ("model", "optimizer", "step", "loader", "stream", "last_host"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compared_items(self) -> list:
        n, length = len(self.dataset.items), len(self.dataset)
        return [[self.dataset.items[i] for i in ref_batch.batch_items(
            self.seed, 0, length, n, self.B, j)] for j in range(int(self.hyper["compared_steps"]))]

    def reference(self, control: bool = False, rows: int | None = None,
                  frozen: bool = False) -> dict:
        """The reference's readings over the compared steps: f32, or the
        control (fp8 operands); ``rows`` and ``frozen`` plant faults
        (``reference.train.follow``)."""
        w0 = seeded.make(self.specs, self.seed, self.device)
        q = fp8 if control else identity
        out = follow(self.m, self.hyper, self.specs, w0, self.compared_items(), self.device,
                     q=q, rows=rows, frozen=frozen)
        del w0
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def batch_mismatch(self) -> int:
        """Elements of the first device batch that differ from the batch the
        reference assembles from the raw items (model ids, tokens, views,
        windowed_compact rows and ids); a shape that differs counts whole."""
        items = self.compared_items()[0]
        prog = self.first_batch
        bad = sum(a != b for a, b in zip(prog["model_id"], [it["model_id"] for it in items]))
        expected = {"tokens": torch.from_numpy(np.stack([it["tokens"] for it in items]))}
        if self.m["image"]:
            expected["images"] = torch.from_numpy(np.stack([it["images"] for it in items]))
        if self.m["voxel"]:
            D = self.m["voxel_size"]
            grid = ref_batch.packed_grid(items, D, self.device)
            k = ref_batch.rows_budget(self.dataset.items, D)
            rows, ids = ref_batch.windowed_rows(grid, items, D, k)
            expected["voxel_rows"], expected["voxel_row_ids"] = rows.cpu(), ids.cpu()
        for key, want in expected.items():
            got = prog.get(key)
            if got is None or tuple(got.shape) != tuple(want.shape):
                bad += want.numel()
            else:
                bad += int((got.to(want.dtype) != want).sum())
        return int(bad)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(call, device, n: int = TIMED_CALLS) -> float:
    """The median ms of ``n`` calls, each between CUDA events, after one
    untimed call."""
    call()
    sync(device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for start, end in events:
        start.record()
        call()
        end.record()
    sync(device)
    return statistics.median(s.elapsed_time(e) for s, e in events)

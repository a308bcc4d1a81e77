"""The voxel encoder's two stages inside the real step, from one more
profiled pass at the program's tracing level 2, run once a run when a
reader first asks (``BENCHMARK.json`` lists these readers after the
``_spans`` ones, so the pass follows theirs).

The pass turns tracing on at level 2 (``tricolo_tpu_torch.tracing``), runs
``FLUSH`` steps unprofiled, so that each batch of the profiled steps was
collated with tracing on (the loader's thread holds that many collated
batches), then about ``harness.TRACE_SECONDS`` of steps, at least 3, under
``torch.profiler`` inside ``_spans.ANNOTATION``. The spans are merged into
the exported trace (``tracing.merge_into``) and read by
``_spans.analyse``: device ms a step by the innermost span of the thread
that launched the work. The readings:

* ``tile_ms``: under ``forward.voxel.tiles`` + ``backward.voxel.tiles``
  (blocks 1-2 on the tile rows, the unpack and both scatters);
* ``dense_ms``: under ``forward.voxel.dense`` + ``backward.voxel.dense``
  (blocks 3-5 on the dense grids and the head);
* ``dense_mfu``: the dense stage's model FLOPs (``_flops.voxel`` for blocks
  3-5 and the head, on the profiled batches' active sites at D/4, D/8 and
  D/16), a step on average, over its device seconds × 989 TFLOP/s, in %;
* ``padding_share``: 1 − the loader's active tiles over the encoder's tile
  rows, in %, summed over the pass's batches: each ``loader.collate``
  span's move of ``loader.voxel_active_tiles`` paired by batch with the
  ``forward.voxel`` span's move of ``voxel.tile_rows``;
* ``wgrad_roofline``: the floor of the tile blocks' weight gradients
  (``wgrad_floor_s``) over the device time a step of the kernels whose
  name holds ``wgrad`` and that were launched under
  ``backward.voxel.tiles`` (cuDNN's), in %. At 128³ block 1's convolution
  has more than 2^31 output elements, so PyTorch runs cuDNN on it in
  chunks of the batch: its weight gradient is then several launches, all
  counted here.

A program whose tracing has no level 2 gives no pass, and every reader
returns None; a trace without a stage's spans gives None for that stage.
The pass prints one line, ``benchmark: voxel stages {...}``, to standard
error: the readings and the device pass's device ms by span.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from benchmark.metrics import _flops, _spans
from benchmark.metrics._kernel_work import HBM_BYTES_PER_S
from benchmark.metrics.step_mfu import PEAK_FLOPS

FLUSH = 3
TILES = ("forward.voxel.tiles", "backward.voxel.tiles")
DENSE = ("forward.voxel.dense", "backward.voxel.dense")
ROWS = "voxel.tile_rows"
ACTIVE = "loader.voxel_active_tiles"


def reading(run, key: str) -> float | None:
    """One reading of the pass, made on the first call and kept on the run."""
    if not hasattr(run, "voxel_stages"):
        run.voxel_stages = _pass(run)
    return None if run.voxel_stages is None else run.voxel_stages[key]


def _pass(run) -> dict | None:
    try:
        from tricolo_tpu_torch import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "level") or not run.m["voxel"]:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import TRACE_SECONDS, sync

    n = int(min(30, max(3, round(TRACE_SECONDS * run.steps / run.window_s))))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if run.device.type == "cuda" else [])
    model_ids = []
    tracing.clear()
    tracing.enable(level=2)
    try:
        for _ in range(FLUSH):
            run._one_step(next(run.stream))
        sync(run.device)
        with profile(activities=activities) as prof:
            with record_function(_spans.ANNOTATION):
                for _ in range(n):
                    host = next(run.stream)
                    model_ids.append(host["model_id"])
                    run._one_step(host)
                sync(run.device)
    finally:
        tracing.disable()
    spans = tracing.spans()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    tracing.merge_into(trace)
    tracing.clear()
    found = _spans.analyse(trace)
    flops = [dense_flops(run.m, run.B, run.active_sites(ids)) for ids in model_ids]
    out = readings(found, spans, sum(flops) / len(flops))
    wgrad = None if found is None else tile_wgrad(trace, found["steps"])
    out["wgrad_roofline"] = None
    if wgrad and "voxel_row_ids" in run.first_batch:
        rows = run.B * int(run.first_batch["voxel_row_ids"].shape[1])
        edge = round(run.first_batch["voxel_rows"].shape[-1] ** (1 / 3))
        elem = 2 if run.cfg.precision.compute_dtype == "bfloat16" else 4
        floor = wgrad_floor_s(rows, edge, run.m["ef_dim"], elem)
        out["wgrad_roofline"] = 100.0 * floor / (wgrad[0] / 1e3)
    print("benchmark: voxel stages " + json.dumps(
        {**out, "steps": n, "tile_wgrad_ms_launches": wgrad,
         "span_ms": None if found is None else found["span_ms"]}),
        file=sys.stderr, flush=True)
    return out


def dense_flops(m: dict, B: int, active: list) -> float:
    """``_flops``' count of blocks 3-5 and the head for a batch whose
    active sites a block are ``active`` (at D, D/2, ..., D/16)."""
    ef = m["ef_dim"]
    channels = (ef, 2 * ef, 4 * ef, 8 * ef, m["voxel_z_dim"])
    flat = (m["voxel_size"] // 32) ** 3 * m["voxel_z_dim"]
    return _flops.voxel([0, 0, *active[2:]], channels, B, flat, m["out_dim"])


def readings(found: dict | None, spans: list, flops_per_step: float) -> dict:
    """The four readings from ``_spans.analyse``'s result (None without
    device work), the pass's finished spans and the dense stage's model
    FLOPs a step."""
    span_ms = {} if found is None else found["span_ms"]

    def stage(names):
        return sum(span_ms[n] for n in names if n in span_ms) if any(
            n in span_ms for n in names) else None

    tile_ms, dense_ms = stage(TILES), stage(DENSE)
    mfu = None if not dense_ms else 100.0 * flops_per_step / (dense_ms / 1e3 * PEAK_FLOPS)
    return {"tile_ms": tile_ms, "dense_ms": dense_ms, "dense_mfu": mfu,
            "padding_share": padding_share(spans)}


def tile_wgrad(trace: dict, steps: int) -> tuple | None:
    """(device ms, launches) a step of the kernels named ``*wgrad*`` in
    ``_spans.ANNOTATION`` whose launch falls under ``backward.voxel.tiles``,
    by ``_spans.analyse``'s rule (the correlated launch's innermost span on
    its thread); None where there are none."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == _spans.ANNOTATION]
    if not marks:
        return None
    start = min(e["ts"] for e in marks)
    end = max(e["ts"] + e["dur"] for e in marks)
    launches = {e["args"]["correlation"]: e for e in events if e.get("cat") in _spans.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    threads: dict = {}
    for e in events:
        if e.get("cat") == _spans.SPAN_CAT:
            threads.setdefault((e["pid"], e["tid"]), []).append(e)
    threads = {k: _spans._Thread(v) for k, v in threads.items()}
    us, count = 0.0, 0
    for e in events:
        if e.get("cat") != "kernel" or "wgrad" not in e["name"] or not start <= e["ts"] < end:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        thread = None if launch is None else threads.get((launch["pid"], launch["tid"]))
        owner = None if thread is None else thread.at(launch["ts"])
        if owner is not None and owner["name"] == TILES[1]:
            us, count = us + e["dur"], count + 1
    per = max(steps, 1)
    return (us / 1e3 / per, count / per) if count else None


def wgrad_floor_s(rows: int, edge: int, ef: int, elem: int) -> float:
    """The floor of one step's tile-block weight gradients on ``rows`` window
    rows of ``edge``³ sites: block 1 (4 → ef channels, VALID 3³) and, for
    14³ windows, block 2 on its 6³ tiles (ef → 2·ef). Each reads its input
    and output gradient and writes its weights once, at ``elem`` bytes, or
    does its 2·27·Cin·Cout FLOPs a output site, whichever takes longer."""
    blocks = [(edge, 4, ef)] + ([(edge // 2 - 1, ef, 2 * ef)] if edge == 14 else [])
    total = 0.0
    for n, cin, cout in blocks:
        out = n - 2
        moved = elem * (rows * (n**3 * cin + out**3 * cout) + 27 * cin * cout)
        total += max(moved / HBM_BYTES_PER_S, 2 * rows * out**3 * 27 * cin * cout / PEAK_FLOPS)
    return total


def padding_share(spans: list) -> float | None:
    """1 − Σ active tiles ÷ Σ tile rows over the batches that have both a
    ``loader.collate`` span with its ``ACTIVE`` move and a
    ``forward.voxel`` span with its ``ROWS`` move, in %."""
    def moves(name, key):
        return {s.batch: s.args[key] for s in spans
                if s.name == name and s.args and key in s.args}

    active, rows = moves("loader.collate", ACTIVE), moves("forward.voxel", ROWS)
    both = [b for b in rows if b in active]
    total = sum(rows[b] for b in both)
    return 100.0 * (1.0 - sum(active[b] for b in both) / total) if total else None

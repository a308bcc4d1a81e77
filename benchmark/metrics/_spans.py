"""The program's own spans (``tricolo_tpu_torch.tracing``) over two more
passes of steps, run once a run, after every other reader has read.

* The host pass: tracing on, no profiler, as many steps as the window
  took and at least ``HOST_STEPS``, through the window's loop. Host-clock
  readings come from it, because the profiler slows the host.
* The device pass: tracing on under ``torch.profiler`` for about
  ``harness.TRACE_SECONDS`` of steps, the program's spans merged into the
  exported Chrome trace on its clock (``tracing.merge_into``). A device
  event belongs to the innermost span of the thread that launched it: its
  launch is the host event with the same ``correlation`` id. A span's root
  is found through the ``parent`` ids the spans carry. An idle gap of the
  device goes to the innermost span over its midpoint of the threads that
  launch device work (the dispatching thread, the autograd engine's), with
  the innermost span of the other threads (the prefetch thread) beside it.

Each pass turns tracing off when it ends. The loader's thread has already
collated a few batches when tracing turns on, so a reader averages over
the spans present. A program without ``tracing`` gives no passes, and every
reader of this module then returns None. The passes also print one line,
``benchmark: spans {...}``, to standard error: what the trace's device time
falls under, the idle gaps by span, the host's waits for the device by
span and the rate with tracing on.

The window and idle arithmetic is ``_trace``'s: its categories and
``merged``; ``_trace.analyse`` keeps its gaps' places to itself, so the
walk over the idle intervals is written here again.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import threading
import time

from benchmark.metrics._trace import DEVICE_CATS, HOST_CATS, merged

HOST_STEPS = 20  # the host pass's least number of steps
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "program_span"
ANNOTATION = "benchmark.span_steps"
STEP = "step"
PRODUCER = ("loader.collate", "loader.pin", "loader.put_wait")  # the prefetch thread's
# The in-step parts, each the device time of its spans (the readers').
PARTS = {"voxel": ("forward.voxel", "backward.voxel"),
         "image": ("forward.image", "backward.image"),
         "text": ("forward.text", "backward.text"),
         "loss": ("loss.forward", "backward.loss"),
         "optimizer": ("optimizer",)}
# Runtime calls in which the host waits for the device.
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def passes(run) -> dict | None:
    """Both passes' readings, made on the first call and kept on the run;
    None when the program has no ``tracing``."""
    if not hasattr(run, "span_passes"):
        run.span_passes = _passes(run)
    return run.span_passes


def device_ms(run, *names) -> float | None:
    """Device ms a traced step of the spans ``names``; None without a
    device pass that saw device work."""
    found = passes(run)
    if found is None or found["device"] is None:
        return None
    return sum(found["device"]["span_ms"].get(n, 0.0) for n in names)


def host(run, key) -> float | None:
    found = passes(run)
    return None if found is None else found["host"][key]


def _passes(run) -> dict | None:
    try:
        from tricolo_tpu_torch import tracing
    except ImportError:
        return None
    from benchmark.harness import TRACE_SECONDS

    host_pass = _host_pass(run, tracing, max(HOST_STEPS, run.steps))
    n = int(min(30, max(3, round(TRACE_SECONDS * run.steps / run.window_s))))
    device_pass = _device_pass(run, tracing, n)
    print("benchmark: spans " + json.dumps({"host": host_pass, "device": device_pass}),
          file=sys.stderr, flush=True)
    return {"host": host_pass, "device": device_pass}


def _steps(run, n: int) -> None:
    from benchmark.harness import sync

    for _ in range(n):
        run._one_step(next(run.stream))
    sync(run.device)


def _host_pass(run, tracing, n: int) -> dict:
    tracing.clear()
    tracing.enable()
    try:
        tic = time.perf_counter()
        _steps(run, n)
        seconds = time.perf_counter() - tic
    finally:
        tracing.disable()
    spans = tracing.spans()
    main = threading.get_native_id()
    steps = [s for s in spans if s.name == STEP and s.thread == main]
    prepare = collections.defaultdict(float)  # step id -> its step.prepare's ms
    for s in spans:
        if s.name == "step.prepare" and s.parent is not None:
            prepare[s.parent.id] += (s.end - s.start) / 1e6
    dispatch = [(s.end - s.start) / 1e6 - prepare[s.id] for s in steps]
    produced = collections.defaultdict(float)
    collated, pinned = set(), []
    for s in spans:
        if s.name in PRODUCER[:2]:
            produced[tuple(s.batch)] += (s.end - s.start) / 1e6
            if s.name == "loader.collate":
                collated.add(tuple(s.batch))
            elif s.args:
                pinned.append(s.args.get("loader.pinned_bytes", 0) / 2**20)
    per_batch = [produced[b] for b in collated]
    dispatching = collections.defaultdict(float)  # the main and the autograd threads
    for s in spans:
        if s.name not in PRODUCER:
            dispatching[s.name] += (s.end - s.start) / 1e6 / n
    return {
        "steps": n, "pairs_per_s_traced": run.B * n / seconds,
        "span_host_ms": {k: round(v, 4) for k, v in sorted(dispatching.items())},
        "step_dispatch_ms": statistics.fmean(dispatch) if dispatch else None,
        "step_dispatch_ms_range": [min(dispatch), max(dispatch)] if dispatch else None,
        "loader_produce_ms": statistics.fmean(per_batch) if per_batch else None,
        "loader_produce_ms_range": [min(per_batch), max(per_batch)] if per_batch else None,
        "loader_batches": len(per_batch),
        "loader_pinned_mib": statistics.fmean(pinned) if pinned else None,
    }


def _device_pass(run, tracing, n: int) -> dict | None:
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if run.device.type == "cuda" else [])
    tracing.clear()
    tracing.enable()
    try:
        with profile(activities=activities) as prof:
            with record_function(ANNOTATION):
                _steps(run, n)
    finally:
        tracing.disable()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    tracing.merge_into(trace)
    tracing.clear()
    return analyse(trace)


def _length(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


class _Thread:
    """One thread's spans, for the innermost span at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]

    def at(self, t: float):
        """The shortest span that holds ``t``, or None."""
        best = None
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            e = self.spans[i]
            if t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return best


def analyse(trace: dict) -> dict | None:
    """The device pass's readings from a merged trace; None when it holds
    no device event."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == ANNOTATION and e.get("cat") in HOST_CATS]
    start = min(e["ts"] for e in marks)
    end = max(e["ts"] + e["dur"] for e in marks)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < end and e["ts"] + e["dur"] > start]
    if not device:
        return None
    launches = {e["args"]["correlation"]: e for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    program = [e for e in events if e.get("cat") == SPAN_CAT]
    by_id = {e["args"]["span"]: e for e in program}
    threads = collections.defaultdict(list)
    for e in program:
        threads[(e["pid"], e["tid"])].append(e)
    threads = {k: _Thread(v) for k, v in threads.items()}

    def root(e) -> str:
        while e["args"].get("parent") in by_id:
            e = by_id[e["args"]["parent"]]
        return e["name"]

    steps = sum(1 for e in program if e["name"] == STEP and e["ts"] >= start
                and e["ts"] + e["dur"] <= end)
    span_us: dict = collections.defaultdict(float)
    clipped = [(max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in device]
    claimed, in_step, kernels = [], [], 0
    dispatching = set()  # the threads that launched device work
    for e, interval in zip(device, clipped):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            dispatching.add((launch["pid"], launch["tid"]))
        thread = None if launch is None else threads.get((launch["pid"], launch["tid"]))
        owner = None if thread is None else thread.at(launch["ts"])
        span_us[owner["name"] if owner else "(none)"] += interval[1] - interval[0]
        if owner is not None:
            claimed.append(interval)
            if root(owner) == STEP:
                in_step.append(interval)
                kernels += e.get("cat") == "kernel"
    busy = _length(clipped)
    per = max(steps, 1)
    span_ms = {k: v / 1e3 / per for k, v in sorted(span_us.items(), key=lambda kv: -kv[1])}
    parts = {k: sum(span_ms.get(n, 0.0) for n in names) for k, names in PARTS.items()}
    idle, cursor = [], start
    for s, e in merged(clipped):
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        idle.append((cursor, end))
    idle.sort(key=lambda g: g[0] - g[1])
    launching = _Thread([e for e in program if (e["pid"], e["tid"]) in dispatching])
    others = _Thread([e for e in program if (e["pid"], e["tid"]) not in dispatching])
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != ANNOTATION]
    host_at = _Thread(host)

    def name(e):
        return e["name"] if e else None

    loader = collections.defaultdict(list)
    for e in program:
        if e["name"].startswith("loader."):
            loader[e["name"]].append(e["dur"] / 1e3)
    runtime = collections.defaultdict(float)
    waits = collections.defaultdict(float)  # host ms a step waiting for the device, by span
    for e in events:
        if e.get("cat") in LAUNCH_CATS and start <= e["ts"] <= end:
            runtime[e["name"]] += e["dur"] / 1e3 / per
            if e["name"] in WAITS:
                thread = threads.get((e["pid"], e["tid"]))
                waits[name(thread.at(e["ts"]) if thread else None)] += e["dur"] / 1e3 / per
    return {
        "steps": steps, "busy_ms_per_step": busy / 1e3 / per,
        "window_ms": (end - start) / 1e3,
        "unclaimed_share": 1.0 - _length(claimed) / busy if busy else None,
        "in_step_ms_per_step": _length(in_step) / 1e3 / per,
        "parts_ms": parts,
        "parts_and_copy_ms": sum(parts.values()) + span_ms.get("to_device", 0.0),
        "span_ms": span_ms,
        "kernels_per_step": kernels / per if steps else None,
        "gaps": [[round((e - s) / 1e3, 4), name(launching.at((s + e) / 2)),
                  name(others.at((s + e) / 2)), name(host_at.at((s + e) / 2))]
                 for s, e in idle[:10]],
        "waits_ms": {str(k): round(v, 4) for k, v in sorted(waits.items(),
                                                            key=lambda kv: -kv[1])},
        "loader_ms": {k: [len(v), statistics.fmean(v)] for k, v in loader.items()},
        "runtime_ms": {k: round(v, 4) for k, v in
                       sorted(runtime.items(), key=lambda kv: -kv[1])[:6]},
    }

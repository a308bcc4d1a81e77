"""Summarise a ``torch.profiler`` Chrome trace of the port: device time
per step, by kernel, forward and backward, and where the device idles.

    python -m tricolo_tpu_torch.trace_report DIR --steps N [--top 30] [--json]

The port's twin of ``scripts/trace_report.py``. DIR holds the
``*.pt.trace.json`` files that ``python -m tricolo_tpu_torch.bench --trace
DIR`` and ``trainer.profiler=xplane`` (``training/trainer.py::
profile_trace``) write (the newest by name is read), or is one such file;
N is the number of steps it traced. It reports:

* device ms per step: the summed durations of the device events (kernels,
  memcpy, memset) over N;
* the device idle share of the traced window (the span of all its
  events): 1 − busy / window;
* device time by kernel name, the port's kernels labelled K1-K7
  (``PORT_KERNELS``);
* a forward / backward split: a device event whose launch (the host event
  with its ``correlation`` id) lies inside an
  ``autograd::engine::evaluate_function:`` span of the launching thread is
  ``bwd``, any other linked event ``fwd`` (the optimizer's too), and one
  with no launch in the trace ``unlinked``;
* the longest idle gaps of the device in the window, each with the
  innermost host operation that spans the gap's midpoint and, when the
  trace carries the port's spans (``tracing.merge_into``: ``trainer.
  profiler=xplane``, ``bench --trace``), the innermost program span that
  does on the threads that launch device work (the dispatching thread and
  the autograd engine's), with beside it the innermost span of the other
  threads (the loader's prefetch thread);
* with spans, device ms a step by program span: each device event goes to
  the innermost span of the thread that launched it (its ``correlation``
  id's host event), ``(none)`` when no span holds the launch.

It prints a table, or with ``--json`` one JSON line. ``device_summary`` is
the busy / idle / port-kernel arithmetic that ``chip_smoke.py``'s profiled
steps share.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN_CAT = "program_span"  # tracing.CATEGORY
BACKWARD = "autograd::engine::evaluate_function:"
# The port's kernels by their device function names (csrc/*.cu).
PORT_KERNELS = {
    "K1": ("::bn_relu_pool_kernel",),
    "K2": ("::scatter_pass_kernel", "::inverse_kernel", "::inverse_global_kernel"),
    "K3": ("::bn_relu_pool_bwd_kernel",),
    "K4": ("::nt_xent_fwd_tile_kernel", "::nt_xent_fwd_combine_kernel"),
    "K5-K6": ("::nt_xent_bwd_cluster_kernel",),
    "K7": ("::tile_gather_kernel",),
}


def port_kernel(name: str) -> str | None:
    """The K-label of a device function name, or None."""
    for label, keys in PORT_KERNELS.items():
        if any(key in name for key in keys):
            return label
    return None


def device_summary(events, window_us: float) -> dict:
    """``events``: (name, device µs) of every device event in a window of
    ``window_us``. Busy ms (their sum), the idle share of the window and
    the port kernels' ms by label."""
    busy_us = 0.0
    ours = dict.fromkeys(PORT_KERNELS, 0.0)
    for name, us in events:
        busy_us += us
        for label, keys in PORT_KERNELS.items():
            if any(key in name for key in keys):
                ours[label] += us
    return {"device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / window_us,
            "port_kernels_ms": {k: v / 1e3 for k, v in ours.items()}}


def find_trace(path: str) -> str:
    """``path`` itself, or the newest ``*.pt.trace.json`` directly in it."""
    if os.path.isfile(path):
        return path
    found = sorted(glob.glob(os.path.join(path, "*.pt.trace.json")))
    if not found:
        raise SystemExit(f"no *.pt.trace.json under {path}")
    return found[-1]


def _merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(starts, merged, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def _innermost(events, t: float) -> str | None:
    """The name of the shortest of ``events`` that holds ``t``, or None."""
    around = [e for e in events if e["ts"] <= t <= e["ts"] + e["dur"]]
    return min(around, key=lambda e: e["dur"])["name"] if around else None


def parse(trace: dict):
    """(spans, device events, host events, launches by correlation id) of
    one parsed Chrome trace: its complete events, those on the device
    (``DEVICE_CATS``) and on the host (``HOST_CATS``), and each CUDA
    API call that carries a ``correlation`` id."""
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    if not spans:
        raise ValueError("the trace holds no complete events")
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    host = [e for e in spans if e.get("cat") in HOST_CATS]
    launches = {e["args"]["correlation"]: e for e in host
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    return spans, device, host, launches


def analyse(trace: dict, steps: int, top: int = 30, gaps: int = 5) -> dict:
    """The report of one parsed Chrome trace over ``steps`` steps."""
    spans, device, host, launches = parse(trace)
    start = min(e["ts"] for e in spans)
    window_us = max(e["ts"] + e["dur"] for e in spans) - start
    backward = collections.defaultdict(list)
    for e in host:
        if e["name"].startswith(BACKWARD):
            backward[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
    backward = {thread: _merged(v) for thread, v in backward.items()}
    starts = {thread: [s for s, _ in merged] for thread, merged in backward.items()}

    def phase(event) -> str:
        launch = launches.get(event.get("args", {}).get("correlation"))
        if launch is None:
            return "unlinked"
        thread = (launch["pid"], launch["tid"])
        inside = thread in backward and _inside(starts[thread], backward[thread], launch["ts"])
        return "bwd" if inside else "fwd"

    buckets: dict = collections.defaultdict(lambda: [0.0, 0])
    phases = dict.fromkeys(("fwd", "bwd", "unlinked"), 0.0)
    for e in device:
        p = phase(e)
        phases[p] += e["dur"]
        bucket = buckets[(p, e["name"])]
        bucket[0] += e["dur"]
        bucket[1] += 1
    summary = device_summary(((e["name"], e["dur"]) for e in device), window_us)

    idle = []
    cursor = start
    for s, e in _merged((d["ts"], d["ts"] + d["dur"]) for d in device):
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if start + window_us > cursor:
        idle.append((cursor, start + window_us))
    idle.sort(key=lambda g: g[0] - g[1])

    program = [e for e in spans if e.get("cat") == SPAN_CAT]
    by_thread = collections.defaultdict(list)
    for e in program:
        by_thread[(e["pid"], e["tid"])].append(e)
    by_span: dict = collections.defaultdict(float)
    dispatching = set()  # the threads that launched device work
    for e in device if program else ():
        launch = launches.get(e.get("args", {}).get("correlation"))
        owner = None
        if launch is not None:
            dispatching.add((launch["pid"], launch["tid"]))
            owner = _innermost(by_thread.get((launch["pid"], launch["tid"]), ()), launch["ts"])
        by_span[owner or "(none)"] += e["dur"]
    launching = [e for e in program if (e["pid"], e["tid"]) in dispatching]
    others = [e for e in program if (e["pid"], e["tid"]) not in dispatching]

    per = 1e3 * steps
    rows = sorted(buckets.items(), key=lambda kv: -kv[1][0])[:top]
    gap_rows = []
    for s, e in idle[:gaps]:
        row = {"at_ms": (s - start) / 1e3, "ms": (e - s) / 1e3,
               "host_op": _innermost(host, (s + e) / 2)}
        if program:
            row["span"] = _innermost(launching, (s + e) / 2)
            row["other_span"] = _innermost(others, (s + e) / 2)
        gap_rows.append(row)
    report = {
        "steps": steps,
        "window_ms": window_us / 1e3,
        "device_ms_per_step": summary["device_busy_ms"] / steps,
        "device_busy_ms": summary["device_busy_ms"],
        "device_idle_share": summary["device_idle_share"],
        "port_kernels_ms_per_step": {k: v / steps for k, v in summary["port_kernels_ms"].items()},
        "phase_ms_per_step": {k: v / per for k, v in phases.items()},
        "top": [{"phase": p, "name": name, "label": port_kernel(name),
                 "ms_per_step": us / per, "count": n} for (p, name), (us, n) in rows],
        "gaps": gap_rows,
    }
    if program:
        report["span_ms_per_step"] = {k: v / per for k, v in
                                      sorted(by_span.items(), key=lambda kv: -kv[1])}
    return report


def format_report(report: dict) -> str:
    lines = [
        f"total device time: {report['device_ms_per_step']:.3f} ms/step "
        f"({report['steps']} steps traced); device idle share "
        f"{report['device_idle_share']:.4f} of a {report['window_ms']:.3f} ms window",
        "by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in report["phase_ms_per_step"].items())
        + " ms/step",
        "port kernels: " + ", ".join(
            f"{k} {v:.3f}" for k, v in report["port_kernels_ms_per_step"].items()) + " ms/step",
    ]
    for row in report["top"]:
        label = row["label"] or ""
        lines.append(f"{row['ms_per_step']:9.3f} ms  {row['phase']:<8} {label:<5} "
                     f"x{row['count']:<5d} {row['name'][:100]}")
    if "span_ms_per_step" in report:
        lines.append("device time by program span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in report["span_ms_per_step"].items()) + " ms/step")
    lines.append("longest device idle gaps:")
    for gap in report["gaps"]:
        span = ""
        if "span" in gap:
            span = f"  span: {gap['span']}"
            if gap["other_span"]:
                span += f" (beside {gap['other_span']})"
        lines.append(f"{gap['ms']:9.3f} ms  at +{gap['at_ms']:.3f} ms  host: {gap['host_op']}"
                     + span)
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.trace_report",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir", help="a directory of *.pt.trace.json files, or one file")
    ap.add_argument("--steps", type=int, required=True, help="steps the trace covers")
    ap.add_argument("--top", type=int, default=30, help="rows of the by-kernel table")
    ap.add_argument("--json", action="store_true", help="print one JSON line instead")
    args = ap.parse_args(argv)
    path = find_trace(args.trace_dir)
    with open(path) as f:
        report = analyse(json.load(f), args.steps, args.top)
    report["trace"] = path
    print(json.dumps(report) if args.json else format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

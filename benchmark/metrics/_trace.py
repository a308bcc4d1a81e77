"""Reading a ``torch.profiler`` Chrome trace of the traced steps.

A copy of the arithmetic of ``tricolo_tpu_torch/trace_report.py`` (device
and host events, merged intervals, the innermost host op over an idle gap),
restricted to the window of one user annotation that wraps the traced
steps and ends in a synchronize:

* ``busy_s``: the union of the device events' intervals (kernels, copies,
  sets) inside the window;
* ``window_s``: the annotation's length;
* ``ops``: device seconds by name (summed over launches);
* ``gaps``: the device's idle intervals inside the window, longest first,
  each with the innermost host operation spanning its midpoint.
"""

from __future__ import annotations

import collections

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def merged(intervals):
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def analyse(trace: dict, annotation: str) -> dict:
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("name") == annotation and e.get("cat") in HOST_CATS]
    if not marks:
        raise ValueError(f"the trace holds no {annotation!r} annotation")
    start = min(e["ts"] for e in marks)
    end = max(e["ts"] + e["dur"] for e in marks)
    device = [e for e in spans if e.get("cat") in DEVICE_CATS
              and e["ts"] < end and e["ts"] + e["dur"] > start]
    host = [e for e in spans if e.get("cat") in HOST_CATS and e.get("name") != annotation]
    busy = merged((max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in device)
    ops: dict = collections.defaultdict(float)
    for e in device:
        ops[e["name"]] += e["dur"] / 1e6
    idle, cursor = [], start
    for s, e in busy:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        idle.append((cursor, end))
    idle.sort(key=lambda g: g[0] - g[1])

    def host_op(t: float) -> str:
        around = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        return min(around, key=lambda e: e["dur"])["name"] if around else "(none)"

    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (end - start) / 1e6,
        "ops": dict(ops),
        "gaps": [(host_op((s + e) / 2), (e - s) / 1e6) for s, e in idle[:10]],
    }

"""Roofline of a traced, work-counted loop of the port: how close each op,
and the whole step, comes to the card's floor.

    python -m tricolo_tpu_torch.roofline_report DIR --steps N [--top 25]
        [--peak-bf16-tflops 989] [--peak-tf32-tflops 494]
        [--peak-f32-tflops 67] [--peak-gbps 3350] [--json]

The port's twin of ``scripts/roofline_report.py``. DIR is what ``python -m
tricolo_tpu_torch.bench --roofline DIR`` writes: the newest
``*.pt.trace.json`` (a ``torch.profiler`` trace of N steps) and the newest
``work.*.json`` (``work.WorkCounter``'s record of the same loop). Each op's
floor is

    t_min = max(bytes / PEAK_BW, flops / PEAK_FLOPS[its compute class])

from the record (the XLA profiler's per-op ``bytes_accessed`` and
``model_flops`` in the JAX script; peaks default to the H100 SXM data
sheet's: 989 bf16 / 494 TF32 / 67 f32 TFLOP/s, 3350 GB/s).

Attribution: each device event (kernel, memcpy, memset) goes to the
innermost ``work#…`` range on its launching thread (the CUDA API call
with its ``correlation`` id) that encloses the launch. Rows, one per
op name (an aten op, or a port kernel's label K1 … K9): device ms a step,
floor ms a step, floor / device, BW- or FLOP-bound, calls a step that
launched device work (``launches``) and device events a step
(``kernels``). Device time with no enclosing range is the ``unattributed``
row (never dropped, nor is a row listed under ``impossible``); a counted op that launched nothing adds its floor to
``no_device_work_floor_ms`` (≈ 0 for a step on the card). Totals: device
and floor ms a step, the step's floor share (floor / device), FLOPs and
bytes a step by class, the attributed share of device time, the peaks and
the card. A row above 105% of its floor is a counting fault and is listed
under ``impossible``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

from .trace_report import find_trace, parse
from .work import HBM_BYTES_PER_S, PEAK_FLOPS
from .work import load as load_record

IMPOSSIBLE = 1.05


def find_record(path: str) -> str:
    """The newest ``work.*.json`` in the directory ``path``."""
    found = sorted(glob.glob(os.path.join(path, "work.*.json")))
    if not found:
        raise SystemExit(f"no work.*.json under {path}")
    return found[-1]


def peaks(bf16_tflops: float, tf32_tflops: float, f32_tflops: float, gbps: float) -> dict:
    """Peak FLOP/s by compute class and HBM bytes/s."""
    return {"flops": {"bf16": bf16_tflops * 1e12, "tf32": tf32_tflops * 1e12,
                      "f32": f32_tflops * 1e12},
            "bytes_per_s": gbps * 1e9}


DEFAULT_PEAKS = peaks(PEAK_FLOPS["bf16"] / 1e12, PEAK_FLOPS["tf32"] / 1e12,
                      PEAK_FLOPS["f32"] / 1e12, HBM_BYTES_PER_S / 1e9)


def _record_id(name: str) -> int | None:
    if not name.startswith("work#"):
        return None
    return int(name[len("work#"):].split(":", 1)[0])


def owners(host, launches) -> dict:
    """Correlation id → the record id of the innermost ``work#`` range on
    the launch's thread that encloses it (ranges on one thread nest)."""
    by_thread: dict = collections.defaultdict(list)
    for e in host:
        rid = _record_id(e["name"])
        if rid is not None:
            by_thread[(e["pid"], e["tid"])].append((e["ts"], 0, e["ts"] + e["dur"], rid))
    for corr, e in launches.items():
        by_thread[(e["pid"], e["tid"])].append((e["ts"], 1, e["ts"], corr))
    out = {}
    for events in by_thread.values():
        events.sort(key=lambda ev: (ev[0], ev[1], -ev[2]))
        stack: list = []
        for start, kind, end, key in events:
            while stack and stack[-1][0] < start:
                stack.pop()
            if kind == 0:
                stack.append((end, key))
            elif stack:
                out[key] = stack[-1][1]
    return out


def analyse(trace: dict, record: dict, steps: int, top: int = 25,
            peak: dict = DEFAULT_PEAKS) -> dict:
    """The report of one parsed Chrome trace and its work record
    (``work.load``) over ``steps`` steps."""
    _, device, host, launches = parse(trace)
    owner = owners(host, launches)
    ops = record["ops"]

    def floor_parts(rid):
        _, cls, flops, nbytes = ops[rid]
        t_bw = nbytes / peak["bytes_per_s"]
        t_fl = flops / peak["flops"][cls] if flops else 0.0
        return t_bw, t_fl

    busy = collections.Counter()
    events = collections.Counter()
    unattributed = [0.0, 0]
    by_kernel: dict = collections.defaultdict(lambda: [0.0, set()])
    for e in device:
        rid = owner.get(e.get("args", {}).get("correlation"))
        if rid is None or rid not in ops:
            unattributed[0] += e["dur"]
            unattributed[1] += 1
        else:
            busy[rid] += e["dur"]
            events[rid] += 1
            by_kernel[e["name"]][0] += e["dur"]
            by_kernel[e["name"]][1].add(rid)

    rows: dict = {}
    idle_floor_s = 0.0
    for rid, (op, cls, flops, nbytes) in ops.items():
        t_bw, t_fl = floor_parts(rid)
        if not events[rid]:
            idle_floor_s += max(t_bw, t_fl)
            continue
        row = rows.setdefault(op, {"us": 0.0, "floor_s": 0.0, "bw_s": 0.0, "flop_s": 0.0,
                                   "calls": 0, "events": 0})
        row["us"] += busy[rid]
        row["floor_s"] += max(t_bw, t_fl)
        row["bw_s"] += t_bw
        row["flop_s"] += t_fl
        row["calls"] += 1
        row["events"] += events[rid]

    total_us = sum(e["dur"] for e in device)
    table = []
    for op, r in rows.items():
        device_ms = r["us"] / 1e3 / steps
        floor_ms = r["floor_s"] * 1e3 / steps
        table.append({"op": op, "device_ms": device_ms, "floor_ms": floor_ms,
                      "pct_of_floor": floor_ms / device_ms if device_ms else 0.0,
                      "bound": "FLOP" if r["flop_s"] > r["bw_s"] else "BW",
                      "launches": r["calls"] / steps, "kernels": r["events"] / steps})
    table.sort(key=lambda r: -r["device_ms"])
    floor_ms = sum(r["floor_ms"] for r in table)
    device_ms = total_us / 1e3 / steps
    kernels = []
    for name, (us, rids) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        kernels.append({"kernel": name, "device_ms": us / 1e3 / steps,
                        "ops": sorted({ops[r][0] for r in rids}),
                        "ops_floor_ms": sum(max(floor_parts(r)) for r in rids) * 1e3 / steps,
                        "ops_device_ms": sum(busy[r] for r in rids) / 1e3 / steps})
    by_class: dict = {}
    for _, cls, flops, nbytes in ops.values():
        c = by_class.setdefault(cls, {"flops": 0.0, "bytes": 0.0})
        c["flops"] += flops / steps
        c["bytes"] += nbytes / steps
    return {
        "steps": steps,
        "card": record["card"],
        "peaks": {"bf16_tflops": peak["flops"]["bf16"] / 1e12,
                  "tf32_tflops": peak["flops"]["tf32"] / 1e12,
                  "f32_tflops": peak["flops"]["f32"] / 1e12,
                  "gbps": peak["bytes_per_s"] / 1e9},
        "device_ms_per_step": device_ms,
        "floor_ms_per_step": floor_ms,
        "floor_share": floor_ms / device_ms if device_ms else 0.0,
        "attributed_share": 1.0 - unattributed[0] / total_us if total_us else 0.0,
        "no_device_work_floor_ms": idle_floor_s * 1e3 / steps,
        "per_step_by_class": by_class,
        "impossible": [r["op"] for r in table if r["pct_of_floor"] > IMPOSSIBLE],
        "rows": table[:top] + [r for r in table[top:] if r["pct_of_floor"] > IMPOSSIBLE]
        + [{"op": "unattributed", "device_ms": unattributed[0] / 1e3 / steps,
                                "floor_ms": 0.0, "pct_of_floor": 0.0, "bound": "-",
                                "launches": unattributed[1] / steps,
                                "kernels": unattributed[1] / steps}],
        "kernel_rows": {r["op"]: r for r in table if not r["op"].startswith("aten::")},
        "by_kernel": kernels,
    }


def format_report(report: dict) -> str:
    p = report["peaks"]
    lines = [
        f"card: {report['card']}; peaks {p['bf16_tflops']:g} bf16 / {p['tf32_tflops']:g} TF32 / "
        f"{p['f32_tflops']:g} f32 TFLOP/s, {p['gbps']:g} GB/s",
        f"actual device time : {report['device_ms_per_step']:9.3f} ms/step "
        f"({report['steps']} steps; {report['attributed_share']:.4f} of it attributed)",
        f"roofline floor     : {report['floor_ms_per_step']:9.3f} ms/step (Σ max(bytes / BW, "
        f"flops / peak of the op's class) over the ops that ran on the device)",
        f"floor share        : {report['floor_share']:.4f} of the device time",
        f"floor of the ops that launched nothing: {report['no_device_work_floor_ms']:.4f} "
        "ms/step",
        "by class, a step: " + ", ".join(
            f"{cls} {v['flops'] / 1e9:.2f} GFLOP {v['bytes'] / 1e6:.1f} MB"
            for cls, v in sorted(report["per_step_by_class"].items())),
        f"impossible (> {IMPOSSIBLE:.0%} of floor): {report['impossible'] or 'none'}",
        "",
        f"{'ms/step':>9} {'floor':>8} {'%floor':>7} bound {'launch':>7} {'kern':>6}  op",
    ]
    for r in report["rows"]:
        lines.append(f"{r['device_ms']:9.3f} {r['floor_ms']:8.3f} {100 * r['pct_of_floor']:6.1f}% "
                     f"{r['bound']:5} {r['launches']:7.1f} {r['kernels']:6.1f}  {r['op']}")
    lines += ["", "device kernels: ms/step, and the floor / device ms of the ops that launched "
                  "them"]
    for k in report["by_kernel"]:
        lines.append(f"{k['device_ms']:9.3f} {k['ops_floor_ms']:8.3f} {k['ops_device_ms']:9.3f}  "
                     f"{k['kernel'][:90]}  [{', '.join(k['ops'])}]")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.roofline_report",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir", help="the directory bench --roofline wrote")
    ap.add_argument("--steps", type=int, required=True, help="steps the trace covers")
    ap.add_argument("--top", type=int, default=25, help="rows of the table")
    ap.add_argument("--peak-bf16-tflops", type=float, default=PEAK_FLOPS["bf16"] / 1e12)
    ap.add_argument("--peak-tf32-tflops", type=float, default=PEAK_FLOPS["tf32"] / 1e12)
    ap.add_argument("--peak-f32-tflops", type=float, default=PEAK_FLOPS["f32"] / 1e12)
    ap.add_argument("--peak-gbps", type=float, default=HBM_BYTES_PER_S / 1e9)
    ap.add_argument("--json", action="store_true", help="print one JSON line instead")
    args = ap.parse_args(argv)
    path = find_trace(args.trace_dir)
    with open(path) as f:
        trace = json.load(f)
    record_path = find_record(args.trace_dir)
    report = analyse(trace, load_record(record_path), args.steps, args.top,
                     peaks(args.peak_bf16_tflops, args.peak_tf32_tflops, args.peak_f32_tflops,
                           args.peak_gbps))
    report.update(trace=path, record=record_path)
    print(json.dumps(report) if args.json else format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

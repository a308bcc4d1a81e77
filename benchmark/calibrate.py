"""Readings from which a cell's correctness limits are set.

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 ... [--out FILE]

For each seed, in one process: the program's readings of the compared
steps (set-up as ``run.py`` makes it, no window), the f32 reference's, the
control's (the reference with fp8 operands put in the program's place) and
two planted faults' (the f32 reference on half of each batch, the mean
taken over the rest; and with its state left unchanged by each step), each
compared with the f32 reference by ``compare.numbers``.
Prints one JSON line a seed (also appended to ``--out``) and last a
summary: each number's largest program reading (the lower reading), and
the smallest reading of the control and of the fault (candidates for the
upper one). A step's answer altered where it is produced (its loss × 1.1)
reads a loss gap of 0.1 by construction and needs no run. The limits are then set by hand into ``limits/<cell>.json``
(PERF.md says how).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import environment
from .spec import load_cell


def calibrate_seed(cell, seed: int, device, tiny=None) -> dict:
    from . import compare
    from .harness import Run

    clock = {}
    tic = time.perf_counter()
    run = Run(cell, seed, device, tiny)
    run.setup()
    run.stream.close()
    clock["program_s"] = time.perf_counter() - tic
    run.close()
    tic = time.perf_counter()
    ref = run.reference()
    clock["reference_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    control = run.reference(control=True)
    clock["control_s"] = time.perf_counter() - tic
    half = run.reference(rows=run.B // 2)
    frozen = run.reference(frozen=True)
    program = compare.numbers(run.readings, ref)
    program["batch_mismatch"] = run.batch_mismatch()
    every_leaf = compare.worst_leaf(run.readings["grad"], ref["grad"], ref["grad"])
    return {"seed": seed, "program": program, "control": compare.numbers(control, ref),
            "half_batch": compare.numbers(half, ref),
            "unchanged_state": compare.numbers(frozen, ref), "seconds": clock,
            "grad_gap_every_leaf": every_leaf,
            "loss": {"program": run.readings["loss"], "reference": ref["loss"],
                     "control": control["loss"]}}


def summary(rows: list) -> dict:
    out = {}
    for name in rows[0]["program"]:
        out[name] = {"lower": max(r["program"][name] for r in rows),
                     "control_min": min(r["control"].get(name, float("nan")) for r in rows),
                     "half_batch_min": min(r["half_batch"].get(name, float("nan")) for r in rows),
                     "unchanged_state_min": min(r["unchanged_state"].get(name, float("nan"))
                                                for r in rows)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="append every line to this file too")
    args = ap.parse_args(argv)
    environment()
    import torch

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        row = calibrate_seed(cell, seed, "cuda")
        row["workload"] = args.workload
        rows.append(row)
        emit(row, args.out)
    emit({"workload": args.workload, "summary": summary(rows)}, args.out)
    return 0


def emit(obj: dict, path: str | None) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())

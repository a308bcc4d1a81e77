"""Run one cell of ``BENCHMARK.json`` once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the GPUs the cell asks for.
Set-up (counted in ``setup_s``, from the process's start to the first
timed step) makes the traffic's dataset and the weights from ``--seed``,
builds the program's model, optimizer, step and loader, and drives the
compared steps (``harness``). The window then trains for ``--seconds`` and
ends in a synchronize. With ``--trace 1`` the per-layer metrics are read
after it: a few more steps under ``torch.profiler``, then the per-encoder
timings. Last, the program's state is freed and the plain reference
follows the compared steps (``compare``).

Standard output's last line is one JSON object: ``correct``, ``attempted``
(the window's steps), ``failed`` (those with a non-finite loss),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number with its limit, which also end standard
error. Without CUDA, with fewer GPUs than the cell asks for, or with
``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX package loaded once the
window has closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import ctypes.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .spec import ROOT, load_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tricolo_tpu")
INTRA_OP_THREADS = 4
# glibc's mallopt parameters (malloc.h) and what environment() sets them to:
# one arena, no mmap'd chunks, no trimming, 64 MiB of heap grown at a time.
MALLOPT = {"M_ARENA_MAX": (-8, 1), "M_MMAP_MAX": (-4, 0),
           "M_TRIM_THRESHOLD": (-1, 2**31 - 1), "M_TOP_PAD": (-2, 64 << 20)}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the window's length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool, device, tiny=None,
            start: float | None = None) -> dict:
    """One run; returns the result line's object (``tiny``: the CPU tests'
    sizes, ``harness.Run``)."""
    import torch

    from . import compare
    from .harness import Run

    tic = time.time()
    run = Run(cell, seed, device, tiny)
    run.setup()
    setup_s = time.time() - (T_START if start is None else start)
    print(f"benchmark: set-up {setup_s:.3f} s: imports and CUDA {tic - T_START:.3f} s, "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items()),
          file=sys.stderr, flush=True)
    run.window(seconds)
    dev = run.device
    values = {"train_pairs_per_s": run.B * run.steps / run.window_s,
              "peak_mem_gib": run.peak_bytes / 2**30, "setup_s": setup_s}
    result = {"correct": False, "attempted": run.steps, "failed": run.failed}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": run.peak_bytes}
    breakdown = None
    if trace:
        # The traced steps run here, straight after the window and before
        # any reader: every reader reads this one report, in whatever order
        # BENCHMARK.json lists the metrics.
        report = run.trace()
        info["busy_s"], info["window_s"] = report["busy_s"], report["window_s"]
        metrics = {}
        for metric in cell.per_layer:
            value = cell.metric_reader(metric["name"]).read(run)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        ops = sorted(report["ops"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[name, s] for name, s in ops],
                     "idle_gaps": [[name, s] for name, s in report["gaps"]]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    run.close()
    found = compare.numbers(run.readings, run.reference())
    found["batch_mismatch"] = run.batch_mismatch()
    correct, checks = compare.judge(found, cell.limits)
    result.update(correct=correct and run.failed == 0, metrics=metrics, device=info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    ``INTRA_OP_THREADS`` threads for torch's CPU work, which sleep when
    idle (``OMP_WAIT_POLICY=PASSIVE``): the loader's thread copies each
    batch's ~220 MiB into pinned memory through that pool (35 ms a batch
    on one thread, 10 on four, on the H100's host), while a pool that
    spins between its calls contends with the loader's and the
    dispatching thread on the host's few cores; and glibc's malloc held to
    memory it has once faulted in (``MALLOPT``). The loader's thread
    allocates some 230 MB of fresh arrays a batch; served by ``mmap``,
    every batch paid its page faults, zeroing and ``munmap`` in 135-209 ms
    of system time a step, by an amount that swung with the host. On one
    arena that keeps what is freed, a batch's arrays take the memory the
    last one left (PERF.md). Set before torch is imported and before any
    thread starts."""
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    for name, (param, value) in MALLOPT.items():
        if libc.mallopt(param, value) != 1:
            raise RuntimeError(f"mallopt({name}, {value}) failed: not glibc's malloc?")
    os.environ["OMP_NUM_THREADS"] = str(INTRA_OP_THREADS)
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    environment()
    import torch

    torch.set_num_threads(INTRA_OP_THREADS)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

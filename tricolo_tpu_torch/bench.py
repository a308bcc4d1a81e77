"""Training throughput of the flagship Tri(I+V) step on the GPU.

    python -m tricolo_tpu_torch.bench [--config tri|bi_i|bi_v] [--voxel-size 64]
        [--batch-size 128] [--n-points N] [--override key=value ...]
        [--trace DIR] [--roofline DIR] [--pairs 5] [--idle-wait 240]
        [--stall-s S] [--device cuda|cpu]

The port's twin of the JAX package's ``bench.py``: the steady-state train
step (forward, backward and Adam over BiGRU + MVCNN/ResNet18 + VoxelCNN
with the pairwise NT-Xent loss) at batch 128, 6 views of 128² and 64³
voxels, bf16 compute, on two pre-staged batches of solid ellipsoids
(``bench_data.host_batch``, seeds 0 and 1). The loss runs through the
NT-Xent kernels (``loss.NTXentLoss.use_pallas=true``) unless an override
names that key. Prints exactly one JSON line on stdout:

    {"metric": "train_pairs_per_sec_per_chip", "value": ...,
     "unit": "caption-shape pairs/sec/chip", "step_ms": ..., "pairs": ...,
     "salvaged": false, "config": "tri", "voxel_size": 64,
     "batch_size": 128, "card": "<nvidia-smi name, power limit>" or "cpu"}

and everything else on stderr, ending with the kernel launches per timed
step (``ops.launches()``) as ``bench: {"launches_per_step": ..., "steps": N}``.

Method. ``bench.warmup_steps`` steps, one ``torch.cuda.synchronize()`` and
a finite-loss check; then ``--pairs`` two-point estimates t(2N) − t(N),
N = ``bench.steps``, each leg a host clock around N steps that ends in a
synchronize, so every per-loop constant cancels. ``value`` is
B·N / median estimate (one process: the data-parallel world is 1);
``step_ms`` is the median over N. ``--trace DIR`` first runs one extra
loop of N steps under ``torch.profiler``, with the port's spans merged in
(``tracing``; read it with ``python -m tricolo_tpu_torch.trace_report DIR
--steps N``); that loop feeds no estimate. ``--roofline DIR``, after the
timed pairs, runs one more loop of N steps under ``torch.profiler`` and a
``work.WorkCounter``, with tracing off, and writes its
trace and the counter's record ``work.<ns>.json`` into DIR (read them with
``python -m tricolo_tpu_torch.roofline_report DIR --steps N``). The
counter slows the host, so that loop's idle share means nothing; it feeds
no estimate either.

A stall watchdog guards the timed loops (``measure``): with no leg
finished for ``--stall-s`` seconds (default max(300, 10 × the warm-up's
wall)) it prints the median of the estimates completed so far, marked
``"salvaged": true``, and exits 0, or exits 3 with no line when none has
completed. Whichever of it and the main thread prints first takes a
once-flag under a lock, so one line at most is ever printed.

Configuration, as ``bench.py`` sets it: ``bi_i`` / ``bi_v`` drop the
voxel / image encoder (and its arrays); the transfer is windowed_compact
unless an override names ``data.voxel_transfer``, with per-sample rows k
fitted to the batches' worst sample; the full ``windowed`` transfer fits
``tile_budget_frac`` with 25% headroom; ``dense`` densifies on the host,
``packed`` passes through; 128³ and above remat the voxel stack unless an
override names ``precision.remat_voxel``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Callable

from .bench_data import flagship_cfg, host_batch

STALL_FLOOR_S = 300.0
VOXEL_KEYS = ("voxel_flat", "voxel_rgb")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def wait_for_idle(limit_s: float) -> None:
    """Wait up to ``limit_s`` for the host's 1-minute load to fall to
    max(0.5, cores/4): another busy process skews host-dispatched steps.
    Samples ``/proc/loadavg`` before this process adds its own load."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        try:
            with open("/proc/loadavg") as f:
                load1 = float(f.read().split()[0])
        except (OSError, ValueError):
            return
        if load1 <= max(0.5, 0.25 * (os.cpu_count() or 1)):
            return
        log(f"host load {load1:.2f}, waiting for idle "
            f"(deadline in {deadline - time.monotonic():.0f} s)")
        time.sleep(10.0)


def bench_config(config: str = "tri", voxel_size: int = 64, batch_size: int = 128,
                 overrides=()):
    """The benchmark's config: ``bench_data.flagship_cfg`` at these sizes
    with ``bench.py``'s rules (module docstring) and the NT-Xent kernels."""
    overrides = list(overrides)
    cfg = flagship_cfg(extra=[f"data.voxel_size={voxel_size}", f"data.batch_size={batch_size}",
                              "loss.NTXentLoss.use_pallas=true", *overrides])

    def named(key: str) -> bool:
        return any(o.startswith(key) for o in overrides)

    if config == "bi_i":
        cfg.model.voxel_encoder = None
    elif config == "bi_v":
        cfg.model.image_encoder = None
    elif config != "tri":
        raise ValueError(f"--config must be tri, bi_i or bi_v, got {config!r}")
    if not named("data.voxel_transfer"):
        cfg.data.voxel_transfer = "windowed_compact"
    if voxel_size >= 128 and not named("precision.remat_voxel"):
        cfg.precision.remat_voxel = True
    return cfg


def fit_budgets(cfg, host_batches: list, overrides=()) -> int:
    """windowed_compact's per-sample rows k from the batches' worst sample
    (``tile_budget`` explicit or auto, as the loader reads it), or 0; for
    the full ``windowed`` transfer, unless an override names
    ``tile_budget``, sets ``tile_budget_frac`` to the worst batch's active
    tiles + 25%, rounded up to 256 rows."""
    from .ops.tile_sparse import host_sample_tile_counts, host_tile_count, sample_tile_budget

    transfer, D = cfg.data.voxel_transfer, cfg.data.voxel_size
    if cfg.model.voxel_encoder is None or transfer not in ("windowed", "windowed_compact"):
        return 0
    tg3 = (D // 8) ** 3
    voxel_cfg = cfg.model.modules.VoxelCNNEncoder
    if transfer == "windowed_compact":
        budget = voxel_cfg.get("tile_budget", "auto")
        explicit = isinstance(budget, (int, float)) and not isinstance(budget, bool)
        worst = max(max(host_sample_tile_counts(b["voxel_flat"], D)) for b in host_batches)
        return sample_tile_budget(budget, tg3, None if explicit else worst)
    if not any(o.startswith("model.modules.VoxelCNNEncoder.tile_budget") for o in overrides):
        worst = max(host_tile_count(b["voxel_flat"], D) for b in host_batches)
        voxel_cfg.tile_budget_frac = windowed_frac(worst, cfg.data.batch_size, tg3)
    return 0


def windowed_frac(active_tiles: int, batch_size: int, tg3: int) -> float:
    """The full windowed transfer's ``tile_budget_frac`` for a batch of
    ``active_tiles``: 25% headroom, rounded up to 256 rows, at most 1."""
    rows = -(-int(active_tiles * 1.25) // 256) * 256
    return min(1.0, rows / (batch_size * tg3))


def to_transfer(cfg, host: dict, tile_rows: int) -> dict:
    """A packed host batch in the config's ``data.voxel_transfer`` (the
    loader's arrays), without the arrays of a disabled encoder."""
    from .data.device_prep import densify_on_host, windowed_compact_on_host, windowed_on_host
    from .ops.tile_sparse import windowed_halo

    host = dict(host)
    if cfg.model.image_encoder is None:
        host.pop("images")
    if cfg.model.voxel_encoder is None:
        for key in VOXEL_KEYS:
            host.pop(key)
        return host
    D, transfer = cfg.data.voxel_size, cfg.data.voxel_transfer
    halo = windowed_halo(cfg.model.modules.VoxelCNNEncoder.get("tile_sparse_blocks", 2))
    if transfer == "packed":
        return host
    flat, rgb = (host.pop(key) for key in VOXEL_KEYS)
    if transfer == "dense":
        host["voxel_grid"] = densify_on_host(flat, rgb, D)
    elif transfer == "windowed":
        host["voxel_windows"], host["voxel_tile_occ"] = windowed_on_host(flat, rgb, D, halo=halo)
    elif transfer == "windowed_compact":
        host["voxel_rows"], host["voxel_row_ids"], _ = windowed_compact_on_host(
            flat, rgb, D, tile_rows, halo=halo)
    else:
        raise ValueError(f"unknown data.voxel_transfer={transfer!r}")
    return host


def stage(batch: dict, device):
    """One host batch on ``device``: through pinned memory on CUDA."""
    from .data.loader import pin_batch
    from .inference import to_device_batch

    return to_device_batch(pin_batch(batch) if device.type == "cuda" else batch, device)


def build_step(cfg, device):
    """(model, optimizer, step): ``TriCoLoNet.from_config`` after
    ``torch.manual_seed(0)``, the port's Adam and its train step."""
    import torch

    from .models.tricolo_net import TriCoLoNet
    from .training import make_optimizer, make_train_step

    torch.manual_seed(0)
    model = TriCoLoNet.from_config(cfg).to(device)
    optimizer = make_optimizer(cfg, model)
    return model, optimizer, make_train_step(model, optimizer, cfg)


def default_stall_s(warmup_s: float) -> float:
    """The stall threshold: 300 s, or 10 × the warm-up's wall when longer."""
    return max(STALL_FLOOR_S, 10.0 * warmup_s)


def measure(timed_loop: Callable[[int], float], steps: int, pairs: int, stall_s: float,
            emit: Callable[[list, bool], None], exit: Callable[[int], None] = os._exit) -> int:
    """``pairs`` two-point estimates ``timed_loop(2·steps) − timed_loop(steps)``
    under a stall watchdog; ``emit(estimates, salvaged)`` prints the one
    result line. Returns 0 once the main thread has emitted. When no leg
    has finished for ``stall_s`` seconds the watchdog emits the estimates
    completed so far (salvaged) and calls ``exit(0)``, or calls ``exit(3)``
    without emitting when there are none; ``measure`` then returns that
    code. Whichever thread emits first takes the once-flag under the lock."""
    estimates: list[float] = []
    lock = threading.Lock()
    state = {"last": time.monotonic(), "code": None}
    done = threading.Event()

    def watchdog() -> None:
        tick = max(0.01, min(10.0, stall_s / 5))
        while not done.wait(tick):
            if time.monotonic() - state["last"] <= stall_s:
                continue
            with lock:
                if state["code"] is not None:
                    return
                if estimates:
                    log(f"no leg finished in {stall_s:.0f} s: salvaging the median of "
                        f"{len(estimates)} completed two-point estimates")
                    emit(list(estimates), True)
                    state["code"] = 0
                else:
                    log(f"stalled {stall_s:.0f} s before any two-point estimate completed: "
                        "aborting")
                    state["code"] = 3
            exit(state["code"])
            return

    thread = threading.Thread(target=watchdog, name="bench-watchdog", daemon=True)
    thread.start()
    try:
        for _ in range(pairs):
            single = timed_loop(steps)
            state["last"] = time.monotonic()
            double = timed_loop(2 * steps)
            with lock:
                estimates.append(double - single)
                state["last"] = time.monotonic()
    finally:
        done.set()
    with lock:
        if state["code"] is None:
            emit(list(estimates), False)
            state["code"] = 0
    thread.join(timeout=60)
    return state["code"]


def card_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def per_step(counts: dict, steps: int) -> dict:
    """Launch counts over ``steps`` steps, per step (ints where exact)."""
    out = {}
    for name, n in counts.items():
        value = n / steps if steps else 0.0
        out[name] = int(value) if value == int(value) else value
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("tri", "bi_i", "bi_v"), default="tri",
                    help="tri = the flagship Tri(I+V); bi_i / bi_v the bimodal variants")
    ap.add_argument("--voxel-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--n-points", type=int, default=None,
                    help="voxel sites a sample is padded to (default 8192·(voxel_size/64)³; "
                         "~0.8 of them occupied)")
    ap.add_argument("--override", action="append", default=[],
                    help="a config override key=value (repeatable), e.g. bench.steps=10")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of one extra loop of "
                         "bench.steps steps into DIR (python -m tricolo_tpu_torch.trace_report "
                         "DIR --steps N)")
    ap.add_argument("--roofline", default=None, metavar="DIR",
                    help="after the timed pairs, write a trace and a work record of one more "
                         "loop of bench.steps steps into DIR (python -m "
                         "tricolo_tpu_torch.roofline_report DIR --steps N)")
    ap.add_argument("--pairs", type=int, default=5,
                    help="two-point estimates; the value is their median")
    ap.add_argument("--idle-wait", type=float, default=240.0,
                    help="seconds to wait at most for host load to drop first (0: no wait)")
    ap.add_argument("--stall-s", type=float, default=None,
                    help="the watchdog's threshold (default max(300, 10 × the warm-up's wall))")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    import torch

    from . import ops
    from .inference import resolve_device
    from .training import dropout_generator
    from .training.trainer import profile_trace

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.pairs < 1:
        raise ValueError("--pairs must be at least 1")
    if args.idle_wait > 0:
        wait_for_idle(args.idle_wait)
    card = card_name(device)

    cfg = bench_config(args.config, args.voxel_size, args.batch_size, args.override)
    n_points = args.n_points or 8192 * args.voxel_size**3 // 64**3
    hosts = [host_batch(cfg, n_points=n_points, seed=s) for s in range(2)]
    tile_rows = fit_budgets(cfg, hosts, args.override)
    batches = [stage(to_transfer(cfg, h, tile_rows), device) for h in hosts]
    del hosts
    _, _, step = build_step(cfg, device)
    lr = cfg.optimizer.lr
    warmup, steps = int(cfg.bench.warmup_steps), int(cfg.bench.steps)
    if warmup < 1 or steps < 1:
        raise ValueError("bench.warmup_steps and bench.steps must be at least 1")
    log(f"{args.config} {cfg.data.voxel_size}³ B {cfg.data.batch_size}, "
        f"{cfg.data.voxel_transfer} (k {tile_rows}), n_points {n_points}, {card}")

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    taken = [0]

    def run(n: int):
        losses = None
        for _ in range(n):
            losses = step(batches[taken[0] % 2], lr,
                          dropout_generator(cfg.train_seed, taken[0], device))
            taken[0] += 1
        return losses

    tic = time.perf_counter()
    losses = run(warmup)
    sync()
    warmup_s = time.perf_counter() - tic
    total = float(losses["train_loss/total_loss"])
    if not math.isfinite(total):
        raise RuntimeError(f"warm-up ended with a non-finite loss {total}")
    stall_s = args.stall_s if args.stall_s is not None else default_stall_s(warmup_s)
    log(f"warm-up: {warmup} steps in {warmup_s:.3f} s, loss {total}; stall threshold "
        f"{stall_s:.0f} s")

    def timed_loop(n: int) -> float:
        tic = time.perf_counter()
        run(n)
        sync()
        return time.perf_counter() - tic

    if args.trace:
        with profile_trace(args.trace, device, name="bench"):
            timed_loop(steps)
        log(f"trace of {steps} steps written under {args.trace}")

    ops.reset_launches()
    first_timed = taken[0]

    def emit(estimates: list, salvaged: bool) -> None:
        median = statistics.median(estimates)
        counted = taken[0] - first_timed
        log(json.dumps({"launches_per_step": per_step(ops.launches(), counted),
                        "steps": counted}))
        print(json.dumps({
            "metric": "train_pairs_per_sec_per_chip",
            "value": cfg.data.batch_size * steps / median,
            "unit": "caption-shape pairs/sec/chip",
            "step_ms": median / steps * 1e3,
            "pairs": len(estimates),
            "salvaged": salvaged,
            "config": args.config,
            "voxel_size": cfg.data.voxel_size,
            "batch_size": cfg.data.batch_size,
            "card": card,
        }), flush=True)

    code = measure(timed_loop, steps, args.pairs, stall_s, emit)
    if args.roofline:
        from .work import WorkCounter

        with (profile_trace(args.roofline, device, name="roofline", spans=False),
              WorkCounter() as counter):
            timed_loop(steps)
        counter.write(os.path.join(args.roofline, f"work.{time.time_ns()}.json"), card)
        log(f"roofline: trace and work record of {steps} steps written under {args.roofline}")
    return code


if __name__ == "__main__":
    sys.exit(main())

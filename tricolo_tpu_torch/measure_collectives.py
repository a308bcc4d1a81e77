"""The loss collectives' cost against the world size.

    python -m tricolo_tpu_torch.measure_collectives [--worlds 1 2 4 8]
        [--backend gloo|nccl] [--repeats 10]

The port's twin of ``scripts/measure_collectives.py``: at a fixed per-rank
batch of 128 × 512 f32 (seeded standard normal rows, each rank its stripe of
the global batch), time the value and gradient of the global-negative
NT-Xent — ``parallel.make_parallel_loss_fn`` in its gathered form
(``parallel.global_negatives``, the default: normalise, all-gather, the
loss at B_global) and its ``explicit_collectives`` form (each rank's logit
rows, ``psum``) — against the local loss (``global_negatives=false``: no
collective but the loss's mean), in a world of 1, 2, 4 and 8 ranks. The
NT-Xent runs through its kernels (``loss.NTXentLoss.use_pallas=true``:
their plain versions on CPU tensors).

Each time is the median of ``--repeats`` calls, each ending in a CUDA
synchronize on the card, measured on rank 0. Beside it, the bytes a rank
gathers: 2·2·B·(n − 1)·D·4 for a global form (both embeddings, forward and
again in the backward's transpose), 0 for the local one. ``--backend
gloo`` (the default) runs the ranks as processes on the CPU, as the JAX
script runs its virtual CPU mesh; ``--backend nccl`` runs each world the
machine has GPUs for, rank r on cuda:r. Prints one JSON line a (world,
loss), then one with each world's global − local gap and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time

import numpy as np

PER_RANK, DIM, SEED = 128, 512, 0
KINDS = {"global": [], "global_explicit": ["parallel.explicit_collectives=true"],
         "local": ["parallel.global_negatives=false"]}


def gathered_bytes(kind: str, per_rank: int, world: int, dim: int) -> int:
    """The bytes a rank gathers in one value and gradient (JAX l.78-83)."""
    return 0 if kind == "local" else 2 * 2 * per_rank * (world - 1) * dim * 4


def global_batch(world: int, per_rank: int = PER_RANK, dim: int = DIM):
    """The seeded (B_global, D) zis and zjs f32."""
    rng = np.random.default_rng(SEED)
    B = per_rank * world
    return (rng.standard_normal((B, dim)).astype(np.float32),
            rng.standard_normal((B, dim)).astype(np.float32))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, backend: str, port: int, repeats: int, per_rank: int,
              dim: int, keep: bool, threads: int, queue) -> None:
    """One rank: join the world, then for each loss form the value and the
    gradient of the rank's rows, timed ``repeats`` times after a warm-up.
    Rank 0 puts {form: {"ms", "loss"[, "grads"]}} on ``queue`` (``keep``:
    the full (B_global, D) gradients, gathered from the ranks)."""
    import torch
    import torch.distributed as dist

    from .bench_data import flagship_cfg
    from .parallel import World, make_parallel_loss_fn

    torch.set_num_threads(threads)
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        w = World(rank, world, dist.group.WORLD)
        zis, zjs = (torch.from_numpy(a[rank * per_rank:(rank + 1) * per_rank]).to(device)
                    for a in global_batch(world, per_rank, dim))
        out = {}
        for kind, extra in KINDS.items():
            cfg = flagship_cfg(extra=["loss.NTXentLoss.use_pallas=true", *extra])
            loss_fn = make_parallel_loss_fn(cfg, w)

            def value_and_grad():
                a, b = zis.clone().requires_grad_(True), zjs.clone().requires_grad_(True)
                loss = loss_fn(a, b)
                grads = torch.autograd.grad(loss, (a, b))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                return loss, grads

            loss, grads = value_and_grad()
            times = []
            for _ in range(repeats):
                dist.barrier()
                tic = time.perf_counter()
                value_and_grad()
                times.append(time.perf_counter() - tic)
            row = {"ms": statistics.median(times) * 1e3, "loss": loss.item()}
            if keep:
                full = []
                for g in grads:
                    parts = [torch.empty_like(g) for _ in range(world)]
                    dist.all_gather(parts, g.contiguous())
                    full.append(torch.cat(parts).cpu().numpy())
                row["grads"] = full
            out[kind] = row
        if rank == 0:
            queue.put(out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, n: int, args: tuple, timeout: float):
    """Run ``target(rank, *args, queue)`` in ``n`` spawned processes and
    return what rank 0 puts on the queue; raises when a rank exits with an
    error or nothing arrives within ``timeout`` seconds. Every process is
    joined (or killed) before it returns."""
    import multiprocessing
    import queue as queues

    ctx = multiprocessing.get_context("spawn")
    channel = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, channel)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                result = channel.get(timeout=1.0)
                break
            except queues.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"a rank exited with {failed}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no result from {n} ranks in {timeout:.0f} s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"a rank exited with {failed}")
    return result


def run_world(world: int, backend: str = "gloo", repeats: int = 10, per_rank: int = PER_RANK,
              dim: int = DIM, keep: bool = False, timeout: float = 600.0) -> dict:
    """``rank_main`` in ``world`` spawned processes; rank 0's results."""
    threads = max(1, (os.cpu_count() or 1) // world)
    return spawn_ranks(rank_main, world, (world, backend, free_port(), repeats, per_rank, dim,
                                          keep, threads), timeout)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.measure_collectives",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="gloo: ranks on the CPU; nccl: rank r on cuda:r, for each world "
                         "the machine has GPUs for")
    ap.add_argument("--repeats", type=int, default=10)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    import torch

    from .bench import card_name

    args = parse_args(argv)
    worlds = args.worlds
    if args.backend == "nccl":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("--backend nccl needs a GPU")
        worlds = [n for n in worlds if n <= count]
        if not worlds:
            raise RuntimeError(f"no world of {args.worlds} fits this machine's {count} GPUs")
    by: dict = {}
    for n in worlds:
        tic = time.perf_counter()
        result = run_world(n, args.backend, args.repeats)
        print(f"measure_collectives: {n} {args.backend} rank(s) in "
              f"{time.perf_counter() - tic:.1f} s", file=sys.stderr, flush=True)
        for kind, row in result.items():
            by[(n, kind)] = row["ms"]
            print(json.dumps({"world": n, "backend": args.backend, "loss": kind,
                              "ms_per_step": row["ms"], "value": row["loss"],
                              "gathered_bytes_per_rank":
                                  gathered_bytes(kind, PER_RANK, n, DIM)}), flush=True)
    gaps = {n: {"global": by[(n, "global")] - by[(n, "local")],
                "global_explicit": by[(n, "global_explicit")] - by[(n, "local")]}
            for n in worlds}
    device = torch.device("cuda" if args.backend == "nccl" else "cpu")
    print(json.dumps({"gap_ms": gaps, "backend": args.backend, "card": card_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

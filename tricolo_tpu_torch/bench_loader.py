"""Loader-included throughput: does the input pipeline keep the card fed?

    python -m tricolo_tpu_torch.bench_loader --mode host|e2e
        [--voxel-transfer windowed_compact] [--steps 20] [--batch-size 128]
        [--override key=value ...] [--device cuda|cpu]

The port's twin of ``scripts/bench_loader.py``. ``bench`` times pre-staged
device batches; this times the host path the trainer runs: the dataset's
items → ``collate`` (the C++ sweeps of the voxel transfer) in the
``BatchIterator``'s prefetch thread → the train step, over an epoch of
``--steps`` batches at the flagship sizes (``bench_data.flagship_cfg``:
batch 128, 6 views of 128², 64³ voxels; ``--override`` changes them).
The dataset is ``bench_data.EllipsoidDataset``: 256 distinct solid
ellipsoids of ~0.8·8192 sites, cycled.

Tile budgets, fitted as ``bench`` fits them: the full windowed transfer's
``tile_budget_frac`` to the first batch's active tiles + 25%, rounded up
to 256 rows; windowed_compact's per-sample rows k to the dataset's worst
item (the loader's ``tile_budget=auto`` rule, so no later batch can
overflow it).

* ``--mode host``: the iterator alone (no device work): one warm epoch,
  then a timed epoch; prints ``loader_host_ms_per_batch_median`` with its
  p90, mean, batches, MB a batch and the host-only pairs/s.
* ``--mode e2e``: the iterator with ``pin_memory`` on CUDA, each batch
  through ``inference.to_device_batch`` (``non_blocking`` from pinned
  memory) and the train step (``bench.build_step``; two warm-up steps on
  the first batch); prints ``loader_included_pairs_per_sec`` with ms a
  step, MB a batch, batches and the card.

One JSON line on stdout; runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

N_ITEMS = 256
N_POINTS = 8192


def batch_bytes(batch: dict) -> int:
    import torch

    return sum(v.nbytes for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))


def fit_budgets(cfg, dataset, batch_size: int) -> int:
    """Sets ``tile_budget_frac`` from the first batch; returns the
    windowed_compact rows k (module docstring)."""
    from .bench import windowed_frac
    from .data.loader import BatchIterator
    from .ops.tile_sparse import host_sample_tile_counts, host_tile_count, sample_tile_budget

    D = cfg.data.voxel_size
    probe = BatchIterator(dataset, batch_size, drop_last=True, prefetch=False,
                          voxel_transfer="packed", voxel_size=D).peek()
    tg3 = (D // 8) ** 3
    cfg.model.modules.VoxelCNNEncoder.tile_budget_frac = windowed_frac(
        host_tile_count(probe["voxel_flat"], D), batch_size, tg3)
    worst = max(host_sample_tile_counts([item["voxel_flat"] for item in dataset.items], D))
    return sample_tile_budget("auto", tg3, worst)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.bench_loader",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("host", "e2e"), default="host")
    ap.add_argument("--voxel-transfer", default="windowed_compact",
                    choices=("packed", "dense", "windowed", "windowed_compact"))
    ap.add_argument("--steps", type=int, default=20, help="batches in the timed epoch")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--override", action="append", default=[],
                    help="a config override key=value (repeatable), e.g. data.voxel_size=32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    import torch

    from .bench import build_step, card_name
    from .bench_data import EllipsoidDataset, flagship_cfg
    from .data.loader import BatchIterator
    from .inference import resolve_device, to_device_batch
    from .ops.tile_sparse import windowed_halo
    from .training import dropout_generator

    args = parse_args(argv)
    device = resolve_device(args.device)
    B = args.batch_size
    cfg = flagship_cfg(extra=[f"data.batch_size={B}",
                              f"data.voxel_transfer={args.voxel_transfer}",
                              "loss.NTXentLoss.use_pallas=true", *args.override])
    dataset = EllipsoidDataset(cfg, n_items=N_ITEMS, length=args.steps * B, n_points=N_POINTS)
    tile_rows = fit_budgets(cfg, dataset, B)
    halo = windowed_halo(cfg.model.modules.VoxelCNNEncoder.get("tile_sparse_blocks", 2))
    pin = args.mode == "e2e" and device.type == "cuda"

    def make_iter():
        return BatchIterator(dataset, B, shuffle=True, drop_last=True, prefetch=True,
                             voxel_transfer=args.voxel_transfer,
                             voxel_size=cfg.data.voxel_size, tile_budget=tile_rows,
                             windowed_halo=halo, pin_memory=pin)

    if args.mode == "host":
        it = make_iter()
        nbytes = 0
        for batch in it:  # the warm epoch
            nbytes = nbytes or batch_bytes(batch)
        times = []
        t_last = time.perf_counter()
        for _ in make_iter():
            t = time.perf_counter()
            times.append(t - t_last)
            t_last = t
        ms = np.sort(np.array(times) * 1e3)
        median = float(np.median(ms))
        print(json.dumps({
            "metric": "loader_host_ms_per_batch_median",
            "voxel_transfer": args.voxel_transfer,
            "value": median,
            "p90": float(ms[int(0.9 * (len(ms) - 1))]),
            "mean": float(ms.mean()),
            "batches": len(times),
            "h2d_mb_per_batch": nbytes / 1e6,
            "pairs_per_sec_host_only": B * 1e3 / median,
        }), flush=True)
        return 0

    _, _, step = build_step(cfg, device)
    lr = cfg.optimizer.lr
    first_host = next(iter(make_iter()))
    nbytes = batch_bytes(first_host)
    first = to_device_batch(first_host, device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    taken = 0
    for _ in range(2):
        losses = step(first, lr, dropout_generator(cfg.train_seed, taken, device))
        taken += 1
    sync()
    total = float(losses["train_loss/total_loss"])
    if not math.isfinite(total):
        raise RuntimeError(f"warm-up ended with a non-finite loss {total}")
    tic = time.perf_counter()
    n = 0
    for host in make_iter():
        step(to_device_batch(host, device), lr,
             dropout_generator(cfg.train_seed, taken, device))
        taken += 1
        n += 1
    sync()
    elapsed = time.perf_counter() - tic
    print(json.dumps({
        "metric": "loader_included_pairs_per_sec",
        "voxel_transfer": args.voxel_transfer,
        "value": n * B / elapsed,
        "ms_per_step": 1e3 * elapsed / n,
        "h2d_mb_per_batch": nbytes / 1e6,
        "batches": n,
        "card": card_name(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

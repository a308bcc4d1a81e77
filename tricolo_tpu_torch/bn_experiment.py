"""The structured retrieval experiment: 20-epoch runs with per-epoch curves.

The port's twin of the JAX package's ``scripts/bn_experiment.py``: same
flags, same overrides, same JSON layout (``runs``, ``summary``, ``args``).
Each run trains Bi(V) on ``data=structured`` (captions determine the
shapes' attributes, so retrieval metrics carry signal) at the flagship
widths — 64³ voxels, ef 32, z 512, batch 128, bf16, masked BN,
windowed_compact — with the blocked NT-Xent kernels
(``loss.NTXentLoss.use_pallas=true``) and a metrics-log row every step.

    python -m tricolo_tpu_torch.bn_experiment --modes masked --seeds 123 231 \\
        --tag _off --out experiments/torch_structured_h100_off.json
    python -m tricolo_tpu_torch.bn_experiment --modes masked --seeds 123 \\
        --tag _xdgrad --extra model.modules.VoxelCNNEncoder.explicit_dgrad=true \\
        --out experiments/torch_structured_h100_xdgrad.json

Each run's ``curve`` holds one row per validation (``val_eval/*``, the
``val_loss/total_loss`` and that epoch's mean ``train_loss/total_loss``),
``train_curve`` the mean train loss of every epoch, both read from the
run's ``metrics.jsonl``; ``step_ms`` holds the host-clock time of every
train step (each ends in a device synchronise), ``step_ms_median`` their
median past the first, ``step_s_total`` their sum, ``timers_s`` the
trainer's wall by phase (``data_load``, ``train``, ``validate``,
``checkpoint``), and ``device`` the card.
Runs on the GPU; ``--extra +device=cpu`` runs on the CPU instead.
``--modes`` defaults to ``masked``; ``--modes dense`` runs the all-site BN
arm (``masked_bn=false``, whose windowed_compact default falls back to the
packed transfer):

    python -m tricolo_tpu_torch.bn_experiment --modes dense --seeds 123 \
        --out experiments/torch_structured_h100_dense.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

METRICS = ("RR@1", "RR@5", "NDCG@5", "MRR")


def _card(torch) -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _curves(metrics_path: str) -> tuple[list, list]:
    """(validation curve, per-epoch mean train loss) from a metrics log."""
    train = defaultdict(list)
    val_rows = []
    with open(metrics_path) as f:
        for line in f:
            row = json.loads(line)
            if "train_loss/total_loss" in row:
                train[row["epoch"]].append(row["train_loss/total_loss"])
            if "val_eval/RR@5" in row:
                val_rows.append(row)
    train_curve = [{"epoch": e, "train_loss": statistics.fmean(v)}
                   for e, v in sorted(train.items())]
    means = {r["epoch"]: r["train_loss"] for r in train_curve}
    curve = [{"epoch": row["epoch"], **{m: row[f"val_eval/{m}"] for m in METRICS},
              "val_loss": row.get("val_loss/total_loss", float("nan")),
              "train_loss": means.get(row["epoch"], float("nan"))}
             for row in val_rows]
    return curve, train_curve


def run_one(mode: str, seed: int, epochs: int, models: int, out_root: str,
            extra: list[str] = (), tag: str = "") -> dict:
    import torch

    from .config import load_config
    from .data import DataModule
    from .training import Trainer

    overrides = [
        "data=structured",
        f"data.num_models={models}",
        "model.voxel_encoder=VoxelCNNEncoder",
        "precision.compute_dtype=bfloat16",
        f"train_seed={seed}",
        f"trainer.max_epochs={epochs}",
        "trainer.check_val_every_n_epoch=2",
        "trainer.log_every_n_steps=1",
        "trainer.profiler=none",
        "logger.backend=jsonl",
        f"project_root_path={out_root}",
        f"experiment_name=bn_{mode}{tag}_s{seed}",
        "checkpoint_monitor.save_top_k=0",
        "loss.NTXentLoss.use_pallas=true",
        # Both arms explicit, whatever the config default is.
        "model.modules.VoxelCNNEncoder.masked_bn=" + ("true" if mode == "masked" else "false"),
        *extra,
    ]
    cfg = load_config(overrides)
    trainer = Trainer(cfg, device=cfg.get("device", None))
    step_ms: list[float] = []
    step = trainer.train_step

    def timed(batch, lr):
        tic = time.perf_counter()
        losses = step(batch, lr)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        step_ms.append((time.perf_counter() - tic) * 1e3)
        return losses

    trainer.train_step = timed
    tic = time.time()
    trainer.fit(DataModule(cfg))
    wall = time.time() - tic

    curve, train_curve = _curves(os.path.join(cfg.logger.save_dir, "metrics.jsonl"))
    final = curve[-1] if curve else {}
    best = max(curve, key=lambda r: r["RR@5"]) if curve else {}
    # train less step_s_total is the loader's share (collation, H2D).
    timers = dict(trainer.timers)
    print(f"[{mode}{tag} seed={seed}] {wall:.0f}s  final "
          + " ".join(f"{m}={final.get(m, float('nan')):.2f}" for m in METRICS)
          + "  phases " + " ".join(f"{k}={v:.1f}s" for k, v in timers.items())
          + f" steps={sum(step_ms) / 1e3:.1f}s")
    return {"mode": mode, "seed": seed, "wall_sec": wall, "steps": len(step_ms),
            "step_ms_median": statistics.median(step_ms[1:] or step_ms),
            "step_s_total": sum(step_ms) / 1e3, "step_ms": step_ms, "timers_s": timers,
            "curve": curve, "train_curve": train_curve, "final": final, "best_by_rr5": best}


def main(argv: list[str] | None = None) -> dict:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[123, 231, 312])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--models", type=int, default=300)
    ap.add_argument("--out", default="experiments/torch_structured.json")
    ap.add_argument("--modes", nargs="+", default=["masked"])
    ap.add_argument("--tag", default="",
                    help="experiment-name suffix so A/B arms do not collide")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="more config overrides, e.g. +device=cpu data.voxel_size=32")
    args = ap.parse_args(argv)

    out_root = os.path.join(os.path.dirname(args.out) or ".", "bn_runs")
    runs = [run_one(mode, seed, args.epochs, args.models, out_root, args.extra, args.tag)
            for mode in args.modes for seed in args.seeds]

    summary = {}
    for mode in args.modes:
        finals = [r["final"] for r in runs if r["mode"] == mode and r["final"]]
        bests = [r["best_by_rr5"] for r in runs if r["mode"] == mode and r["best_by_rr5"]]
        summary[mode] = {
            f"final_{m}": {"mean": float(np.mean([f[m] for f in finals])),
                           "std": float(np.std([f[m] for f in finals])),
                           "values": [f[m] for f in finals]}
            for m in METRICS
        }
        summary[mode]["best_RR@5"] = {"mean": float(np.mean([b["RR@5"] for b in bests])),
                                      "std": float(np.std([b["RR@5"] for b in bests]))}

    result = {"runs": runs, "summary": summary, "args": vars(args), "device": _card(torch)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)

    print("\n## Structured experiment (final epoch, mean ± std over seeds)\n")
    print("| Mode | " + " | ".join(METRICS) + " | best RR@5 |")
    print("|---|" + "---|" * (len(METRICS) + 1))
    for mode in args.modes:
        s = summary[mode]
        cells = [f"{s[f'final_{m}']['mean']:.2f} ± {s[f'final_{m}']['std']:.2f}" for m in METRICS]
        cells.append(f"{s['best_RR@5']['mean']:.2f} ± {s['best_RR@5']['std']:.2f}")
        print(f"| {mode}{args.tag} | " + " | ".join(cells) + " |")
    print(f"\nwritten: {args.out} [{result['device']}]")
    return result


if __name__ == "__main__":
    main()

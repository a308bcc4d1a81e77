"""A Text2Shape chair_table-sized dress rehearsal of the train CLI.

    python -m tricolo_tpu_torch.dress_rehearsal generate [--root DIR] [--scale F]
    python -m tricolo_tpu_torch.dress_rehearsal run [--root DIR] [--epochs N]
        [--device cuda|cpu] [--extra key=value ...]
    python -m tricolo_tpu_torch.dress_rehearsal report [--root DIR]

The port's twin of ``scripts/dress_rehearsal.py``. ``generate`` writes a
synthetic split at the real chair_table cardinality (``SPLITS``: 6,777
train and 1,486 val models, 5 captions each, vocabulary 3,588; times
``--scale``, default 1) in the on-disk layout the loader reads
(``exp_data/{category}/{model}.npz`` + ``{split}_map.json``): each model a
solid ellipsoid of ~8k sites (log-normal, 2.5k-26k) at 64³ RGBA and 6
smooth views of 224², drawn from one seeded stream in the JAX script's
order, so the arrays and maps are the JAX script's bit for bit (the npz
compression runs on a thread pool; the draws stay in order). ``run``
drives ``python -m tricolo_tpu_torch.train`` on it with the JAX script's
overrides (flagship Tri(I+V), ``--epochs`` epochs, validation every
epoch, 8 loader threads; ``--device cpu`` adds ``+device=cpu``), its
output in ``train_log.txt`` with the child's peak RSS and wall appended;
on the card it samples ``nvidia-smi``'s ``utilization.gpu`` (the share of
each second a kernel ran) once a second beside the run. ``report`` reads
the log (the trainer's wall by phase: data_load, train, validate,
checkpoint), ``metrics.jsonl`` (step pace, validation metrics) and the
samples, and prints one JSON line with ``REPORT_KEYS``: peak RSS, wall,
the phases' seconds, s a step, eval wall, checkpoint sizes, whether the
tile budget fit without truncation (no truncation warning in the log), and
the train phase's idle share (1 − its mean utilisation; None without
samples). DIR defaults to ``build/dress_rehearsal`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DEFAULT_ROOT = REPO / "build" / "dress_rehearsal"
SPLITS = {
    "train": {"models": 6777, "captions_per_model": 5},
    "val": {"models": 1486, "captions_per_model": 5},
}
VOCAB = 3588
CATEGORIES = ("03001627", "04379243")  # chair, table
STORED_VIEWS = 6
STORED_VIEW_SIZE = 224
VOXEL_D = 64
REPORT_KEYS = ("peak_rss_gb", "total_wall_s", "data_load_s", "train_s", "validate_s",
               "checkpoint_s", "steps", "s_per_step", "val_epochs", "eval_wall_s", "ckpt_mb",
               "tile_budget_fit", "train_idle_share", "utilization_samples")


def _one_model(rng, model_id: str):
    """One model's payload: a solid-ellipsoid voxel64 RGBA grid and 6
    smooth synthetic views (the JAX script's draws, in its order)."""
    D = VOXEL_D
    n_target = int(rng.lognormal(np.log(8000), 0.35))
    n_target = int(np.clip(n_target, 2500, 26000))
    z, y, x = np.ogrid[0:D, 0:D, 0:D]
    base_r = (n_target * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    c = rng.uniform(0.35 * D, 0.65 * D, 3)
    r = base_r * rng.uniform(0.8, 1.25, 3)
    mask = (
        ((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((x - c[2]) / r[2]) ** 2
    ) <= 1.0
    rgb_base = rng.integers(40, 216, 3, dtype=np.uint8)
    vox = np.zeros((4, D, D, D), np.uint8)
    for ch in range(3):
        vox[ch][mask] = rgb_base[ch]
    vox[3][mask] = 255

    S = STORED_VIEW_SIZE
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    views = np.empty((STORED_VIEWS, 3, S, S), np.uint8)
    for v in range(STORED_VIEWS):
        phase = 2 * np.pi * v / STORED_VIEWS
        shade = 0.5 + 0.5 * np.sin(2 * np.pi * xx + phase) * np.cos(np.pi * yy)
        for ch in range(3):
            views[v, ch] = (shade * float(rgb_base[ch])).astype(np.uint8)
    return vox, views


def splits(scale: float = 1.0) -> dict:
    """``SPLITS`` with the model counts scaled (at least one model each)."""
    return {name: dict(spec, models=max(1, round(spec["models"] * scale)))
            for name, spec in SPLITS.items()}


def exp_dir(root: Path) -> Path:
    return root / "text2shape-data" / "chair_table" / "preprocessed" / "exp_data"


def _save(path: Path, vox, views) -> None:
    np.savez_compressed(path, **{f"voxel{VOXEL_D}": vox, "images": views})


def generate(root: Path, seed: int = 0, scale: float = 1.0) -> dict:
    """Write the split under ``root``; returns {split: models, "seconds"}."""
    exp = exp_dir(root)
    exp.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    out: dict = {}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        pending = []
        for split, spec in splits(scale).items():
            rows = []
            for i in range(spec["models"]):
                cat = CATEGORIES[i % 2]
                model_id = f"{split}{i:06x}"
                npz_path = exp / cat / f"{model_id}.npz"
                npz_path.parent.mkdir(exist_ok=True)
                if not npz_path.exists():
                    pending.append(pool.submit(_save, npz_path, *_one_model(rng, model_id)))
                for _ in range(spec["captions_per_model"]):
                    n_tok = int(rng.integers(8, 21))
                    tokens = rng.integers(1, VOCAB, n_tok).tolist()
                    rows.append({"model_id": model_id, "category": cat,
                                 "caption": " ".join(f"w{t}" for t in tokens),
                                 "tokens": tokens})
                if len(pending) >= 64:  # bound the payloads held in memory
                    for future in pending:
                        future.result()
                    pending = []
            with open(exp / f"{split}_map.json", "w") as f:
                json.dump(rows, f)
            out[split] = spec["models"]
            print(f"{split}: {spec['models']} models, {len(rows)} captions "
                  f"({time.time() - t0:.0f}s total)", flush=True)
        for future in pending:
            future.result()
    out["seconds"] = time.time() - t0
    print(f"dataset of {sum(v for k, v in out.items() if k != 'seconds')} models at {exp} in "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def train_command(root: Path, epochs: int, device: str, extra=()) -> list[str]:
    """The train CLI with the JAX script's overrides."""
    cmd = [sys.executable, "-m", "tricolo_tpu_torch.train",
           "data=text2shape_chair_table",
           f"data.dataset_root_path={root}",
           "model.voxel_encoder=VoxelCNNEncoder",
           "model.image_encoder=MVCNNEncoder",
           f"trainer.max_epochs={epochs}",
           "trainer.check_val_every_n_epoch=1",
           "experiment_name=dress_rehearsal",
           f"project_root_path={root}",
           "data.num_workers=8",
           *extra]
    if device == "cpu":
        cmd.append("+device=cpu")
    return cmd


def run(root: Path, epochs: int, device: str = "cuda", extra=()) -> int:
    """The train CLI on the split under ``root`` (module docstring); its
    exit code."""
    import resource

    logp = root / "train_log.txt"
    cmd = train_command(root, epochs, device, extra)
    print(" ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    sink = open(root / "utilization.csv", "w") if device != "cpu" else None
    sampler = None
    t0 = time.time()
    try:
        if sink is not None:
            sampler = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu",
                 "--format=csv,noheader", "-lms", "1000"], stdout=sink,
                stderr=subprocess.DEVNULL)
        with open(logp, "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                                env=env).returncode
    finally:
        if sampler is not None:
            sampler.terminate()
            sampler.wait(timeout=30)
        if sink is not None:
            sink.close()
    wall = time.time() - t0
    peak_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    with open(logp, "a") as log:
        log.write(f"\n\tMaximum resident set size (kbytes): {peak_kb}\n")
        log.write(f"\tElapsed (wall clock) seconds: {wall:.2f}\n")
        log.write(f"\tStarted at (unix seconds): {t0:.3f}\n")
    print(f"train rc={rc} wall={wall:.0f}s; log: {logp}", flush=True)
    return rc


def _utilization(root: Path, start: float, end: float) -> list[float]:
    """The ``nvidia-smi`` utilization.gpu samples (percent) taken in [start, end]
    (unix seconds)."""
    from datetime import datetime

    path = root / "utilization.csv"
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            stamp, util = (part.strip() for part in line.split(","))
            t = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
            value = float(util.rstrip(" %"))
        except ValueError:
            continue
        if start <= t <= end:
            out.append(value)
    return out


def report(root: Path) -> dict:
    """The rehearsal's numbers (module docstring) as a dict with
    ``REPORT_KEYS``."""
    log = (root / "train_log.txt").read_text()
    out: dict = dict.fromkeys(REPORT_KEYS)
    m = re.search(r"Maximum resident set size \(kbytes\): (\d+)", log)
    if m:
        out["peak_rss_gb"] = int(m.group(1)) / 1e6
    m = re.search(r"Elapsed \(wall clock\) seconds: ([\d.]+)", log)
    if m:
        out["total_wall_s"] = float(m.group(1))
    for phase in ("train", "validate", "checkpoint", "data_load"):
        m = re.search(rf"^\s*{phase}\s+([\d.]+)s", log, re.M)
        out[f"{phase}_s"] = float(m.group(1)) if m else 0.0
    out["tile_budget_fit"] = not re.search(r"truncat|will be dropped", log, re.I)
    metrics_path = (root / "output" / "Text2ShapeChairTable" / "dress_rehearsal" / "training"
                    / "metrics.jsonl")
    steps, vals, epochs = [], [], {}
    if metrics_path.exists():
        for line in metrics_path.read_text().splitlines():
            row = json.loads(line)
            if "val_eval/RR@5" in row:
                epochs[row["epoch"]] = {k.split("/")[-1]: v for k, v in row.items()
                                        if k.startswith("val_eval/")}
                vals.append(row)
            elif "train_loss/total_loss" in row:
                steps.append(row)
    out["val_epochs"] = epochs
    out["steps"] = max((row["step"] for row in steps + vals), default=0)
    paces = [(b["time"] - a["time"]) / (b["step"] - a["step"])
             for a, b in zip(steps, steps[1:]) if b["step"] > a["step"]]
    if paces:
        out["s_per_step"] = {"median": float(np.median(paces)), "min": min(paces),
                             "max": max(paces)}
    out["eval_wall_s"] = [v["time"] - max(s["time"] for s in steps if s["time"] < v["time"])
                          for v in vals if any(s["time"] < v["time"] for s in steps)]
    ckpt_dir = metrics_path.parent
    out["ckpt_mb"] = sorted(os.path.getsize(ckpt_dir / f) / 1e6 for f in os.listdir(ckpt_dir)
                            if f.endswith(".ckpt")) if ckpt_dir.exists() else []
    util = _utilization(root, steps[0]["time"], steps[-1]["time"]) if len(steps) > 1 else []
    out["utilization_samples"] = len(util)
    out["train_idle_share"] = 1.0 - float(np.mean(util)) / 100.0 if util else None
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.dress_rehearsal",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("generate", "run", "report"))
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--scale", type=float, default=1.0, help="generate: model counts × F")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="run: cuda (default) or cpu")
    ap.add_argument("--extra", nargs="*", default=[], help="run: more train CLI overrides")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    if args.cmd == "generate":
        generate(root, scale=args.scale)
    elif args.cmd == "run":
        return run(root, args.epochs, args.device, args.extra)
    else:
        print(json.dumps(report(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

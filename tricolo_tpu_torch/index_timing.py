"""Time ``RetrievalServer.build_index`` end to end: the flagship
synthetic-256 index (Tri(I+V), 64³ voxels, 6×128² views, batch 128, bf16,
windowed_compact), random weights from seed 0.

    python tricolo_tpu_torch/index_timing.py [--root DIR] [--repeats 5]

``--root`` names the checkout whose ``tricolo_tpu_torch`` is timed (default:
the one holding this file), so one machine can time two versions of the
package in turns, each in its own process. One warm-up build (kernels,
cuDNN plans, pinned buffers), then ``--repeats`` builds, each from the
split's set-up to the last embedding on the host (a device synchronise
before and after). Prints one JSON line: the walls, their median, the card
and the host CPU. ``--extra`` appends config overrides (``+device=cpu
data.voxel_size=32 ...`` for a small run on the CPU); without ``+device``
it needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = [
    "data=synthetic",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "precision.compute_dtype=bfloat16",
    "data.voxel_size=64",
    "data.image_size=128",
    "data.num_views=6",
    "data.batch_size=128",
    "data.vocab_size=3588",
    "data.num_models=256",
    "experiment_name=index_timing",
]


def _describe(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return ""


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--extra", nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    import tricolo_tpu_torch
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer

    cfg = load_config(FLAGSHIP + args.extra)
    torch.manual_seed(0)
    server = RetrievalServer(cfg, TriCoLoNet.from_config(cfg), device=cfg.get("device", None))
    cuda = server.device.type == "cuda"

    def build() -> float:
        if cuda:
            torch.cuda.synchronize()
        tic = time.perf_counter()
        server.build_index(DataModule(cfg))
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - tic

    warmup = build()
    walls = [build() for _ in range(args.repeats)]
    lscpu = dict(line.split(":", 1) for line in _describe(["lscpu"]).splitlines() if ":" in line)
    card = (_describe(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
            .strip().splitlines() or ["none"])[0] if cuda else "cpu"
    result = {"package": str(Path(tricolo_tpu_torch.__file__).resolve().parent),
              "models": len(server.index.model_ids),
              "warmup_s": warmup, "walls_s": walls, "median_s": statistics.median(walls),
              "card": card, "cpu": lscpu.get("Model name", "unknown").strip()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

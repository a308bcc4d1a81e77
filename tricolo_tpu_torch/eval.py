"""Offline evaluation of a saved prediction pickle.

    python -m tricolo_tpu_torch.eval +prediction_file_path=output/.../predictions/output.p

Reads the ``output.p`` that either package's test CLI writes, ranks it on
the GPU (``evaluation.compute_metrics_on_device``; ``+device=cpu`` on the
CPU) and prints "RR@1 RR@5 NDCG@5 MRR" as the JAX package's ``eval.py``
does. The numpy pipeline it equals (RR@k exactly, NDCG and MRR to f32
rounding) stays the reference.
"""

from __future__ import annotations

import pickle
import sys


def main(argv: list[str] | None = None):
    from .config import load_config
    from .evaluation import compute_metrics_on_device
    from .inference import resolve_device

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    path = cfg.get("prediction_file_path", None)
    if not path:
        raise AssertionError("pass +prediction_file_path=<output.p>")
    device = resolve_device(cfg.get("device", None))
    with open(path, "rb") as f:
        embeddings = pickle.load(f)
    metrics = compute_metrics_on_device(embeddings, device)[0]
    metrics.print_results()
    return metrics


if __name__ == "__main__":
    main()

"""Retrieval evaluation on the device: similarity, ranking and metrics.

Port of ``tricolo_tpu.evaluation.device``. The (Q, M) similarity matrix is
one f32 product, the ranking one stable argsort, flipped — the numpy
pipeline's tie order: among equal similarities the higher fit index ranks
first — and every metric a masked reduction, so the rankings never reach
the host. The numpy pipeline (``retrieval.py``) stays the reference.

Scope: text→shape retrieval, where the fit set is the deduplicated shape
matrix, so each query has exactly one relevant item. The numpy path's
fit == query self-removal (shape↔shape evals) is not handled here.
"""

from __future__ import annotations

import numpy as np
import torch

from .retrieval import N_NEIGHBORS, RetrievalMetrics, construct_embeddings_matrix


def _device_metrics(text, shape, labels, n_neighbors: int) -> dict:
    sims = text @ shape.T
    order = torch.argsort(sims, dim=1, stable=True).flip(1)
    top_k = order[:, :n_neighbors]
    # After deduplication the fit labels are the fit indices.
    rel = (top_k == labels[:, None]).float()
    num_correct = torch.cumsum(rel, dim=1)
    ranks = torch.arange(1, n_neighbors + 1, dtype=torch.float32, device=text.device)
    discounts = torch.log2(ranks + 1)
    ideal = torch.zeros(n_neighbors, device=text.device)
    ideal[0] = 1.0
    dcg = torch.cumsum((torch.exp2(rel) - 1) / discounts, dim=1)
    idcg = torch.cumsum((torch.exp2(ideal) - 1) / discounts, dim=0)
    # argmax returns the first maximum: the rank of the one relevant item.
    first_hit = torch.argmax((order == labels[:, None]).to(torch.uint8), dim=1)
    # Sums over the queries; the host divides by Q in float64, so the
    # hit counts' rates come out as the numpy pipeline's, bit for bit.
    return {
        "precision": torch.sum(num_correct / ranks, dim=0),
        "recall": torch.sum(num_correct, dim=0),  # one relevant item a query
        "recall_rate": torch.sum(num_correct > 0, dim=0),
        "ndcg": torch.sum(dcg / idcg, dim=0),
        "mrr": torch.sum(1.0 / (first_hit + 1).float()),
        "top_k": top_k,
        "top_k_sims": torch.gather(sims, 1, top_k),
    }


def compute_metrics_on_device(embeddings_dict, device, n_neighbors: int = N_NEIGHBORS):
    """Device twin of ``retrieval.compute_metrics`` (no artifacts) →
    ``(RetrievalMetrics, top_k, top_k_sims, label_to_model_id)``; the last
    three feed ``write_nearest_info`` without rebuilding the matrices."""
    text, shape, labels, _, label_to_model_id = construct_embeddings_matrix(embeddings_dict)
    with torch.no_grad():
        out = _device_metrics(
            torch.as_tensor(text, dtype=torch.float32, device=device),
            torch.as_tensor(shape, dtype=torch.float32, device=device),
            torch.as_tensor(labels, device=device),
            min(n_neighbors, shape.shape[0]),
        )
    host = {k: v.cpu().numpy() for k, v in out.items()}
    q = text.shape[0]
    metrics = RetrievalMetrics(
        precision=host["precision"].astype(np.float64) / q,
        recall=host["recall"].astype(np.float64) / q,
        recall_rate=host["recall_rate"].astype(np.float64) / q,
        ndcg=host["ndcg"].astype(np.float64) / q,
        mrr=float(host["mrr"]) / q,
    )
    return metrics, host["top_k"], host["top_k_sims"], label_to_model_id

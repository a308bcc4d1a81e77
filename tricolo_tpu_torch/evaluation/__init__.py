"""Retrieval evaluation (numpy)."""

from .retrieval import (
    RetrievalMetrics,
    compute_metrics,
    compute_nearest_neighbors,
    compute_pr_at_k,
    construct_embeddings_matrix,
    write_nearest_info,
)

__all__ = [
    "RetrievalMetrics",
    "compute_metrics",
    "compute_nearest_neighbors",
    "compute_pr_at_k",
    "construct_embeddings_matrix",
    "write_nearest_info",
]

"""Retrieval evaluation: the numpy pipeline and its device twin."""

from .device import compute_metrics_on_device
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
    "compute_metrics_on_device",
    "compute_nearest_neighbors",
    "compute_pr_at_k",
    "construct_embeddings_matrix",
    "write_nearest_info",
]

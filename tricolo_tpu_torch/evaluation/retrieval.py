"""Text→shape retrieval metrics (RR@k, NDCG@k, precision/recall@k, MRR).

The port's numpy copy of ``tricolo_tpu.evaluation.retrieval`` (the
reference's evaluation pipeline, tricolo/evaluation/eval_retrieval.py):

* the shape matrix is deduplicated by *first occurrence* of each model_id in
  caption order;
* similarity is the raw dot product;
* ranking is a full descending argsort; ties resolve as ``np.argsort`` +
  flip (stable sort reversed);
* when fit == query, each query's self-match is removed from its neighbor
  list;
* RR@k ("recall_rate") = fraction of queries with ≥1 relevant in top-k;
  NDCG@k uses exp2-gain binary-relevance DCG against an ideal prefix;
  MRR = mean over queries of 1/rank of the *first* occurrence of the query's
  label in the full ranking;
* ``nearest.jsonl`` rows are written in a random-permutation order with the
  top-k retrieved model ids and distances (each query's own top-k
  distances, descending).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Sequence

import numpy as np

N_NEIGHBORS = 5  # top-k used for all @k metrics (eval_retrieval.py:257)
_BLOCK_QUERY_THRESHOLD = 8000
_BLOCK_SIZE = 3000


@dataclasses.dataclass
class RetrievalMetrics:
    """Per-k metric arrays (index k-1 = metric@k) plus scalar MRR."""

    precision: np.ndarray
    recall: np.ndarray
    recall_rate: np.ndarray
    ndcg: np.ndarray
    mrr: float

    def summary(self, prefix: str = "") -> dict[str, float]:
        """The four headline numbers, ×100 (reference tricolo_net.py:94-97).

        When the fit set is smaller than 5 the @5 slots report the deepest
        available k (the reference would crash on such tiny sets).
        """
        last = len(self.recall_rate) - 1
        return {
            f"{prefix}RR@1": float(self.recall_rate[0] * 100),
            f"{prefix}RR@5": float(self.recall_rate[min(4, last)] * 100),
            f"{prefix}NDCG@5": float(self.ndcg[min(4, last)] * 100),
            f"{prefix}MRR": float(self.mrr * 100),
        }

    def print_results(self):
        """Reference `_print_results` format (eval_retrieval.py:309-313)."""
        last = min(4, len(self.recall_rate) - 1)
        print("\nRR@1 RR@5 NDCG@5 MRR")
        print(
            f"{round(self.recall_rate[0] * 100, 2)} "
            f"{round(self.recall_rate[last] * 100, 2)} "
            f"{round(self.ndcg[last] * 100, 2)} "
            f"{round(self.mrr * 100, 2)}"
        )


def construct_embeddings_matrix(embeddings_dict: Mapping[str, Any]):
    """Build (text_matrix, shape_matrix, labels, fit_labels, label_to_model_id).

    ``embeddings_dict["caption_embedding_tuples"]`` holds per-caption tuples
    (caption, category, model_id, text_embedding, shape_embedding) — the
    reference's accumulation format (tricolo_net.py:124-158). One text row per
    caption; one shape row per unique model_id, first occurrence wins
    (eval_retrieval.py:38-63).
    """
    tuples = embeddings_dict["caption_embedding_tuples"]
    if not tuples:
        raise ValueError("no caption embedding tuples to evaluate")
    embedding_dim = np.asarray(tuples[0][3]).shape[0]
    num_embeddings = len(tuples)

    text_matrix = np.zeros((num_embeddings, embedding_dim))
    labels = np.zeros(num_embeddings, dtype=np.int64)
    shape_rows = []
    model_id_to_label: dict[Any, int] = {}
    label_to_model_id: dict[int, Any] = {}

    for idx, (_, _, model_id, text_emb, shape_emb) in enumerate(tuples):
        if model_id not in model_id_to_label:
            label = len(model_id_to_label)
            model_id_to_label[model_id] = label
            label_to_model_id[label] = model_id
            shape_rows.append(np.asarray(shape_emb))
        text_matrix[idx] = np.asarray(text_emb)
        labels[idx] = model_id_to_label[model_id]

    shape_matrix = np.vstack(shape_rows)
    fit_labels = np.arange(shape_matrix.shape[0], dtype=np.int64)
    return text_matrix, shape_matrix, labels, fit_labels, label_to_model_id


def _rank_block(
    fit_matrix: np.ndarray,
    query_block: np.ndarray,
    n_neighbors: int,
    fit_eq_query: bool,
    range_start: int = 0,
):
    """Descending full ranking + top-k for one query block.

    Matches reference `_compute_nearest_neighbors_cosine`
    (eval_retrieval.py:68-99) including its tie-breaking (stable ascending
    argsort, reversed) and the self-removal rule, with the axis=1 distances
    flip fix documented in the module docstring.
    """
    k = n_neighbors + 1 if fit_eq_query else n_neighbors
    k = min(k, fit_matrix.shape[0])
    similarities = query_block @ fit_matrix.T
    sort_indices = np.flip(np.argsort(similarities, axis=1, kind="stable"), 1)
    indices = sort_indices[:, :k]
    # Gather through the argsort instead of a second full O(Q·M log M) sort.
    distances = np.take_along_axis(similarities, indices, axis=1)

    if fit_eq_query:
        n_neighbors = min(n_neighbors, fit_matrix.shape[0] - 1)
        n_queries = indices.shape[0]
        self_ids = np.arange(range_start, range_start + n_queries)[:, None]
        has_self = indices == self_ids
        final = np.empty((n_queries, n_neighbors), dtype=indices.dtype)
        for row in range(n_queries):
            hit = np.nonzero(has_self[row])[0]
            if hit.size:
                final[row] = np.delete(indices[row], hit[0])
            else:
                final[row] = indices[row, :n_neighbors]
        indices = final
        distances = distances[:, :n_neighbors]
    return distances, indices, sort_indices


def compute_nearest_neighbors(
    fit_matrix: np.ndarray,
    query_matrix: np.ndarray,
    n_neighbors: int = N_NEIGHBORS,
):
    """(distances, top-k indices, full sort_indices) for every query.

    Replicates the reference's ≥8000-query blocking at 3000 — which matters
    because self-removal compares indices against block-relative positions
    (eval_retrieval.py:102-130).
    """
    fit_eq_query = fit_matrix.shape == query_matrix.shape and np.allclose(
        fit_matrix, query_matrix
    )
    n_queries = query_matrix.shape[0]
    if n_queries > _BLOCK_QUERY_THRESHOLD:
        parts = [
            _rank_block(
                fit_matrix,
                query_matrix[start : start + _BLOCK_SIZE],
                n_neighbors,
                fit_eq_query,
                range_start=start,
            )
            for start in range(0, n_queries, _BLOCK_SIZE)
        ]
        distances, indices, sort_indices = (np.vstack([p[i] for p in parts]) for i in range(3))
        return distances, indices, sort_indices
    return _rank_block(fit_matrix, query_matrix, n_neighbors, fit_eq_query)


def compute_pr_at_k(
    indices: np.ndarray,
    sort_indices: np.ndarray,
    labels: np.ndarray,
    n_neighbors: int,
    fit_labels: np.ndarray | None = None,
) -> RetrievalMetrics:
    """Vectorized port of the reference's metric loop (eval_retrieval.py:149-207).

    The reference iterates queries in Python; every quantity here is a masked
    (Q, k) reduction. Verified element-equal against a literal oracle in
    tests/test_retrieval.py.
    """
    if fit_labels is None:
        fit_labels = labels
    labels = np.asarray(labels)
    fit_labels = np.asarray(fit_labels)
    num_embeddings = labels.shape[0]
    n_neighbors = min(n_neighbors, indices.shape[1])
    # Truncate retrieved columns to n_neighbors (the reference's Python loop
    # does this implicitly; without it a smaller n_neighbors broadcasts
    # (Q, k) against (n_neighbors,) and crashes).
    indices = indices[:, :n_neighbors]

    # Binary relevance of each retrieved neighbor.
    nearest_classes = fit_labels[indices]  # (Q, k)
    rel = (nearest_classes == labels[:, None]).astype(np.float32)
    num_correct = np.cumsum(rel, axis=1)  # (Q, k): hits within top-k

    # Ideal relevance prefix: as many 1s as the query has relevant fit items.
    label_counter = np.bincount(fit_labels)
    num_relevant = label_counter[labels]  # (Q,)
    clamped = np.minimum(num_relevant, n_neighbors)
    rel_ideal = (np.arange(n_neighbors)[None, :] < clamped[:, None]).astype(np.float32)

    # exp2-gain DCG (binary relevance → gain 1 per hit) with log2 discounts.
    discounts = np.log2(np.arange(1, n_neighbors + 1) + 1)
    dcg = np.cumsum((np.exp2(rel) - 1) / discounts, axis=1)
    dcg_ideal = np.cumsum((np.exp2(rel_ideal) - 1) / discounts, axis=1)
    ndcg = dcg / dcg_ideal

    # MRR over the *full* ranking: 1/(first position of the query's label).
    full_classes = fit_labels[sort_indices]  # (Q, n_fit)
    first_hit = np.argmax(full_classes == labels[:, None], axis=1)
    mrr = float(np.mean(1.0 / (first_hit + 1)))

    return RetrievalMetrics(
        precision=np.sum(num_correct / np.arange(1, n_neighbors + 1), axis=0) / num_embeddings,
        recall=np.sum(num_correct / num_relevant[:, None], axis=0) / num_embeddings,
        recall_rate=np.sum(num_correct > 0, axis=0) / num_embeddings,
        ndcg=np.sum(ndcg, axis=0) / num_embeddings,
        mrr=mrr,
    )


def write_nearest_info(
    tuples: Sequence,
    indices: np.ndarray,
    distances: np.ndarray,
    label_to_model_id: Mapping[int, Any],
    path: str = "nearest.jsonl",
    rng: np.random.Generator | None = None,
):
    """Write per-query retrieval rows as JSON lines (eval_retrieval.py:281-304).

    Row format matches the reference: cat_id, groundtruth "<model_id>-%04d"
    (suffix = query index), retrieved_models top-k list, distance list. Rows
    are emitted in a random-permutation order as upstream does.
    """
    rng = rng or np.random.default_rng()
    perm = rng.permutation(len(indices))
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as handle:
        for i in perm:
            _, cat_id, model_id = tuples[i][0], tuples[i][1], tuples[i][2]
            row = {
                "cat_id": cat_id,
                "groundtruth": f"{model_id}-{i:04d}",
                "retrieved_models": [label_to_model_id[c] for c in indices[i]],
                "distance": np.asarray(distances[i], dtype=float).tolist(),
            }
            handle.write(json.dumps(row) + "\n")


def compute_metrics(
    embeddings_dict: Mapping[str, Any],
    print_results: bool = False,
    nearest_path: str | None = "nearest.jsonl",
    rng: np.random.Generator | None = None,
) -> RetrievalMetrics:
    """Full pipeline: matrices → NN → metrics → artifacts (eval_retrieval.py:249-278)."""
    text_matrix, shape_matrix, labels, fit_labels, label_to_model_id = (
        construct_embeddings_matrix(embeddings_dict)
    )
    distances, indices, sort_indices = compute_nearest_neighbors(
        shape_matrix, text_matrix, N_NEIGHBORS
    )
    metrics = compute_pr_at_k(indices, sort_indices, labels, N_NEIGHBORS, fit_labels)
    if nearest_path:
        write_nearest_info(
            embeddings_dict["caption_embedding_tuples"],
            indices,
            distances,
            label_to_model_id,
            path=nearest_path,
            rng=rng,
        )
    if print_results:
        metrics.print_results()
    return metrics

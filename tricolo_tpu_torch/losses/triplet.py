"""Semi-hard triplet loss, vectorised, plain PyTorch.

Port of ``tricolo_tpu.losses.triplet`` (the reference's double loop,
triplet.py:103-125, as masked reductions): positives are the diagonal
cross-modal pairs (i, i); a negative (i, j), j ≠ i, is *semi-hard* when
d_ii < d_ij < d_ii + margin and adds d_ii − d_ij + margin. Without any
semi-hard pair in the batch the *hard* negatives (d_ij < d_ii) are used
instead. The loss is the mean over the selected pairs, in f32, with no
host synchronisation (``torch.where`` on the counts, not a branch).

``pairwise_distances`` is the reference's expression to the letter — the
squared-norm terms transposed against the textbook formula (equal for
L2-normalised inputs), the clamp at zero (``torch.maximum``, whose
gradient splits at a tie as ``jnp.maximum``'s does) and the masked square
root with its 1e-16 — since the gradient where a distance is 0 depends on
exactly that expression. The inputs are the encoders' outputs as they are:
the loss does not normalise them.

As in the JAX package (a documented divergence from the reference, which
divides by zero), a batch with no semi-hard and no hard pair gives 0.0.
"""

from __future__ import annotations

import torch


def pairwise_distances(zis: torch.Tensor, zls: torch.Tensor,
                       squared: bool = False) -> torch.Tensor:
    """Reference ``_pairwise_distances`` (triplet.py:11-45): (B, B)."""
    dot = zls @ zis.T
    a_sq = (zls * zls).sum(dim=1)  # diag(zls zlsᵀ)
    b_sq = (zis * zis).sum(dim=1)  # diag(zis zisᵀ)
    # Reference quirk: a_sq broadcasts over rows, b_sq over columns.
    distances = a_sq[None, :] - 2.0 * dot + b_sq[:, None]
    distances = torch.maximum(distances, torch.zeros_like(distances))
    if not squared:
        zero_mask = (distances == 0.0).to(distances.dtype)
        distances = distances + zero_mask * 1e-16
        distances = (1.0 - zero_mask) * torch.sqrt(distances)
    return distances


def triplet_loss(zis: torch.Tensor, zls: torch.Tensor, margin: float = 0.025) -> torch.Tensor:
    """The semi-hard (else hard) triplet loss of (B, D) embeddings."""
    distances = pairwise_distances(zis.float(), zls.float())
    batch = distances.shape[0]
    d_pos = distances.diagonal()[:, None]  # d_ii per anchor row
    off_diag = ~torch.eye(batch, dtype=torch.bool, device=distances.device)
    semi_hard = off_diag & (d_pos < distances) & (distances < d_pos + margin)
    hard = off_diag & (distances < d_pos)
    terms = d_pos - distances + margin
    zero = torch.zeros((), dtype=terms.dtype, device=terms.device)
    semi_count, hard_count = semi_hard.sum(), hard.sum()
    use_semi = semi_count > 0
    total = torch.where(use_semi, torch.where(semi_hard, terms, zero).sum(),
                        torch.where(hard, terms, zero).sum())
    count = torch.where(use_semi, semi_count, hard_count)
    return total / count.clamp(min=1).to(total.dtype)

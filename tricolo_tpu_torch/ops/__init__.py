"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version; each launch counts ``launches.<wrapper>`` in ``tracing``
(``launches()``, ``reset_launches()``).

* ``bn_relu_pool`` (K1, ``csrc/bn_relu_pool.cu``) — masked BN → ReLU →
  zero → MaxPool(2³) + first argmax; replaces ``fused_bn_pool._fwd_kernel``;
  ``bn_relu_pool_unmasked`` is its unmasked (all-site) entry, that
  kernel's own function.
* ``scatter_tiles_ps`` / ``scatter_tiles_global`` (K2, ``csrc/tile_scatter.cu``)
  — tile → grid scatter by per-sample or global tile id; replaces
  ``_graveyard/dma_tiles._scatter_kernel``.
* ``bn_relu_pool_bwd`` (K3, ``csrc/bn_relu_pool_bwd.cu``) — the
  full-resolution dy of the masked BN-ReLU-pool backward; replaces
  ``fused_bn_pool._dy_kernel``; ``bn_relu_pool_bwd_unmasked`` is its
  unmasked entry.
* ``nt_xent_fwd`` / ``nt_xent_bwd_rows`` / ``nt_xent_bwd_cols`` (K4-K6,
  ``csrc/nt_xent.cu``) — the blocked online-softmax NT-Xent; replace
  ``nt_xent_pallas._fwd_kernel`` / ``_bwd_kernel`` / ``_bwd_cols_kernel``;
  ``nt_xent_fwd_pair`` computes both directions' forward from one pass over
  the logits (the loss's forward), ``nt_xent_bwd`` K5's and K6's terms of
  one operand in one launch (the loss's backward).
* ``gather_tiles`` (K7, ``csrc/tile_gather.cu``) — halo'd tile gather from
  a dense grid by global tile id; replaces ``_graveyard/dma_tiles._gather_kernel``.

Beside them: ``conv3d_valid_explicit_dgrad`` (cuDNN convolutions with the
input gradient written as a forward conv) and the tile-sparse helpers of
``tile_sparse``.
"""

from .. import tracing
from .bn_relu_pool import (
    batch_stats,
    bn_relu_pool,
    bn_relu_pool_bwd,
    bn_relu_pool_bwd_plain,
    bn_relu_pool_bwd_unmasked,
    bn_relu_pool_plain,
    bn_relu_pool_train,
    bn_relu_pool_unmasked,
    fold_bn,
    masked_bn_relu_pool_train,
)
from .conv3d import conv3d_valid_explicit_dgrad
from .nt_xent import (
    blocked_nt_xent_loss,
    nt_xent_bwd,
    nt_xent_bwd_cols,
    nt_xent_bwd_cols_plain,
    nt_xent_bwd_plain,
    nt_xent_bwd_rows,
    nt_xent_bwd_rows_plain,
    nt_xent_fwd,
    nt_xent_fwd_pair,
    nt_xent_fwd_pair_plain,
    nt_xent_fwd_plain,
)
from .tile_gather import gather_tiles, gather_tiles_autograd, gather_tiles_plain
from .tile_scatter import (
    gather_tiles_global,
    gather_tiles_ps,
    scatter_tiles,
    scatter_tiles_global,
    scatter_tiles_global_autograd,
    scatter_tiles_global_plain,
    scatter_tiles_ps,
    scatter_tiles_ps_plain,
)

KERNELS = (
    bn_relu_pool,
    scatter_tiles_ps,
    bn_relu_pool_bwd,
    nt_xent_fwd,
    nt_xent_fwd_pair,
    nt_xent_bwd_rows,
    nt_xent_bwd_cols,
    nt_xent_bwd,
    gather_tiles,
    scatter_tiles_global,
    bn_relu_pool_unmasked,
    bn_relu_pool_bwd_unmasked,
)


def reset_launches() -> None:
    tracing.reset_counts("launches.")


def launches() -> dict[str, int]:
    return {wrapper.__name__: tracing.counter("launches." + wrapper.__name__)
            for wrapper in KERNELS}


__all__ = [
    "KERNELS",
    "batch_stats",
    "blocked_nt_xent_loss",
    "bn_relu_pool",
    "bn_relu_pool_bwd",
    "bn_relu_pool_bwd_plain",
    "bn_relu_pool_bwd_unmasked",
    "bn_relu_pool_plain",
    "bn_relu_pool_train",
    "bn_relu_pool_unmasked",
    "conv3d_valid_explicit_dgrad",
    "fold_bn",
    "gather_tiles",
    "gather_tiles_autograd",
    "gather_tiles_global",
    "gather_tiles_plain",
    "gather_tiles_ps",
    "launches",
    "masked_bn_relu_pool_train",
    "nt_xent_bwd",
    "nt_xent_bwd_cols",
    "nt_xent_bwd_cols_plain",
    "nt_xent_bwd_plain",
    "nt_xent_bwd_rows",
    "nt_xent_bwd_rows_plain",
    "nt_xent_fwd",
    "nt_xent_fwd_pair",
    "nt_xent_fwd_pair_plain",
    "nt_xent_fwd_plain",
    "reset_launches",
    "scatter_tiles",
    "scatter_tiles_global",
    "scatter_tiles_global_autograd",
    "scatter_tiles_global_plain",
    "scatter_tiles_ps",
    "scatter_tiles_ps_plain",
]

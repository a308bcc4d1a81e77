"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version and a launch counter.

* ``bn_relu_pool`` (K1, ``csrc/bn_relu_pool.cu``) — masked eval BN → ReLU →
  zero → MaxPool(2³); replaces ``fused_bn_pool._fwd_kernel``.
* ``scatter_tiles_ps`` (K2, ``csrc/tile_scatter.cu``) — per-sample tile →
  grid scatter; replaces ``_graveyard/dma_tiles._scatter_kernel``.
"""

from .bn_relu_pool import bn_relu_pool, bn_relu_pool_plain, fold_bn
from .tile_scatter import scatter_tiles_ps, scatter_tiles_ps_plain

KERNELS = (bn_relu_pool, scatter_tiles_ps)


def reset_launches() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0


def launches() -> dict[str, int]:
    return {wrapper.__name__: wrapper.launches for wrapper in KERNELS}


__all__ = [
    "KERNELS",
    "bn_relu_pool",
    "bn_relu_pool_plain",
    "fold_bn",
    "launches",
    "reset_launches",
    "scatter_tiles_ps",
    "scatter_tiles_ps_plain",
]

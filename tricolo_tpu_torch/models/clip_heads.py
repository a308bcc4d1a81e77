"""Trainable MLP heads over frozen, precached CLIP features.

Port of ``tricolo_tpu.models.clip_heads``: the frozen ViT-L/14 features
are extracted offline (``clip/extract.py``, ``python -m
tricolo_tpu_torch.extract_clip_feats``) and each "encoder" is an
``MLPHead(feature_dim → out_dim → out_dim)`` with dropout (0.1 by default)
over the cached (B, feature_dim) batch features, its output in float32;
its Linears hold ``param_dtype`` and compute in the compute dtype.
The heads do *not* L2-normalise their output, unlike the other encoders,
as in the JAX package and the reference. The two dense layers are
``common.Linear`` (cuBLAS), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import MLPHead


class CLIPTextEncoder(nn.Module):
    """Precached text features (B, feature_dim) → (B, out_dim) float32."""

    def __init__(self, out_dim: int = 512, feature_dim: int = 768, dropout: float = 0.1,
                 param_dtype=torch.float32):
        super().__init__()
        self.head = MLPHead(feature_dim, out_dim, out_dim, dropout, param_dtype)

    def forward(self, features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in train mode."""
        return self.head(features, generator).float()


class CLIPImageEncoder(CLIPTextEncoder):
    """Precached mean-over-views image features (B, feature_dim) →
    (B, out_dim) float32; the same head as the text one."""

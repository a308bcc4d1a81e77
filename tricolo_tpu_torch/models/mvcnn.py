"""Multi-view CNN image encoder with max view-pooling.

Port of ``tricolo_tpu.models.mvcnn.MVCNNEncoder``: views fold into the
batch, a shared backbone runs over (B·V, H, W, 3) — a ResNet (resnet18/34/
50) or, for a ``cnn_name`` that starts with
``efficientnet``, an EfficientNet (b0/b3), as the reference's cnn_name
switch (reference mv_cnn.py:44-60) —, pooled per-view features are
max-reduced over views BEFORE the ``fc`` projection (``feature_dim`` →
``z_dim``), then an MLP head and L2 normalization.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Linear, MLPHead, fold_views, l2_normalize
from .efficientnet import EfficientNet
from .resnet import ResNet


class MVCNNEncoder(nn.Module):
    """images (B, V, H, W, 3) float → L2-normalized (B, out_dim) float32."""

    def __init__(self, num_views: int = 6, z_dim: int = 512, out_dim: int = 512,
                 cnn_name: str = "resnet18", param_dtype=torch.float32):
        super().__init__()
        self.num_views = num_views
        backbone = EfficientNet if cnn_name.startswith("efficientnet") else ResNet
        self.backbone = backbone(cnn_name, param_dtype)
        self.fc = Linear(self.backbone.feature_dim, z_dim, dtype=param_dtype)
        self.head = MLPHead(z_dim, out_dim, out_dim, param_dtype=param_dtype)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the EfficientNet's stochastic-depth masks' source
        in train mode (the ResNets draw nothing)."""
        batch, views = images.shape[:2]
        features = self.backbone(fold_views(images), generator).reshape(batch, views, -1)
        pooled = features.amax(dim=1)
        return l2_normalize(self.head(self.fc(pooled)).float())

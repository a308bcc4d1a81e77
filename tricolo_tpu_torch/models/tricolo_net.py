"""TriCoLoNet: the configured modality encoders.

Port of ``tricolo_tpu.models.tricolo_net.TriCoLoNet`` for the BiGRU text
encoder, the MVCNN image encoder and the windowed voxel encoder
(``voxel_rows`` input). ``train()`` / ``eval()`` switch the BatchNorms
between batch and running statistics; the non-CLIP encoders have no
dropout. The CLIP heads are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .bigru import BiGRUEncoder
from .mvcnn import MVCNNEncoder
from .voxel_cnn import VoxelCNNEncoder

_VOXEL_ALIASES = {"VoxelCNNEncoder", "SparseCNNEncoder"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TriCoLoNet(nn.Module):
    """Joint embedding model; ``forward(batch)`` → dict of (B, out_dim)."""

    def __init__(self, text_encoder: str = "BiGRUEncoder", image_encoder: str | None = None,
                 voxel_encoder: str | None = None, out_dim: int = 512,
                 vocab_size: int = 3588, embed_dim: int = 256, gru_hidden_dim: int = 128,
                 num_views: int = 6, z_dim: int = 512, cnn_name: str = "resnet18",
                 voxel_size: int = 64, ef_dim: int = 32, voxel_z_dim: int = 512,
                 compute_dtype=torch.float32):
        super().__init__()
        if text_encoder != "BiGRUEncoder":
            raise NotImplementedError(f"text encoder {text_encoder!r} is not ported yet")
        self.compute_dtype = compute_dtype
        self.text_encoder = BiGRUEncoder(vocab_size, out_dim, embed_dim, gru_hidden_dim)
        self.image_encoder = None
        if image_encoder == "MVCNNEncoder":
            self.image_encoder = MVCNNEncoder(num_views, z_dim, out_dim, cnn_name)
        elif image_encoder is not None:
            raise NotImplementedError(f"image encoder {image_encoder!r} is not ported yet")
        self.voxel_encoder = None
        if voxel_encoder in _VOXEL_ALIASES:
            self.voxel_encoder = VoxelCNNEncoder(
                voxel_size, ef_dim, voxel_z_dim, out_dim, compute_dtype
            )
        elif voxel_encoder is not None:
            raise ValueError(f"unknown voxel encoder: {voxel_encoder}")

    @classmethod
    def from_config(cls, cfg) -> "TriCoLoNet":
        modules = cfg.model.modules
        voxel = modules.VoxelCNNEncoder
        if cfg.model.voxel_encoder is not None and not voxel.get("masked_bn", False):
            raise NotImplementedError("the port runs the masked voxel encoder only")
        return cls(
            text_encoder=cfg.model.text_encoder or "BiGRUEncoder",
            image_encoder=cfg.model.image_encoder,
            voxel_encoder=cfg.model.voxel_encoder,
            out_dim=cfg.model.out_dim,
            vocab_size=modules.BiGRUEncoder.vocab_size,
            embed_dim=modules.BiGRUEncoder.embed_dim,
            gru_hidden_dim=modules.BiGRUEncoder.hidden_dim,
            num_views=modules.MVCNNEncoder.num_views,
            z_dim=modules.MVCNNEncoder.z_dim,
            cnn_name=modules.MVCNNEncoder.cnn_name,
            voxel_size=voxel.voxel_size,
            ef_dim=voxel.ef_dim,
            voxel_z_dim=voxel.get("z_dim", modules.MVCNNEncoder.z_dim),
            compute_dtype=DTYPES[cfg.precision.compute_dtype],
        )

    def set_compute_dtype(self, dtype) -> None:
        self.compute_dtype = dtype
        if self.voxel_encoder is not None:
            self.voxel_encoder.compute_dtype = dtype

    def forward(self, batch: dict) -> dict:
        """batch: tokens (B, T) int; images (B, V, H, W, 3) normalized
        float; voxel_rows (B, k, s³) int32 + voxel_row_ids (B, k) int32."""
        out = {"text_features": self.text_encoder(batch["tokens"])}
        if self.image_encoder is not None:
            out["image_features"] = self.image_encoder(batch["images"])
        if self.voxel_encoder is not None:
            out["voxel_features"] = self.voxel_encoder(
                batch["voxel_rows"], batch["voxel_row_ids"]
            )
        return out

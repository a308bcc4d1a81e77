"""TriCoLoNet: the configured modality encoders.

Port of ``tricolo_tpu.models.tricolo_net.TriCoLoNet``: the text encoder
is the BiGRU or the CLIP text head, the image encoder the MVCNN (a
ResNet18/34/50 or EfficientNet-B0/B3 backbone, ``cnn_name``) or the CLIP
image head (both heads over precached CLIP features), and the voxel
encoder runs masked BN on every voxel input (``voxel_windows``,
``voxel_rows`` or dense ``voxels``) or all-site BN (``masked_bn=false``) on
dense ``voxels``. ``train()`` / ``eval()`` switch the BatchNorms between
batch and running statistics and the CLIP heads' dropout (and the
EfficientNet's stochastic depth) on and off; in train mode they draw from
the ``generator`` passed to ``forward``. ``precision.remat_voxel``
rematerialises the voxel encoder's train forward (``torch.utils.checkpoint``,
as JAX's ``nn.remat``); ``MVCNNEncoder.hybrid_stem`` and ``s2d_stem`` are
accepted and run the plain ResNet stem, of which the JAX package's opt-ins
are exact rewrites with the same variables (``models/resnet.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from .bigru import BiGRUEncoder
from .clip_heads import CLIPImageEncoder, CLIPTextEncoder
from .mvcnn import MVCNNEncoder
from .voxel_cnn import VoxelCNNEncoder

_VOXEL_ALIASES = {"VoxelCNNEncoder", "SparseCNNEncoder"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SCATTER_LAYOUTS = ("transpose", "lines", "hybrid")
# The JAX package's fused_bn_pool values ("auto" and None: hybrid, true:
# Pallas, false: composed XLA), which compute one function to rounding.
FUSED_BN_POOL = ("auto", None, True, False)


class TriCoLoNet(nn.Module):
    """Joint embedding model; ``forward(batch)`` → dict of (B, out_dim)."""

    def __init__(self, text_encoder: str = "BiGRUEncoder", image_encoder: str | None = None,
                 voxel_encoder: str | None = None, out_dim: int = 512,
                 vocab_size: int = 3588, embed_dim: int = 256, gru_hidden_dim: int = 128,
                 num_views: int = 6, z_dim: int = 512, cnn_name: str = "resnet18",
                 voxel_size: int = 64, ef_dim: int = 32, voxel_z_dim: int = 512,
                 compute_dtype=torch.float32, tile_sparse: bool = False,
                 tile_sparse_blocks: int = 2, tile_budget_frac: float = 0.5,
                 explicit_dgrad: bool = False, masked_bn: bool = True,
                 clip_feature_dim: int = 768, clip_dropout: float = 0.1,
                 clip_image_dropout: float = 0.1, remat_voxel: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        if text_encoder == "CLIPTextEncoder":
            self.text_encoder = CLIPTextEncoder(out_dim, clip_feature_dim, clip_dropout)
        elif text_encoder == "BiGRUEncoder":
            self.text_encoder = BiGRUEncoder(vocab_size, out_dim, embed_dim, gru_hidden_dim)
        else:
            raise ValueError(f"unknown text encoder: {text_encoder}")
        self.image_encoder = None
        if image_encoder == "CLIPImageEncoder":
            self.image_encoder = CLIPImageEncoder(out_dim, clip_feature_dim, clip_image_dropout)
        elif image_encoder == "MVCNNEncoder":
            self.image_encoder = MVCNNEncoder(num_views, z_dim, out_dim, cnn_name)
        elif image_encoder is not None:
            raise ValueError(f"unknown image encoder: {image_encoder}")
        self.voxel_encoder = None
        if voxel_encoder in _VOXEL_ALIASES:
            self.voxel_encoder = VoxelCNNEncoder(
                voxel_size, ef_dim, voxel_z_dim, out_dim, compute_dtype,
                tile_sparse=tile_sparse, tile_sparse_blocks=tile_sparse_blocks,
                tile_budget_frac=tile_budget_frac, explicit_dgrad=explicit_dgrad,
                masked_bn=masked_bn, remat=remat_voxel,
            )
        elif voxel_encoder is not None:
            raise ValueError(f"unknown voxel encoder: {voxel_encoder}")

    @classmethod
    def from_config(cls, cfg) -> "TriCoLoNet":
        modules = cfg.model.modules
        voxel = modules.VoxelCNNEncoder
        if cfg.precision.get("param_dtype", "float32") != "float32":
            raise NotImplementedError(
                f"precision.param_dtype={cfg.precision.param_dtype}: the port builds float32 "
                "parameters only")
        # MVCNNEncoder.hybrid_stem and s2d_stem rewrite the plain stem exactly
        # for the TPU's layout: the port runs the plain stem for either.
        # Every layout of the JAX package computes the same scatter, which K2
        # does one way: the key is checked and has no other effect.
        layout = voxel.get("scatter_layout", None)
        if layout is not None and layout not in SCATTER_LAYOUTS:
            raise ValueError(f"scatter_layout must be one of {SCATTER_LAYOUTS}, got {layout!r}")
        # So do the JAX package's three BN-ReLU-pool paths, which the port
        # computes with its one kernel path (K1/K3): the key is checked only.
        fused = voxel.get("fused_bn_pool", "auto")
        if fused not in FUSED_BN_POOL:
            raise ValueError(f"fused_bn_pool must be one of {FUSED_BN_POOL}, got {fused!r}")
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
            tile_sparse=bool(voxel.get("tile_sparse", False)),
            tile_sparse_blocks=int(voxel.get("tile_sparse_blocks", 2)),
            tile_budget_frac=float(voxel.get("tile_budget_frac", 0.5)),
            explicit_dgrad=bool(voxel.get("explicit_dgrad", False)),
            masked_bn=bool(voxel.get("masked_bn", False)),
            clip_feature_dim=modules.clip_feature_dim,
            clip_dropout=modules.CLIPTextEncoder.dropout,
            clip_image_dropout=modules.CLIPImageEncoder.get(
                "dropout", modules.CLIPTextEncoder.dropout),
            remat_voxel=bool(cfg.precision.get("remat_voxel", False)),
        )

    def set_compute_dtype(self, dtype) -> None:
        self.compute_dtype = dtype
        if self.voxel_encoder is not None:
            self.voxel_encoder.compute_dtype = dtype

    def forward(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """batch (``data.device_prep.prepare_device_batch``): tokens (B, T)
        int, or clip_embeddings_text (B, F) float for the CLIP text head;
        images (B, V, H, W, 3) normalized float, or clip_embeddings_img
        (B, F) float for the CLIP image head; and voxel_windows (B·tg³, s³)
        int32 + voxel_tile_occ (B·tg³,), or voxel_rows (B, k, s³) int32 +
        voxel_row_ids (B, k) int32, or voxels (B, D, D, D, 4) float.
        ``generator`` (train mode, CLIP heads, EfficientNet): the dropout
        and stochastic-depth masks' source, drawn by the text head, then the
        image encoder."""
        if isinstance(self.text_encoder, CLIPTextEncoder):
            text = self.text_encoder(batch["clip_embeddings_text"], generator)
        else:
            text = self.text_encoder(batch["tokens"])
        out = {"text_features": text}
        if isinstance(self.image_encoder, CLIPImageEncoder):
            out["image_features"] = self.image_encoder(batch["clip_embeddings_img"], generator)
        elif self.image_encoder is not None:
            out["image_features"] = self.image_encoder(batch["images"], generator)
        enc = self.voxel_encoder
        if enc is not None:
            if "voxel_windows" in batch:
                features = enc(windows=batch["voxel_windows"], tile_occ=batch["voxel_tile_occ"])
            elif "voxel_rows" in batch:
                features = enc(batch["voxel_rows"], batch["voxel_row_ids"])
            else:
                features = enc(voxels=batch["voxels"])
            out["voxel_features"] = features
        return out

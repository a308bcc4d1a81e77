"""Offline CLIP feature-cache extraction.

The port's copy of ``tricolo_tpu.clip.extract`` (the reference's
``extract_clip_feats.py``). For each split the frozen CLIP encoders run
over every model and caption, and the cache holds, keyed by model_id in
``clip_embeddings_{split}.npz`` (keys ``{model_id}/img`` and
``{model_id}/text``, the format ``data.datasets`` loads):

* ``img`` — the L2-normalised mean over the views of the per-view image
  embeddings;
* ``text`` — the L2-normalised caption embedding. The cache is keyed by
  model_id while the loop runs per caption, so every shape keeps the
  embedding of its *last* caption: the reference's quirk, kept on purpose.

The backend receives the dataset pipeline's tensors, never raw strings or
uint8 pixels: views normalised with the CLIP mean and std the training
pipeline uses (``clip_normalize_images``), captions as CLIP BPE ids
(``tokenizer.ClipTokenizer``). It is injectable, so the pipeline runs
without CLIP weights; ``TransformersClipBackend`` reads a local
HuggingFace CLIP checkpoint directory on the host's CPU.
"""

from __future__ import annotations

import os
from typing import Callable, Protocol

import numpy as np

from ..data.datasets import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def clip_normalize_images(images_u8: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 → CLIP-normalised float32 (the host twin of
    ``data.device_prep.normalize_images``)."""
    x = images_u8.astype(np.float32) / 255.0
    mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.asarray(CLIP_IMAGE_STD, np.float32)
    return (x - mean) / std


def l2_rows(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """x / max(‖x‖₂, 1e-12) along ``axis`` (numpy)."""
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


class ClipBackend(Protocol):
    """The frozen-CLIP surface the extractor and the CLIP-text server need."""

    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float32 CLIP-normalised → (N, D) float32."""
        ...

    def encode_text(self, tokens: np.ndarray) -> np.ndarray:
        """(N, 77) int32 CLIP BPE ids → (N, D) float32."""
        ...


class TransformersClipBackend:
    """A HuggingFace CLIP checkpoint from a *local directory*, on the host's
    CPU (extraction is offline; the card never runs CLIP).

    ``transformers`` is imported here, on construction, and nowhere else in
    the port. The processor is bypassed: ``pixel_values`` and ``input_ids``
    go straight to the model, so the extractor's tensors are what it
    encodes. No attention mask is passed: CLIP's text transformer is
    causally masked and pools at the EOT position, so the zero padding
    cannot change the feature."""

    def __init__(self, model_path: str):
        if not os.path.isdir(model_path):
            raise FileNotFoundError(
                f"local CLIP checkpoint directory not found: {model_path!r}; "
                "download openai/clip-vit-large-patch14 on a connected host "
                "and point model.modules.clip_model at the directory."
            )
        from transformers import CLIPModel

        self.model = CLIPModel.from_pretrained(model_path)
        self.model.eval()

    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        import torch

        pixel_values = torch.from_numpy(np.ascontiguousarray(pixels.transpose(0, 3, 1, 2)))
        with torch.no_grad():
            feats = self.model.get_image_features(pixel_values=pixel_values)
        return feats.numpy().astype(np.float32)

    def encode_text(self, tokens: np.ndarray) -> np.ndarray:
        import torch

        input_ids = torch.from_numpy(tokens.astype(np.int64))
        with torch.no_grad():
            feats = self.model.get_text_features(input_ids=input_ids)
        return feats.numpy().astype(np.float32)


def extract_clip_features(
    dataset,
    backend: ClipBackend,
    output_path: str,
    batch_captions: int = 64,
    tokenizer: Callable[[str], np.ndarray] | None = None,
) -> dict:
    """Build one split's cache from a dataset of the ``GeneralDataset``
    contract (``vision_data`` per (category, model_id), ``language_data``
    per caption) and write it to ``output_path``; returns ``{model_id:
    {"img", "text"}}``. ``tokenizer`` maps a caption to (77,) int32 ids;
    by default a ``ClipTokenizer`` on ``TRICOLO_CLIP_BPE``."""
    if tokenizer is None:
        from .tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()
    cache: dict[str, dict[str, np.ndarray]] = {}
    for (_, model_id), vision in dataset.vision_data.items():
        per_view = backend.encode_image(clip_normalize_images(vision["images"]))
        cache[model_id] = {"img": l2_rows(per_view.mean(axis=0))}
    rows = dataset.language_data
    for start in range(0, len(rows), batch_captions):
        chunk = rows[start : start + batch_captions]
        tokens = np.stack([tokenizer(r["text"]) for r in chunk])
        for row, emb in zip(chunk, l2_rows(backend.encode_text(tokens))):
            cache[row["model_id"]]["text"] = emb  # the last caption wins
    flat = {f"{model_id}/{kind}": value.astype(np.float32)
            for model_id, entry in cache.items() for kind, value in entry.items()}
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    np.savez(output_path, **flat)
    return cache

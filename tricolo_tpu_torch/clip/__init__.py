"""Frozen-CLIP support: the BPE tokenizer and the offline feature cache.

The port's copy of ``tricolo_tpu.clip``. The CLIP heads consume features
precached once, on the host, from a frozen CLIP ViT-L/14:

* ``tokenizer`` — CLIP's byte-level BPE (the merges file from a path the
  user gives);
* ``extract`` — the cache extractor: per split, image embedding = the
  L2-normalised mean over views of the per-view image embeddings, text
  embedding = the L2-normalised caption embedding keyed by model_id (the
  *last* caption seen wins, the reference's quirk), saved as
  ``clip_embeddings_{split}.npz``.

The encoder backend is injectable (``ClipBackend``):
``TransformersClipBackend`` reads a local HuggingFace CLIP checkpoint
directory, and the tests pass a deterministic stand-in.
"""

from .extract import ClipBackend, TransformersClipBackend, extract_clip_features
from .tokenizer import CONTEXT_LENGTH, ClipTokenizer

__all__ = ["CONTEXT_LENGTH", "ClipBackend", "ClipTokenizer", "TransformersClipBackend",
           "extract_clip_features"]

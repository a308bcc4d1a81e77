"""Text-to-shape retrieval serving: index building and query answering.

Port of ``tricolo_tpu.serving``:

* ``RetrievalIndex`` — the deduplicated shape-embedding matrix (one row per
  model, first occurrence wins) with ``.npz`` save/load and provenance;
* ``TextTokenizer`` — raw text → Text2Shape token ids through the inverted
  ``shapenet.json`` vocabulary;
* ``RetrievalServer`` — embeds the split with the full eval forward,
  answers token / text queries by the evaluator's raw dot product (the
  text embedding against the unnormalized image+voxel sum) and image
  queries through the MVCNN; ``serve_http`` exposes it on a stdlib HTTP
  endpoint (POST /retrieve {"query"|"tokens", "k"}).

A BiGRU query runs on the device. With the CLIP text head a query's 77
CLIP BPE ids go through the frozen CLIP backend's ``encode_text`` on the
host (``clip.extract.TransformersClipBackend`` on
``model.modules.clip_model``, a local checkpoint directory, unless a
backend is injected), are L2-normalised, as the cached training features
were, and then go through the trained head on the device; a raw-text
query is tokenized with the CLIP BPE (``TRICOLO_CLIP_BPE``).

The server runs on ``cuda`` unless it is given ``device="cpu"``; without a
GPU and without that request it raises.
"""

from __future__ import annotations

import json
import re
from typing import Any, Sequence

import numpy as np
import torch

from .clip.extract import l2_rows
from .clip.tokenizer import CONTEXT_LENGTH, ClipTokenizer
from .data.device_prep import normalize_images
from .inference import autocast, collect_embeddings, resolve_device
from .models.mvcnn import MVCNNEncoder
from .models.tricolo_net import TriCoLoNet
from .training.checkpoint import load_checkpoint, prune_disabled_encoders


class TextTokenizer:
    """Raw text → Text2Shape token ids (lowercased words, OOV dropped)."""

    def __init__(self, vocab: dict):
        self.word_to_idx = {w: int(i) for i, w in vocab["idx_to_word"].items()}

    @classmethod
    def from_file(cls, path: str) -> "TextTokenizer":
        with open(path) as f:
            return cls(json.load(f))

    def __call__(self, text: str, max_tokens: int) -> np.ndarray:
        words = re.findall(r"[a-z0-9]+(?:'[a-z]+)?", text.lower())
        ids = [self.word_to_idx[w] for w in words if w in self.word_to_idx]
        if words and not ids:
            raise ValueError(
                f"no word of {text!r} is in the vocabulary; the query would be empty"
            )
        out = np.zeros(max_tokens, dtype=np.int32)
        ids = ids[:max_tokens]
        out[: len(ids)] = ids
        return out


class RetrievalIndex:
    """Deduplicated shape-embedding matrix keyed by model_id."""

    def __init__(self, model_ids: Sequence[str], matrix: np.ndarray):
        if len(model_ids) != matrix.shape[0]:
            raise ValueError(f"{len(model_ids)} ids vs matrix {matrix.shape}")
        self.model_ids = list(model_ids)
        self.matrix = np.asarray(matrix, np.float32)

    @classmethod
    def from_embeddings_dict(cls, embeddings_dict: dict) -> "RetrievalIndex":
        ids: list[str] = []
        rows: list[np.ndarray] = []
        seen: set[str] = set()
        for (_, _, model_id, _, shape) in embeddings_dict["caption_embedding_tuples"]:
            if model_id in seen:
                continue
            seen.add(model_id)
            ids.append(model_id)
            rows.append(np.asarray(shape, np.float32))
        return cls(ids, np.stack(rows))

    @staticmethod
    def _norm_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str, provenance: str = "") -> str:
        path = self._norm_path(path)
        np.savez(path, model_ids=np.asarray(self.model_ids), matrix=self.matrix,
                 provenance=np.asarray(provenance))
        return path

    @classmethod
    def load(cls, path: str, expect_provenance: str | None = None) -> "RetrievalIndex":
        data = np.load(cls._norm_path(path), allow_pickle=False)
        if expect_provenance is not None and "provenance" in data:
            found = str(data["provenance"])
            if found and found != expect_provenance:
                raise ValueError(
                    f"index was built from {found!r} but the server loaded "
                    f"{expect_provenance!r} — rebuild the index or drop +index_path"
                )
        return cls([str(m) for m in data["model_ids"]], data["matrix"])

    def topk(self, query_embedding: np.ndarray, k: int = 5):
        """Top-k (model_id, similarity) by the raw dot product."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        sims = self.matrix @ np.asarray(query_embedding, np.float32)
        k = min(k, len(self.model_ids))
        order = np.argsort(-sims)[:k]
        return [(self.model_ids[i], float(sims[i])) for i in order]


class RetrievalServer:
    """Answer text and image queries against a built shape index.
    ``clip_backend`` (the CLIP text head only) encodes token queries; by
    default a ``TransformersClipBackend`` on ``model.modules.clip_model``."""

    def __init__(self, cfg, model: TriCoLoNet, index: RetrievalIndex | None = None,
                 tokenizer: TextTokenizer | None = None, device=None, clip_backend=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.index = index
        self.tokenizer = tokenizer
        self.clip_backend = None
        self.clip_tokenizer = None
        self.max_tokens = cfg.data.get("max_tokens", 96)
        if (cfg.model.text_encoder or "BiGRUEncoder") == "CLIPTextEncoder":
            if clip_backend is None:
                from .clip.extract import TransformersClipBackend

                clip_backend = TransformersClipBackend(cfg.model.modules.clip_model)
            self.clip_backend = clip_backend
            self.max_tokens = CONTEXT_LENGTH

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_path: str, device=None, **kw) -> "RetrievalServer":
        """Build the model from ``cfg`` and load its weights from any
        checkpoint ``training.checkpoint.load_checkpoint`` reads (the
        port's, a bare state_dict, the JAX package's), without the disabled
        encoders' entries."""
        model = TriCoLoNet.from_config(cfg)
        model.load_state_dict(prune_disabled_encoders(load_checkpoint(ckpt_path)["model"], cfg))
        return cls(cfg, model, device=device, **kw)

    def build_index(self, data_module) -> RetrievalIndex:
        """Embed the ``inference.split`` split and build the index."""
        data_module.setup("test")
        loader = data_module.test_loader(pin_memory=self.device.type == "cuda")
        embeddings, _ = collect_embeddings(self.model, loader, self.device)
        self.index = RetrievalIndex.from_embeddings_dict(embeddings)
        return self.index

    @torch.no_grad()
    def embed_text(self, tokens) -> np.ndarray:
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        padded = np.zeros((tokens.shape[0], self.max_tokens), np.int32)
        n = min(tokens.shape[1], self.max_tokens)
        padded[:, :n] = tokens[:, :n]
        if self.clip_backend is not None:
            features = l2_rows(self.clip_backend.encode_text(padded)).astype(np.float32)
            inputs = torch.from_numpy(features)
        else:
            inputs = torch.from_numpy(padded)
        with autocast(self.model, self.device.type):
            out = self.model.text_encoder(inputs.to(self.device))
        return out.float().cpu().numpy()

    def query(self, text: str | None = None, tokens=None, k: int = 5):
        """Top-k (model_id, similarity) for a raw-text or token-id query."""
        if self.index is None:
            raise RuntimeError("no index built — call build_index() first")
        if tokens is None:
            if text is None:
                raise ValueError("provide text or tokens")
            if self.clip_backend is not None:
                # The CLIP BPE ids the frozen backend expects.
                if self.clip_tokenizer is None:
                    self.clip_tokenizer = ClipTokenizer()
                tokens = self.clip_tokenizer(text)
            elif self.tokenizer is None:
                raise RuntimeError(
                    "raw-text queries need a vocabulary — pass +vocab_path "
                    "(shapenet.json with idx_to_word) or query with tokens"
                )
            else:
                tokens = self.tokenizer(text, self.max_tokens)
        return self.index.topk(self.embed_text(np.asarray(tokens))[0], k)

    @torch.no_grad()
    def query_image(self, views_u8: np.ndarray, k: int = 5):
        """Top-k shapes for one sample's (V, H, W, 3) uint8 views."""
        if self.index is None:
            raise RuntimeError("no index built — call build_index() first")
        if not isinstance(self.model.image_encoder, MVCNNEncoder):
            raise NotImplementedError(
                "query_image needs the MVCNN image encoder (model.image_encoder=MVCNNEncoder)"
            )
        views = np.asarray(views_u8, np.uint8)
        if views.ndim == 4:
            views = views[None]
        images = normalize_images(torch.from_numpy(views).to(self.device),
                                  self.model.compute_dtype)
        with autocast(self.model, self.device.type):
            emb = self.model.image_encoder(images)
        return self.index.topk(emb.float().cpu().numpy()[0], k)

    def serve_http(self, port: int, host: str = "127.0.0.1",
                   max_requests: int | None = None) -> None:
        """Blocking stdlib HTTP endpoint: POST /retrieve {"query": str |
        "tokens": [int], "k": int} → {"results": [{"model_id", "similarity"}]};
        GET /healthz → {"status": "ok", "index_size": N}. Binds localhost
        by default; ``max_requests`` bounds the loop."""
        import http.server

        server_ref = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path == "/healthz":
                    index = server_ref.index
                    self._reply(200, {"status": "ok",
                                      "index_size": len(index.model_ids) if index else 0})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):  # noqa: N802
                if self.path != "/retrieve":
                    self._reply(404, {"error": "unknown path"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    results = server_ref.query(
                        text=req.get("query"), tokens=req.get("tokens"),
                        k=int(req.get("k", 5)),
                    )
                    self._reply(200, {"results": [
                        {"model_id": m, "similarity": s} for m, s in results
                    ]})
                except (ValueError, KeyError, TypeError, json.JSONDecodeError) as exc:
                    self._reply(400, {"error": str(exc)})
                except Exception:
                    import traceback

                    traceback.print_exc()
                    self._reply(500, {"error": "internal server error"})

            def log_message(self, *args: Any) -> None:
                pass

        httpd = http.server.HTTPServer((host, port), Handler)
        try:
            if max_requests is None:
                httpd.serve_forever()
            else:
                for _ in range(max_requests):
                    httpd.handle_request()
        finally:
            httpd.server_close()

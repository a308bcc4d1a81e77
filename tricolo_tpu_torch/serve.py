"""Retrieval serving entry point of the PyTorch port.

Build the shape index from a checkpoint + split, then answer text
queries — one-shot, or as an HTTP endpoint:

    python -m tricolo_tpu_torch.serve data=text2shape_chair_table \\
        model.image_encoder=MVCNNEncoder model.voxel_encoder=VoxelCNNEncoder \\
        +ckpt_path=output/.../training/last.ckpt +query_tokens="12,5,99"

    # HTTP endpoint (POST /retrieve {"query": ..., "k": 5})
    python -m tricolo_tpu_torch.serve ... +ckpt_path=... +port=8080

The checkpoint is any file ``training.checkpoint.load_checkpoint`` reads:
the port's, a bare state_dict saved with ``torch.save``, or the JAX
package's msgpack ``.ckpt``. Runs on the GPU; ``+device=cpu``
runs on the CPU instead. ``+index_path=index.npz`` caches the built index;
``+vocab_path=...`` points at the Text2Shape ``shapenet.json`` for raw-text
queries (default ``{data.dataset_path}/shapenet.json``).
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None):
    from .config import load_config, resolve_interpolations
    from .data import DataModule
    from .serving import RetrievalIndex, RetrievalServer, TextTokenizer

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg.experiment_name is None:
        cfg.experiment_name = "default"
        resolve_interpolations(cfg)

    ckpt_path = cfg.get("ckpt_path", None)
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise SystemExit(f"checkpoint not found: {ckpt_path!r} (pass +ckpt_path=...)")

    tokenizer = None
    vocab_path = cfg.get("vocab_path", None) or os.path.join(
        cfg.data.get("dataset_path") or "", "shapenet.json"
    )
    if os.path.exists(vocab_path):
        tokenizer = TextTokenizer.from_file(vocab_path)

    server = RetrievalServer.from_checkpoint(
        cfg, ckpt_path, device=cfg.get("device", None), tokenizer=tokenizer
    )
    index_path = cfg.get("index_path", None)
    if index_path:
        index_path = RetrievalIndex._norm_path(index_path)
    if index_path and os.path.exists(index_path):
        server.index = RetrievalIndex.load(index_path, expect_provenance=ckpt_path)
        print(f"index loaded from {index_path} ({len(server.index.model_ids)} models)")
    else:
        server.build_index(DataModule(cfg))
        print(f"index built: {len(server.index.model_ids)} models")
        if index_path:
            print(f"index saved to {server.index.save(index_path, provenance=ckpt_path)}")

    query_tokens = cfg.get("query_tokens", None)
    query = cfg.get("query", None)
    if query_tokens is not None:
        tokens = [int(t) for t in str(query_tokens).split(",")]
        for model_id, sim in server.query(tokens=tokens):
            print(f"{model_id}\t{sim:.4f}")
    elif query is not None:
        for model_id, sim in server.query(text=str(query)):
            print(f"{model_id}\t{sim:.4f}")

    port = cfg.get("port", None)
    if port is not None:
        print(f"serving on :{port} — POST /retrieve, GET /healthz")
        server.serve_http(int(port))


if __name__ == "__main__":
    main()

"""The serving slice as a whole: the port's RetrievalServer against the JAX
package's eval forward + ``shape_embedding_sum`` +
``RetrievalIndex.from_embeddings_dict`` on the same synthetic split.

Tolerance: atol 1e-4 on the index matrix (f32 on the CPU; convolution
reduction order differs between XLA and PyTorch); model ids and top-k ids
must be equal.
"""

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import (  # noqa: E402
    TINY,
    jax_cfg,
    jax_device_batch,
    jax_variables,
    torch_cfg,
    torch_model,
)

QUERIES = ([5, 12, 9], [100, 3, 77, 41, 8], [1])


@pytest.fixture(scope="module")
def served():
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.serving import RetrievalIndex as JaxIndex
    from tricolo_tpu.training.steps import shape_embedding_sum
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    cfg = jax_cfg()
    model, params, stats = jax_variables(cfg, seed=1)
    variables = {"params": params, "batch_stats": stats}
    dm = JaxDataModule(cfg)
    dm.setup("test")
    tuples = []
    for batch in dm.test_loader():
        out = model.apply(variables, jax_device_batch(batch, cfg), train=False)
        text = np.asarray(out["text_features"])
        shape = np.asarray(shape_embedding_sum(out))
        for i in range(batch["num_valid"]):
            tuples.append((None, batch["category"][i], batch["model_id"][i], text[i], shape[i]))
    ref_index = JaxIndex.from_embeddings_dict({"caption_embedding_tuples": tuples})

    server = RetrievalServer(torch_cfg(), torch_model(params, stats), device="cpu")
    server.build_index(DataModule(torch_cfg()))
    return cfg, model, params, ref_index, server


def test_index_matches_jax(served):
    _, _, _, ref_index, server = served
    assert server.index.model_ids == ref_index.model_ids
    assert len(server.index.model_ids) == 5
    np.testing.assert_allclose(server.index.matrix, ref_index.matrix, rtol=0, atol=1e-4)


@pytest.mark.parametrize("tokens", QUERIES)
def test_topk_matches_jax(served, tokens):
    from tricolo_tpu.models.bigru import BiGRUEncoder

    cfg, _, params, ref_index, server = served
    padded = np.zeros((1, cfg.data.max_tokens), np.int32)
    padded[0, : len(tokens)] = tokens
    enc = BiGRUEncoder(vocab_size=cfg.data.vocab_size, out_dim=512)
    ref_emb = np.asarray(enc.apply({"params": params["text_encoder"]}, padded))[0]
    ref = ref_index.topk(ref_emb, k=5)
    got = server.query(tokens=tokens, k=5)
    assert [m for m, _ in got] == [m for m, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-4)


def test_query_image_ranks_index(served):
    from tricolo_tpu_torch.data import DataModule

    *_, server = served
    dm = DataModule(torch_cfg())
    dm.setup("test")
    views = dm.test_loader().peek()["images"][0]
    results = server.query_image(views, k=3)
    sims = [s for _, s in results]
    assert len(results) == 3 and sims == sorted(sims, reverse=True)


def test_http_request_answered(served):
    *_, server = served
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    thread = threading.Thread(target=server.serve_http, args=(port,),
                              kwargs={"max_requests": 1}, daemon=True)
    thread.start()
    body = json.dumps({"tokens": list(QUERIES[0]), "k": 3}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/retrieve", data=body,
                                 headers={"Content-Type": "application/json"})
    for _ in range(50):
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = json.loads(resp.read())
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.1)
    thread.join(timeout=10)
    assert not thread.is_alive()
    expected = server.query(tokens=list(QUERIES[0]), k=3)
    assert [r["model_id"] for r in payload["results"]] == [m for m, _ in expected]


def test_index_save_load_round_trip(served, tmp_path):
    from tricolo_tpu_torch.serving import RetrievalIndex

    *_, server = served
    path = server.index.save(str(tmp_path / "index"), provenance="ckpt.pt")
    loaded = RetrievalIndex.load(path, expect_provenance="ckpt.pt")
    assert loaded.model_ids == server.index.model_ids
    np.testing.assert_array_equal(loaded.matrix, server.index.matrix)
    with pytest.raises(ValueError, match="built from"):
        RetrievalIndex.load(path, expect_provenance="other.pt")


def test_server_raises_without_cuda_or_cpu_request(monkeypatch):
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalServer(cfg, TriCoLoNet.from_config(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalServer(cfg, TriCoLoNet.from_config(cfg), device="cuda")


def test_serve_cli_from_checkpoint(served, tmp_path, capsys):
    from tricolo_tpu_torch import serve

    *_, server = served
    ckpt = tmp_path / "tri.pt"
    torch.save(server.model.state_dict(), ckpt)
    serve.main([*TINY, f"+ckpt_path={ckpt}", "+device=cpu",
                "+query_tokens=5,12,9"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "index built: 5 models"
    expected = server.query(tokens=[5, 12, 9], k=5)
    assert [line.split("\t")[0] for line in lines[1:]] == [m for m, _ in expected]


def test_index_timing_runs_on_cpu(capsys):
    """``index_timing`` builds the index a warm-up and ``--repeats`` times
    and prints one JSON line naming the package it timed."""
    from pathlib import Path

    from tricolo_tpu_torch import index_timing

    result = index_timing.main([
        "--repeats", "2", "--extra", "+device=cpu", "data.voxel_size=32",
        "data.image_size=32", "data.num_views=2", "data.batch_size=4", "data.num_models=6",
        "model.modules.VoxelCNNEncoder.ef_dim=8", "precision.compute_dtype=float32"])
    assert result["models"] == 6 and len(result["walls_s"]) == 2 and result["card"] == "cpu"
    assert Path(result["package"]) == Path(index_timing.__file__).resolve().parent
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result

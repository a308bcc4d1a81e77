"""A training run's lifecycle in the port against the JAX package: the
validation losses, the device evaluation, the test and eval CLIs and their
artifacts, the metrics log, and the structured experiment's script.

* Validation losses equal the JAX eval step's ``val_loss/*`` averaged over
  the full batches (the tail batch left out, as JAX's
  ``Trainer.collect_embeddings(with_loss=True)`` does): rel 1e-5 (f32).
* ``evaluation.device`` equals the numpy pipeline: RR@k exactly, NDCG and
  MRR within 1e-6, on embeddings built with exact ties.
* ``python -m tricolo_tpu_torch.test`` writes an ``output.p`` that the JAX
  ``eval.py`` scores alike and the port's eval CLI, which ranks on the
  device, within the same bounds, and a ``nearest.jsonl``
  equal to the JAX ``write_nearest_info`` rows for the same embeddings; it
  also takes a JAX checkpoint, and the pruned load serves Bi(V) from a
  Tri(I+V) file.
* The metrics log carries the JAX key set; the experiment script runs two
  tiny epochs on the CPU.
"""

import importlib.util
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import TINY, jax_device_batch, jax_variables  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BI_V = [o for o in TINY if o != "model.image_encoder=MVCNNEncoder"]
PORT = [*BI_V, "loss.NTXentLoss.use_pallas=true", "trainer.profiler=none",
        "logger.backend=jsonl"]


def _port_cfg(extra=()):
    from tricolo_tpu_torch.config import load_config

    return load_config([*PORT, *extra])


@pytest.fixture(scope="module")
def jax_setup():
    """Bi(V) JAX weights, the port model carrying them, and the JAX eval
    step's per-batch features and losses over the val split."""
    import jax.numpy as jnp

    from tricolo_tpu.config import load_config
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.losses import make_loss_fn, pairwise_losses
    from tricolo_tpu.training.steps import shape_embedding_sum
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    cfg = load_config(BI_V)
    model, params, stats = jax_variables(cfg, seed=6)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    loss_pair = make_loss_fn(cfg)

    @jax.jit
    def eval_step(batch):  # tricolo_tpu/training/steps.py make_eval_step
        out = model.apply(variables, batch, train=False)
        return out, pairwise_losses(loss_pair, out, "val_loss")

    dm = JaxDataModule(cfg)
    dm.setup("test")
    tuples, losses = [], []
    for batch in dm.test_loader():
        out, loss = eval_step(jax_device_batch(batch, cfg))
        text, shape = np.asarray(out["text_features"]), np.asarray(shape_embedding_sum(out))
        for i in range(batch["num_valid"]):
            tuples.append((None, batch["category"][i], batch["model_id"][i], text[i], shape[i]))
        losses.append((batch["num_valid"], {k: float(v) for k, v in loss.items()}))
    port = TriCoLoNet.from_config(_port_cfg())
    port.load_state_dict(jax_to_torch(params, stats))
    return {"params": params, "stats": stats, "model": port,
            "embeddings": {"caption_embedding_tuples": tuples}, "losses": losses}


def test_val_losses_equal_jax(jax_setup):
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import collect_embeddings
    from tricolo_tpu_torch.losses import make_loss_fn

    cfg = _port_cfg()
    dm = DataModule(cfg)
    dm.setup("test")
    loader = dm.test_loader()
    embeddings, losses = collect_embeddings(jax_setup["model"], loader, torch.device("cpu"),
                                            loss_fn=make_loss_fn(cfg))
    full = [loss for n, loss in jax_setup["losses"] if n == loader.batch_size]
    assert len(full) == 7 and len(jax_setup["losses"]) == 8  # 15 captions, B=2
    assert sorted(losses) == sorted(full[0]) == ["val_loss/text_voxel_loss",
                                                 "val_loss/total_loss"]
    for key in losses:
        np.testing.assert_allclose(losses[key], np.mean([loss[key] for loss in full]), rtol=1e-5)
    ours = embeddings["caption_embedding_tuples"]
    ref = jax_setup["embeddings"]["caption_embedding_tuples"]
    assert [t[2] for t in ours] == [t[2] for t in ref]
    np.testing.assert_allclose(np.stack([t[4] for t in ours]), np.stack([t[4] for t in ref]),
                               rtol=0, atol=1e-4)


def _tied_embeddings(n_models=12, captions=3, dim=8, seed=0):
    """Embeddings on a 1/8 grid (f32 and f64 products exact) with repeated
    shape rows and repeated text rows: equal similarities everywhere."""
    rng = np.random.default_rng(seed)
    shapes = rng.integers(-2, 3, (n_models, dim)).astype(np.float32) / 8
    shapes[5], shapes[9] = shapes[2], shapes[2]
    tuples = []
    for m in range(n_models):
        for _ in range(captions):
            text = rng.integers(-2, 3, dim).astype(np.float32) / 8
            if m % 4 == 0:
                text = shapes[(m + 2) % n_models].copy()
            tuples.append((None, "cat", f"model_{m:02d}", text, shapes[m]))
    return {"caption_embedding_tuples": tuples}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_eval_equals_numpy(seed):
    from tricolo_tpu.evaluation import compute_metrics_on_device as jax_device_metrics
    from tricolo_tpu_torch.evaluation import (
        compute_metrics,
        compute_metrics_on_device,
        compute_nearest_neighbors,
        construct_embeddings_matrix,
    )

    embeddings = _tied_embeddings(seed=seed)
    ref = compute_metrics(embeddings, nearest_path=None)
    got, top_k, top_sims, _ = compute_metrics_on_device(embeddings, torch.device("cpu"))
    np.testing.assert_array_equal(got.recall_rate, ref.recall_rate)
    np.testing.assert_allclose(got.ndcg, ref.ndcg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.precision, ref.precision, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.recall, ref.recall, rtol=0, atol=1e-6)
    assert abs(got.mrr - ref.mrr) <= 1e-6
    text, shape, *_ = construct_embeddings_matrix(embeddings)
    distances, indices, _ = compute_nearest_neighbors(shape, text)
    np.testing.assert_array_equal(top_k, indices)  # the tie order
    np.testing.assert_allclose(top_sims, distances, rtol=0, atol=1e-6)
    jax_top_k = jax_device_metrics(embeddings)[1]
    np.testing.assert_array_equal(top_k, jax_top_k)


def _load_jax_eval_cli():
    spec = importlib.util.spec_from_file_location("jax_eval_cli", ROOT / "eval.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed_metrics(out: str) -> list[str]:
    lines = out.strip().splitlines()
    i = lines.index("RR@1 RR@5 NDCG@5 MRR")
    return lines[i + 1].split()


def _assert_device_metrics_equal(got, ref):
    """The device ranking against the numpy pipeline: hit counts exact, the
    f32 sums of NDCG and MRR within 1e-6."""
    np.testing.assert_array_equal(got.recall_rate, ref.recall_rate)
    np.testing.assert_allclose(got.ndcg, ref.ndcg, rtol=0, atol=1e-6)
    assert abs(got.mrr - ref.mrr) <= 1e-6


def _nearest_rows(path):
    with open(path) as f:
        return sorted((json.loads(line) for line in f), key=lambda r: r["groundtruth"])


def test_test_cli_artifacts_match_jax(jax_setup, tmp_path, monkeypatch, capsys):
    from tricolo_tpu.evaluation import compute_metrics as jax_compute_metrics
    from tricolo_tpu_torch import eval as port_eval
    from tricolo_tpu_torch import test as port_test
    from tricolo_tpu_torch.training.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "epoch=0.ckpt")
    model = jax_setup["model"]
    save_checkpoint(ckpt, {"model": model.state_dict(), "optimizer": {}, "step": 0}, epoch=0)
    monkeypatch.chdir(tmp_path)
    metrics = port_test.main([*PORT, f"project_root_path={tmp_path}", "experiment_name=t",
                              f"+ckpt_path={ckpt}", "+device=cpu"])
    out = capsys.readouterr().out
    printed = _printed_metrics(out)
    output_p = tmp_path / "output" / "Synthetic" / "t" / "inference" / "val" / "predictions"
    output_p = output_p / "output.p"
    assert f"Predictions saved at {output_p}" in out

    _load_jax_eval_cli().main([f"+prediction_file_path={output_p}"])
    assert _printed_metrics(capsys.readouterr().out) == printed
    # The port's eval CLI ranks on the device: RR@k exact, NDCG/MRR to 1e-6.
    ours = port_eval.main([f"+prediction_file_path={output_p}", "+device=cpu"])
    printed_on_device = _printed_metrics(capsys.readouterr().out)
    assert printed_on_device[:2] == printed[:2]
    _assert_device_metrics_equal(ours, metrics)

    with open(output_p, "rb") as f:
        embeddings = pickle.load(f)
    jax_compute_metrics(embeddings, nearest_path=str(tmp_path / "jax_nearest.jsonl"))
    assert _nearest_rows(tmp_path / "nearest.jsonl") == _nearest_rows(
        tmp_path / "jax_nearest.jsonl")
    # The port's output.p holds the JAX features within the forward's tolerance.
    ref = jax_setup["embeddings"]["caption_embedding_tuples"]
    got = embeddings["caption_embedding_tuples"]
    assert [t[:3] for t in got] == [t[:3] for t in ref]
    np.testing.assert_allclose(np.stack([t[3] for t in got]), np.stack([t[3] for t in ref]),
                               rtol=0, atol=1e-4)

    # A pickle written from JAX features reads in the port's eval CLI.
    jax_pickle = tmp_path / "jax_output.p"
    with open(jax_pickle, "wb") as f:
        pickle.dump(jax_setup["embeddings"], f)
    ours = port_eval.main([f"+prediction_file_path={jax_pickle}", "+device=cpu"])
    _assert_device_metrics_equal(ours, jax_compute_metrics(jax_setup["embeddings"],
                                                           nearest_path=None))
    capsys.readouterr()

    # With inference.device_eval the test CLI ranks as the eval CLI does.
    (tmp_path / "device_eval").mkdir()
    monkeypatch.chdir(tmp_path / "device_eval")
    port_test.main([*PORT, f"project_root_path={tmp_path}", "experiment_name=t",
                    f"+ckpt_path={ckpt}", "+device=cpu", "inference.device_eval=true"])
    assert _printed_metrics(capsys.readouterr().out) == printed_on_device


def test_test_cli_reads_jax_checkpoint_and_prunes(jax_setup, tmp_path, monkeypatch, capsys):
    """A JAX Tri(I+V)-shaped file: the voxel-only config drops the image
    encoder's entries (the pruned load) and tests Bi(V) from it."""
    import jax.numpy as jnp

    from tricolo_tpu.training.checkpoint import save_checkpoint
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu_torch import test as port_test

    params = dict(jax_setup["params"], image_encoder={"Dense_0": {"kernel": np.ones((2, 2))}})
    state = TrainState(step=jnp.asarray(0), params=params,
                       batch_stats=jax_setup["stats"], opt_state={})
    ckpt = str(tmp_path / "jax.ckpt")
    save_checkpoint(ckpt, state, epoch=4)
    monkeypatch.chdir(tmp_path)
    metrics = port_test.main([*PORT, f"project_root_path={tmp_path}", "experiment_name=j",
                              f"+ckpt_path={ckpt}", "+device=cpu"])
    capsys.readouterr()
    from tricolo_tpu_torch.evaluation import compute_metrics

    ref = compute_metrics(jax_setup["embeddings"], nearest_path=None)
    assert metrics.summary() == pytest.approx(ref.summary(), abs=1e-9)
    with pytest.raises(AssertionError, match="Checkpoint path does not exists"):
        port_test.main([*PORT, f"+ckpt_path={tmp_path / 'missing.ckpt'}", "+device=cpu"])


def test_new_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from tricolo_tpu_torch import eval as port_eval
    from tricolo_tpu_torch import test as port_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tmp_path / "w.pt"
    ckpt.write_bytes(b"PK")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test.main([*PORT, f"+ckpt_path={ckpt}", f"project_root_path={tmp_path}"])
    output_p = tmp_path / "output.p"
    with open(output_p, "wb") as f:
        pickle.dump(_tied_embeddings(), f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.main([f"+prediction_file_path={output_p}"])


def test_metrics_log_rows_carry_jax_keys(tmp_path):
    from tricolo_tpu.evaluation.retrieval import RetrievalMetrics as JaxMetrics
    from tricolo_tpu.losses import pairwise_losses as jax_pairwise
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    cfg = _port_cfg(["trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1",
                     "trainer.log_every_n_steps=3", f"project_root_path={tmp_path}",
                     "experiment_name=log", "checkpoint_monitor.async_save=true"])
    manager = Trainer(cfg, device="cpu").fit(DataModule(cfg))
    assert sorted(os.listdir(manager.dirpath)) == [
        "checkpoints.json", "epoch=0.ckpt", "epoch=1.ckpt", "metrics.jsonl", "nearest.jsonl"]
    with open(os.path.join(cfg.logger.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    features = {"text_features": 0.0, "voxel_features": 0.0}
    train_keys = set(jax_pairwise(lambda a, b: 0.0, features, "train_loss"))
    val_keys = set(jax_pairwise(lambda a, b: 0.0, features, "val_loss"))
    eval_keys = set(JaxMetrics(*(np.zeros(5),) * 4, 0.0).summary("val_eval/"))
    train_rows = [r for r in rows if "lr" in r]
    val_rows = [r for r in rows if "lr" not in r]
    assert [r["step"] for r in train_rows] == [3, 6, 9, 12]  # 7 steps an epoch
    assert [(r["step"], r["epoch"]) for r in val_rows] == [(7, 0), (14, 1)]
    for row in train_rows:
        assert set(row) == {"step", "time", "epoch", "lr"} | train_keys
    for row in val_rows:
        assert set(row) == {"step", "time", "epoch"} | eval_keys | val_keys
        assert all(np.isfinite(row[k]) for k in val_keys)


def test_bn_experiment_two_tiny_epochs_on_cpu(tmp_path):
    from tricolo_tpu_torch import bn_experiment

    out = tmp_path / "exp" / "structured.json"
    result = bn_experiment.main([
        "--seeds", "7", "--epochs", "2", "--models", "12", "--out", str(out), "--tag", "_t",
        "--extra", "+device=cpu", "data.voxel_size=32", "data.batch_size=8",
        "model.modules.VoxelCNNEncoder.ef_dim=8"])
    saved = json.loads(out.read_text())
    assert saved.keys() == {"runs", "summary", "args", "device"} and saved["device"] == "cpu"
    run = result["runs"][0]
    assert run["steps"] == len(run["step_ms"]) == 8  # 36 captions, B=8: 4 steps an epoch
    assert set(run["timers_s"]) == {"data_load", "train", "validate", "checkpoint"}
    assert 0 < run["step_s_total"] <= run["timers_s"]["train"] <= run["wall_sec"]
    assert [r["epoch"] for r in run["train_curve"]] == [0, 1]
    assert [r["epoch"] for r in run["curve"]] == [1]
    final = run["final"]
    assert set(final) == {"epoch", "RR@1", "RR@5", "NDCG@5", "MRR", "val_loss", "train_loss"}
    assert all(np.isfinite(v) for v in final.values())
    assert final["train_loss"] == run["train_curve"][1]["train_loss"]
    assert saved["summary"]["masked"]["final_RR@1"]["values"] == [final["RR@1"]]

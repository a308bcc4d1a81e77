"""The ``masked_bn=false`` (all-site BN) slice as a whole, on the tiny
Tri(I+V) fixture (voxel 32, image 32, 2 views, ef_dim 8, B=2, f32): the
port's ``collect_embeddings``, train step, JAX-checkpoint reader and CLIs
against the JAX package with ``model.modules.VoxelCNNEncoder.masked_bn=false``.

Tolerances are those of ``test_torch_dense_slice.py``: embeddings atol
1e-4; one train step from a shared state: per-pair losses rtol 1e-5,
updated parameters within 2·lr (a gradient that rounding pushes across
zero flips Adam's ±lr step) and all but 0.1% of them within 1e-6, batch
statistics atol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import (  # noqa: E402
    TINY,
    jax_cfg,
    jax_variables,
    torch_cfg,
    torch_model,
)

UNMASKED = ["model.modules.VoxelCNNEncoder.masked_bn=false"]


def _overrides(transfer="packed"):
    return [f"data.voxel_transfer={transfer}", *UNMASKED]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def teardown_module(module):
    jax.clear_caches()


@pytest.fixture(scope="module")
def variables():
    """The JAX Tri(I+V) at masked_bn=false with random BN state."""
    return jax_variables(jax_cfg(_overrides()), seed=7)


def _jax_shape_embeddings(model, params, stats, cfg):
    """(model_id, text, shape) per valid caption of the JAX eval forward."""
    import jax.numpy as jnp

    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.data.device_prep import prepare_device_batch
    from tricolo_tpu.training.steps import shape_embedding_sum

    dm = JaxDataModule(cfg)
    dm.setup("test")
    fwd = jax.jit(lambda b: model.apply(
        {"params": params, "batch_stats": stats},
        prepare_device_batch(b, cfg.data.voxel_size, jnp.float32, voxel_mask=True), train=False))
    ref = []
    for batch in dm.test_loader():
        out = fwd({k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
        text, shape = np.asarray(out["text_features"]), np.asarray(shape_embedding_sum(out))
        ref += [(batch["model_id"][i], text[i], shape[i]) for i in range(batch["num_valid"])]
    return ref


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_collect_embeddings_match_jax(variables, transfer):
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import collect_embeddings

    model, params, stats = variables
    ref = _jax_shape_embeddings(model, params, stats, jax_cfg(_overrides(transfer)))
    port_dm = DataModule(torch_cfg(_overrides(transfer)))
    port_dm.setup("test")
    port = torch_model(params, stats, _overrides(transfer))
    assert not port.voxel_encoder.masked_bn
    got, _ = collect_embeddings(port, port_dm.test_loader(), torch.device("cpu"))
    tuples = got["caption_embedding_tuples"]
    assert len(tuples) == len(ref) == 15
    for (_, _, model_id, text, shape), (ref_id, ref_text, ref_shape) in zip(tuples, ref):
        assert model_id == ref_id
        np.testing.assert_allclose(text, ref_text, rtol=0, atol=1e-4)
        np.testing.assert_allclose(shape, ref_shape, rtol=0, atol=1e-4)


def test_train_step_matches_jax_make_train_step(variables):
    """One packed train step of the port at masked_bn=false against JAX
    ``make_train_step`` from the same state."""
    import jax.numpy as jnp

    from test_torch_train import _flat, _port_tree
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.training.optim import lr_for_epoch, make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import make_optimizer as port_optimizer
    from tricolo_tpu_torch.training import make_train_step as port_train_step

    cfg = jax_cfg(_overrides())
    model, params, stats = variables
    dm = JaxDataModule(cfg)
    dm.setup("fit")
    batch = dm.train_loader().peek()
    lr = lr_for_epoch(cfg, 0)
    tx = make_optimizer(cfg)
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                               "batch_stats": jax.tree.map(jnp.asarray, stats)}, tx)
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    state, ref = make_train_step(model, tx, cfg)(state, arrays, lr, jax.random.PRNGKey(0))

    pcfg = torch_cfg(_overrides())
    port = torch_model(params, stats, _overrides())
    step = port_train_step(port, port_optimizer(pcfg, port), pcfg)
    got = step(to_device_batch(batch, torch.device("cpu")), lr)
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    got_params, got_stats = (_flat(t) for t in _port_tree(port))
    diffs = np.concatenate([np.abs(got_params[n] - r).ravel()
                            for n, r in _flat(state.params).items()])
    assert diffs.max() <= 2 * lr * 1.01, diffs.max()
    assert (diffs > 1e-6).mean() <= 1e-3, (diffs > 1e-6).mean()
    for name, r in _flat(state.batch_stats).items():
        np.testing.assert_allclose(got_stats[name], r, rtol=0, atol=1e-5, err_msg=name)


def test_jax_checkpoint_of_unmasked_model_serves_equal_features(variables, tmp_path):
    """A JAX msgpack checkpoint of a masked_bn=false model, read by
    ``training/jax_checkpoint.py`` in ``RetrievalServer.from_checkpoint``,
    gives the JAX eval forward's shape embeddings."""
    import jax.numpy as jnp

    from tricolo_tpu.training.checkpoint import save_checkpoint
    from tricolo_tpu.training.optim import make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    cfg = jax_cfg(_overrides())
    model, params, stats = variables
    ref, seen = [], set()
    for model_id, _, shape in _jax_shape_embeddings(model, params, stats, cfg):
        if model_id not in seen:
            seen.add(model_id)
            ref.append(shape)
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                               "batch_stats": jax.tree.map(jnp.asarray, stats)},
                              make_optimizer(cfg))
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)
    pcfg = torch_cfg(_overrides())
    server = RetrievalServer.from_checkpoint(pcfg, path, device="cpu")
    assert not server.model.voxel_encoder.masked_bn
    index = server.build_index(DataModule(pcfg))
    np.testing.assert_allclose(index.matrix, np.stack(ref), rtol=0, atol=1e-4)


def test_train_test_and_serve_clis_run_unmasked(tmp_path, capsys, monkeypatch):
    """The train CLI (one epoch, the default windowed_compact transfer, which
    falls back to packed), the test CLI and the serving CLI at
    masked_bn=false on the CPU."""
    import os

    from tricolo_tpu_torch import serve, train
    from tricolo_tpu_torch import test as test_cli

    args = [*TINY, *UNMASKED, "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
            "experiment_name=unmasked", f"project_root_path={tmp_path}", "+device=cpu"]
    with pytest.warns(UserWarning, match="falling back to data.voxel_transfer=packed"):
        best = train.main(args)
    assert os.path.basename(best) == "epoch=0.ckpt"
    out = capsys.readouterr().out
    assert "epoch 0: RR@1=" in out
    monkeypatch.chdir(tmp_path)  # the test CLI writes nearest.jsonl here
    metrics = test_cli.main([*args, f"+ckpt_path={best}"])
    lines = capsys.readouterr().out.strip().splitlines()
    i = lines.index("RR@1 RR@5 NDCG@5 MRR")
    assert len(lines[i + 1].split()) == 4 and all(np.isfinite(v) for v in metrics.summary().values())
    serve.main([*args, f"+ckpt_path={best}", "+query_tokens=5,12,9"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "index built: 5 models"
    assert len(lines) == 6 and all(len(line.split("\t")) == 2 for line in lines[1:])

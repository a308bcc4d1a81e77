"""The dense-input plan as a whole, on the tiny Tri(I+V) fixture (voxel 32,
image 32, 2 views, ef_dim 8, B=2, f32, masked BN): the port's loader,
``collect_embeddings``, train step and serving CLI against the JAX
package on ``data.voxel_transfer=packed|dense|windowed`` with
``VoxelCNNEncoder.tile_sparse=true``; and the configuration checks of
``masked_bn=false`` (a windowed transfer falls back to packed with the JAX
loader's warning, ``fused_bn_pool`` takes the JAX values only, windowed
input to the unmasked encoder raises).

Tolerances are those of ``test_torch_serving.py`` and
``test_torch_train_steps.py``: embeddings atol 1e-4; one train step from
a shared state: per-pair losses rtol 1e-5, updated parameters within 2·lr
(a gradient that rounding pushes across zero flips Adam's ±lr step) and
all but 0.1% of them within 1e-6, batch statistics atol 1e-5.
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

SPARSE = ["model.modules.VoxelCNNEncoder.tile_sparse=true"]


def _transfer(name):
    return [f"data.voxel_transfer={name}", *SPARSE]


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
    """JAX Tri(I+V) weights with random BN state (one tree serves every
    transfer: the plans share their parameters)."""
    cfg = jax_cfg(_transfer("packed"))
    model, params, stats = jax_variables(cfg, seed=4)
    return model, params, stats


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_batches_match_jax(transfer):
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule

    ours, ref = DataModule(torch_cfg(_transfer(transfer))), JaxDataModule(jax_cfg(
        _transfer(transfer)))
    ours.setup("test"), ref.setup("test")
    keys = {"packed": ("voxel_flat", "voxel_rgb"), "dense": ("voxel_grid",)}[transfer]
    for a, b in zip(ours.test_loader(), ref.test_loader()):
        assert a["num_valid"] == b["num_valid"] and a["model_id"] == b["model_id"]
        for key in ("tokens", "images", *keys):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("transfer", ["packed", "dense", "windowed"])
def test_collect_embeddings_match_jax(variables, transfer):
    import jax.numpy as jnp

    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.data.device_prep import prepare_device_batch
    from tricolo_tpu.training.steps import shape_embedding_sum
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import collect_embeddings

    model, params, stats = variables
    cfg = jax_cfg(_transfer(transfer))
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

    port_dm = DataModule(torch_cfg(_transfer(transfer)))
    port_dm.setup("test")
    port = torch_model(params, stats, _transfer(transfer))
    assert port.voxel_encoder.tile_sparse
    got, losses = collect_embeddings(port, port_dm.test_loader(), torch.device("cpu"))
    assert losses == {}
    tuples = got["caption_embedding_tuples"]
    assert len(tuples) == len(ref) == 15
    for (_, _, model_id, text, shape), (ref_id, ref_text, ref_shape) in zip(tuples, ref):
        assert model_id == ref_id
        np.testing.assert_allclose(text, ref_text, rtol=0, atol=1e-4)
        np.testing.assert_allclose(shape, ref_shape, rtol=0, atol=1e-4)


def test_train_step_matches_jax_make_train_step(variables):
    """One packed tile-sparse train step of the port against JAX
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

    overrides = _transfer("packed")
    cfg = jax_cfg(overrides)
    model, params, stats = variables
    dm = JaxDataModule(cfg)
    dm.setup("fit")
    batch = dm.train_loader().peek()
    assert "voxel_flat" in batch
    lr = lr_for_epoch(cfg, 0)
    tx = make_optimizer(cfg)
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                               "batch_stats": jax.tree.map(jnp.asarray, stats)}, tx)
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    state, ref = make_train_step(model, tx, cfg)(state, arrays, lr, jax.random.PRNGKey(0))

    pcfg = torch_cfg(overrides)
    port = torch_model(params, stats, overrides)
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


def test_serve_cli_answers_on_the_dense_plan(variables, tmp_path, capsys):
    from tricolo_tpu_torch import serve

    _, params, stats = variables
    overrides = _transfer("packed")
    port = torch_model(params, stats, overrides)
    ckpt = tmp_path / "tri.pt"
    torch.save(port.state_dict(), ckpt)
    serve.main([*TINY, *overrides, f"+ckpt_path={ckpt}", "+device=cpu", "+query_tokens=5,12,9"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "index built: 5 models"
    assert len(lines) == 6 and all(len(line.split("\t")) == 2 for line in lines[1:])


def test_tile_budget_canary_warns(tmp_path):
    """The trainer warns when the first batch holds more active tiles than
    the dense plan's static budget."""
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    # 8 samples of 64³ (8·512 tiles): the budget rounds up to 256 tiles.
    cfg = load_config([*TINY, *_transfer("packed"), "data.voxel_size=64", "data.batch_size=8",
                       "model.modules.VoxelCNNEncoder.tile_budget_frac=0.01",
                       f"project_root_path={tmp_path}", "experiment_name=canary"])
    trainer = Trainer(cfg, device="cpu")
    dm = DataModule(cfg)
    dm.setup("fit")
    with pytest.warns(UserWarning, match="tile_sparse budget 256"):
        trainer._check_tile_budget(dm.train_loader())


UNMASKED = ["model.modules.VoxelCNNEncoder.masked_bn=false"]


@pytest.mark.parametrize("transfer", ["windowed_compact", "windowed"])
def test_masked_bn_false_windowed_transfer_falls_back_to_packed(transfer):
    """A windowed transfer at masked_bn=false warns as the JAX loader does
    and collates ``packed``."""
    import warnings

    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule

    overrides = [f"data.voxel_transfer={transfer}", *UNMASKED]
    caught = []
    for dm in (DataModule(torch_cfg(overrides)), JaxDataModule(jax_cfg(overrides))):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            kwargs = dm._loader_kwargs()
        assert kwargs["voxel_transfer"] == "packed"
        caught.append([str(w.message) for w in seen if issubclass(w.category, UserWarning)])
    assert caught[0] == caught[1] and len(caught[0]) == 1
    assert caught[0][0].startswith(f"voxel_transfer={transfer} requires masked_bn=true")


@pytest.mark.parametrize("value,ok", [("auto", True), ("null", True), ("true", True),
                                      ("false", True), ("pallas", False), ("2", False)])
def test_fused_bn_pool_values(value, ok):
    """``fused_bn_pool`` takes the JAX package's four values (one kernel
    path computes them all) and refuses any other."""
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    cfg = torch_cfg([*UNMASKED, f"model.modules.VoxelCNNEncoder.fused_bn_pool={value}"])
    if ok:
        assert not TriCoLoNet.from_config(cfg).voxel_encoder.masked_bn
    else:
        with pytest.raises(ValueError, match="fused_bn_pool"):
            TriCoLoNet.from_config(cfg)


def test_masked_bn_false_refuses_windowed_input():
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    enc = TriCoLoNet.from_config(torch_cfg(UNMASKED)).voxel_encoder
    with pytest.raises(ValueError, match="requires masked_bn=true"):
        enc(torch.zeros(2, 3, 14**3, dtype=torch.int32), torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="requires masked_bn=true"):
        enc(windows=torch.zeros(128, 10**3, dtype=torch.int32), tile_occ=torch.ones(128))

"""The slice as a whole: Tri(I+V) (text + multi-view images + voxels) with
the reference's other backbones and the triplet loss, against the JAX
package on the tiny fixture (``test_torch_data.TINY``: voxel 32, 2 views of
32², ef_dim 8, B = 2, windowed_compact, masked BN).

* One train step, ``cnn_name=resnet50 loss.name=TripletLoss``, and one,
  ``cnn_name=efficientnet_b0`` with NT-Xent at stochastic-depth rate 0
  (the JAX backbone built with ``drop_connect_rate=0``, the port's blocks
  set to 0), against the body of ``tricolo_tpu.training.steps``' loss
  (``model.apply(train=True)`` + ``pairwise_losses`` of ``make_loss_fn``):
  the losses, every gradient and the running statistics. Both packages run
  the models in float64 (JAX under ``jax.enable_x64`` with the model's
  ``dtype`` float64; each package's losses cast to f32 as they do): in f32
  the fixture's ResNet50 normalises layer 4 over 4 values in train mode,
  and neither package resolves the step — measured here, JAX's f32
  triplet losses lie 0.62 relative from the port's float64 ones, and even
  at 64² with B = 4 the f32 gradients lie up to 0.48 (JAX) and 0.18 (port)
  of max from float64's. The triplet step first asserts that its features keep every
  d_ij at least 1e-4 from d_ii and d_ii + margin.
* The serving index of Tri(I+V) with EfficientNet-B3 (f32) against the JAX
  eval forward + ``RetrievalIndex``, and ``query_image`` through it.
* ``Trainer.fit`` one epoch with EfficientNet-B0 (stochastic depth drawn
  from the step's generator) and the triplet loss, its validation losses
  through the triplet loss, and the checkpoint served.

The JAX trees are ``jax.eval_shape`` of ``init`` filled with seeded numpy
values (``test_torch_backbones.fill_tree``), carried to the port with
``convert.jax_to_torch``.

Tolerances, stated before the first run: losses rtol 1e-5 or 1e-6
absolute (the triplet loss is a difference of distances of ~1.4, which f32
resolves to ~2.4e-7); gradients within 3e-4 of each tensor's largest JAX
magnitude (exact zeros: below 1e-10 of the largest gradient); running
statistics atol 1e-6; the index atol 1e-4 (``test_torch_serving.py``).
"""

import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_backbones import assert_grads_close, fill_tree, flat  # noqa: E402
from test_torch_data import TINY, jax_cfg, torch_cfg  # noqa: E402
from test_torch_triplet import assert_separated  # noqa: E402

PORT = ["loss.NTXentLoss.use_pallas=true"]
STEPS = {
    "resnet50_triplet": ["model.modules.MVCNNEncoder.cnn_name=resnet50",
                         "loss.name=TripletLoss"],
    "efficientnet_b0_ntxent": ["model.modules.MVCNNEncoder.cnn_name=efficientnet_b0"],
}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
STATS_TOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_stochastic_depth(monkeypatch):
    """The JAX MVCNN builds its EfficientNet at ``drop_connect_rate`` 0."""
    from tricolo_tpu.models import mvcnn
    from tricolo_tpu.models.efficientnet import EfficientNet

    monkeypatch.setattr(mvcnn, "EfficientNet",
                        functools.partial(EfficientNet, drop_connect_rate=0.0))


def _batch(cfg, split):
    from tricolo_tpu.data import DataModule

    dm = DataModule(cfg)
    dm.setup(split)
    loader = dm.train_loader() if split == "fit" else dm.test_loader()
    return loader.peek()


def _jax_model(cfg, seed):
    """(model, params, batch_stats): the JAX TriCoLoNet with seeded trees."""
    import jax.numpy as jnp

    from test_torch_data import jax_device_batch

    from tricolo_tpu.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax_device_batch(_batch(cfg, "test"), cfg))
    rng = np.random.default_rng(seed)
    params = fill_tree(shapes["params"], rng)
    stats = fill_tree(shapes["batch_stats"], rng)
    return model, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)


def _port_model(cfg_extra, params, stats):
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.efficientnet import MBConv
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(torch_cfg(cfg_extra))
    model.load_state_dict(jax_to_torch(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, stats)))
    for block in model.modules():
        if isinstance(block, MBConv):
            block.drop_rate = 0.0
    return model


def _jax_step64(model, params, stats, batch, cfg):
    """Loss dict, gradients and new batch_stats of the JAX train step's loss
    (``tricolo_tpu/training/steps.py::make_train_step.loss_fn``) with the
    model in float64; the features too."""
    import jax.numpy as jnp

    from tricolo_tpu.data.device_prep import prepare_device_batch
    from tricolo_tpu.losses import make_loss_fn, pairwise_losses

    loss_pair = make_loss_fn(cfg)
    with jax.enable_x64(True):
        model64 = model.clone(dtype=jnp.float64)
        arrays = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
        device_batch = prepare_device_batch(arrays, cfg.data.voxel_size, jnp.float64,
                                            voxel_mask=True)
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731

        def loss_fn(p, s):
            output, mutated = model64.apply(
                {"params": p, "batch_stats": s}, device_batch, train=True,
                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            loss_dict = pairwise_losses(loss_pair, output, "train_loss")
            return loss_dict["train_loss/total_loss"], (loss_dict, mutated["batch_stats"],
                                                        output)

        grads, (losses, new_stats, output) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            f64(params), f64(stats))
        return ({k: float(v) for k, v in losses.items()}, flat(grads), flat(new_stats),
                {k: np.asarray(v) for k, v in output.items()})


def _port_step64(model, batch, cfg_extra):
    from tricolo_tpu_torch.convert import torch_to_jax
    from tricolo_tpu_torch.data.device_prep import normalize_images
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.losses import make_loss_fn, pairwise_losses

    model = model.train().to(torch.float64)
    model.set_compute_dtype(torch.float64)
    inputs = to_device_batch(batch, CPU)
    inputs["images"] = normalize_images(inputs["images"], torch.float64)
    losses = pairwise_losses(make_loss_fn(torch_cfg(cfg_extra)), model(inputs), "train_loss")
    losses["train_loss/total_loss"].backward()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    grads = dict(state, **{n: p.grad.detach().clone() for n, p in model.named_parameters()})
    return ({k: v.item() for k, v in losses.items()}, flat(torch_to_jax(grads)[0]),
            flat(torch_to_jax(state)[1]))


@pytest.mark.parametrize("step", list(STEPS))
def test_train_step_matches_jax_steps(step, no_stochastic_depth):
    extra = STEPS[step]
    cfg = jax_cfg(extra)
    model, params, stats = _jax_model(cfg, seed=4)
    batch = _batch(cfg, "fit")
    ref_losses, ref_grads, ref_stats, features = _jax_step64(model, params, stats, batch, cfg)
    if cfg.loss.name == "TripletLoss":
        for a, b in (("text", "image"), ("text", "voxel"), ("image", "voxel")):
            assert_separated(features[f"{a}_features"], features[f"{b}_features"],
                             cfg.loss.TripletLoss.margin)
    losses, grads, new_stats = _port_step64(_port_model([*extra, *PORT], params, stats),
                                            batch, [*extra, *PORT])
    assert sorted(losses) == sorted(ref_losses) and len(losses) == 4
    for key, value in ref_losses.items():
        np.testing.assert_allclose(losses[key], value, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=key)
    assert_grads_close(grads, ref_grads)
    assert sorted(new_stats) == sorted(ref_stats)
    for key, value in ref_stats.items():
        np.testing.assert_allclose(new_stats[key], value, rtol=0, atol=STATS_TOL, err_msg=key)


def test_serving_index_matches_jax_with_efficientnet_b3():
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.serving import RetrievalIndex as JaxIndex
    from tricolo_tpu.training.steps import shape_embedding_sum
    from test_torch_data import jax_device_batch

    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    extra = ["model.modules.MVCNNEncoder.cnn_name=efficientnet_b3"]
    cfg = jax_cfg(extra)
    model, params, stats = _jax_model(cfg, seed=5)
    apply = jax.jit(lambda p, s, b: model.apply({"params": p, "batch_stats": s}, b))
    dm = JaxDataModule(cfg)
    dm.setup("test")
    tuples, views = [], None
    for batch in dm.test_loader():
        out = apply(params, stats, jax_device_batch(batch, cfg))
        text, shape = np.asarray(out["text_features"]), np.asarray(shape_embedding_sum(out))
        for i in range(batch["num_valid"]):
            tuples.append((None, batch["category"][i], batch["model_id"][i], text[i], shape[i]))
        if views is None:
            views, ref_image = batch["images"][0], np.asarray(out["image_features"])[0]
    ref_index = JaxIndex.from_embeddings_dict({"caption_embedding_tuples": tuples})
    server = RetrievalServer(torch_cfg(extra), _port_model(extra, params, stats), device="cpu")
    server.build_index(DataModule(torch_cfg(extra)))
    assert server.index.model_ids == ref_index.model_ids and len(ref_index.model_ids) == 5
    np.testing.assert_allclose(server.index.matrix, ref_index.matrix, rtol=0, atol=1e-4)
    got = server.query_image(views, k=3)
    want = ref_index.topk(ref_image, k=3)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)


def test_fit_with_efficientnet_and_triplet_serves(tmp_path, monkeypatch):
    """One epoch through ``Trainer.fit`` on the CPU: finite per-step
    triplet losses, stochastic depth drawn from the step generators,
    validation losses through the triplet loss, the checkpoint served."""
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models import efficientnet
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer

    cfg = load_config([*TINY, *PORT, *STEPS["resnet50_triplet"][1:],
                       "model.modules.MVCNNEncoder.cnn_name=efficientnet_b0",
                       "trainer.max_epochs=1", "experiment_name=fit",
                       f"project_root_path={tmp_path}", "logger.backend=jsonl"])
    trainer = Trainer(cfg, device="cpu")
    draws = []
    real = efficientnet.stochastic_depth

    def counted(x, rate, generator, rows=(0, 1)):
        draws.append(generator.initial_seed())
        return real(x, rate, generator, rows)

    monkeypatch.setattr(efficientnet, "stochastic_depth", counted)
    path = trainer.fit(DataModule(cfg)).best_path
    assert trainer.step == 7  # 15 captions, B = 2, drop_last
    # Every train step drew its masks from its own (train_seed, step)
    # generator, once for each residual block past block 0.
    assert len(set(draws)) == 7 and len(draws) % 7 == 0 and draws
    rows = [json.loads(line) for line in
            (tmp_path / "output" / "Synthetic" / "fit" / "training" / "metrics.jsonl")
            .read_text().splitlines()]
    val = [r for r in rows if "val_loss/total_loss" in r]
    assert val and all(np.isfinite(v) for k, v in val[-1].items() if k.startswith("val_loss/"))
    server = RetrievalServer.from_checkpoint(cfg, path, device="cpu")
    server.build_index(DataModule(cfg))
    dm = DataModule(cfg)
    dm.setup("test")
    answer = server.query_image(dm.test_loader().peek()["images"][0], k=3)
    assert len(answer) == 3 and all(np.isfinite(s) for _, s in answer)

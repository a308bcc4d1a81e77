"""The C13/128³ configuration in the port, the twin of ``test_voxel128.py``:
``data.voxel_size=128`` on the tiny Tri(I+V) fixture of
``test_torch_data.py`` (image 32, 2 views, ef_dim 8, B = 2, f32, masked
BN, windowed_compact at halo 3 over the synthetic preset's random
scatter), against the JAX package on the CPU.

* the MLP width derives to (128/32)³·z_dim = 32768 at the flagship z_dim
  (the reference's Linear fixed it at 64³'s 4096);
* the synthetic split's 128³ packed sites survive ``collate`` and
  ``to_device_batch`` (8-bit coordinates: 128 fits), and its
  windowed_compact batches equal the JAX package's;
* the f32 eval forward equals the JAX package's within 1e-4 (f32
  convolutions summed in other orders; as at 64³);
* one f32 windowed_compact train step equals the JAX package's (losses rel
  1e-5, gradients 3e-4 of each tensor's max: the fixture's ResNet layer 4
  normalises over 4 samples, ``test_torch_train.py``) and the port's
  packed (dense masked) step from the same weights within the same bounds;
* ``precision.remat_voxel`` (the recipe's memory plan) gives the plain
  step's losses, gradients and running statistics within 1e-6 of each
  tensor's max (the recompute repeats the forward's arithmetic).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import (  # noqa: E402
    host_batch,
    jax_cfg,
    jax_device_batch,
    jax_variables,
    torch_cfg,
    torch_model,
)
from test_torch_train import _flat, _max_normalised_errors, _port_tree  # noqa: E402

V128 = ["data.voxel_size=128"]
PORT = ["loss.NTXentLoss.use_pallas=true"]
CPU = torch.device("cpu")
FEATURE_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
REMAT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_128():
    """(cfg, model, params, batch_stats) of the JAX fixture at 128³."""
    cfg = jax_cfg(V128)
    model, params, stats = jax_variables(cfg, seed=3)
    return cfg, model, params, stats


def test_mlp_width_derives_from_the_voxel_size():
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    overrides = ["data=synthetic", "model.voxel_encoder=VoxelCNNEncoder", *V128]
    model = TriCoLoNet.from_config(torch_cfg_plain(overrides))
    assert model.voxel_encoder.head.fc1.in_features == (128 // 32) ** 3 * 512 == 32768
    cfg = jax_cfg_plain(overrides)
    batch = {"tokens": jax.ShapeDtypeStruct((1, 16), np.int32),
             "voxels": jax.ShapeDtypeStruct((1, 128, 128, 128, 3), np.float32)}
    shapes = jax.eval_shape(JaxNet.from_config(cfg).init, jax.random.PRNGKey(0), batch)
    kernel = shapes["params"]["voxel_encoder"]["MLPHead_0"]["TorchLinear_0"]["Dense_0"]["kernel"]
    assert kernel.shape == (32768, 512)


def torch_cfg_plain(overrides):
    from tricolo_tpu_torch.config import load_config

    return load_config(overrides)


def jax_cfg_plain(overrides):
    from tricolo_tpu.config import load_config

    return load_config(overrides)


def test_synthetic_128_plumbing_through_collate_and_to_device_batch():
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule, collate
    from tricolo_tpu_torch.data.datasets import build_dataset
    from tricolo_tpu_torch.data.device_prep import prepare_device_batch
    from tricolo_tpu_torch.inference import to_device_batch

    cfg = torch_cfg(V128)
    ds = build_dataset(cfg, "train")
    items = [ds[0], ds[1]]
    batch = collate(items, ds.max_voxel_points, "packed", 128)
    dev = prepare_device_batch(to_device_batch(batch, CPU), 128, torch.float32)
    assert dev["voxels"].shape == (2, 128, 128, 128, 4)
    assert int((dev["voxels"][..., 3] > 0).sum()) == sum(len(i["voxel_flat"]) for i in items)
    ours, ref = DataModule(cfg), JaxDataModule(jax_cfg(V128))
    ours.setup("test"), ref.setup("test")
    a, b = ours.test_loader().peek(), ref.test_loader().peek()
    assert a["voxel_rows"].shape[2] == 14**3
    assert ours.test_loader().tile_budget_rows == ref.test_loader().tile_budget_rows
    for key in ("voxel_rows", "voxel_row_ids"):
        np.testing.assert_array_equal(a[key], b[key])
    assert 0 <= int(a["voxel_row_ids"].min()) and int(a["voxel_row_ids"].max()) <= 16**3  # pad tg³


def test_f32_forward_equals_jax(jax_128):
    cfg, model, params, stats = jax_128
    batch = host_batch(cfg)
    ref = model.apply({"params": params, "batch_stats": stats}, jax_device_batch(batch, cfg))
    from tricolo_tpu_torch.inference import eval_step, to_device_batch

    port = torch_model(params, stats, V128)
    out = eval_step(port, to_device_batch(batch, CPU))
    for key in ("text_features", "image_features", "voxel_features"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0,
                                   atol=FEATURE_TOL, err_msg=key)


def _train_batch(extra):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(torch_cfg([*V128, *extra]))
    dm.setup("fit")
    return dm.train_loader().peek()


def _port_step(params, stats, batch, extra=()):
    """Losses and gradient tree of one port forward/backward (train mode)."""
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.losses import make_loss_fn, pairwise_losses

    cfg = torch_cfg([*V128, *PORT, *extra])
    port = torch_model(params, stats, [*V128, *PORT, *extra]).train()
    inputs = prepare_inputs(port, to_device_batch(batch, CPU))
    losses = pairwise_losses(make_loss_fn(cfg), port(inputs), "train_loss")
    losses["train_loss/total_loss"].backward()
    grads = _flat(_port_tree(port, grads=True)[0])
    return {k: v.item() for k, v in losses.items()}, grads


def test_f32_train_step_equals_jax_and_the_packed_path(jax_128):
    from tricolo_tpu.losses import make_loss_fn, pairwise_losses

    cfg, model, params, stats = jax_128
    batch = _train_batch([])
    assert batch["voxel_rows"].shape[2] == 14**3
    device_batch = jax_device_batch(batch, cfg)
    loss_pair = make_loss_fn(cfg)

    def loss_fn(p, s):  # tricolo_tpu/training/steps.py loss_fn
        output, mutated = model.apply(
            {"params": p, "batch_stats": s}, device_batch, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        loss_dict = pairwise_losses(loss_pair, output, "train_loss")
        return loss_dict["train_loss/total_loss"], loss_dict

    grads, ref_losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params, stats)
    ref_flat = _flat(grads)
    losses, got = _port_step(params, stats, batch)
    packed = ["data.voxel_transfer=packed"]
    packed_batch = _train_batch(packed)
    assert packed_batch["model_id"] == batch["model_id"]
    packed_losses, packed_got = _port_step(params, stats, packed_batch, packed)
    assert sorted(got) == sorted(ref_flat) == sorted(packed_got)
    for name, value in ref_losses.items():
        np.testing.assert_allclose(losses[name], float(value), rtol=LOSS_RTOL, err_msg=name)
        np.testing.assert_allclose(packed_losses[name], losses[name], rtol=LOSS_RTOL,
                                   err_msg=name)
    for label, errors in (("jax", _max_normalised_errors(got, ref_flat)),
                          ("packed", _max_normalised_errors(packed_got, got))):
        worst = max(errors.items(), key=lambda kv: kv[1])
        assert worst[1] <= GRAD_TOL, (label, worst)


def test_remat_step_equals_the_plain_step_at_128():
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer, make_train_step

    batch = _train_batch([])
    runs = []
    for remat in (False, True):
        cfg = torch_cfg([*V128, *PORT, f"precision.remat_voxel={str(remat).lower()}"])
        torch.manual_seed(cfg.train_seed)
        model = TriCoLoNet.from_config(cfg)
        assert model.voxel_encoder.remat is remat
        step = make_train_step(model, make_optimizer(cfg, model), cfg)
        losses = step(to_device_batch(batch, CPU), cfg.optimizer.lr)
        runs.append(({k: float(v) for k, v in losses.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers()}))
    (ref_losses, ref_grads, ref_buffers), (losses, grads, buffers) = runs
    for name, value in ref_losses.items():
        assert abs(losses[name] - value) <= REMAT_TOL * abs(value), name
    for tensors, refs in ((grads, ref_grads), (buffers, ref_buffers)):
        for name, ref in refs.items():
            if ref.dtype.is_floating_point:
                scale = float(ref.abs().max().clamp_min(1e-30))
                assert float((tensors[name] - ref).abs().max()) <= REMAT_TOL * scale, name
            else:
                assert torch.equal(tensors[name], ref), name


def test_kernel_launch_plans_at_the_recipe_shapes():
    """The 32-bit guards at 128³. A random-scatter batch at the recipe's
    B = 32, every sample at k = tg³ = 4096 tiles (T = 131,072 rows of
    12³ sites after block 1's VALID conv), passes K1's and K2's plans; K1's
    site math would wrap past 303 such samples, and there its plan raises
    (through the wrapper, before any launch) instead of computing."""
    from tricolo_tpu_torch.ops.bn_relu_pool import launch_plan as pool_plan
    from tricolo_tpu_torch.ops.tile_scatter import launch_plan as scatter_plan

    proxy = torch.empty(64, dtype=torch.bfloat16)  # 16-byte-aligned addresses
    assert pool_plan((32 * 4096, 12, 12, 12, 32), 2, proxy, proxy, proxy) == 8
    assert pool_plan((303 * 4096, 12, 12, 12, 32), 2, proxy, proxy, proxy) == 8
    with pytest.raises(ValueError, match="2\\^31"):
        pool_plan((304 * 4096, 12, 12, 12, 32), 2, proxy, proxy, proxy)
    # K2 per-sample: the (B, 4096, 2³, 64) tiles onto a 32³ grid, a
    # 4096-entry inverse map a sample.
    assert scatter_plan(32, 32 * 4096, 2, 32, 64, 2, proxy) == 16

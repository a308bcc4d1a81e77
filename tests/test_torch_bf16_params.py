"""bf16 parameters (``precision.param_dtype=bfloat16``) in every encoder,
against the JAX package on the CPU.

The JAX TriCoLoNet is built from the tiny config (voxel 32, image 32, 2
views, ef_dim 8, B=2) at ``param_dtype=bfloat16``; its variable shapes come
from ``jax.eval_shape(init)`` and are filled with seeded numpy values, each
leaf in its own dtype (bf16 parameters, f32 BN statistics), so both
packages hold the same bf16 values; ``convert.jax_to_torch`` carries them
over by their bits. Encoders: the BiGRU, the MVCNN over ResNet18 and over
EfficientNet-B0, the CLIP heads, and the VoxelCNN on windowed_compact rows
(masked), on the full windowed transfer, on the dense-input plan and
unmasked (all-site BN). The train-mode voxel paths (``explicit_dgrad``,
``remat_voxel``) are held in ``test_torch_bf16_train.py``.

Tolerances, on each feature tensor's max |Δ| over its max |JAX|:

* ``compute_dtype=float32``: 1e-4. Both packages use the same bf16 values
  widened to f32 and compute in f32, so only f32 summation order separates
  them, as in ``test_torch_encoders.py``;
* ``compute_dtype=bfloat16``: 2e-2. Both round activations to bf16 (8 bits
  of mantissa, 3.9e-3 a rounding) at other places: XLA's fusions against
  PyTorch's autocast op by op. Measured worst: 7.7e-3 (the BiGRU's text
  features); 3.8e-3 to 6.8e-3 for the image, voxel and CLIP features. At
  f32 compute every case measured ≤ 5.9e-7.

Also: every parameter and both Adam moments are bf16 and every BN running
buffer f32; and K1/K3's train entries (their plain versions, the CPU path)
with bf16 γ, β against ``masked_hybrid_bn_relu_pool2`` and the all-site
``hybrid_bn_relu_pool``: dγ, dβ come back bf16 within one bf16 ulp (both
round an f32 sum taken in another order), values and dy as
``test_torch_bn_relu_pool_train.py`` holds them at f32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_backbones import fill_tree  # noqa: E402
from test_torch_data import host_batch, jax_cfg, torch_cfg  # noqa: E402

BF16 = ["precision.param_dtype=bfloat16"]
CPU = torch.device("cpu")
CLIP = ["model.text_encoder=CLIPTextEncoder", "model.image_encoder=CLIPImageEncoder",
        "model.voxel_encoder=null"]
CASES = {
    # BiGRU, MVCNN-ResNet18, VoxelCNN on windowed_compact rows (masked BN).
    "tri": [],
    "efficientnet_b0": ["model.modules.MVCNNEncoder.cnn_name=efficientnet_b0",
                        "model.voxel_encoder=null"],
    "clip": CLIP,
    "dense_plan": ["model.image_encoder=null", "data.voxel_transfer=packed",
                   "model.modules.VoxelCNNEncoder.tile_sparse=true"],
    "unmasked": ["model.image_encoder=null", "data.voxel_transfer=packed",
                 "model.modules.VoxelCNNEncoder.masked_bn=false"],
    "windowed": ["model.image_encoder=null", "data.voxel_transfer=windowed"],
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def fill(shapes, rng):
    """Seeded values in an ``eval_shape`` tree, each leaf in its dtype."""
    import jax.numpy as jnp

    return jax.tree.map(lambda value, shape: np.asarray(jnp.asarray(value, shape.dtype)),
                        fill_tree(shapes, rng), shapes)


def arrays(batch) -> dict:
    """A host batch's arrays (what the JAX steps take)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def jax_inputs(batch, cfg):
    """The JAX package's device batch of a host batch's ``arrays``, in its
    compute dtype."""
    from tricolo_tpu.data.device_prep import prepare_device_batch
    from tricolo_tpu.training.steps import _compute_dtype, _wants_voxel_mask

    return prepare_device_batch(batch, cfg.data.voxel_size, _compute_dtype(cfg),
                                _wants_voxel_mask(cfg))


def bf16_pair(overrides, compute="float32", seed=0):
    """(JAX cfg, JAX model, params, batch_stats, port model carrying them,
    host batch) at bf16 parameters."""
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    keys = [*BF16, f"precision.compute_dtype={compute}", *overrides]
    cfg = jax_cfg(keys)
    model = JaxNet.from_config(cfg)
    batch = host_batch(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax_inputs(arrays(batch), cfg))
    rng = np.random.default_rng(seed)
    params = fill(shapes["params"], rng)
    stats = fill(shapes["batch_stats"], rng) if "batch_stats" in shapes else {}
    port = TriCoLoNet.from_config(torch_cfg(keys))
    port.load_state_dict(jax_to_torch(params, stats))
    return cfg, model, params, stats, port, batch


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_forward_matches_jax(case, compute):
    from tricolo_tpu_torch.inference import eval_step, to_device_batch

    cfg, model, params, stats, port, batch = bf16_pair(CASES[case], compute)
    ref = jax.jit(lambda p, s, b: model.apply({"params": p, "batch_stats": s},
                                              jax_inputs(b, cfg), train=False))(
        params, stats, arrays(batch))
    got = eval_step(port.eval(), to_device_batch(batch, CPU))
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        assert value.dtype == torch.float32, key
        error = rel(value.numpy(), ref[key])
        assert error <= TOL[compute], (key, error)


@pytest.mark.parametrize("case", sorted(CASES))
def test_parameters_and_moments_bf16_statistics_f32(case):
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer

    cfg = torch_cfg([*BF16, *CASES[case]])
    model = TriCoLoNet.from_config(cfg)
    params = list(model.parameters())
    assert {p.dtype for p in params} == {torch.bfloat16}
    stats = [b for name, b in model.named_buffers() if "running_" in name]
    assert {b.dtype for b in stats} <= {torch.float32}
    assert bool(stats) == (case != "clip")  # the CLIP heads have no BatchNorm
    optimizer = make_optimizer(cfg, model)
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    optimizer.step()
    for p in params:
        state = optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.bfloat16
        assert p.grad.dtype == torch.bfloat16
    assert {b.dtype for name, b in model.named_buffers() if "running_" in name} <= {
        torch.float32}


# ------------------------------------------- K1/K3's train entries, bf16 γ, β

EPS = 1e-5


def _op_inputs(shape, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    y = (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    scale = np.asarray(jnp.asarray(rng.uniform(0.5, 1.5, C), jnp.bfloat16))
    bias = np.asarray(jnp.asarray(rng.normal(0.0, 0.3, C), jnp.bfloat16))
    zmask = (rng.random((N, D, H, W, 1)) < 0.6).astype(np.float32)
    smask = (rng.random((N, D, H, W, 1)) < 0.5).astype(np.float32) * zmask
    g = rng.normal(size=(N, D // 2, H // 2, W // 2, C)).astype(np.float32)
    return y, scale, bias, zmask, smask, g


def _bits(a) -> torch.Tensor:
    """A bf16 numpy array (JAX's) as a torch.bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _ulps(got: torch.Tensor, ref) -> int:
    """Largest distance in bf16 steps between two bf16 vectors of one sign."""
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = np.array(ref).view(np.int16).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("ydtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_train_entries_take_bf16_scale_and_bias(masked, ydtype):
    import jax.numpy as jnp

    from tricolo_tpu.ops.fused_bn_pool import hybrid_bn_relu_pool, masked_hybrid_bn_relu_pool2
    from tricolo_tpu_torch.ops.bn_relu_pool import bn_relu_pool_train, masked_bn_relu_pool_train

    y, scale, bias, zmask, smask, g = _op_inputs((3, 6, 6, 6, 8), 4 + masked)
    jdt, tdt = getattr(jnp, ydtype), getattr(torch, ydtype)
    masks = (smask, zmask) if masked else ()

    def f(y, scale, bias):
        op = masked_hybrid_bn_relu_pool2 if masked else hybrid_bn_relu_pool
        out = op(y, scale, bias, *(jnp.asarray(m, jdt) for m in masks), EPS)
        return jnp.sum(out[0].astype(jnp.float32) * g), out

    ref_grads, ref_out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(y, jdt), jnp.asarray(scale), jnp.asarray(bias))

    yt = torch.tensor(y, dtype=tdt, requires_grad=True)
    st, bt = (_bits(a).requires_grad_() for a in (scale, bias))
    if masked:
        smask_t, zmask_t = (torch.from_numpy(m).to(tdt) for m in masks)
        out = masked_bn_relu_pool_train(yt, st, bt, smask_t, zmask_t, EPS, use_kernels=False)
    else:
        out = bn_relu_pool_train(yt, st, bt, EPS, use_kernels=False)
    (out[0].float() * torch.from_numpy(g)).sum().backward()

    assert st.grad.dtype == bt.grad.dtype == torch.bfloat16
    assert str(ref_grads[1].dtype) == str(ref_grads[2].dtype) == "bfloat16"
    assert _ulps(st.grad, ref_grads[1]) <= 1 and _ulps(bt.grad, ref_grads[2]) <= 1
    atol = 1e-5 if ydtype == "float32" else 1e-2
    for got, want in zip(out[:3], ref_out[:3]):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), rtol=0, atol=atol)
    np.testing.assert_allclose(yt.grad.float().numpy(), np.asarray(ref_grads[0], np.float32),
                               rtol=0, atol=atol)
    assert (out[0] > 0).any() and (yt.grad != 0).any()

"""The unmasked (all-site) BN → ReLU → MaxPool(2³) of the port against the
JAX package: the op, its eval form and the ``masked_bn=false`` voxel
encoder. On the CPU the port runs the plain versions of K1's and K3's
unmasked entries; ``test_torch_kernels.py`` (``-m cuda``) and
``chip_smoke.py`` hold the kernels to those bit for bit.

Tolerances, f32 on the CPU, against each JAX variant (``fused_bn_relu_pool``
with the Pallas kernels in interpret mode, ``hybrid_bn_relu_pool``,
``reference_bn_relu_pool``): pooled atol 1e-5; mean and var rtol 1e-6 (the
inputs are quantized to eighths, so their sums are exact and only the
division and the variance's subtraction round); dy, dγ and dβ atol 3e-5,
the JAX package's own bar between its three paths
(``tests/test_fused_bn_pool.py``). In bf16 against ``hybrid_bn_relu_pool``,
whose rounding the port follows (f32 backward, one cast): one bf16 ulp of
the larger magnitude, elementwise. The eval form against
``inference_bn_relu_pool``: 1e-5 in f32, exact in bf16 (the same two
roundings). The encoder with JAX weights carried by ``convert.jax_to_torch``:
eval features atol 1e-4 (convolutions sum in other orders); one train
step's features 1e-4, gradients within 3e-4 of each tensor's largest
magnitude, running statistics atol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops import (  # noqa: E402
    bn_relu_pool,
    bn_relu_pool_train,
    fold_bn,
)

EPS = 1e-5
POOL_ATOL = 1e-5
STATS_RTOL = 1e-6
GRAD_ATOL = 3e-5
FEAT_ATOL = 1e-4
GRAD_TOL = 3e-4
STATS_ATOL = 1e-5


def teardown_module(module):
    # Interpret-mode pallas_call state: clear it as the repo's Pallas test
    # modules do.
    jax.clear_caches()


def _inputs(shape, seed, zero_scale=False):
    """Quantized activations (exact ties in windows), a dead region (every
    activation of its windows below the ReLU), BN parameters, and the
    cotangents of pooled, mean and var."""
    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    y = (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    y[0, :2, :2, :4] = -3.0  # dead windows in every channel
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, C).astype(np.float32)
    if zero_scale:
        scale[0], bias[0] = 0.0, 0.5  # γ = 0, live pooled cells
    g = rng.normal(size=(N, D // 2, H // 2, W // 2, C)).astype(np.float32)
    g_mean = rng.normal(size=C).astype(np.float32)
    g_var = rng.normal(size=C).astype(np.float32)
    return y, scale, bias, g, g_mean, g_var


def _port(y, scale, bias, g, g_mean, g_var, dtype=torch.float32):
    """Values and (dy, dγ, dβ) of Σ pooled·g + Σ mean·g_mean + Σ var·g_var."""
    yt = torch.tensor(y).to(dtype).requires_grad_()
    st, bt = (torch.tensor(a, requires_grad=True) for a in (scale, bias))
    pooled, mean, var = bn_relu_pool_train(yt, st, bt, EPS)
    loss = ((pooled.float() * torch.from_numpy(g)).sum() + (mean * torch.from_numpy(g_mean)).sum()
            + (var * torch.from_numpy(g_var)).sum())
    loss.backward()
    values = [pooled.detach().float().numpy(), mean.detach().numpy(), var.detach().numpy()]
    return values, [yt.grad.float().numpy(), st.grad.numpy(), bt.grad.numpy()]


def _jax(op, y, scale, bias, g, g_mean, g_var, dtype=None):
    import jax.numpy as jnp

    def f(y, scale, bias):
        pooled, mean, var = op(y, scale, bias, EPS)
        loss = (jnp.sum(pooled.astype(jnp.float32) * g) + jnp.sum(mean * g_mean)
                + jnp.sum(var * g_var))
        return loss, (pooled, mean, var)

    y = jnp.asarray(y) if dtype is None else jnp.asarray(y).astype(dtype)
    grads, out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(
        y, jnp.asarray(scale), jnp.asarray(bias))
    return ([np.asarray(v.astype(jnp.float32)) for v in out],
            [np.asarray(d.astype(jnp.float32)) for d in grads])


def _variant(name):
    from tricolo_tpu.ops import fused_bn_pool

    if name == "fused_bn_relu_pool":  # the Pallas kernels, in interpret mode
        return lambda y, s, b, eps: fused_bn_pool.fused_bn_relu_pool(y, s, b, eps, 2, True)
    return getattr(fused_bn_pool, name)


def _assert_matches(values, grads, ref_values, ref_grads):
    np.testing.assert_allclose(values[0], ref_values[0], rtol=0, atol=POOL_ATOL)
    for got, ref in zip(values[1:], ref_values[1:]):
        np.testing.assert_allclose(got, ref, rtol=STATS_RTOL, atol=0)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 8), (3, 4, 4, 8, 16)])
@pytest.mark.parametrize("variant", ["fused_bn_relu_pool", "hybrid_bn_relu_pool",
                                     "reference_bn_relu_pool"])
def test_train_op_matches_jax_variant(variant, shape):
    args = _inputs(shape, 0)
    values, grads = _port(*args)
    _assert_matches(values, grads, *_jax(_variant(variant), *args))
    assert (values[0] == 0).any() and (values[0] > 0).any()  # dead and live cells
    assert (np.abs(grads[0]) > 0).all(axis=-1).any()


@pytest.mark.parametrize("variant", ["fused_bn_relu_pool", "hybrid_bn_relu_pool"])
def test_zero_scale_channel(variant):
    """γ = 0 makes ẑ at the argmax unrecoverable: dγ of that channel is 0,
    as in JAX's fused and hybrid paths (the composed reference path
    differentiates through the tie instead, so it is not held here)."""
    args = _inputs((2, 4, 4, 4, 8), 1, zero_scale=True)
    values, grads = _port(*args)
    ref_values, ref_grads = _jax(_variant(variant), *args)
    assert grads[1][0] == 0.0 and ref_grads[1][0] == 0.0 and grads[2][0] != 0.0
    _assert_matches(values, grads, ref_values, ref_grads)


def _bf16_ulp(a, b):
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)


def test_bf16_within_one_ulp_of_hybrid():
    import jax.numpy as jnp

    from tricolo_tpu.ops.fused_bn_pool import hybrid_bn_relu_pool

    args = _inputs((2, 8, 8, 8, 16), 2)
    values, grads = _port(*args, dtype=torch.bfloat16)
    ref_values, ref_grads = _jax(hybrid_bn_relu_pool, *args, dtype=jnp.bfloat16)
    for got, ref in ((values[0], ref_values[0]), (grads[0], ref_grads[0])):
        assert (np.abs(got - ref) <= _bf16_ulp(got, ref)).all(), np.abs(got - ref).max()
    for got, ref in zip(values[1:] + grads[1:], ref_values[1:] + ref_grads[1:]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=GRAD_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_form_matches_inference_bn_relu_pool(dtype):
    import jax.numpy as jnp

    from tricolo_tpu.ops.fused_bn_pool import inference_bn_relu_pool

    rng = np.random.default_rng(3)
    y, scale, bias, *_ = _inputs((2, 8, 6, 4, 16), 3)
    mean = rng.normal(0.0, 0.3, 16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    ref = np.asarray(inference_bn_relu_pool(
        jnp.asarray(y).astype(dtype), *map(jnp.asarray, (scale, bias, mean, var)), EPS
    ).astype(jnp.float32))
    t = getattr(torch, dtype)
    mul, add = fold_bn(*map(torch.from_numpy, (scale, bias, mean, var)), EPS, t)
    got = bn_relu_pool(torch.tensor(y).to(t), mul, add).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=POOL_ATOL if dtype == "float32" else 0)


# ------------------------------------------------------------ the encoder


def _voxels(batch, d, seed):
    """(B, d, d, d, 4): RGB at ~12% occupied sites, the occupancy channel."""
    rng = np.random.default_rng(seed)
    occ = rng.random((batch, d, d, d, 1)) < 0.12
    rgb = rng.uniform(0.05, 1.0, (batch, d, d, d, 3)) * occ
    return np.concatenate([rgb, occ], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def encoder_weights():
    """JAX ``VoxelCNNEncoder(masked_bn=False)`` weights (voxel 32, ef 8) with
    random BN state, as numpy trees."""
    from test_torch_data import _numpy_tree, _randomize_bn
    from tricolo_tpu.models.voxel_cnn import VoxelCNNEncoder

    enc = VoxelCNNEncoder(voxel_size=32, ef_dim=8, masked_bn=False)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(5), _voxels(2, 32, 0))
    params, stats = _numpy_tree(variables["params"]), _numpy_tree(variables["batch_stats"])
    _randomize_bn(params, stats, np.random.default_rng(5))
    return params, stats


def _port_encoder(params, stats):
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.voxel_cnn import VoxelCNNEncoder

    enc = VoxelCNNEncoder(32, 8, 512, 512, masked_bn=False)
    enc.load_state_dict(jax_to_torch(params, stats))
    return enc


def test_encoder_eval_matches_jax_and_ignores_the_mask_channel(encoder_weights):
    from tricolo_tpu.models.voxel_cnn import VoxelCNNEncoder

    params, stats = encoder_weights
    voxels = _voxels(3, 32, 1)
    ref = np.asarray(VoxelCNNEncoder(voxel_size=32, ef_dim=8, masked_bn=False).apply(
        {"params": params, "batch_stats": stats}, voxels))
    enc = _port_encoder(params, stats).eval()
    with torch.no_grad():
        got4 = enc(voxels=torch.from_numpy(voxels)).numpy()
        got3 = enc(voxels=torch.from_numpy(voxels[..., :3].copy())).numpy()
    np.testing.assert_allclose(got4, ref, rtol=0, atol=FEAT_ATOL)
    np.testing.assert_array_equal(got3, got4)


@pytest.mark.parametrize("fused", [None, True, False], ids=["auto", "true", "false"])
def test_encoder_train_step_matches_jax(encoder_weights, fused):
    """Features, gradients of Σ features·G and the updated running
    statistics of one train-mode forward/backward, against the JAX encoder
    at each ``fused_bn_pool`` (hybrid, Pallas in interpret mode, composed)."""
    import jax.numpy as jnp

    from test_torch_train import _flat
    from tricolo_tpu.models.voxel_cnn import VoxelCNNEncoder
    from tricolo_tpu_torch.convert import torch_to_jax

    params, stats = encoder_weights
    voxels = _voxels(2, 32, 2)
    cot = np.random.default_rng(6).normal(size=(2, 512)).astype(np.float32)
    model = VoxelCNNEncoder(voxel_size=32, ef_dim=8, masked_bn=False, fused_bn_pool=fused)

    def loss(params):
        out, mutated = model.apply({"params": params, "batch_stats": stats}, voxels, True,
                                   mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mutated["batch_stats"])

    grads, (ref_out, ref_stats) = jax.jit(jax.grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))

    enc = _port_encoder(params, stats).train()
    out = enc(voxels=torch.from_numpy(voxels))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0,
                               atol=FEAT_ATOL)
    state = {k: v.detach().clone() for k, v in enc.state_dict().items()}
    state.update({n: p.grad.detach().clone() for n, p in enc.named_parameters()})
    got_grads, got_stats = (_flat(t) for t in torch_to_jax(state))
    ref_grads = _flat(grads)
    assert sorted(got_grads) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        err = np.abs(got_grads[name] - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)
    for name, ref in _flat(ref_stats).items():
        np.testing.assert_allclose(got_stats[name], ref, rtol=0, atol=STATS_ATOL, err_msg=name)


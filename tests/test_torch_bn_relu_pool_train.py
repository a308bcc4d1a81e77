"""The train-mode masked BN → ReLU → zero → MaxPool(2³) op (K1 forward +
K3 backward) against the JAX package: the hybrid masked ops
``masked_hybrid_bn_relu_pool2`` / ``masked_hybrid_bn_relu_pool`` and, with
all-ones masks, the Pallas ``fused_bn_relu_pool`` (``_fwd_kernel`` +
``_dy_kernel`` in interpret mode). On the CPU the op runs the kernels'
plain versions; the CUDA kernels are held against those in
``test_torch_kernels.py`` and by ``chip_smoke.py``.

Tolerance: atol 1e-5 at f32 on values and on the gradients of a random
cotangent with respect to y, scale and bias (the statistics' sums run in
another order in XLA and PyTorch). Inputs are quantized to eighths so
windows hold exact ties and the first-max routing is exercised.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops.bn_relu_pool import masked_bn_relu_pool_train  # noqa: E402

EPS = 1e-5
ATOL = 1e-5


def teardown_module(module):
    # Interpret-mode pallas_call state: clear it as the repo's Pallas test
    # modules do.
    jax.clear_caches()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    y = (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, C).astype(np.float32)
    zmask = (rng.random((N, D, H, W, 1)) < 0.6).astype(np.float32)
    zmask[:, :2, :2, :2] = 0.0  # an all-zero window
    smask = (rng.random((N, D, H, W, 1)) < 0.5).astype(np.float32) * zmask
    g = rng.normal(size=(N, D // 2, H // 2, W // 2, C)).astype(np.float32)
    return y, scale, bias, zmask, smask, g


def _port(y, scale, bias, smask, zmask, g):
    """Values and (dy, dscale, dbias) of sum(pooled · g) through the port."""
    yt, st, bt = (torch.tensor(a, requires_grad=True) for a in (y, scale, bias))
    zt = None if zmask is None else torch.from_numpy(zmask)
    out = masked_bn_relu_pool_train(yt, st, bt, torch.from_numpy(smask), zt, EPS)
    (out[0] * torch.from_numpy(g)).sum().backward()
    values = [t.detach().numpy() for t in out]
    return values, [yt.grad.numpy(), st.grad.numpy(), bt.grad.numpy()]


def _jax(op, y, scale, bias, g, *masks):
    import jax.numpy as jnp

    def f(y, scale, bias):
        out = op(y, scale, bias, *masks, EPS)
        return jnp.sum(out[0] * g), out

    grads, out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias)
    )
    return [np.asarray(v) for v in out], [np.asarray(d) for d in grads]


def _assert_close(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 6, 6, 6, 8), (2, 4, 4, 4, 16)])
def test_matches_masked_hybrid_two_masks(shape):
    from tricolo_tpu.ops.fused_bn_pool import masked_hybrid_bn_relu_pool2

    y, scale, bias, zmask, smask, g = _inputs(shape, 0)
    ref_vals, ref_grads = _jax(masked_hybrid_bn_relu_pool2, y, scale, bias, g, smask, zmask)
    vals, grads = _port(y, scale, bias, smask, zmask, g)
    _assert_close(vals, ref_vals)
    _assert_close(grads, ref_grads)
    assert (np.abs(grads[0]) > 0).any() and (vals[0] > 0).any()


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 8), (4, 2, 2, 2, 32)])
def test_matches_masked_hybrid_one_mask(shape):
    from tricolo_tpu.ops.fused_bn_pool import masked_hybrid_bn_relu_pool

    y, scale, bias, mask, _, g = _inputs(shape, 1)
    ref_vals, ref_grads = _jax(masked_hybrid_bn_relu_pool, y, scale, bias, g, mask)
    vals, grads = _port(y, scale, bias, mask, None, g)
    _assert_close(vals, ref_vals)
    _assert_close(grads, ref_grads)
    # Masked-out sites receive no gradient.
    assert np.all(grads[0][np.broadcast_to(mask == 0, y.shape)] == 0)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8, 8), (1, 4, 2, 4, 32)])
def test_all_ones_masks_match_pallas_fused(shape):
    """With every site live the op is the unmasked train BN-ReLU-pool of the
    Pallas ``fused_bn_relu_pool`` (``_fwd_kernel`` + ``_dy_kernel``)."""
    from tricolo_tpu.ops.fused_bn_pool import fused_bn_relu_pool

    y, scale, bias, _, _, g = _inputs(shape, 2)
    ones = np.ones(shape[:-1] + (1,), np.float32)

    def pallas(y, scale, bias, eps):
        return fused_bn_relu_pool(y, scale, bias, eps, 2, True)

    ref_vals, ref_grads = _jax(pallas, y, scale, bias, g)
    vals, grads = _port(y, scale, bias, ones, None, g)
    _assert_close(vals[:3], ref_vals)
    np.testing.assert_array_equal(vals[3], 1.0)
    _assert_close(grads, ref_grads)


def test_zero_scale_channel_has_zero_dgamma():
    """γ == 0 makes ẑ at the argmax unrecoverable; dγ is reported as 0 for
    that channel, as in the JAX package."""
    from tricolo_tpu.ops.fused_bn_pool import masked_hybrid_bn_relu_pool2

    y, scale, bias, zmask, smask, g = _inputs((2, 4, 4, 4, 8), 3)
    scale[0] = 0.0
    bias[0] = 0.5  # live pooled cells in channel 0
    ref_vals, ref_grads = _jax(masked_hybrid_bn_relu_pool2, y, scale, bias, g, smask, zmask)
    vals, grads = _port(y, scale, bias, smask, zmask, g)
    assert grads[1][0] == 0.0 and ref_grads[1][0] == 0.0
    assert (vals[0][..., 0] > 0).any() and grads[2][0] != 0.0
    _assert_close(grads, ref_grads)

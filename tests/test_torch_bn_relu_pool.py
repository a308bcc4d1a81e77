"""Kernel K1 (masked eval BN → ReLU → zero → MaxPool 2³): the plain PyTorch
version against the JAX package's ops and its Pallas kernel (interpret
mode). The CUDA kernel is held against the plain version in
``test_torch_kernels.py`` and by ``chip_smoke.py``.

Tolerance: atol 1e-6 in f32 against the JAX ops (the fold's rsqrt may
differ by one ulp between XLA and PyTorch); the argmax index and the
pooled masks are compared exactly. Inputs are quantized to multiples of
1/8 so windows hold exact ties and the first-max rule is exercised.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops.bn_relu_pool import bn_relu_pool_plain, fold_bn  # noqa: E402

EPS = 1e-5


def teardown_module(module):
    # Interpret-mode pallas_call state: clear it as the repo's Pallas test
    # modules do.
    jax.clear_caches()


def _inputs(shape, seed, two_masks=False):
    rng = np.random.default_rng(seed)
    N, D, H, W, C = shape
    y = (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, C).astype(np.float32)
    mean = rng.normal(0.0, 0.3, C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    mask = (rng.random((N, D, H, W, 1)) < 0.6).astype(np.float32)
    mask[:, :2, :2, :2] = 0.0  # an all-zero window
    stats = (rng.random((N, D, H, W, 1)) < 0.4).astype(np.float32) * mask
    return y, scale, bias, mean, var, mask, (stats if two_masks else None)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 6, 6, 6, 8), (2, 4, 4, 4, 16)])
def test_plain_matches_masked_inference_two_masks(shape):
    from tricolo_tpu.ops.fused_bn_pool import masked_inference_bn_relu_pool2

    y, scale, bias, mean, var, zmask, smask = _inputs(shape, 0, two_masks=True)
    ref, ref_mask = masked_inference_bn_relu_pool2(
        y, scale, bias, mean, var, smask, zmask, EPS
    )
    mul, add = fold_bn(*map(_t, (scale, bias, mean, var)), EPS, torch.float32)
    got, got_mask = bn_relu_pool_plain(_t(y), mul, add, _t(zmask), _t(smask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 8), (4, 2, 2, 2, 32)])
def test_plain_matches_masked_inference(shape):
    from tricolo_tpu.ops.fused_bn_pool import masked_inference_bn_relu_pool

    y, scale, bias, mean, var, mask, _ = _inputs(shape, 1)
    ref, ref_mask = masked_inference_bn_relu_pool(y, scale, bias, mean, var, mask, EPS)
    mul, add = fold_bn(*map(_t, (scale, bias, mean, var)), EPS, torch.float32)
    got, got_mask = bn_relu_pool_plain(_t(y), mul, add, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_fold_matches_muladd():
    import jax.numpy as jnp

    from tricolo_tpu.ops.fused_bn_pool import _muladd

    _, scale, bias, mean, var, _, _ = _inputs((1, 2, 2, 2, 64), 2)
    invstd = jax.lax.rsqrt(jnp.asarray(var) + EPS)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref_mul, ref_add = _muladd(jnp.asarray(mean), invstd, scale, bias, jdt)
        mul, add = fold_bn(*map(_t, (scale, bias, mean, var)), EPS, tdt)
        assert mul.dtype == tdt and add.dtype == tdt
        np.testing.assert_allclose(
            mul.float().numpy(), np.asarray(ref_mul, np.float32), rtol=1e-6 if tdt == torch.float32 else 1e-2
        )
        np.testing.assert_allclose(
            add.float().numpy(), np.asarray(ref_add, np.float32), rtol=0,
            atol=1e-6 if tdt == torch.float32 else 1e-2,
        )


@pytest.mark.parametrize("shape", [(2, 4, 4, 8, 8), (1, 4, 2, 4, 32)])
def test_plain_matches_pallas_fwd_kernel(shape):
    """All-ones masks + batch-statistics fold = what the Pallas
    ``_fwd_kernel`` computes: pooled values and the first-argmax index."""
    import jax.numpy as jnp

    from tricolo_tpu.ops import fused_bn_pool

    y, scale, bias, _, _, _, _ = _inputs(shape, 3)
    (pooled, mean, var), residuals = fused_bn_pool._fwd(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias), EPS, 2, True
    )
    idx_ref = np.asarray(residuals[2]).reshape(pooled.shape)
    ones = torch.ones(shape[:-1] + (1,))
    mul, add = fold_bn(_t(scale), _t(bias), _t(np.asarray(mean)), _t(np.asarray(var)),
                       EPS, torch.float32)
    got, got_mask, idx = bn_relu_pool_plain(_t(y), mul, add, ones, want_idx=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pooled), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy().astype(np.float32), idx_ref)
    assert torch.all(got_mask == 1)
    assert (idx_ref > 0).any() and (idx_ref == 0).any()

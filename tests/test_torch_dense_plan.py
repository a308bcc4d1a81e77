"""The dense-input voxel plan of the port against the JAX package: the
device densify/unpack of packed and dense voxels, the voxel encoder on
dense input (tile-sparse and dense masked) and on the full ``windowed``
transfer, and the explicit-dgrad VALID conv.

Tolerances (f32 on the CPU; XLA and PyTorch reduce convolutions, matmuls
and the masked statistics in other orders): features atol 1e-4 (the
serving tolerance of ``test_torch_encoders.py``); train-mode features and
batch statistics atol 1e-5; parameter gradients within 3e-4 of each
tensor's largest magnitude (the gradient tolerance of
``test_torch_train.py``). The densify/unpack helpers are exact. The port-only
checks hold the tile-sparse plan to the port's dense masked path to
rounding (atol 1e-5 on values and statistics, 1e-5 of max on gradients).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import jax_cfg  # noqa: E402

D = 32
ATOL = 1e-4
TRAIN_ATOL = 1e-5
GRAD_TOL = 3e-4
ENC = dict(voxel_size=D, ef_dim=8, z_dim=32, out_dim=16)


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


def _packed(n_samples=2, first=1):
    """(flat, rgb) u32 (B, N) words of synthetic items, with an occupied
    pure-black voxel and padding sentinels."""
    from tricolo_tpu.data.datasets import SyntheticDataset

    ds = SyntheticDataset(jax_cfg(), "val")
    n = ds.max_voxel_points + 4
    flat = np.full((n_samples, n), 0xFFFFFFFF, np.uint32)
    rgb = np.zeros_like(flat)
    for i in range(n_samples):
        item = ds[first + 3 * i]
        flat[i, : len(item["voxel_flat"])] = item["voxel_flat"]
        rgb[i, : len(item["voxel_rgb"])] = item["voxel_rgb"]
    rgb[0, 0] = 1 << 24  # occupied, RGB (0, 0, 0)
    return flat, rgb


def _dense_input():
    """(B, 32³, 4) f32 RGB + occupancy from the JAX package's densify."""
    import jax.numpy as jnp

    from tricolo_tpu.data.device_prep import densify_voxels

    flat, rgb = _packed()
    return np.array(densify_voxels(jnp.asarray(flat), jnp.asarray(rgb), D, jnp.float32, True))


# ------------------------------------------------------------ device prep


@pytest.mark.parametrize("with_mask", [True, False])
def test_densify_and_unpack_match_jax(with_mask):
    import jax.numpy as jnp

    from tricolo_tpu.data import device_prep as ref
    from tricolo_tpu_torch.data import device_prep as ours

    flat, rgb = _packed()
    want = np.asarray(ref.densify_voxels(jnp.asarray(flat), jnp.asarray(rgb), D, jnp.float32,
                                         with_mask))
    got = ours.densify_voxels(torch.from_numpy(flat.view(np.int32)),
                              torch.from_numpy(rgb.view(np.int32)), D, torch.float32, with_mask)
    np.testing.assert_array_equal(got.numpy(), want)
    grid = ref.densify_on_host(flat, rgb, D)
    np.testing.assert_array_equal(ours.densify_on_host(flat, rgb, D), grid)
    unpacked = ours.unpack_dense_voxels(torch.from_numpy(grid.view(np.int32)), torch.float32,
                                        with_mask)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(ref.unpack_dense_voxels(jnp.asarray(grid), jnp.float32,
                                                             with_mask)))
    if with_mask:  # the pure-black voxel is occupied, its colour zero
        site = flat[0, 0]
        x, y, z = site >> 16, (site >> 8) & 0xFF, site & 0xFF
        assert list(got[0, x, y, z].numpy()) == [0.0, 0.0, 0.0, 1.0]


def test_densify_on_host_drops_out_of_range_sites():
    import jax.numpy as jnp

    from tricolo_tpu.data import device_prep as ref
    from tricolo_tpu_torch.data import device_prep as ours

    flat, rgb = _packed(1)
    flat[0, 1] = (40 << 16) | 3  # x = 40 ≥ D: dropped by the host densify
    want = ref.densify_on_host(flat, rgb, D)
    np.testing.assert_array_equal(ours.densify_on_host(flat, rgb, D), want)
    dev = ours.densify_voxels(torch.from_numpy(flat.view(np.int32)),
                              torch.from_numpy(rgb.view(np.int32)), D)
    ref_dev = ref.densify_voxels(jnp.asarray(flat), jnp.asarray(rgb), D)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_dev))


def test_prepare_device_batch_routes_every_transfer():
    from tricolo_tpu_torch.data.device_prep import densify_on_host, prepare_device_batch

    flat, rgb = _packed()
    tokens = torch.zeros(2, 4, dtype=torch.int32)
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    packed = prepare_device_batch({"tokens": tokens, "voxel_flat": as_i32(flat),
                                   "voxel_rgb": as_i32(rgb)}, D)
    dense = prepare_device_batch({"tokens": tokens,
                                  "voxel_grid": as_i32(densify_on_host(flat, rgb, D))}, D)
    assert packed["voxels"].shape == (2, D, D, D, 4)
    assert torch.equal(packed["voxels"], dense["voxels"])
    rows = {"tokens": tokens, "voxel_rows": tokens, "voxel_row_ids": tokens}
    assert set(prepare_device_batch(rows, D)) == {"tokens", "voxel_rows", "voxel_row_ids"}


# ----------------------------------------------------------- the encoder


def _jax_encoder(**kw):
    from tricolo_tpu.models.voxel_cnn import VoxelCNNEncoder

    return VoxelCNNEncoder(**ENC, masked_bn=True, tile_budget_frac=0.9, **kw)


@pytest.fixture(scope="module")
def weights():
    """JAX encoder variables with random BN state, and the port's encoder
    carrying them (through ``convert.jax_to_torch``)."""
    import jax.numpy as jnp

    from test_torch_data import _numpy_tree, _randomize_bn

    vox = _dense_input()
    variables = jax.jit(lambda v: _jax_encoder().init(jax.random.PRNGKey(3), v, True))(
        jnp.asarray(vox))
    params, stats = _numpy_tree(variables["params"]), _numpy_tree(variables["batch_stats"])
    _randomize_bn(params, stats, np.random.default_rng(3))
    return vox, params, stats


def _port_encoder(params, stats, **kw):
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.voxel_cnn import VoxelCNNEncoder

    state = jax_to_torch({"voxel_encoder": params}, {"voxel_encoder": stats})
    enc = VoxelCNNEncoder(**ENC, tile_budget_frac=0.9, **kw)
    enc.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    return enc


def _max_normalised(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("tile_sparse", [True, False])
def test_dense_encoder_eval_matches_jax(weights, tile_sparse):
    vox, params, stats = weights
    enc = _jax_encoder(tile_sparse=tile_sparse, tile_sparse_blocks=2)
    ref = jax.jit(lambda v: enc.apply({"params": params, "batch_stats": stats}, v, False))(vox)
    port = _port_encoder(params, stats, tile_sparse=tile_sparse).eval()
    with torch.no_grad():
        got = port(voxels=torch.from_numpy(vox)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    with torch.no_grad():  # 3-channel input: the nonzero-RGB mask fallback
        got3 = port(voxels=torch.from_numpy(vox[..., :3])).numpy()
    ref3 = jax.jit(lambda v: enc.apply({"params": params, "batch_stats": stats}, v, False))(
        vox[..., :3])
    np.testing.assert_allclose(got3, np.asarray(ref3), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tile_sparse", [True, False])
def test_dense_encoder_train_matches_jax(weights, tile_sparse):
    """Train-mode features, updated running statistics and the parameter
    gradients of sum(features · g)."""
    import jax.numpy as jnp

    from test_torch_train import _flat
    from tricolo_tpu_torch.convert import torch_to_jax

    vox, params, stats = weights
    g = np.random.default_rng(1).normal(size=(vox.shape[0], ENC["out_dim"])).astype(np.float32)
    enc = _jax_encoder(tile_sparse=tile_sparse, tile_sparse_blocks=2)

    def loss(p):
        out, mut = enc.apply({"params": p, "batch_stats": stats}, vox, True,
                             mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    grads, (ref_out, ref_stats) = jax.jit(jax.grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    port = _port_encoder(params, stats, tile_sparse=tile_sparse).train()
    out = port(voxels=torch.from_numpy(vox))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0,
                               atol=TRAIN_ATOL)
    state = {k: v.detach() for k, v in port.state_dict().items()}
    got_stats = torch_to_jax({f"voxel_encoder.{k}": v for k, v in state.items()})[1]
    for name, ref in _flat(ref_stats).items():
        np.testing.assert_allclose(_flat(got_stats["voxel_encoder"])[name], ref, rtol=0,
                                   atol=TRAIN_ATOL, err_msg=name)
    for name, p in port.named_parameters():
        state[name] = p.grad
    got_grads = _flat(torch_to_jax({f"voxel_encoder.{k}": v for k, v in state.items()})[0])
    for name, ref in _flat(grads).items():
        err = _max_normalised(got_grads[f"voxel_encoder/{name}"], ref)
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_sparse_plan_equals_port_dense_masked(weights, blocks):
    """Port only: the tile-sparse plan at 1-3 sparse blocks equals the
    port's own dense masked path — eval values, train values, running
    statistics and gradients."""
    vox, params, stats = weights
    x = torch.from_numpy(vox)
    dense = _port_encoder(params, stats)
    sparse = _port_encoder(params, stats, tile_sparse=True, tile_sparse_blocks=blocks)
    with torch.no_grad():
        np.testing.assert_allclose(sparse.eval()(voxels=x).numpy(), dense.eval()(voxels=x).numpy(),
                                   rtol=0, atol=1e-5)
    g = torch.from_numpy(np.random.default_rng(blocks).normal(size=(x.shape[0], ENC["out_dim"])))
    outs = []
    for enc in (dense.train(), sparse.train()):
        out = enc(voxels=x)
        (out * g).sum().backward()  # sum(out²) of unit vectors has no gradient
        outs.append(out.detach().numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)
    for (name, a), b in zip(dense.state_dict().items(), sparse.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=name)
    for (name, a), b in zip(dense.named_parameters(), sparse.parameters()):
        assert _max_normalised(b.grad.numpy(), a.grad.numpy()) <= 1e-5, name


@pytest.mark.parametrize("halo", [1, 3])
def test_full_windowed_matches_jax(weights, halo):
    """voxel_transfer=windowed: the on-device row take + global scatter
    equals the JAX package's ``_windowed_forward`` full mode."""
    from tricolo_tpu.data.device_prep import windowed_on_host

    _, params, stats = weights
    flat, rgb = _packed()
    windows, occ = windowed_on_host(flat, rgb, D, halo=halo)
    enc = _jax_encoder()
    ref = jax.jit(lambda w, o: enc.apply({"params": params, "batch_stats": stats}, None, False,
                                         True, w, o))(windows, occ)
    port = _port_encoder(params, stats).eval()
    with torch.no_grad():
        got = port(windows=torch.from_numpy(windows.view(np.int32)),
                   tile_occ=torch.from_numpy(occ)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


# ------------------------------------------------------ explicit dgrad


@pytest.mark.parametrize("shape", [(3, 6, 6, 6, 8, 16), (2, 10, 10, 10, 4, 8)])
def test_conv3d_explicit_dgrad_matches_jax(shape):
    """Values and both gradients of the explicit-dgrad VALID conv equal the
    JAX package's ``conv3d_valid_explicit_dgrad`` (f32: sums of 27·C
    products in another order, within 1e-5 of each gradient's largest
    magnitude)."""
    import jax.numpy as jnp

    from tricolo_tpu.ops.conv3d import conv3d_valid_explicit_dgrad as jax_conv
    from tricolo_tpu_torch.ops import conv3d_valid_explicit_dgrad

    N, Dd, H, W, cin, cout = shape
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(N, Dd, H, W, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(N, Dd - 2, H - 2, W - 2, cout)).astype(np.float32)
    f = jax.jit(jax.value_and_grad(lambda a, b: jnp.sum(jax_conv(a, b) * g), argnums=(0, 1)))
    ref_val, (ref_dx, ref_dw) = f(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x.transpose(0, 4, 1, 2, 3), requires_grad=True)
    wt = torch.tensor(w.transpose(4, 3, 0, 1, 2), requires_grad=True)
    out = conv3d_valid_explicit_dgrad(xt, wt)
    val = (out * torch.from_numpy(g.transpose(0, 4, 1, 2, 3))).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    assert _max_normalised(xt.grad.numpy().transpose(0, 2, 3, 4, 1), np.asarray(ref_dx)) <= 1e-5
    assert _max_normalised(wt.grad.numpy().transpose(2, 3, 4, 1, 0), np.asarray(ref_dw)) <= 1e-5
    # The same gradients as autograd's own transposed convolution.
    xa = xt.detach().clone().requires_grad_()
    wa = wt.detach().clone().requires_grad_()
    (torch.nn.functional.conv3d(xa, wa) * torch.from_numpy(g.transpose(0, 4, 1, 2, 3))).sum(
    ).backward()
    assert _max_normalised(xt.grad.numpy(), xa.grad.numpy()) <= 1e-5
    assert _max_normalised(wt.grad.numpy(), wa.grad.numpy()) <= 1e-5


def test_explicit_dgrad_encoder_matches_default(weights):
    """``explicit_dgrad=true`` changes only how the VALID convs' input
    gradient is computed: values equal, gradients to rounding."""
    vox, params, stats = weights
    x = torch.from_numpy(vox)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(x.shape[0], ENC["out_dim"])))
    grads = []
    for explicit in (False, True):
        enc = _port_encoder(params, stats, tile_sparse=True, explicit_dgrad=explicit).train()
        assert enc.explicit_dgrad == explicit
        (enc(voxels=x) * g).sum().backward()
        grads.append([p.grad.numpy() for p in enc.parameters()])
    for a, b in zip(*grads):
        assert _max_normalised(b, a) <= 1e-5

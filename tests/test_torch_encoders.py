"""Each encoder of the port (eval) against the JAX package's ``apply``.

Tolerance: atol 1e-4 on the L2-normalized f32 outputs. Both sides compute
in f32 on the CPU; XLA and PyTorch reduce convolutions and matmuls in
different orders, which moves the last bits.
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
    torch_model,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def tri():
    cfg = jax_cfg()
    model, params, stats = jax_variables(cfg)
    return cfg, model, params, stats, torch_model(params, stats), host_batch(cfg)


def test_bigru_matches(tri):
    from tricolo_tpu.models.bigru import BiGRUEncoder

    cfg, _, params, _, port, batch = tri
    enc = BiGRUEncoder(vocab_size=cfg.data.vocab_size, out_dim=512)
    tokens = batch["tokens"].copy()
    tokens[1, -4:] = 0  # trailing padding runs through both directions
    ref = np.asarray(enc.apply({"params": params["text_encoder"]}, tokens))
    with torch.no_grad():
        got = port.text_encoder(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_mvcnn_matches(tri):
    import jax.numpy as jnp

    from tricolo_tpu.data.device_prep import normalize_images
    from tricolo_tpu.models.mvcnn import MVCNNEncoder

    _, _, params, stats, port, batch = tri
    images = np.array(normalize_images(jnp.asarray(batch["images"])))
    enc = MVCNNEncoder(num_views=2, z_dim=512, out_dim=512)
    ref = np.asarray(
        enc.apply(
            {"params": params["image_encoder"], "batch_stats": stats["image_encoder"]},
            images,
        )
    )
    with torch.no_grad():
        got = port.image_encoder(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("halo", [3, 1])
def test_windowed_voxel_matches(tri, halo):
    from tricolo_tpu.data.device_prep import windowed_compact_on_host
    from tricolo_tpu.data.datasets import SyntheticDataset
    from tricolo_tpu.models.voxel_cnn import VoxelCNNEncoder

    cfg, _, params, stats, port, _ = tri
    ds = SyntheticDataset(cfg, "val")
    flat = np.full((2, ds.max_voxel_points), 0xFFFFFFFF, np.uint32)
    rgb = np.zeros_like(flat)
    for i in range(2):
        item = ds[4 + 3 * i]
        flat[i, : len(item["voxel_flat"])] = item["voxel_flat"]
        rgb[i, : len(item["voxel_rgb"])] = item["voxel_rgb"]
    # A budget above the split's need adds padding rows and ids (≥ tg³).
    rows, ids, _ = windowed_compact_on_host(flat, rgb, 32, 64, halo=halo)
    enc = VoxelCNNEncoder(voxel_size=32, ef_dim=8, masked_bn=True)
    ref = np.asarray(
        enc.apply(
            {"params": params["voxel_encoder"], "batch_stats": stats["voxel_encoder"]},
            None, False, True, rows, None, ids,
        )
    )
    with torch.no_grad():
        got = port.voxel_encoder(
            torch.from_numpy(rows.view(np.int32)), torch.from_numpy(ids)
        ).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_tricolo_net_matches(tri):
    from tricolo_tpu_torch.inference import eval_step, to_device_batch

    cfg, model, params, stats, port, batch = tri
    ref = model.apply(
        {"params": params, "batch_stats": stats}, jax_device_batch(batch, cfg), train=False
    )
    got = eval_step(port, to_device_batch(batch, torch.device("cpu")))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("halo,k", [(3, 64), (1, 64), (3, 9)])
def test_windowed_compact_on_host_matches_jax(halo, k):
    from tricolo_tpu.data.datasets import SyntheticDataset
    from tricolo_tpu.data.device_prep import windowed_compact_on_host as ref_fn
    from tricolo_tpu_torch.data.device_prep import windowed_compact_on_host

    ds = SyntheticDataset(jax_cfg(), "val")
    flat = np.full((3, ds.max_voxel_points), 0xFFFFFFFF, np.uint32)
    rgb = np.zeros_like(flat)
    for i in range(3):
        item = ds[3 * i + 1]
        flat[i, : len(item["voxel_flat"])] = item["voxel_flat"]
        rgb[i, : len(item["voxel_rgb"])] = item["voxel_rgb"]
    for a, b in zip(
        windowed_compact_on_host(flat, rgb, 32, k, halo=halo),
        ref_fn(flat, rgb, 32, k, halo=halo),
    ):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

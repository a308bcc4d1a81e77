"""PyTorch port vs the JAX package: config, data pipeline, and the shared
tiny Tri(I+V) fixture the other ``test_torch_*`` files import.

The fixture builds the JAX TriCoLoNet at tiny width (voxel 32, image 32,
2 views, ef_dim 8, B=2, f32), gives every BatchNorm random scale/bias and
random running statistics (so eval BN is not the identity), and carries the
weights to the port with ``tricolo_tpu_torch.convert``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

TINY = [
    "data=synthetic",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "data.batch_size=2",
    "data.num_models=5",
    "model.modules.VoxelCNNEncoder.ef_dim=8",
    "precision.compute_dtype=float32",
]


def jax_cfg(extra=()):
    from tricolo_tpu.config import load_config

    return load_config([*TINY, *extra])


def torch_cfg(extra=()):
    from tricolo_tpu_torch.config import load_config

    return load_config([*TINY, *extra])


def host_batch(cfg):
    """First eval batch of the JAX package's loader (numpy)."""
    from tricolo_tpu.data import DataModule

    dm = DataModule(cfg)
    dm.setup("test")
    return dm.test_loader().peek()


def jax_device_batch(batch, cfg):
    import jax.numpy as jnp

    from tricolo_tpu.data.device_prep import prepare_device_batch

    arrays = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    return prepare_device_batch(arrays, cfg.data.voxel_size, jnp.float32, voxel_mask=True)


def _randomize_bn(params, stats, rng):
    """Random BN scale/bias and running mean/var, in place (numpy trees)."""

    def walk(p, s):
        for key, value in p.items():
            if isinstance(value, dict):
                walk(value, s.get(key, {}) if isinstance(s, dict) else {})
        if "scale" in p and "bias" in p:
            c = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["bias"] = rng.normal(0.0, 0.2, c).astype(np.float32)
            s["mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    walk(params, stats)


def _numpy_tree(tree):
    return {
        k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
        for k, v in tree.items()
    }


def jax_variables(cfg, seed=0):
    """(model, params, batch_stats): the JAX TriCoLoNet and numpy trees
    with non-trivial BN state."""
    from tricolo_tpu.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jax_device_batch(host_batch(cfg), cfg)
    )
    params = _numpy_tree(variables["params"])
    stats = _numpy_tree(variables["batch_stats"])
    _randomize_bn(params, stats, np.random.default_rng(seed))
    return model, params, stats


def torch_model(params, stats, extra=()):
    """The port's TriCoLoNet carrying the JAX weights, on the CPU."""
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(torch_cfg(extra))
    model.load_state_dict(jax_to_torch(params, stats))
    return model.eval()


# --------------------------------------------------------------------- tests


@pytest.mark.parametrize(
    "overrides",
    [
        TINY,
        ["data=text2shape_chair_table", "+a.b=3", "model.out_dim=256"],
        ["data=structured", "experiment_name=x"],
    ],
)
def test_config_matches_jax(overrides):
    from tricolo_tpu.config import load_config as jax_load
    from tricolo_tpu_torch.config import load_config as torch_load

    a, b = jax_load(overrides).to_dict(), torch_load(overrides).to_dict()
    a.pop("project_root_path"), b.pop("project_root_path")
    assert a == b


def test_config_rejects_unknown_key():
    from tricolo_tpu_torch.config import load_config

    with pytest.raises(KeyError):
        load_config(["model.no_such_key=1"])


def test_synthetic_items_match_jax():
    from tricolo_tpu.data.datasets import SyntheticDataset as JaxSynthetic
    from tricolo_tpu_torch.data.datasets import SyntheticDataset

    ours, ref = SyntheticDataset(torch_cfg(), "val"), JaxSynthetic(jax_cfg(), "val")
    assert len(ours) == len(ref)
    assert ours.max_voxel_points == ref.max_voxel_points
    assert ours.max_voxel_tiles == ref.max_voxel_tiles
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["model_id"] == b["model_id"] and a["category"] == b["category"]
        for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
            np.testing.assert_array_equal(a[key], b[key])


def test_eval_batches_match_jax():
    """Every eval batch — tail padding and num_valid included."""
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule

    ours, ref = DataModule(torch_cfg()), JaxDataModule(jax_cfg())
    ours.setup("test"), ref.setup("test")
    loaders = ours.test_loader(), ref.test_loader()
    assert loaders[0].tile_budget_rows == loaders[1].tile_budget_rows
    ref_batches = list(loaders[1])
    ours_batches = list(loaders[0])
    assert len(ours_batches) == len(ref_batches) == 8
    for a, b in zip(ours_batches, ref_batches):
        assert a["num_valid"] == b["num_valid"]
        assert a["model_id"] == b["model_id"]
        for key in ("tokens", "images", "voxel_rows", "voxel_row_ids"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("halo", [1, 3])
def test_windowed_on_host_matches_jax(halo):
    from tricolo_tpu.data.datasets import SyntheticDataset as JaxSynthetic
    from tricolo_tpu.data.device_prep import windowed_on_host as jax_windowed
    from tricolo_tpu_torch.data.device_prep import windowed_on_host

    ds = JaxSynthetic(jax_cfg(), "val")
    flat = np.full((2, ds.max_voxel_points), 0xFFFFFFFF, np.uint32)
    rgb = np.zeros_like(flat)
    for i in range(2):
        item = ds[3 * i]
        flat[i, : len(item["voxel_flat"])] = item["voxel_flat"]
        rgb[i, : len(item["voxel_rgb"])] = item["voxel_rgb"]
    ours = windowed_on_host(flat, rgb, 32, halo=halo)
    ref = jax_windowed(flat, rgb, 32, halo=halo)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_unpack_and_normalize_match_jax():
    import jax.numpy as jnp

    from tricolo_tpu.data import device_prep as ref
    from tricolo_tpu_torch.data import device_prep as ours

    batch = host_batch(jax_cfg())
    rows = batch["voxel_rows"]
    x_ref, m_ref = ref.unpack_windowed_rows(jnp.asarray(rows), jnp.float32)
    x, m = ours.unpack_windowed_rows(torch.from_numpy(rows.view(np.int32)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    img_ref = ref.normalize_images(jnp.asarray(batch["images"]), jnp.float32)
    img = ours.normalize_images(torch.from_numpy(batch["images"]))
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), rtol=0, atol=1e-6)


def test_ellipsoid_sample_matches_graft_entry():
    from __graft_entry__ import ellipsoid_sample as ref_sample
    from tricolo_tpu_torch.data.ellipsoid import ellipsoid_sample

    for seed in (0, 1):
        ours = ellipsoid_sample(np.random.default_rng(seed), 32, 2048)
        ref = ref_sample(np.random.default_rng(seed), 32, 2048)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_general_dataset_matches_jax(tmp_path):
    """A reference-format split on disk (caption map + per-model npz)."""
    import os

    from test_data import make_disk_dataset
    from tricolo_tpu.data.datasets import GeneralDataset as JaxGeneral
    from tricolo_tpu_torch.data.datasets import GeneralDataset

    make_disk_dataset(str(tmp_path))
    overrides = [
        f"data.exp_data_root_path={tmp_path}",
        f"data.train_lang_data_path={os.path.join(tmp_path, 'train_map.json')}",
        "data.image_size=16", "data.num_views=4", "data.max_tokens=12",
    ]
    ours = GeneralDataset(torch_cfg(overrides), "train")
    ref = JaxGeneral(jax_cfg(overrides), "train")
    assert len(ours) == len(ref) == 6
    assert ours.max_voxel_points == ref.max_voxel_points
    assert ours.max_voxel_tiles == ref.max_voxel_tiles
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert (a["model_id"], a["category"]) == (b["model_id"], b["category"])
        for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
            np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------- host path: prefetch, split load


def _train_loader(**kw):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(torch_cfg(["data.num_models=8"]))
    dm.setup("fit")
    loader = dm.train_loader()
    for key, value in kw.items():
        setattr(loader, key, value)
    return loader


def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "tricolo-prefetch"]


def test_prefetch_stream_equals_synchronous_stream():
    """Batch for batch over two shuffled epochs, with and without the
    producer thread."""
    loader = _train_loader()
    streams = {}
    for prefetch in (True, False):
        loader.prefetch = prefetch
        streams[prefetch] = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            streams[prefetch] += list(loader)
    assert len(streams[True]) == len(streams[False]) == 2 * len(loader) > 2
    assert streams[True][0]["model_id"] != streams[True][len(loader)]["model_id"]
    for a, b in zip(streams[True], streams[False]):
        assert a.keys() == b.keys() and a["model_id"] == b["model_id"]
        assert a["num_valid"] == b["num_valid"]
        for key in ("tokens", "images", "voxel_rows", "voxel_row_ids"):
            np.testing.assert_array_equal(a[key], b[key])


def test_producer_error_reaches_the_consumer():
    loader = _train_loader()

    class Broken(type(loader.dataset)):
        def __getitem__(self, idx):
            raise OSError(f"unreadable item {idx}")

    loader.dataset.__class__ = Broken
    with pytest.raises(OSError, match="unreadable item"):
        list(loader)
    assert not _prefetch_threads()


def test_abandoned_iterator_thread_exits():
    loader = _train_loader()
    before = set(_prefetch_threads())
    it = iter(loader)
    next(it)
    (thread,) = set(_prefetch_threads()) - before
    it.close()  # drains the queue and joins with a 5 s timeout
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_peek_starts_no_thread(monkeypatch):
    from tricolo_tpu_torch.data import loader as loader_module

    loader = _train_loader()

    def no_thread(*args, **kwargs):
        raise AssertionError("peek started a thread")

    monkeypatch.setattr(loader_module.threading, "Thread", no_thread)
    batch = loader.peek()
    assert isinstance(batch["voxel_rows"], np.ndarray)
    with pytest.raises(AssertionError, match="started a thread"):
        next(iter(loader))


def test_collate_never_calls_the_plain_sweeps(monkeypatch):
    """Every transfer's collation goes through the C++ sweeps."""
    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.data import DataModule, device_prep

    for name in ("densify_on_host_plain", "windowed_on_host_plain",
                 "windowed_compact_on_host_plain"):
        monkeypatch.setattr(device_prep, name, None)
    native.reset_calls()
    for transfer, sweep in (("dense", "packed_to_dense"), ("windowed", "packed_to_windowed"),
                            ("windowed_compact", "packed_to_windowed_compact")):
        dm = DataModule(torch_cfg([f"data.voxel_transfer={transfer}"]))
        dm.setup("test")
        batches = list(dm.test_loader())
        assert native.call_counts()[sweep] == len(batches) > 0


def test_cpu_to_device_batch_pins_nothing():
    from tricolo_tpu_torch import tracing
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch

    dm = DataModule(torch_cfg())
    dm.setup("test")
    loader = dm.test_loader()
    assert loader.prefetch and not loader.pin_memory
    copies = tracing.counts("to_device.")
    for batch in loader:
        out = to_device_batch(batch, torch.device("cpu"))
        assert out.keys() == {"tokens", "images", "voxel_rows", "voxel_row_ids"}
        assert not any(t.is_pinned() for t in out.values())
        np.testing.assert_array_equal(out["voxel_rows"].numpy().view(np.uint32),
                                      batch["voxel_rows"])
    assert tracing.counts("to_device.") == copies  # counts only copies to a CUDA device


@pytest.mark.parametrize("workers", [1, 4])
def test_general_dataset_threaded_load_matches_jax(tmp_path, monkeypatch, workers):
    """data.num_workers loads the models over that many threads, item for
    item equal to the JAX GeneralDataset."""
    import os

    from test_data import make_disk_dataset
    from tricolo_tpu.data.datasets import GeneralDataset as JaxGeneral
    from tricolo_tpu_torch.data import datasets

    pools = []

    class Recording(datasets.ThreadPoolExecutor):
        def __init__(self, max_workers):
            pools.append(max_workers)
            super().__init__(max_workers=max_workers)

    monkeypatch.setattr(datasets, "ThreadPoolExecutor", Recording)
    make_disk_dataset(str(tmp_path), n_models=6)
    overrides = [
        f"data.exp_data_root_path={tmp_path}",
        f"data.train_lang_data_path={os.path.join(tmp_path, 'train_map.json')}",
        "data.image_size=16", "data.num_views=4", "data.max_tokens=12",
        f"data.num_workers={workers}",
    ]
    ours = datasets.GeneralDataset(torch_cfg(overrides), "train")
    ref = JaxGeneral(jax_cfg(overrides), "train")
    assert pools == ([] if workers == 1 else [workers])
    assert list(ours.vision_data) == list(ref.vision_data)
    assert len(ours) == len(ref) == 12
    assert ours.max_voxel_points == ref.max_voxel_points
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert (a["model_id"], a["category"]) == (b["model_id"], b["category"])
        for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
            np.testing.assert_array_equal(a[key], b[key])

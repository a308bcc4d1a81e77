"""The port's zlib readers (``tricolo_tpu_torch/native/npz_reader.py`` over
``csrc/npz_reader.cpp``) against the JAX package's library and ``np.load``,
bit for bit, on the CPU with g++ and zlib: the fused inflate-and-pack
(``load_npz_voxels_packed``), one member's bytes (``npz_read``) and a gzip
stream (``gzip_decode``), on deflated (``np.savez_compressed``) and stored
(``np.savez``) members; a missing member and a wrong shape raise the same
errors; and the port's split load goes through the fused reader, as its
call counter shows.

The JAX package's library is compiled into the test's own directory (as in
``test_torch_host_loader.py``). Every comparison is exact: the readers only
move and inflate bytes, and the packing is integer arithmetic.
"""

import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_host_loader import jax_native  # noqa: E402,F401  (a fixture)


def _grid(d: int, seed: int) -> np.ndarray:
    """A (4, d, d, d) RGBA grid: a random scatter and a solid block, some
    occupied voxels pure black."""
    rng = np.random.default_rng(seed)
    grid = np.zeros((4, d, d, d), np.uint8)
    sites = rng.choice(d**3, size=d * 5, replace=False)
    x, y, z = sites // (d * d), (sites // d) % d, sites % d
    grid[3, x, y, z] = 255
    grid[:3, x, y, z] = rng.integers(0, 256, (3, len(sites)))
    grid[:, 2:6, 3:9, 1:4] = 200
    grid[:3, 2:4, 3:5, 1:3] = 0  # occupied pure black
    return grid


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    """A deflated and a stored npz with voxel32/64/128 members, views and a
    wrong-shaped member."""
    root = tmp_path_factory.mktemp("npz")
    arrays = {f"voxel{d}": _grid(d, d) for d in (32, 64, 128)}
    arrays["images"] = np.random.default_rng(1).integers(0, 256, (3, 3, 24, 24), np.uint8)
    arrays["flat3"] = np.zeros((4, 8, 8), np.uint8)
    paths = {"deflated": str(root / "deflated.npz"), "stored": str(root / "stored.npz")}
    np.savez_compressed(paths["deflated"], **arrays)
    np.savez(paths["stored"], **arrays)
    return paths, arrays


@pytest.mark.parametrize("kind", ["deflated", "stored"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_load_equals_jax_and_np_load(npz_files, jax_native, kind, d):  # noqa: F811
    from tricolo_tpu_torch.data.datasets import dense_rgba_to_packed_plain
    from tricolo_tpu_torch.native import npz_reader

    paths, arrays = npz_files
    got = npz_reader.load_npz_voxels_packed(paths[kind], f"voxel{d}")
    with np.load(paths[kind]) as npz:
        want = dense_rgba_to_packed_plain(npz[f"voxel{d}"])
    ref = jax_native.load_npz_voxels_packed(paths[kind], f"voxel{d}")
    for a, b, c in zip(got, want, ref):
        assert a.dtype == np.uint32 and a.shape == b.shape == c.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got[0]) == int((arrays[f"voxel{d}"][3] > 0).sum())


@pytest.mark.parametrize("kind", ["deflated", "stored"])
def test_npz_read_equals_jax_and_zipfile(npz_files, jax_native, kind):  # noqa: F811
    import zipfile

    from tricolo_tpu_torch.native import npz_reader

    paths, _ = npz_files
    with zipfile.ZipFile(paths[kind]) as z:
        for member in ("voxel128", "images"):
            want = z.read(f"{member}.npy")
            assert npz_reader.npz_read(paths[kind], member) == want
            assert jax_native.npz_read(paths[kind], member) == want


def test_missing_member_and_wrong_shape_raise_as_jax(npz_files, jax_native):  # noqa: F811
    from tricolo_tpu_torch.native import npz_reader

    paths, _ = npz_files
    path = paths["deflated"]
    for fn in (npz_reader.load_npz_voxels_packed, npz_reader.npz_read):
        with pytest.raises(ValueError, match=r"\[voxel256\]: member not found: voxel256"):
            fn(path, "voxel256")
    for module in (npz_reader, jax_native):
        with pytest.raises(ValueError, match="expected \\(4, D, D, D\\) RGBA voxel grid"):
            module.load_npz_voxels_packed(path, "flat3")
        with pytest.raises(ValueError, match="npy dtype is not uint8"):
            np.savez(path + ".f32.npz", voxel32=np.zeros((4, 2, 2, 2), np.float32))
            module.load_npz_voxels_packed(path + ".f32.npz", "voxel32")
        with pytest.raises(ValueError, match="cannot read file"):
            module.load_npz_voxels_packed(path + ".absent", "voxel32")
        with pytest.raises(ValueError, match="sites exceed cap 10"):
            module.load_npz_voxels_packed(path, "voxel32", n_cap=10)


def test_gzip_decode_round_trip():
    from tricolo_tpu_torch.native import npz_reader

    payload = np.random.default_rng(3).integers(0, 4, 100_000, np.uint8).tobytes()
    stream = gzip.compress(payload)
    assert npz_reader.gzip_decode(stream, len(payload)) == payload
    # A larger buffer returns the stream's own length.
    assert npz_reader.gzip_decode(stream, len(payload) + 17) == payload
    for bad in (stream[:-40], b"not gzip at all"):
        with pytest.raises(ValueError, match="gzip stream corrupt or buffer too small"):
            npz_reader.gzip_decode(bad, len(payload))
    with pytest.raises(ValueError, match="gzip stream corrupt or buffer too small"):
        npz_reader.gzip_decode(stream, len(payload) - 1)


def test_gzip_decode_matches_jax_library(jax_native):  # noqa: F811
    from tricolo_tpu_torch.native import npz_reader

    payload = bytes(range(256)) * 300
    stream = gzip.compress(payload)
    assert npz_reader.gzip_decode(stream, len(payload)) == jax_native.gzip_decode(
        stream, len(payload)) == payload


def test_split_load_goes_through_the_fused_reader(tmp_path):
    """``GeneralDataset`` packs each model's voxel member with one fused
    call and no numpy grid: the reader counts one call a model, the host
    loader's RGBA packing none; items equal the np.load + sweep path."""
    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data.datasets import GeneralDataset, dense_rgba_to_packed_plain
    from tricolo_tpu_torch.data.fixture import exp_data_dir, write_c13_fixture
    from tricolo_tpu_torch.native import npz_reader

    splits = write_c13_fixture(str(tmp_path), models_per_category=3, categories=2,
                               captions_per_model=2, voxel_sizes=(32, 128), num_views=2)
    cfg = load_config(["data=text2shape_c13", f"data.dataset_root_path={tmp_path}",
                       "data.voxel_size=128", "data.num_workers=2", "data.image_size=32",
                       "data.num_views=2"])
    npz_reader.reset_calls()
    native.reset_calls()
    ds = GeneralDataset(cfg, "train")
    assert npz_reader.call_counts() == {"load_npz_voxels_packed": len(splits["train"]),
                                        "npz_read": 0, "gzip_decode": 0}
    assert native.call_counts()["dense_rgba_to_packed"] == 0
    with open(os.path.join(exp_data_dir(str(tmp_path)), "train_map.json")) as f:
        assert len(ds) == len(json.load(f))
    for (category, model_id), entry in ds.vision_data.items():
        path = os.path.join(exp_data_dir(str(tmp_path)), category, f"{model_id}.npz")
        with np.load(path) as npz:
            flat, rgb = dense_rgba_to_packed_plain(npz["voxel128"])
        np.testing.assert_array_equal(entry["flat"], flat)
        np.testing.assert_array_equal(entry["rgb"], rgb)


def test_failed_build_raises(tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing falls back."""
    from tricolo_tpu_torch.native import npz_reader

    bad = tmp_path / "npz_reader.cpp"
    bad.write_text("#include <zlib.h>\nint broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for npz_reader.cpp"):
        npz_reader.build(bad, tmp_path / "build")

"""The port's offline stages (``tricolo_tpu_torch.data.{nrrd,render,
preprocess}`` and ``python -m tricolo_tpu_torch.preprocess``) against the
JAX package's, on the CPU.

Every comparison is exact: both packages run the same numpy code on the
same inputs (the NRRD codec, the OBJ parser, the z-buffer rasterizer, the
caption rows), and the npz views are what Pillow's JPEG decoder gives back
for the same JPEG files. The last test runs ``preprocess_all`` over a tiny
raw C13-shaped tree (solid-ellipsoid NRRDs at 32, 64 and 128, OBJs, maps)
in both packages and loads the port's output with the port's
``GeneralDataset`` at each voxel size, item for item the JAX package's.
"""

import gzip
import json
import os
import pickle
import shutil
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL")

from test_preprocess import CUBE_OBJ  # noqa: E402

C13 = "data=text2shape_c13"


# ------------------------------------------------------------------ NRRD


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_nrrd_round_trip_equals_jax(tmp_path, encoding, dtype):
    from tricolo_tpu.data import nrrd as ref
    from tricolo_tpu_torch.data import nrrd

    arr = (np.random.default_rng(0).random((4, 5, 6, 7)) * 100).astype(dtype)
    ours, theirs = str(tmp_path / "ours.nrrd"), str(tmp_path / "theirs.nrrd")
    nrrd.write(ours, arr, encoding=encoding)
    ref.write(theirs, arr, encoding=encoding)
    head_a, _, payload_a = open(ours, "rb").read().partition(b"\n\n")
    head_b, _, payload_b = open(theirs, "rb").read().partition(b"\n\n")
    assert head_a == head_b
    if encoding == "gzip":  # the gzip header carries the write time
        payload_a, payload_b = gzip.decompress(payload_a), gzip.decompress(payload_b)
    assert payload_a == payload_b
    for path in (ours, theirs):
        got, header = nrrd.read(path)
        want, ref_header = ref.read(path)
        assert got.dtype == want.dtype and header == ref_header
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)


def test_nrrd_zlib_payload_and_fortran_order(tmp_path):
    """A zlib-encoded file (which neither writer emits) reads as JAX reads
    it, fastest axis first."""
    from tricolo_tpu.data import nrrd as ref
    from tricolo_tpu_torch.data import nrrd

    arr = np.arange(4 * 3 * 5, dtype=np.uint16).reshape(4, 3, 5)
    path = tmp_path / "z.nrrd"
    path.write_bytes(b"NRRD0004\n# a comment\ntype: ushort\ndimension: 3\nsizes: 4 3 5\n"
                     b"encoding: zlib\nendian: little\nspace:=left\n\n"
                     + zlib.compress(arr.astype("<u2").tobytes(order="F")))
    got, header = nrrd.read(str(path))
    want, ref_header = ref.read(str(path))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, want)
    assert header == ref_header and header["space"] == "left"
    for bad, match in ((b"PNG\n\n", "not an NRRD"),
                       (b"NRRD0004\ntype: uchar\nsizes: 2\nencoding: bzip2\n\nxx",
                        "not supported")):
        path.write_bytes(bad)
        with pytest.raises((ValueError, NotImplementedError), match=match):
            nrrd.read(str(path))


# ----------------------------------------------------------- OBJ, render


def test_load_obj_quads_and_negative_indices_equal_jax(tmp_path):
    from tricolo_tpu.data.render import load_obj as ref_load
    from tricolo_tpu_torch.data.render import load_obj

    path = tmp_path / "cube.obj"
    path.write_text(CUBE_OBJ + "vt 0 0\nvn 0 0 1\nf -1/1/1 -2/1/1 -3/1/1 -4/1/1\n")
    v, f = load_obj(str(path))
    rv, rf = ref_load(str(path))
    assert f.shape == (14, 3)  # 6 quads + 1 negative-index quad → 14 triangles
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(f[-2:], [[7, 6, 5], [7, 5, 4]])


def test_render_views_and_occlusion_equal_jax(tmp_path):
    from tricolo_tpu.data import render as ref
    from tricolo_tpu_torch.data import render

    small = CUBE_OBJ.replace("0.5", "0.15").replace("v  0.15  0.15  0.15", "v  0.3  0.3  0.15")
    path = tmp_path / "cube.obj"
    path.write_text(small)
    views = render.render_views(str(path), num_views=3, image_size=48)
    assert views.dtype == np.uint8 and views.shape == (3, 48, 48, 3)
    np.testing.assert_array_equal(views, ref.render_views(str(path), 3, 48))
    assert not np.array_equal(views[0], views[1])
    vertices = np.array([[-0.4, -0.4, 0.0], [0.4, -0.4, 0.0], [0.4, 0.4, 0.0], [-0.4, 0.4, 0.0],
                         [-0.2, -0.2, 0.3], [0.2, -0.2, 0.3], [0.2, 0.2, 0.3], [-0.2, 0.2, 0.3]])
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 1.0]
    img = render.render_mesh(vertices, faces, pose, image_size=64)
    np.testing.assert_array_equal(img, ref.render_mesh(vertices, faces, pose, image_size=64))
    assert (img[32, 32] != 255).any() and (img[32, 12] != 255).any() and (img[0, 0] == 255).all()
    for yaw in (0.0, 1.0):
        np.testing.assert_array_equal(render.camera_pose(np.ones(3), yaw),
                                      ref.camera_pose(np.ones(3), yaw))


# ----------------------------------------------------- captions, npz packing


def test_caption_map_rows_equal_jax(tmp_path):
    from tricolo_tpu.data.preprocess import create_model_id_caption_mapping as ref_map
    from tricolo_tpu_torch.data.preprocess import create_model_id_caption_mapping

    (tmp_path / "shapenet.json").write_text(
        json.dumps({"idx_to_word": {"1": "a", "2": "red", "3": "chair", "4": "tall\n"}}))
    tuples = [(np.array([2, 3, 0, 0]), "03001627", "modelA.nrrd"),
              (np.array([1, 4, 3, 0]), "03001627", "modelA.nrrd"),
              (np.array([3, 0, 2, 0]), "04379243", "modelB.nrrd"),
              (np.array([1, 0, 0, 0]), "03001627", "ignored.nrrd")]
    with open(tmp_path / "caps.p", "wb") as f:
        pickle.dump({"caption_tuples": tuples}, f)
    args = (str(tmp_path / "caps.p"), str(tmp_path / "shapenet.json"))
    ours = create_model_id_caption_mapping(*args, str(tmp_path / "a" / "map.json"),
                                           ["03001627/ignored"])
    theirs = ref_map(*args, str(tmp_path / "b" / "map.json"), ["03001627/ignored"])
    assert ours == theirs == (("03001627", "modelA"), ("04379243", "modelB"))
    assert (tmp_path / "a" / "map.json").read_text() == (tmp_path / "b" / "map.json").read_text()


def _write_raw_model(root: str, model_id: str, seed: int, sizes=(32, 64, 128)):
    """One model's solid-ellipsoid NRRDs under ``root`` (the c13 dataset
    path)."""
    from tricolo_tpu_torch.data import nrrd
    from tricolo_tpu_torch.data.fixture import ellipsoid_rgba

    rng = np.random.default_rng(seed)
    centre, radii, color = rng.uniform(0.4, 0.6, 3), rng.uniform(0.15, 0.3, 3), rng.uniform(
        40, 200, 3)
    for d in sizes:
        folder = os.path.join(root, f"nrrd_256_filter_div_{d}_solid", model_id)
        os.makedirs(folder, exist_ok=True)
        nrrd.write(os.path.join(folder, f"{model_id}.nrrd"),
                   ellipsoid_rgba(centre, radii, color, d))
    return centre, radii


def test_pack_npz_members_equal_jax(tmp_path):
    from PIL import Image

    from tricolo_tpu.data.preprocess import pack_npz as ref_pack
    from tricolo_tpu_torch.data.preprocess import pack_npz

    rng = np.random.default_rng(0)
    _write_raw_model(str(tmp_path), "m0", 0)
    view_dir = tmp_path / "imgs" / "cat" / "m0"
    view_dir.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(
            view_dir / f"{i}.jpg")
    for fn, out in ((pack_npz, "ours"), (ref_pack, "theirs")):
        fn(("cat", "m0"), data_root_path=str(tmp_path), img_root_path=str(tmp_path / "imgs"),
           output_root_path=str(tmp_path / out), num_views=3)
    with np.load(tmp_path / "ours" / "cat" / "m0.npz") as a, \
            np.load(tmp_path / "theirs" / "cat" / "m0.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["images", "voxel128", "voxel32",
                                                        "voxel64"]
        for key in a.files:
            assert a[key].dtype == np.uint8
            np.testing.assert_array_equal(a[key], b[key])
        assert a["voxel128"].shape == (4, 128, 128, 128)
        assert a["images"].shape == (3, 3, 224, 224)


# ------------------------------------------------------------ preprocess_all


def test_preprocess_all_loads_at_every_voxel_size(tmp_path):
    """The CLI over a tiny raw tree (2 models, 2 views, caption maps
    shipped as c13's are) in the port and in the JAX package: equal JPEGs
    and npz members, and the port's GeneralDataset
    at voxel sizes 32, 64 and 128 equal to the JAX package's."""
    from tricolo_tpu.config import load_config as jax_load
    from tricolo_tpu.data.datasets import GeneralDataset as JaxGeneral
    from tricolo_tpu.data.preprocess import preprocess_all as jax_preprocess
    from tricolo_tpu_torch import preprocess
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data.datasets import GeneralDataset
    from tricolo_tpu_torch.data.fixture import ellipsoid_obj

    def raw_tree(root):
        c13 = os.path.join(root, "text2shape-data", "c13")
        exp = os.path.join(c13, "preprocessed", "exp_data")
        os.makedirs(exp)
        rows = []
        for i, (category, model_id) in enumerate((("02691156", "aa01"), ("04379243", "bb02"))):
            centre, radii = _write_raw_model(c13, model_id, i)
            obj = os.path.join(root, "text2shape-data", "ShapeNetCore.v2", category, model_id,
                               "models")
            os.makedirs(obj)
            with open(os.path.join(obj, "model_normalized.obj"), "w") as f:
                f.write(ellipsoid_obj(centre, radii, n_lat=4, n_lon=6))
            rows += [{"model_id": model_id, "category": category, "caption": f"c {i} {j}",
                      "tokens": [3 + i, 7 + j, 11]} for j in range(2)]
        for split in ("train", "val", "test"):
            with open(os.path.join(exp, f"{split}_map.json"), "w") as f:
                json.dump(rows, f)
        return exp

    ours_root, theirs_root = str(tmp_path / "ours"), str(tmp_path / "theirs")
    exp = raw_tree(ours_root)
    shutil.copytree(ours_root, theirs_root)
    common = [C13, "data.num_views=2"]
    preprocess.main([*common, f"data.dataset_root_path={ours_root}", "+cpu_workers=1"])
    jax_preprocess(jax_load([*common, f"data.dataset_root_path={theirs_root}"]), cpu_workers=1,
                   splits=("train",))
    theirs_exp = exp.replace(ours_root, theirs_root)
    for category, model_id in (("02691156", "aa01"), ("04379243", "bb02")):
        for name in ("0.jpg", "1.jpg"):
            view = os.path.join("text2shape-data", "c13", "preprocessed", "multiview_imgs",
                                category, model_id, name)
            a = open(os.path.join(ours_root, view), "rb").read()
            assert a == open(os.path.join(theirs_root, view), "rb").read()
        with np.load(os.path.join(exp, category, f"{model_id}.npz")) as a, \
                np.load(os.path.join(theirs_exp, category, f"{model_id}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
    for d in (32, 64, 128):
        overrides = [*common, f"data.voxel_size={d}", "data.image_size=32",
                     "data.num_workers=0"]
        ours = GeneralDataset(load_config([*overrides, f"data.dataset_root_path={ours_root}"]),
                              "train")
        ref = JaxGeneral(jax_load([*overrides, f"data.dataset_root_path={theirs_root}"]),
                         "train")
        assert len(ours) == len(ref) == 4
        assert ours.max_voxel_tiles == ref.max_voxel_tiles
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a["model_id"] == b["model_id"] and len(a["voxel_flat"]) > 0
            for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
                np.testing.assert_array_equal(a[key], b[key])


def test_worker_pool_spawns_and_packs_as_in_process(tmp_path):
    """``+cpu_workers`` > 1 runs the jobs in spawned processes (the parent
    holds PyTorch's threads); their npz equals the in-process one."""
    from functools import partial

    from PIL import Image

    from tricolo_tpu_torch.data.preprocess import _run_pool, pack_npz

    rng = np.random.default_rng(1)
    models = [("cat", "m0"), ("cat", "m1")]
    for seed, (_, model_id) in enumerate(models):
        _write_raw_model(str(tmp_path), model_id, seed, sizes=(32, 64))
        view_dir = tmp_path / "imgs" / "cat" / model_id
        view_dir.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(
            view_dir / "0.jpg")
    (tmp_path / "nrrd_256_filter_div_128_solid").symlink_to(
        tmp_path / "nrrd_256_filter_div_64_solid")  # a 64³ grid stands in for 128
    for workers, out in ((2, "pool"), (1, "inline")):
        _run_pool(partial(pack_npz, data_root_path=str(tmp_path),
                          img_root_path=str(tmp_path / "imgs"),
                          output_root_path=str(tmp_path / out), num_views=1),
                  models, workers, "pack")
    for _, model_id in models:
        with np.load(tmp_path / "pool" / "cat" / f"{model_id}.npz") as a, \
                np.load(tmp_path / "inline" / "cat" / f"{model_id}.npz") as b:
            for key in ("voxel32", "voxel64", "voxel128", "images"):
                np.testing.assert_array_equal(a[key], b[key])

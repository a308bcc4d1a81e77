"""The port's mesh F1 (``tricolo_tpu_torch.evaluation.f1_mesh`` and
``python -m tricolo_tpu_torch.calculate_f1``) against the JAX package's, on
the CPU (``device="cpu"``); on a card (``-m cuda``) the search on the GPU
against a float64 oracle:

    python -m pytest --noconftest tests/test_torch_f1_mesh.py -m cuda

Tolerances, stated before the first run:

* sampled points and point caches: exact (the same numpy draws);
* nearest-neighbour distances at gt-10 scale (coordinates within about
  ±7, so squared norms up to ~100): the JAX package expands |a|² − 2a·bᵀ + |b|²
  in f32, which leaves up to ~4·2⁻²⁴·(|a|² + |b|²) ≈ 5e-5 of d²; the port
  sums the squared differences directly, within a few f32 roundings of d²
  itself. So port d² vs JAX d²: atol 1e-4; port d² vs a float64 oracle:
  rtol 1e-6;
* F1: identical sets 100 and disjoint sets 0, exactly; a sweep's mean F1
  against the JAX package's within the decisions JAX's rounding can flip:
  each point whose d² lies within 1e-4 of the threshold's may move its
  precision or recall by 100/N, and F1 by at most twice that (∂F1/∂P ≤ 2).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

D2_ATOL_JAX = 1e-4
D2_RTOL_F64 = 1e-6
CPU = "cpu"


def _min_d2_f64(a, b):
    """Float64 direct-difference oracle: each row of ``a``'s squared
    distance to its nearest row of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    out = np.empty(len(a))
    for start in range(0, len(a), 1024):
        block = a[start : start + 1024]
        out[start : start + 1024] = ((block[:, None, :] - b[None]) ** 2).sum(-1).min(1)
    return out


def _gt10_points(seed: int, n: int):
    """Two point sets sampled from ellipsoid surfaces at gt-10 scale."""
    from tricolo_tpu_torch.data.fixture import ellipsoid_obj
    from tricolo_tpu_torch.evaluation.f1_mesh import gt_scale_factor, sample_points_on_mesh

    rng = np.random.default_rng(seed)
    meshes = []
    for _ in range(2):
        text = ellipsoid_obj(rng.uniform(0.4, 0.6, 3), rng.uniform(0.2, 0.3, 3))
        lines = text.splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        f = np.array([[int(x) - 1 for x in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
        meshes.append((v, f))
    scale = gt_scale_factor(meshes[0][0])
    return [sample_points_on_mesh(v * scale, f, n, np.random.default_rng(seed + i))
            for i, (v, f) in enumerate(meshes)]


def test_sampled_points_equal_jax():
    pytest.importorskip("jax")
    from tricolo_tpu.evaluation import f1_mesh as ref
    from tricolo_tpu_torch.evaluation import f1_mesh

    rng = np.random.default_rng(5)
    v = rng.normal(size=(40, 3))
    f = rng.integers(0, 40, (60, 3))
    for args in ((), (np.random.default_rng(9),)):
        got = f1_mesh.sample_points_on_mesh(v, f, 777, *args)
        want = ref.sample_points_on_mesh(v, f, 777, *(np.random.default_rng(9),) if args else ())
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert f1_mesh.gt_scale_factor(v) == ref.gt_scale_factor(v)
    with pytest.raises(ValueError, match="zero surface area"):
        f1_mesh.sample_points_on_mesh(np.zeros((3, 3)), np.array([[0, 1, 2]]), 5)


def test_min_dists_against_jax_and_float64():
    pytest.importorskip("jax")
    from tricolo_tpu.evaluation.f1_mesh import _min_dists_chunked
    from tricolo_tpu_torch.evaluation.f1_mesh import min_dists

    a, b = _gt10_points(0, 3000)
    assert np.abs(a).max() <= 8.0  # gt-10 scale: the GT's longest edge is 10
    a = a[:2500]  # two JAX chunks, the second padded
    got = min_dists(a, b, device=CPU)
    assert got.dtype == np.float32 and got.shape == (2500,)
    np.testing.assert_allclose(got.astype(np.float64) ** 2, _min_d2_f64(a, b), rtol=D2_RTOL_F64,
                               atol=0)
    want = _min_dists_chunked(a, b)
    np.testing.assert_allclose(got.astype(np.float64) ** 2, want.astype(np.float64) ** 2,
                               rtol=0, atol=D2_ATOL_JAX)
    # A chunk smaller than the set takes the same values.
    np.testing.assert_array_equal(min_dists(a, b, device=CPU, chunk=700), got)


def test_f1_identical_and_disjoint_sets():
    from tricolo_tpu_torch.evaluation.f1_mesh import f1_between_point_sets

    pts = np.random.default_rng(0).standard_normal((256, 3)).astype(np.float32)
    assert f1_between_point_sets(pts, pts.copy(), device=CPU) == {0.1: 2 * 100.0 * 100.0 / (
        200.0 + 1e-8)}
    assert f1_between_point_sets(pts, pts + 100.0, device=CPU) == {0.1: 0.0}


def _write_obj(shapenet, category, model_id, centre, radii):
    from tricolo_tpu_torch.data.fixture import ellipsoid_obj

    folder = os.path.join(shapenet, category, model_id, "models")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "model_normalized.obj"), "w") as f:
        f.write(ellipsoid_obj(np.asarray(centre), np.asarray(radii)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """OBJs, a val map and a nearest.jsonl exercising the skip rules: an
    exact hit, a near miss and a far miss are scored; a GT outside the map
    and a retrieved model without its OBJ are skipped."""
    root = tmp_path_factory.mktemp("f1")
    shapenet = str(root / "ShapeNetCore.v2")
    models = {"gt0": ([0.5, 0.5, 0.5], [0.3, 0.2, 0.25]),
              "near": ([0.51, 0.5, 0.49], [0.29, 0.21, 0.25]),
              "far": ([0.3, 0.6, 0.5], [0.1, 0.3, 0.2]),
              "noobj": ([0.5, 0.5, 0.5], [0.2, 0.2, 0.2])}
    for model_id, (centre, radii) in models.items():
        if model_id != "noobj":
            _write_obj(shapenet, "cat", model_id, centre, radii)
    (root / "val_map.json").write_text(json.dumps(
        [{"model_id": m, "category": "cat"} for m in models]))
    rows = [("gt0", "gt0"), ("gt0", "near"), ("missing", "gt0"), ("gt0", "noobj"),
            ("near", "far")]
    _write_nearest(root / "nearest.jsonl", rows)
    return root, shapenet


def _write_nearest(path, rows):
    path.write_text("\n".join(
        json.dumps({"groundtruth": f"{gt}-{i:04d}", "retrieved_models": [pred, "gt0"]})
        for i, (gt, pred) in enumerate(rows)) + "\n")


def _recorded_run(cache_dir, nearest, val_map, shapenet):
    """The port's sweep on the CPU, and the bound on its distance from the
    JAX package's: twice 100/N per point whose d² lies within D2_ATOL_JAX
    of t², over both directions of each scored query, averaged over the
    queries (read from the distances the sweep computed)."""
    from tricolo_tpu_torch.evaluation import f1_mesh

    searched = []
    search = f1_mesh.min_dists

    def recording(a, b, device=None, chunk=f1_mesh.CHUNK):
        searched.append(search(a, b, device, chunk))
        return searched[-1]

    f1_mesh.min_dists = recording
    try:
        mean = f1_mesh.run_f1_over_nearest(nearest, val_map, shapenet, cache_dir=cache_dir,
                                           device=CPU)
    finally:
        f1_mesh.min_dists = search
    band = [2 * 100.0 * int((np.abs(d.astype(np.float64) ** 2 - 0.01) <= D2_ATOL_JAX).sum())
            / len(d) for d in searched]
    return mean, sum(band) / (len(searched) // 2)


@pytest.fixture(scope="module")
def swept(sweep):
    """Both packages' mean F1 over the sweep, each with its own cache."""
    pytest.importorskip("jax")
    from tricolo_tpu.evaluation.f1_mesh import run_f1_over_nearest as ref_run

    root, shapenet = sweep
    args = (str(root / "nearest.jsonl"), str(root / "val_map.json"), shapenet)
    ours, bound = _recorded_run(str(root / "pc_ours"), *args)
    theirs = ref_run(*args, cache_dir=str(root / "pc_jax"))
    return ours, theirs, bound


def test_run_f1_over_nearest_equals_jax(sweep, swept):
    from tricolo_tpu_torch.evaluation.f1_mesh import PointCache, mesh_f1_for_query

    root, shapenet = sweep
    ours, theirs, bound = swept
    assert sorted(os.listdir(root / "pc_ours")) == sorted(os.listdir(root / "pc_jax")) == [
        "far.npy", "gt0.npy", "near.npy"]
    for name in os.listdir(root / "pc_ours"):
        np.testing.assert_array_equal(np.load(root / "pc_ours" / name),
                                      np.load(root / "pc_jax" / name))
    assert abs(ours - theirs) <= bound, (ours, theirs, bound)
    assert 0.0 < ours < 100.0
    # The exact hit scores 100 (its points against themselves).
    hit = mesh_f1_for_query("gt0", "gt0", {"gt0": "cat"}, shapenet,
                            PointCache(str(root / "pc_ours")), device=CPU)
    assert hit == 2 * 100.0 * 100.0 / (200.0 + 1e-8)


def test_rows_are_read_as_the_cache_fills(sweep, swept, tmp_path):
    """A row whose GT OBJ is gone is skipped while a point set still needs
    sampling, and scored from the cache (scale 1.0) once an earlier row has
    cached it, as in the JAX package."""
    import shutil

    from tricolo_tpu.evaluation.f1_mesh import run_f1_over_nearest as ref_run

    root, shapenet = sweep
    moved = str(tmp_path / "ShapeNetCore.v2")
    shutil.copytree(shapenet, moved)
    shutil.rmtree(os.path.join(moved, "cat", "far"))
    # Row 0: far has no OBJ and near is not cached: skipped. Row 1 samples
    # near at gt0's scale. Row 2: far and near cached: scored.
    _write_nearest(tmp_path / "nearest.jsonl", [("far", "near"), ("gt0", "near"),
                                                ("far", "near")])
    args = (str(tmp_path / "nearest.jsonl"), str(root / "val_map.json"), moved)
    for cache in ("pc_ours", "pc_jax"):
        shutil.copytree(root / cache, tmp_path / cache)
        os.remove(tmp_path / cache / "near.npy")
    ours, bound = _recorded_run(str(tmp_path / "pc_ours"), *args)
    theirs = ref_run(*args, cache_dir=str(tmp_path / "pc_jax"))
    for cache in ("pc_ours", "pc_jax"):
        assert (tmp_path / cache / "near.npy").exists()
    np.testing.assert_array_equal(np.load(tmp_path / "pc_ours" / "near.npy"),
                                  np.load(tmp_path / "pc_jax" / "near.npy"))
    assert abs(ours - theirs) <= bound, (ours, theirs, bound)


def test_cli_prints_the_mean(sweep, swept, capsys, tmp_path):
    import shutil

    from tricolo_tpu_torch import calculate_f1

    root, shapenet = sweep
    cache = str(tmp_path / "pc")
    shutil.copytree(root / "pc_ours", cache)  # the points of the library run
    got = calculate_f1.main([f"+nearest_path={root / 'nearest.jsonl'}",
                             f"+val_map_path={root / 'val_map.json'}",
                             f"+shapenet_root={shapenet}", f"+point_cache_dir={cache}",
                             "+device=cpu"])
    assert float(capsys.readouterr().out.strip().splitlines()[-1]) == got == swept[0]


def test_no_gpu_raises_unless_the_cpu_is_asked_for(sweep, monkeypatch):
    from tricolo_tpu_torch import calculate_f1
    from tricolo_tpu_torch.evaluation import f1_mesh

    root, shapenet = sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        f1_mesh.min_dists(pts, pts)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        f1_mesh.f1_between_point_sets(pts, pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        f1_mesh.f1_between_point_sets(pts, pts, device="cuda")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        f1_mesh.run_f1_over_nearest(str(root / "nearest.jsonl"), str(root / "val_map.json"),
                                    shapenet, cache_dir=str(root / "pc_ours"))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        calculate_f1.main([f"+nearest_path={root / 'nearest.jsonl'}",
                           f"+val_map_path={root / 'val_map.json'}",
                           f"+shapenet_root={shapenet}"])


@pytest.mark.cuda
def test_cuda_min_dists_hold_the_float64_oracle():
    """On the card the search keeps the CPU's bound against a float64
    oracle (d² rtol 1e-6) and its threshold decisions. It is not bit-equal
    to the CPU: on an H100, 66 of 10,000 distances lay one f32 ulp from the
    CPU's, both at 2.6e-7 of d² from float64 at worst."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tricolo_tpu_torch.evaluation.f1_mesh import min_dists

    a, b = _gt10_points(1, 10000)
    oracle = _min_d2_f64(a, b)
    for device in ("cuda", CPU):
        got = min_dists(a, b, device=device).astype(np.float64)
        np.testing.assert_allclose(got**2, oracle, rtol=D2_RTOL_F64, atol=0, err_msg=device)
        assert np.array_equal(got < 0.1, np.sqrt(oracle) < 0.1), device

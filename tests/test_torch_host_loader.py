"""The port's host loader (``tricolo_tpu_torch/native`` over
``csrc/host_loader.cpp``) against its numpy plain versions and the JAX
package's native sweeps, bit for bit, on the CPU with g++; and, on a card
(``-m cuda``), pinned batches copied without blocking:

    python -m pytest --noconftest tests/test_torch_host_loader.py -m cuda

The JAX package's library is compiled here into the test's own directory
(g++ with zlib) and bound through ``tricolo_tpu.native._bind``, so the
comparison never races another test process that builds ``native/``. Only
the comparisons with it need JAX.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PAD = np.uint32(0xFFFFFFFF)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``tricolo_tpu.native`` bound to a library built in a private
    directory from ``native/tricolo_native.cpp``."""
    pytest.importorskip("jax")
    from tricolo_tpu import native as ref

    out = tmp_path_factory.mktemp("jax_native") / "libtricolo_native.so"
    subprocess.run(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared",
         str(ROOT / "native" / "tricolo_native.cpp"), "-o", str(out), "-lz"],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    ref._bind(lib)
    saved = ref._lib
    ref._lib = lib
    yield ref
    ref._lib = saved


def packed_batch(d: int, seed: int = 0):
    """(flat, rgb) (4, N) u32 words, sorted sites and trailing 0xFFFFFFFF
    padding: a random scatter, an empty sample, a solid block crossing tile
    borders (halo traffic), and a sample whose last site has x ≥ d (it
    must be skipped). RGB words include pure black with bit 24 set."""
    rng = np.random.default_rng(seed)
    samples = []
    sites = np.sort(rng.choice(d**3, size=d * 6, replace=False))
    samples.append(sites)
    samples.append(np.zeros(0, np.int64))
    lo, hi = d // 4 - 3, d // 2 + 3
    block = np.stack(np.meshgrid(*[np.arange(lo, hi)] * 3, indexing="ij"), -1).reshape(-1, 3)
    samples.append((block[:, 0] * d + block[:, 1]) * d + block[:, 2])
    samples.append(np.sort(rng.choice(d**3, size=40, replace=False)))
    n_pad = max(len(s) for s in samples) + 7
    flat = np.full((len(samples), n_pad), PAD, np.uint32)
    rgb = np.zeros((len(samples), n_pad), np.uint32)
    for i, s in enumerate(samples):
        x, y, z = s // (d * d), (s // d) % d, s % d
        words = ((x * 256 + y) * 256 + z).astype(np.uint32)
        colors = rng.integers(0, 256, (len(s), 3)).astype(np.uint32)
        colors[::5] = 0  # occupied pure black
        flat[i, : len(s)] = words
        rgb[i, : len(s)] = colors[:, 0] | colors[:, 1] << 8 | colors[:, 2] << 16 | 1 << 24
    # Sample 3's last site sits past the grid (a cache packed at a larger
    # voxel size): x = d + 1 sorts after every in-range site.
    n3 = 40
    flat[3, n3] = np.uint32(((d + 1) * 256 + 2) * 256 + 3)
    rgb[3, n3] = np.uint32(0x01ABCDEF)
    return flat, rgb


def assert_all_equal(got, *refs):
    got = got if isinstance(got, tuple) else (got,)
    for ref in refs:
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", [32, 64])
def test_packed_to_dense_matches_plain_and_jax(d, jax_native):
    from tricolo_tpu_torch.data import device_prep

    flat, rgb = packed_batch(d)
    got = device_prep.densify_on_host(flat, rgb, d)
    assert_all_equal(got, device_prep.densify_on_host_plain(flat, rgb, d),
                     jax_native.packed_to_dense(flat, rgb, d))
    assert not got[1].any()  # the empty sample
    assert got[2].any()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("halo", [1, 3])
def test_packed_to_windowed_matches_plain_and_jax(d, halo, jax_native):
    from tricolo_tpu_torch.data import device_prep

    flat, rgb = packed_batch(d)
    got = device_prep.windowed_on_host(flat, rgb, d, halo=halo)
    assert_all_equal(got, device_prep.windowed_on_host_plain(flat, rgb, d, halo=halo),
                     jax_native.packed_to_windowed(flat, rgb, d, 8, halo))
    rows, occ = got
    tg3 = (d // 8) ** 3
    assert not occ[tg3 : 2 * tg3].any() and not rows[tg3 : 2 * tg3].any()  # empty sample


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("halo", [1, 3])
@pytest.mark.parametrize("budget", ["fits", "truncates"])
def test_packed_to_windowed_compact_matches_plain_and_jax(d, halo, budget, jax_native):
    """k fitted to the largest sample, or below a sample's tile count: its
    counts exceed k and its highest tiles are dropped, the same on every
    side."""
    from tricolo_tpu_torch.data import device_prep

    flat, rgb = packed_batch(d)
    _, occ = device_prep.windowed_on_host_plain(flat, rgb, d)
    per_sample = occ.reshape(len(flat), -1).sum(axis=1)
    k = int(per_sample.max()) if budget == "fits" else int(per_sample[2]) - 3
    got = device_prep.windowed_compact_on_host(flat, rgb, d, k, halo=halo)
    assert_all_equal(
        got, device_prep.windowed_compact_on_host_plain(flat, rgb, d, k, halo=halo),
        jax_native.packed_to_windowed_compact(flat, rgb, d, k, 8, halo))
    rows, ids, counts = got
    np.testing.assert_array_equal(counts, per_sample)
    assert counts[1] == 0 and (ids[1] == (d // 8) ** 3).all() and not rows[1].any()
    if budget == "truncates":
        assert counts[2] > k and (ids[2] < (d // 8) ** 3).all()


@pytest.mark.parametrize("d", [16, 32, 64])
def test_dense_rgba_to_packed_matches_plain_and_jax(d, jax_native):
    from tricolo_tpu_torch.data import datasets

    rng = np.random.default_rng(d)
    grid = np.zeros((4, d, d, d), np.uint8)
    mask = rng.random((d, d, d)) < 0.1
    grid[3][mask] = rng.integers(1, 256, mask.sum())
    for c in range(3):
        grid[c][mask] = rng.integers(0, 256, mask.sum())
    black = np.argwhere(mask)[::7]  # occupied pure-black voxels
    grid[:3, black[:, 0], black[:, 1], black[:, 2]] = 0
    got = datasets.dense_rgba_to_packed(grid)
    assert_all_equal(got, datasets.dense_rgba_to_packed_plain(grid),
                     jax_native.dense_rgba_to_packed(grid))
    flat, rgb = got
    assert len(flat) == mask.sum() and (np.diff(flat.astype(np.int64)) > 0).all()
    assert ((rgb & 0xFFFFFF) == 0).sum() >= len(black) and (rgb >> 24 == 1).all()
    empty = datasets.dense_rgba_to_packed(np.zeros((4, 8, 8, 8), np.uint8))
    assert empty[0].size == 0 and empty[1].size == 0


def test_thread_count_follows_the_environment(monkeypatch):
    """TRICOLO_NATIVE_THREADS sets the split; the outputs do not depend on
    it."""
    from tricolo_tpu_torch import native

    flat, rgb = packed_batch(32)
    monkeypatch.setenv("TRICOLO_NATIVE_THREADS", "1")
    assert native.threads() == 1
    one = native.packed_to_windowed_compact(flat, rgb, 32, 20, halo=3)
    monkeypatch.setenv("TRICOLO_NATIVE_THREADS", "3")
    assert native.threads() == 3
    assert_all_equal(native.packed_to_windowed_compact(flat, rgb, 32, 20, halo=3), one)
    monkeypatch.delenv("TRICOLO_NATIVE_THREADS")
    assert native.threads() >= 1


def test_calls_are_counted():
    from tricolo_tpu_torch import native

    flat, rgb = packed_batch(32)
    native.reset_calls()
    native.packed_to_dense(flat, rgb, 32)
    native.packed_to_windowed_compact(flat, rgb, 32, 4)
    native.packed_to_windowed_compact(flat, rgb, 32, 4)
    assert native.call_counts() == {"dense_rgba_to_packed": 0, "packed_to_dense": 1,
                                    "packed_to_windowed": 0, "packed_to_windowed_compact": 2}


def test_concurrent_callers_lose_no_count():
    """The split load calls the binding from many threads at once (more
    threads than cores, a short switch interval): every call is counted and
    every output is right."""
    import sys
    import threading

    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.data import datasets

    grid = np.zeros((4, 8, 8, 8), np.uint8)
    grid[:, 1, 2, 3] = 9
    grid[:, 7, 0, 5] = 200
    want = datasets.dense_rgba_to_packed_plain(grid)
    wrong = []

    def work():
        for _ in range(50):
            got = native.dense_rgba_to_packed(grid)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                wrong.append(got)

    native.reset_calls()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert native.call_counts()["dense_rgba_to_packed"] == 32 * 50


@pytest.mark.parametrize("args, match", [
    ((32, 8, 5), "halo"),      # two neighbour windows an axis
    ((36, 8, 1), "multiple"),  # a partial tile
    ((512, 8, 1), "256"),      # past 8 bits an axis
])
def test_out_of_contract_sizes_raise(args, match):
    from tricolo_tpu_torch import native

    d, tile, halo = args
    flat, rgb = packed_batch(32)
    with pytest.raises(ValueError, match=match):
        native.packed_to_windowed(flat, rgb, d, tile, halo)
    with pytest.raises(ValueError, match=match):
        native.packed_to_windowed_compact(flat, rgb, d, 4, tile, halo)


def test_build_reuses_the_library(monkeypatch):
    """A second build finds the hashed library and starts no compiler."""
    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.ops import _build

    first = native.build()
    stamp = first.stat().st_mtime_ns

    def no_compiler(*args, **kwargs):
        raise AssertionError("the compiler ran again")

    monkeypatch.setattr(_build.subprocess, "Popen", no_compiler)
    assert native.build() == first and first.stat().st_mtime_ns == stamp
    assert first.parent == ROOT / "build" / "tricolo_tpu_torch"


def test_broken_source_raises_with_the_compiler_output(tmp_path):
    from tricolo_tpu_torch import native

    source = tmp_path / "host_loader.cpp"
    shutil.copy(native.SOURCE, source)
    source.write_text(source.read_text() + "\nint broken( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for host_loader.cpp") as info:
        native.build(source, build_dir=tmp_path / "build")
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


@pytest.mark.cuda
def test_pinned_batches_copy_non_blocking():
    """On a card: a ``pin_memory`` loader yields page-locked tensors
    (collated in the prefetch thread), and they reach the device equal to
    the pageable path's, counted as pinned copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory is CUDA's")
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch import tracing
    from tricolo_tpu_torch.inference import to_device_batch

    dm = DataModule(load_config([
        "data=synthetic", "model.image_encoder=MVCNNEncoder",
        "model.voxel_encoder=VoxelCNNEncoder", "data.batch_size=2", "data.num_models=5"]))
    dm.setup("test")
    device = torch.device("cuda")
    tracing.reset_counts("to_device.")
    for pinned, plain in zip(dm.test_loader(pin_memory=True), dm.test_loader()):
        assert all(pinned[k].is_pinned() for k in ("tokens", "images", "voxel_rows"))
        a, b = to_device_batch(pinned, device), to_device_batch(plain, device)
        for key in a:
            assert torch.equal(a[key], b[key])
    assert tracing.counter("to_device.pinned") == tracing.counter("to_device.pageable") > 0


@pytest.mark.cuda
def test_clip_fields_reach_the_card_pinned():
    """On a card: a ``pin_memory`` loader's CLIP fields are page-locked and
    reach the device by ``non_blocking`` copies, equal to the pageable ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory is CUDA's")
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch import tracing
    from tricolo_tpu_torch.inference import to_device_batch

    dm = DataModule(load_config([
        "data=synthetic", "data.batch_size=2", "data.num_models=5",
        "model.voxel_encoder=VoxelCNNEncoder", "model.text_encoder=CLIPTextEncoder",
        "model.image_encoder=CLIPImageEncoder"]))
    dm.setup("test")
    tracing.reset_counts("to_device.")
    keys = ("clip_embeddings_img", "clip_embeddings_text")
    for pinned, plain in zip(dm.test_loader(pin_memory=True), dm.test_loader()):
        assert all(pinned[k].is_pinned() for k in keys)
        a = to_device_batch(pinned, torch.device("cuda"))
        b = to_device_batch(plain, torch.device("cuda"))
        assert all(torch.equal(a[k], b[k]) and a[k].is_cuda for k in keys)
    assert tracing.counter("to_device.pinned") == tracing.counter("to_device.pageable") > 0

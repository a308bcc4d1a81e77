"""ctypes binding of the host loader (``csrc/host_loader.cpp``): the C++
voxel sweeps the loader's collation and the split load run.

The library is built at first use with

    g++ -O3 -fPIC -std=c++17 -pthread -shared -o <build>/libhost_loader-<hash>.so \\
        tricolo_tpu_torch/csrc/host_loader.cpp

into ``build/tricolo_tpu_torch/`` at the repository root, through the
helpers that build the CUDA kernels (``ops/_build.py``): the file name
carries a hash of the source and the flags, and the compiler writes a
pid-suffixed file that is renamed into place. It needs a C++17 compiler and
nothing else. There is no fallback: a missing ``g++`` or a failed build
raises with the compiler's output.

A sweep splits its batch over ``TRICOLO_NATIVE_THREADS`` threads (default:
the host's hardware threads; ``threads()`` says how many). ctypes releases
the GIL for the length of a foreign call, so the loader's prefetch thread
runs a sweep while the main thread launches the step.

The wrappers take and return numpy arrays with the signatures and outputs
of the JAX package's binding; each counts its calls as the ``tracing``
counter ``native.<name>`` (``reset_calls``, ``call_counts``), so a run can show that its host path
went through the C++ sweeps. Their numpy formulations are the ``*_plain``
functions of ``data/device_prep.py`` and ``data/datasets.py``.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import numpy as np

from .. import tracing

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host_loader.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]
ABI_VERSION = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build(source: Path = SOURCE, build_dir: Path | None = None) -> Path:
    """Compile ``source`` with g++ into ``build_dir`` (default: the
    kernels' build directory) unless its hashed library exists; returns the
    library's path. Raises RuntimeError with the compiler's output when the
    build fails."""
    # Imported here: the ops package imports the data modules, which import
    # this one.
    from ..ops._build import BUILD_DIR, compile_finish, compile_start, hashed_library

    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host loader of tricolo_tpu_torch "
                           "cannot be built")
    target = hashed_library("host_loader", source, CXX_FLAGS, build_dir or BUILD_DIR)
    compile_finish(compile_start([cxx, *CXX_FLAGS], source, target))
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tricolo_host_loader_abi_version.restype = ctypes.c_int32
    lib.tricolo_host_loader_abi_version.argtypes = []
    lib.tricolo_host_loader_threads.restype = i64
    lib.tricolo_host_loader_threads.argtypes = []
    lib.tricolo_packed_to_dense.restype = None
    lib.tricolo_packed_to_dense.argtypes = [p, p, i64, i64, i64, p]
    lib.tricolo_packed_to_windowed.restype = None
    lib.tricolo_packed_to_windowed.argtypes = [p, p, i64, i64, i64, i64, i64, p, p]
    lib.tricolo_packed_to_windowed_compact.restype = None
    lib.tricolo_packed_to_windowed_compact.argtypes = [
        p, p, i64, i64, i64, i64, i64, i64, p, p, p]
    lib.tricolo_dense_rgba_to_packed.restype = i64
    lib.tricolo_dense_rgba_to_packed.argtypes = [p, i64, p, p, i64]
    version = lib.tricolo_host_loader_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"host loader ABI {version}, the binding expects {ABI_VERSION}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded, bound host library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def threads() -> int:
    """The threads a sweep splits its batch over (before the cap at the
    batch size)."""
    return int(library().tricolo_host_loader_threads())


# ------------------------------------------------------------------ counts

def _count(fn) -> None:
    tracing.count("native." + fn.__name__)


def reset_calls() -> None:
    tracing.reset_counts("native.")


def call_counts() -> dict[str, int]:
    return {fn.__name__: tracing.counter("native." + fn.__name__) for fn in SWEEPS}


# ------------------------------------------------------------------ sweeps


def _packed_pair(flat: np.ndarray, rgb: np.ndarray):
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint32)
    if flat.ndim != 2 or flat.shape != rgb.shape:
        raise ValueError(f"packed words must be two (B, N) arrays, got {flat.shape} "
                         f"and {rgb.shape}")
    return flat, rgb


def _check_grid(d: int, tile: int, halo: int) -> None:
    """The sweeps index windows by d // tile and write at most one
    neighbour window an axis: out-of-contract sizes would write out of
    bounds, so they raise here."""
    if not 0 < d <= 256:
        raise ValueError(f"voxel size {d} outside (0, 256] (8 bits an axis)")
    if tile <= 0 or d % tile:
        raise ValueError(f"voxel size {d} is not a multiple of tile {tile}")
    if not 0 <= 2 * halo <= tile:
        raise ValueError(f"halo {halo} outside [0, tile/2 = {tile // 2}]")


def dense_rgba_to_packed(grid: np.ndarray):
    """(4, D, D, D) uint8 C-order RGBA grid → (flat u32, rgb u32) of the
    occupied (alpha > 0) sites in site order, bit 24 of rgb set."""
    grid = np.ascontiguousarray(grid, dtype=np.uint8)
    if grid.ndim != 4 or grid.shape[0] != 4 or len(set(grid.shape[1:])) != 1:
        raise ValueError(f"expected a (4, D, D, D) RGBA grid, got {grid.shape}")
    d = grid.shape[1]
    if d > 256:
        raise ValueError(f"voxel size {d} > 256 (8 bits an axis)")
    lib = library()
    _count(dense_rgba_to_packed)
    cap = d * d * d
    flat = np.empty(cap, np.uint32)
    rgb = np.empty(cap, np.uint32)
    count = lib.tricolo_dense_rgba_to_packed(
        grid.ctypes.data, d, flat.ctypes.data, rgb.ctypes.data, cap)
    return flat[:count].copy(), rgb[:count].copy()


def packed_to_dense(flat: np.ndarray, rgb: np.ndarray, d: int) -> np.ndarray:
    """Packed (B, N) u32 pairs → dense (B, d, d, d) u32 grid."""
    flat, rgb = _packed_pair(flat, rgb)
    _check_grid(d, 1, 0)
    lib = library()
    _count(packed_to_dense)
    batch, n_points = flat.shape
    grid = np.empty((batch, d, d, d), np.uint32)
    lib.tricolo_packed_to_dense(flat.ctypes.data, rgb.ctypes.data, batch, n_points, int(d),
                                grid.ctypes.data)
    return grid


def packed_to_windowed(flat: np.ndarray, rgb: np.ndarray, d: int, tile: int = 8,
                       halo: int = 1):
    """Packed (B, N) u32 pairs → (rows (B·tg³, s³) u32, tile_occ (B·tg³,)
    u8), s = tile + 2·halo: every tile's halo'd window and its centre
    occupancy."""
    flat, rgb = _packed_pair(flat, rgb)
    _check_grid(d, tile, halo)
    lib = library()
    _count(packed_to_windowed)
    batch, n_points = flat.shape
    tg3, s3 = (d // tile) ** 3, (tile + 2 * halo) ** 3
    rows = np.empty((batch * tg3, s3), np.uint32)
    occ = np.empty(batch * tg3, np.uint8)
    lib.tricolo_packed_to_windowed(flat.ctypes.data, rgb.ctypes.data, batch, n_points, int(d),
                                   int(tile), int(halo), rows.ctypes.data, occ.ctypes.data)
    return rows, occ


def packed_to_windowed_compact(flat: np.ndarray, rgb: np.ndarray, d: int, k: int,
                               tile: int = 8, halo: int = 1):
    """Packed (B, N) u32 pairs → (rows (B, k, s³) u32, local_ids (B, k)
    i32, counts (B,) i32): each sample's first ``k`` active tiles in
    ascending tile-id order, zero rows and tg³ ids as padding, ``counts``
    the total active tiles a sample (count > k means truncation)."""
    flat, rgb = _packed_pair(flat, rgb)
    _check_grid(d, tile, halo)
    if k < 0:
        raise ValueError(f"tile budget k = {k} < 0")
    lib = library()
    _count(packed_to_windowed_compact)
    batch, n_points = flat.shape
    s3 = (tile + 2 * halo) ** 3
    rows = np.empty((batch, k, s3), np.uint32)
    local_ids = np.empty((batch, k), np.int32)
    counts = np.empty(batch, np.int32)
    lib.tricolo_packed_to_windowed_compact(
        flat.ctypes.data, rgb.ctypes.data, batch, n_points, int(d), int(tile), int(halo),
        int(k), rows.ctypes.data, local_ids.ctypes.data, counts.ctypes.data)
    return rows, local_ids, counts


SWEEPS = (dense_rgba_to_packed, packed_to_dense, packed_to_windowed,
          packed_to_windowed_compact)

__all__ = [
    "SWEEPS",
    "build",
    "call_counts",
    "dense_rgba_to_packed",
    "library",
    "packed_to_dense",
    "packed_to_windowed",
    "packed_to_windowed_compact",
    "reset_calls",
    "threads",
]

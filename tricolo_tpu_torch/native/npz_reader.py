"""ctypes binding of the zlib readers (``csrc/npz_reader.cpp``): the split
load's fused npz-member inflate and RGBA packing, one member's raw bytes,
and a gzip stream's.

The library is built at first use with

    g++ -O3 -fPIC -std=c++17 -shared -o <build>/libnpz_reader-<hash>.so \\
        tricolo_tpu_torch/csrc/npz_reader.cpp -lz

into ``build/tricolo_tpu_torch/``, as the host loader is (``native.build``):
hashed name, a pid-suffixed file renamed into place. It needs a C++17
compiler and zlib's header and library. There is no fallback: a missing
``g++``, a failed build or a library that does not load raises, and the
split load does not switch to ``np.load`` quietly.

The wrappers keep the signatures, outputs and errors of the JAX package's
binding (``load_npz_voxels_packed``, ``npz_read``, ``gzip_decode``); each
counts its calls as the ``tracing`` counter ``npz_reader.<name>``
(``reset_calls``, ``call_counts``), so a run
can show that its split load went through the fused reader.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import numpy as np

from .. import tracing

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "npz_reader.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ("-lz",)
ABI_VERSION = 1
# The packed buffers' default capacity: every site of a 256³ grid, the
# largest the 8-bit coordinates address (numpy leaves the untouched pages
# unallocated).
MAX_SITES = 256**3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build(source: Path = SOURCE, build_dir: Path | None = None) -> Path:
    """Compile ``source`` with g++, linked against zlib, into ``build_dir``
    (default: the kernels' build directory) unless its hashed library
    exists; returns the library's path. Raises RuntimeError with the
    compiler's output when the build fails."""
    from ..ops._build import BUILD_DIR, compile_finish, compile_start, hashed_library

    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the npz reader of tricolo_tpu_torch "
                           "cannot be built")
    target = hashed_library("npz_reader", source, [*CXX_FLAGS, *LIBS],
                            build_dir or BUILD_DIR)
    compile_finish(compile_start([cxx, *CXX_FLAGS], source, target, LIBS))
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32, s = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p
    lib.tricolo_npz_reader_abi_version.restype = i32
    lib.tricolo_npz_reader_abi_version.argtypes = []
    lib.tricolo_npz_read.restype = i64
    lib.tricolo_npz_read.argtypes = [s, s, p, i64, s, i32]
    lib.tricolo_load_npz_voxels_packed.restype = i64
    lib.tricolo_load_npz_voxels_packed.argtypes = [s, s, p, p, i64, p, s, i32]
    lib.tricolo_gzip_decode.restype = i64
    lib.tricolo_gzip_decode.argtypes = [p, i64, p, i64]
    version = lib.tricolo_npz_reader_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"npz reader ABI {version}, the binding expects {ABI_VERSION}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded, bound library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _count(fn) -> None:
    tracing.count("npz_reader." + fn.__name__)


def reset_calls() -> None:
    tracing.reset_counts("npz_reader.")


def call_counts() -> dict[str, int]:
    return {fn.__name__: tracing.counter("npz_reader." + fn.__name__) for fn in READERS}


def load_npz_voxels_packed(path: str, member: str, n_cap: int | None = None):
    """The (4, D, D, D) uint8 RGBA member ``member`` of the npz at ``path``
    → packed (flat u32, rgb u32) words of its occupied sites in site order,
    inflated and swept in one native call. ValueError naming the file and
    member when it is missing, not such a grid, or has more than ``n_cap``
    occupied sites."""
    lib = library()
    _count(load_npz_voxels_packed)
    if n_cap is None:
        n_cap = MAX_SITES
    err = ctypes.create_string_buffer(256)
    flat = np.empty(n_cap, np.uint32)
    rgb = np.empty(n_cap, np.uint32)
    d_out = ctypes.c_int64()
    count = lib.tricolo_load_npz_voxels_packed(
        path.encode(), member.encode(), flat.ctypes.data, rgb.ctypes.data,
        n_cap, ctypes.byref(d_out), err, len(err),
    )
    if count < 0:
        raise ValueError(f"{path}[{member}]: {err.value.decode()}")
    if count > n_cap:
        raise ValueError(f"{path}[{member}]: {count} sites exceed cap {n_cap}")
    return flat[:count].copy(), rgb[:count].copy()


def npz_read(path: str, member: str) -> bytes:
    """One npz member's raw bytes (its .npy payload), inflated natively."""
    lib = library()
    _count(npz_read)
    err = ctypes.create_string_buffer(256)
    size = lib.tricolo_npz_read(path.encode(), member.encode(), None, 0, err, len(err))
    if size < 0:
        raise ValueError(f"{path}[{member}]: {err.value.decode()}")
    out = np.empty(size, np.uint8)
    got = lib.tricolo_npz_read(path.encode(), member.encode(), out.ctypes.data, size, err,
                               len(err))
    if got < 0:
        raise ValueError(f"{path}[{member}]: {err.value.decode()}")
    return out.tobytes()


def gzip_decode(data: bytes, expected_size: int) -> bytes:
    """A gzip stream (an NRRD payload) decoded natively into at most
    ``expected_size`` bytes."""
    lib = library()
    _count(gzip_decode)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(expected_size, np.uint8)
    got = lib.tricolo_gzip_decode(src.ctypes.data, len(data), out.ctypes.data, expected_size)
    if got < 0:
        raise ValueError("gzip stream corrupt or buffer too small")
    return out[:got].tobytes()


READERS = (load_npz_voxels_packed, npz_read, gzip_decode)

__all__ = [
    "READERS",
    "build",
    "call_counts",
    "gzip_decode",
    "library",
    "load_npz_voxels_packed",
    "npz_read",
    "reset_calls",
]

"""Build the hand-written CUDA kernels (``csrc/*.cu``), load them, and the
helpers their wrappers share at launch.

Each source compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/lib<name>-<hash>.so csrc/<name>.cu

into ``build/tricolo_tpu_torch/`` at the repository root (listed in
``.gitignore``), at first use. The sources have a plain C interface and
include no PyTorch header, so a build takes seconds; the library is loaded
with ``ctypes``. The file name carries a hash of the source, so an edited
kernel is never served from a stale library. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

There is no fallback: a missing ``nvcc`` or a failed build raises.
``compile_start`` / ``compile_finish`` build any one-file shared library
this way: ``tricolo_tpu_torch.native`` builds the host loader with ``g++``
through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tricolo_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of tricolo_tpu_torch cannot be built"
    )


def hashed_library(name: str, source: Path, flags: list[str],
                   build_dir: Path = BUILD_DIR) -> Path:
    """``<build_dir>/lib<name>-<hash>.so``, the hash over the source and the
    flags: an edited source is never served from a stale library."""
    digest = hashlib.sha1(source.read_bytes() + " ".join(flags).encode())
    return build_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"


def library_path(name: str) -> Path:
    return hashed_library(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def compile_start(command: list[str], source: Path, target: Path, libs: tuple = ()):
    """Start ``command -o <tmp> source libs`` unless ``target`` exists;
    returns (target, tmp, process, label) or None. The output goes to a
    pid-suffixed file that ``compile_finish`` renames into place, so
    processes that build at once never load a half-written library."""
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [*command, "-o", str(tmp), str(source), *libs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return target, tmp, proc, f"{Path(command[0]).name} failed for {source.name}"


def compile_finish(started) -> None:
    """Wait for ``compile_start``'s compiler; raise with its output if it
    failed, else move the library into place."""
    if started is None:
        return
    target, tmp, proc, label = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{label}:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees old or new


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists."""
    return compile_start([_nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu", library_path(name))


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every kernel source at once (one nvcc each); returns
    name → library path."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {name: _start(name) for name in names}
    errors = []
    for handle in started.values():
        try:
            compile_finish(handle)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            compile_finish(_start(name))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def vector_bytes(row_bytes: int, *tensors) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that divides ``row_bytes`` and
    every tensor's address: the vector width of a kernel that moves rows of
    ``row_bytes`` contiguous bytes."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    raise ValueError(f"no 2-byte-aligned copy for {row_bytes}-byte rows")


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")

"""Multi-process data parallelism: the process group, the ranks, the local batch.

Port of ``tricolo_tpu.parallel.multiprocess``. PyTorch's idiom is one
process per GPU, so the JAX package's multi-host runtime (one global mesh
over every process's devices) becomes a ``torch.distributed`` world of N
processes, one device each:

1. ``maybe_initialize(cfg, device)`` brings up the process group once when
   ``parallel.multiprocess=true``: NCCL for a CUDA device, gloo for the CPU
   (``backend=`` overrides it; no config key does). The rank triple comes
   from ``parallel.coordinator_address`` / ``num_processes`` /
   ``process_id``, else from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
   ``WORLD_SIZE``/``RANK``.
2. Every rank runs the same seeded loader permutation and takes its
   ``process_index``-th stripe of each global batch (``data/loader.py``),
   so the union of the stripes is the single-process batch stream.
3. ``data.batch_size`` stays the global batch: ``local_batch_size``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """The data-parallel world one process belongs to: its rank, the
    number of processes and their group."""

    rank: int
    size: int
    group: object  # torch.distributed.ProcessGroup


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _up() else 0


def process_count() -> int:
    return dist.get_world_size() if _up() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def local_batch_size(global_batch: int, count: int | None = None) -> int:
    """Each process's batch: the global batch stays the config contract."""
    n = process_count() if count is None else count
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by process count {n}")
    return global_batch // n


def rank_triple(cfg) -> tuple[str | None, int | None, int | None]:
    """(``host:port``, world size, rank): the config keys first, then
    torchrun's environment; None where neither gives it."""
    par = cfg.parallel
    addr = par.get("coordinator_address", None)
    if addr is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    size = par.get("num_processes", None)
    if size is None:
        size = os.environ.get("WORLD_SIZE")
    rank = par.get("process_id", None)
    if rank is None:
        rank = os.environ.get("RANK")
    return (None if addr is None else str(addr), None if size is None else int(size),
            None if rank is None else int(rank))


def default_device(cfg, device=None):
    """The device a rank runs on: ``device`` when given; under
    ``parallel.multiprocess`` with a GPU, ``cuda:{LOCAL_RANK}`` (torchrun),
    or ``cuda:{rank mod the visible GPUs}`` when only the config keys name
    the rank; otherwise None (``inference.resolve_device``'s default)."""
    if device is not None or not cfg.parallel.get("multiprocess", False):
        return device
    if not torch.cuda.is_available():
        return None
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = rank_triple(cfg)[2] or 0
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def maybe_initialize(cfg, device: torch.device, backend: str | None = None) -> World | None:
    """The process's ``World`` under ``parallel.multiprocess=true`` (the
    process group initialised on first use), else None. ``device`` picks
    the backend, NCCL on CUDA and gloo on the CPU, unless ``backend``
    names one (gloo also takes CUDA tensors: two ranks can share one
    card)."""
    if not cfg.parallel.get("multiprocess", False):
        return None
    if not _up():
        addr, size, rank = rank_triple(cfg)
        if addr is None or size is None or rank is None:
            raise ValueError(
                "parallel.multiprocess=true needs the rank triple: parallel."
                "coordinator_address, num_processes and process_id, or torchrun's "
                "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK"
            )
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=size,
                                rank=rank)
    return World(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)

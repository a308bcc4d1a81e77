"""Batching: fixed-shape collation of every voxel transfer, collated in a
prefetch thread.

The port's copy of ``tricolo_tpu.data.loader``. Eval batches come in split
order, the short tail batch is padded with repeats of its last item and
carries ``num_valid``, and every batch of a split has the same shapes. The
train loader shuffles with ``np.random.default_rng((seed, epoch))`` — the
JAX loader's permutation, so both packages see the same batches — and
drops the short tail. ``data.voxel_transfer`` takes every value the JAX
package takes: ``packed`` (sparse u32 site/RGB words, densified on the
device), ``dense`` (the u32 grid, densified here), ``windowed`` (every
tile's halo'd window rows + per-tile occupancy) and ``windowed_compact``
(per-sample rows of the active tiles only); the last three through the
host loader's C++ sweeps (``data/device_prep.py``). The windowed
transfers need the masked (submanifold) encoder: at ``masked_bn=false``
they warn and fall back to ``packed``, as the JAX loader does.

``BatchIterator`` collates in a one-deep background thread by default
(``prefetch``; the JAX loader's producer: a bounded queue, the producer's
error raised in the consumer, drain and join on close), so a batch's
collation overlaps the previous batch's step. With ``pin_memory`` (set by
the trainer and the server when their device is CUDA) the producer also
copies each batch's arrays into page-locked CPU tensors
(``pin_batch``), which ``inference.to_device_batch`` then copies to the
card with ``non_blocking=True``. ``peek`` collates one batch in the
caller's thread, unpinned. Multi-process striping comes with data
parallelism.
"""

from __future__ import annotations

import logging
import queue
import threading
import warnings
from typing import Any, Iterator

import numpy as np
import torch

from ..ops.tile_sparse import sample_tile_budget, windowed_halo
from .datasets import CLIP_KEYS, build_dataset
from .device_prep import (
    VOXEL_PAD_SENTINEL,
    densify_on_host,
    windowed_compact_on_host,
    windowed_on_host,
)

TRANSFERS = ("packed", "dense", "windowed", "windowed_compact")
# Packed u32 voxel words, carried as their int32 bit view in tensors.
PACKED_KEYS = ("voxel_flat", "voxel_rgb", "voxel_grid", "voxel_windows", "voxel_rows")
# The arrays of a batch that go to the device, with the dtype each carries.
ARRAY_DTYPES = {"tokens": np.int32, "images": None, **dict.fromkeys(PACKED_KEYS, np.uint32),
                "voxel_row_ids": np.int32, "voxel_tile_occ": None,
                **dict.fromkeys(CLIP_KEYS, np.float32)}


def host_tensor(key: str, value) -> torch.Tensor:
    """One batch array → a CPU tensor on its memory (packed u32 words as
    their int32 view; tokens and row ids as int32)."""
    array = np.ascontiguousarray(value, ARRAY_DTYPES[key])
    if key in PACKED_KEYS:
        array = array.view(np.int32)
    return torch.from_numpy(array)


def pin_batch(batch: dict) -> dict:
    """The batch with each array copied into a page-locked CPU tensor, from
    which a ``non_blocking`` copy to the card is asynchronous. Every call
    allocates new pinned buffers (PyTorch's pinned-memory cache reuses one
    only after the copies that read it have finished)."""
    return {key: host_tensor(key, value).pin_memory() if key in ARRAY_DTYPES else value
            for key, value in batch.items()}


def collate(
    items: list[dict],
    max_voxel_points: int,
    voxel_transfer: str = "packed",
    voxel_size: int = 64,
    with_images: bool = True,
    with_voxels: bool = True,
    tile_budget_rows: int = 0,
    windowed_halo: int = 1,
    tile_overflow: str = "error",
) -> dict[str, Any]:
    """Stack items into one fixed-shape numpy batch: tokens (B, T) int32,
    images (B, V, H, W, 3) uint8 and the voxels of ``voxel_transfer``:
    voxel_flat/voxel_rgb (B, N) u32 (packed), voxel_grid (B, D, D, D) u32
    (dense), voxel_windows (B·tg³, s³) u32 + voxel_tile_occ (B·tg³,) u8
    (windowed), or voxel_rows (B, k, s³) u32 + voxel_row_ids (B, k) int32
    (windowed_compact); and the items' precached CLIP features, when they
    carry them, as clip_embeddings_img / clip_embeddings_text (B, F)
    float32."""
    batch: dict[str, Any] = {
        "model_id": [item["model_id"] for item in items],
        "category": [item["category"] for item in items],
        "tokens": np.stack([item["tokens"] for item in items]).astype(np.int32),
    }
    if with_images:
        batch["images"] = np.stack([item["images"] for item in items])
    if with_voxels:
        if voxel_transfer not in TRANSFERS:
            raise ValueError(f"unknown data.voxel_transfer={voxel_transfer!r}")
        flat = np.full((len(items), max_voxel_points), VOXEL_PAD_SENTINEL, np.uint32)
        rgb = np.zeros((len(items), max_voxel_points), np.uint32)
        for i, item in enumerate(items):
            n = min(item["voxel_flat"].shape[0], max_voxel_points)
            flat[i, :n] = item["voxel_flat"][:n]
            rgb[i, :n] = item["voxel_rgb"][:n]
        if voxel_transfer == "dense":
            batch["voxel_grid"] = densify_on_host(flat, rgb, voxel_size)
        elif voxel_transfer == "windowed":
            batch["voxel_windows"], batch["voxel_tile_occ"] = windowed_on_host(
                flat, rgb, voxel_size, halo=windowed_halo
            )
        elif voxel_transfer == "windowed_compact":
            if tile_budget_rows <= 0:
                raise ValueError("windowed_compact collate needs tile_budget_rows > 0")
            rows, local_ids, counts = windowed_compact_on_host(
                flat, rgb, voxel_size, tile_budget_rows, halo=windowed_halo
            )
            if (counts > tile_budget_rows).any():
                msg = (
                    f"windowed_compact: a sample has {int(counts.max())} active "
                    f"tiles > tile_budget={tile_budget_rows} — set model.modules."
                    "VoxelCNNEncoder.tile_budget=auto or raise the budget"
                )
                if tile_overflow != "truncate":
                    raise ValueError(msg)
                logging.getLogger(__name__).warning("%s (highest tiles dropped)", msg)
            batch["voxel_rows"] = rows
            batch["voxel_row_ids"] = local_ids
        else:
            batch["voxel_flat"] = flat
            batch["voxel_rgb"] = rgb
    for key in CLIP_KEYS:
        if key in items[0]:
            batch[key] = np.stack([item[key] for item in items]).astype(np.float32)
    return batch


class BatchIterator:
    """Iterate a dataset in fixed-shape batches: split order, or a seeded
    per-epoch permutation with ``shuffle``; collated in a background thread
    with ``prefetch``, into pinned tensors with ``pin_memory``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        voxel_transfer: str = "windowed_compact",
        voxel_size: int = 64,
        with_images: bool = True,
        with_voxels: bool = True,
        tile_budget: "int | str" = "auto",
        windowed_halo: int = 3,
        tile_overflow: str = "error",
        prefetch: bool = True,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.voxel_transfer = voxel_transfer
        self.voxel_size = voxel_size
        self.with_images = with_images
        self.with_voxels = with_voxels
        self.tile_budget = tile_budget
        self.windowed_halo = windowed_halo
        self.tile_overflow = tile_overflow
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._tile_budget_rows: int | None = None

    @property
    def tile_budget_rows(self) -> int:
        """The resolved per-sample row budget k (see sample_tile_budget)."""
        if self._tile_budget_rows is None:
            explicit = isinstance(self.tile_budget, (int, float)) and not isinstance(
                self.tile_budget, bool
            )
            self._tile_budget_rows = sample_tile_budget(
                self.tile_budget,
                (self.voxel_size // 8) ** 3,
                None if explicit else self.dataset.max_voxel_tiles,
            )
        return self._tile_budget_rows

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle stream (a new seeded permutation each epoch)."""
        self.epoch = epoch

    def _batches(self, pin: bool) -> Iterator[dict]:
        """The epoch's batches, collated in the caller's thread."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        for start in range(0, n, self.batch_size):
            chunk = order[start : start + self.batch_size]
            valid = len(chunk)
            if valid < self.batch_size:
                if self.drop_last:
                    return
                chunk = np.concatenate(
                    [chunk, np.full(self.batch_size - valid, chunk[-1])]
                )
            compact = self.with_voxels and self.voxel_transfer == "windowed_compact"
            batch = collate(
                [self.dataset[int(i)] for i in chunk],
                self.dataset.max_voxel_points,
                self.voxel_transfer,
                self.voxel_size,
                self.with_images,
                self.with_voxels,
                self.tile_budget_rows if compact else 0,
                self.windowed_halo,
                self.tile_overflow,
            )
            batch["num_valid"] = valid
            yield pin_batch(batch) if pin else batch

    def peek(self) -> dict:
        """The first batch, collated here and unpinned, without starting
        the prefetch thread (the trainer's tile-budget canary)."""
        return next(self._batches(pin=False))

    def __iter__(self) -> Iterator[dict]:
        if not self.prefetch:
            yield from self._batches(self.pin_memory)
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def produce():
            try:
                for batch in self._batches(self.pin_memory):
                    # A bounded put that notices an abandoned consumer, so
                    # a dropped iterator never leaves a thread blocked.
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # raised again in the consumer below
                error.append(exc)
            finally:
                q.put(done)

        thread = threading.Thread(target=produce, name="tricolo-prefetch", daemon=True)
        thread.start()
        try:
            while (batch := q.get()) is not done:
                yield batch
        finally:
            stop.set()
            while True:  # drain, so the producer's last put never blocks
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)
        if error:
            raise error[0]


class DataModule:
    """Split construction + loader config: ``setup("fit")`` builds the train
    split and the ``inference.split`` split, ``setup("test")`` the latter."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.train_set = None
        self.val_set = None

    def setup(self, stage: str | None = None):
        if stage in ("fit", None):
            self.train_set = build_dataset(self.cfg, "train")
        self.val_set = build_dataset(self.cfg, self.cfg.inference.split)

    def _loader_kwargs(self) -> dict:
        model = self.cfg.model
        voxel_cfg = model.modules.VoxelCNNEncoder
        transfer = str(self.cfg.data.get("voxel_transfer", "windowed_compact"))
        if transfer not in TRANSFERS:
            raise ValueError(f"unknown data.voxel_transfer={transfer!r}; one of {TRANSFERS}")
        blocks = int(voxel_cfg.get("tile_sparse_blocks", 2))
        if model.voxel_encoder is not None and transfer.startswith("windowed"):
            if blocks > 2:
                warnings.warn(
                    f"tile_sparse_blocks={blocks} with a windowed voxel transfer: "
                    "the windowed encoder runs at most 2 sparse blocks — running "
                    "2. Use voxel_transfer=dense or packed with tile_sparse=true "
                    "for deeper sparse stacks.",
                    stacklevel=2,
                )
            if not voxel_cfg.get("masked_bn", False):
                # Windowed rows are only exact under the masked semantics;
                # the all-site encoder takes the truncation-free packed
                # transfer instead, with the JAX loader's warning.
                warnings.warn(
                    f"voxel_transfer={transfer} requires masked_bn=true; "
                    "masked_bn=false — falling back to "
                    "data.voxel_transfer=packed (dense all-site BN path).",
                    stacklevel=2,
                )
                transfer = "packed"
        return dict(
            batch_size=self.cfg.data.batch_size,
            voxel_transfer=transfer,
            voxel_size=self.cfg.data.voxel_size,
            with_images=model.image_encoder == "MVCNNEncoder",
            with_voxels=model.voxel_encoder is not None,
            tile_budget=voxel_cfg.get("tile_budget", "auto"),
            tile_overflow=str(self.cfg.data.get("tile_overflow", "error")),
            windowed_halo=windowed_halo(blocks),
        )

    def train_loader(self, pin_memory: bool = False) -> BatchIterator:
        return BatchIterator(self.train_set, shuffle=True, drop_last=True,
                             seed=self.cfg.train_seed, pin_memory=pin_memory,
                             **self._loader_kwargs())

    def val_loader(self, pin_memory: bool = False) -> BatchIterator:
        return BatchIterator(self.val_set, pin_memory=pin_memory, **self._loader_kwargs())

    test_loader = val_loader

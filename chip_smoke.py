#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval-serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card — ``nvidia-smi`` name and power limit;
2. build — every ``tricolo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, all
   sources at once;
3. kernels — K1 (bn_relu_pool) at the five flagship voxel-block shapes and
   K2 (scatter_tiles_ps) at the block-2 handoff, in f32 and bf16, against
   their plain PyTorch versions on the card (bit-exact required), and timed
   beside their bandwidth bound;
4. serving — ``RetrievalServer.build_index`` over a 256-model synthetic
   split at the flagship widths (Tri(I+V), 64³ voxels, 6×128² views,
   batch 128, bf16), four token queries and one image query, with the
   kernels' launch counts taken over exactly this phase;
5. plain path — the same index in f32 (TF32 off) through the kernels and
   through their plain versions; the two must agree to 1e-5;
6. one flagship batch — 128 solid-ellipsoid shapes through the eval
   forward, CUDA-event median;
7. the kernels line, then the card line, then ``{"ok": true, ...}``.

Details go to ``chiprun_out/chip_smoke.json``. The script imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_TOL = 1e-5
FLAGSHIP = [
    "data=synthetic",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "precision.compute_dtype=bfloat16",
    "data.voxel_size=64",
    "data.image_size=128",
    "data.num_views=6",
    "data.batch_size=128",
    "data.vocab_size=3588",
    "data.num_models=256",
]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing


def time_ms(fn, torch, repeats: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of one call; ``flush`` runs outside the
    timed region before each call (cold L2)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_flush(torch):
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    return flush


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ------------------------------------------------------------ phase 3: K1/K2


def k1_inputs(torch, shape, dtype, two_masks, gen):
    """Quantized activations (exact ties), random 0/1 masks with all-zero
    windows, stats mask ⊂ zero mask; folded BN from random statistics."""
    from tricolo_tpu_torch.ops import fold_bn

    N, D, H, W, C = shape
    y = torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int8)
    y = y.to(dtype) / 8.0
    mshape = (N, D, H, W, 1)
    zmask = (torch.rand(mshape, generator=gen, device="cuda") < 0.6).to(dtype)
    zmask[:, :2, :2, :2] = 0
    smask = None
    if two_masks:
        smask = ((torch.rand(mshape, generator=gen, device="cuda") < 0.4).to(dtype) * zmask)
    scale = torch.rand(C, generator=gen, device="cuda") + 0.5
    bias = torch.randn(C, generator=gen, device="cuda") * 0.3
    mean = torch.randn(C, generator=gen, device="cuda") * 0.3
    var = torch.rand(C, generator=gen, device="cuda") * 1.5 + 0.5
    mul, add = fold_bn(scale, bias, mean, var, 1e-5, dtype)
    return y, mul, add, zmask, smask


def check_k1(torch, shapes, flush):
    from tricolo_tpu_torch.ops import bn_relu_pool, bn_relu_pool_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, rows = 0.0, []
    for name, shape, two in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_inputs(torch, shape, dtype, two, gen)
            for want_idx in (False, True):
                got = bn_relu_pool(*args, want_idx=want_idx)
                torch.cuda.synchronize()
                ref = bn_relu_pool_plain(*args, want_idx=want_idx)
                for a, b in zip(got, ref):
                    err = (a.float() - b.float()).abs().max().item()
                    max_err = max(max_err, err)
                    require(torch.equal(a, b), f"K1 {name} {dtype} idx={want_idx}: "
                            f"kernel != plain (max err {err})")
                del got, ref
            if dtype == torch.bfloat16:  # the main path's dtype, idx off
                y, mul, add, zmask, smask = args
                pooled_shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2)
                out_bytes = (
                    (torch.Size(pooled_shape).numel() * (shape[4] + 1)) * y.element_size()
                )
                bound = (nbytes(y, zmask, smask) + out_bytes) / HBM_BYTES_PER_S * 1e3
                ms = time_ms(lambda: bn_relu_pool(*args), torch, flush=flush)
                plain = time_ms(lambda: bn_relu_pool_plain(*args), torch, repeats=5,
                                flush=flush)
                rows.append({"block": name, "shape": list(shape), "dtype": "bf16",
                             "ms": ms, "plain_ms": plain, "bound_ms": bound})
                log(f"  K1 {name:7s} {tuple(shape)} bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms)")
            del args
            torch.cuda.empty_cache()
    return max_err, rows


def check_k2(torch, ids, grid, flush):
    from tricolo_tpu_torch.ops import scatter_tiles_ps, scatter_tiles_ps_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, k = ids.shape
    max_err, rows = 0.0, []
    for C, name in ((64, "x"), (1, "mask")):
        for dtype in (torch.float32, torch.bfloat16):
            tiles = torch.randn((B, k, 2, 2, 2, C), generator=gen, device="cuda").to(dtype)
            got = scatter_tiles_ps(tiles, ids, grid)
            torch.cuda.synchronize()
            ref = scatter_tiles_ps_plain(tiles, ids, grid)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, ref), f"K2 C={C} {dtype}: kernel != plain ({err})")
            if dtype == torch.bfloat16:
                bound = nbytes(tiles, ids, got) / HBM_BYTES_PER_S * 1e3
                ms = time_ms(lambda: scatter_tiles_ps(tiles, ids, grid), torch, flush=flush)
                plain = time_ms(lambda: scatter_tiles_ps_plain(tiles, ids, grid), torch,
                                repeats=5, flush=flush)
                rows.append({"tensor": name, "shape": list(tiles.shape), "grid": grid,
                             "dtype": "bf16", "ms": ms, "plain_ms": plain,
                             "bound_ms": bound})
                log(f"  K2 {name:4s} {tuple(tiles.shape)} -> {grid}^3 bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms)")
    return max_err, rows


# -------------------------------------------------------------- phase 4


def index_breakdown(torch, dm, model) -> dict:
    """Where an index build's wall time goes: split construction, host
    collation, host→device copy, and the eval forward's device time (CUDA
    events). ``device_idle_share`` = 1 − forward device time / wall."""
    from tricolo_tpu_torch.inference import eval_step, shape_embedding_sum, to_device_batch

    wall = time.perf_counter()
    tic = time.perf_counter()
    dm.setup("test")
    parts = {"setup_s": time.perf_counter() - tic, "collate_s": 0.0, "h2d_s": 0.0,
             "forward_device_s": 0.0}
    batches = iter(dm.test_loader())
    while True:
        tic = time.perf_counter()
        batch = next(batches, None)
        parts["collate_s"] += time.perf_counter() - tic
        if batch is None:
            break
        tic = time.perf_counter()
        device_batch = to_device_batch(batch, torch.device("cuda"))
        torch.cuda.synchronize()
        parts["h2d_s"] += time.perf_counter() - tic
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eval_step(model, device_batch)
        end.record()
        shape_embedding_sum(out)[: batch["num_valid"]].cpu()
        parts["forward_device_s"] += start.elapsed_time(end) / 1e3
    parts["wall_s"] = time.perf_counter() - wall
    parts["device_idle_share"] = 1.0 - parts["forward_device_s"] / parts["wall_s"]
    return parts


# -------------------------------------------------------------- phase 6


def ellipsoid_batch(cfg, n_points=8192):
    import numpy as np

    from tricolo_tpu_torch.data.device_prep import windowed_compact_on_host
    from tricolo_tpu_torch.data.ellipsoid import ellipsoid_sample
    from tricolo_tpu_torch.ops.tile_sparse import host_sample_tile_counts, sample_tile_budget

    d = cfg.data
    rng = np.random.default_rng(SEED)
    B, D = d.batch_size, d.voxel_size
    flat = np.empty((B, n_points), np.uint32)
    rgb = np.empty((B, n_points), np.uint32)
    for i in range(B):
        flat[i], rgb[i] = ellipsoid_sample(rng, D, n_points)
    k = sample_tile_budget("auto", (D // 8) ** 3, max(host_sample_tile_counts(flat, D)))
    rows, ids, _ = windowed_compact_on_host(flat, rgb, D, k, halo=3)
    return {
        "tokens": rng.integers(1, d.vocab_size, (B, d.max_tokens)).astype(np.int32),
        "images": rng.integers(0, 256, (B, d.num_views, d.image_size, d.image_size, 3),
                               dtype=np.uint8),
        "voxel_rows": rows,
        "voxel_row_ids": ids,
    }, k


# ----------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "tricolo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: tricolo_tpu_torch/ is missing beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import eval_step, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.ops import _build
    from tricolo_tpu_torch.serving import RetrievalServer

    report: dict = {"phases": {}}
    walls = report["phases"]

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    report.update(card=card, kind=kind, torch=torch.__version__, cuda=torch.version.cuda)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    tic = time.perf_counter()
    libs = _build.build_all()
    walls["build_s"] = time.perf_counter() - tic
    log(f"build: {sorted(libs)} in {walls['build_s']:.1f} s")

    # Flagship config and split (shapes for phase 3 come from its loader).
    cfg = load_config(FLAGSHIP)
    cfg.experiment_name = "chip_smoke"
    tic = time.perf_counter()
    dm = DataModule(cfg)
    dm.setup("test")
    loader = dm.test_loader()
    k = loader.tile_budget_rows
    first = next(iter(loader))
    walls["data_s"] = time.perf_counter() - tic
    B = cfg.data.batch_size
    T = B * k
    log(f"split: {len(dm.val_set)} captions, {len(dm.val_set.vision_data)} models, "
        f"k={k} tiles/sample, T={T} rows/batch")

    # 3. kernels vs plain versions
    tic = time.perf_counter()
    flush = make_flush(torch)
    k1_shapes = [
        ("block1", (T, 12, 12, 12, 32), True),
        ("block2", (T, 4, 4, 4, 64), False),
        ("block3", (B, 16, 16, 16, 128), False),
        ("block4", (B, 8, 8, 8, 256), False),
        ("block5", (B, 4, 4, 4, 512), False),
    ]
    k1_err, k1_rows = check_k1(torch, k1_shapes, flush)
    ids = torch.from_numpy(first["voxel_row_ids"]).cuda()
    k2_err, k2_rows = check_k2(torch, ids, cfg.data.voxel_size // 4, flush)
    del flush
    torch.cuda.empty_cache()
    walls["kernels_s"] = time.perf_counter() - tic
    report["k1"], report["k2"] = k1_rows, k2_rows
    log(f"kernels: K1 max err {k1_err}, K2 max err {k2_err} (bit-exact required)")

    # 4. serving path at flagship widths, bf16, through the kernels
    torch.manual_seed(SEED)
    model = TriCoLoNet.from_config(cfg)
    server = RetrievalServer(cfg, model)  # device: cuda
    ops.reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    walls["index_build_s"] = time.perf_counter() - tic
    launches = ops.launches()
    n_batches = len(loader)
    require(index.matrix.shape == (256, cfg.model.out_dim), f"index {index.matrix.shape}")
    require(bool(np.isfinite(index.matrix).all()), "index has non-finite values")
    require(len(set(index.model_ids)) == 256, "index model ids are not unique")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the serving path")
    log(f"index: {len(index.model_ids)} models x {index.matrix.shape[1]} in "
        f"{walls['index_build_s']:.3f} s over {n_batches} batches; launches {launches} "
        f"[{card}]")
    report["index_breakdown"] = parts = index_breakdown(torch, dm, model)
    log("index breakdown (second build, same split): " + ", ".join(
        f"{key} {value:.4f}" for key, value in parts.items()) + f" [{card}]")
    queries = [dm.val_set[i]["tokens"] for i in (0, 3, 100, 500)]
    tic = time.perf_counter()
    answers = [server.query(tokens=q, k=5) for q in queries]
    walls["text_queries_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    image_answer = server.query_image(dm.val_set[0]["images"], k=5)
    walls["image_query_s"] = time.perf_counter() - tic
    for q, a in zip(queries, answers):
        require(len(a) == 5 and all(np.isfinite(s) for _, s in a), "bad text answer")
        log(f"  query {q[q != 0][:6].tolist()}...: {[m for m, _ in a]}")
    require(len(image_answer) == 5, "bad image answer")
    log(f"  image query (views of {dm.val_set[0]['model_id']}): "
        f"{[m for m, _ in image_answer]}")
    log(f"queries: 4 text in {walls['text_queries_s']:.3f} s, 1 image in "
        f"{walls['image_query_s']:.3f} s [{card}]")
    bf16_matrix = index.matrix.copy()
    report["launches"] = launches
    report["index"] = {"models": len(index.model_ids), "batches": n_batches,
                       "topk": [[m for m, _ in a] for a in answers],
                       "image_topk": [m for m, _ in image_answer]}

    # 5. the same path in f32 (TF32 off): kernels vs plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.set_compute_dtype(torch.float32)
    tic = time.perf_counter()
    kernel32 = server.build_index(dm).matrix.copy()
    kernel_top = [[m for m, _ in server.query(tokens=q, k=5)] for q in queries]
    model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dm).matrix.copy()
    plain_top = [[m for m, _ in server.query(tokens=q, k=5)] for q in queries]
    model.voxel_encoder.use_kernels = True
    walls["plain_compare_s"] = time.perf_counter() - tic
    dev_plain = float(np.abs(kernel32 - plain32).max())
    dev_bf16 = float(np.abs(bf16_matrix - kernel32).max())
    require(dev_plain <= F32_TOL, f"f32 kernel path vs plain path: {dev_plain} > {F32_TOL}")
    require(kernel_top == plain_top, "top-k differs between kernel and plain paths")
    report["plain_vs_kernel_f32_max_abs"] = dev_plain
    report["bf16_vs_f32_max_abs"] = dev_bf16
    log(f"plain path: f32 kernel vs plain max |d| = {dev_plain} (tol {F32_TOL}); "
        f"bf16 vs f32 max |d| = {dev_bf16}")
    model.set_compute_dtype(torch.bfloat16)

    # 6. one flagship batch of solid ellipsoids through the eval forward
    tic = time.perf_counter()
    host, k_ell = ellipsoid_batch(cfg)
    batch = to_device_batch(host, torch.device("cuda"))
    walls["ellipsoid_data_s"] = time.perf_counter() - tic
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eval_step(model, batch)
    per_batch = ops.launches()
    step_ms = time_ms(lambda: eval_step(model, batch), torch, repeats=10, warmup=2)
    model.voxel_encoder.use_kernels = False
    plain_step_ms = time_ms(lambda: eval_step(model, batch), torch, repeats=10, warmup=2)
    model.voxel_encoder.use_kernels = True
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    report["flagship_batch"] = {"k": k_ell, "ms": step_ms, "plain_ms": plain_step_ms,
                                "launches": per_batch, "peak_gib": peak_gib}
    log(f"flagship batch (128 ellipsoids, k={k_ell}): {step_ms:.3f} ms eval forward "
        f"(plain kernels {plain_step_ms:.3f} ms), launches/batch {per_batch}, "
        f"peak {peak_gib:.2f} GiB [{card}]")

    # 7. kernels line, card line, result
    def total(rows, key):
        return sum(r[key] for r in rows)

    kernels = [
        {"name": "bn_relu_pool", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/bn_relu_pool.cu",
         "replaces": "tricolo_tpu/ops/fused_bn_pool.py:99",
         "launches": launches["bn_relu_pool"], "max_abs_err": k1_err,
         "ms": total(k1_rows, "ms"), "plain_ms": total(k1_rows, "plain_ms"),
         "bound_ms": total(k1_rows, "bound_ms"), "bound_by": "bytes",
         "library_ms": None, "shapes": k1_rows},
        {"name": "scatter_tiles_ps", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/tile_scatter.cu",
         "replaces": "tricolo_tpu/ops/_graveyard/dma_tiles.py:128",
         "launches": launches["scatter_tiles_ps"], "max_abs_err": k2_err,
         "ms": total(k2_rows, "ms"), "plain_ms": total(k2_rows, "plain_ms"),
         "bound_ms": total(k2_rows, "bound_ms"), "bound_by": "bytes",
         "library_ms": None, "shapes": k2_rows},
    ]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase: report and fail, never print a result
        import traceback

        traceback.print_exc()
        sys.exit(1)

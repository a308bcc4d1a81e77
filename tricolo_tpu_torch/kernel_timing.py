"""Time K3 (``bn_relu_pool_bwd``, masked and unmasked) and K7
(``gather_tiles``) at the shapes the main paths give them, and show what the
compiler made of their sources.

    python tricolo_tpu_torch/kernel_timing.py [--root DIR] [--sass] [--trial]

``--root`` names the checkout whose ``tricolo_tpu_torch`` is timed (default:
the one holding this file), so one machine can time two versions in turns,
each in its own process. Shapes: K3 masked at the windowed_compact blocks
(26,240 rows, then batch 128), the dense plan's two tile-sparse blocks
(32,768 rows) and the C13/128³ blocks (27,680 rows, then batch 32); K3
unmasked at the five blocks of the masked_bn=false flagship; K7 at the dense
plan's four gathers, 14,279 active tiles (a synthetic-256 batch's count) of a
32,768-row budget. Inputs are seeded and bf16. Each row has the CUDA-event
median of 20 calls after a 256 MB L2 flush (``ms``, as ``chip_smoke.py``
times), the fastest of them (``min_ms``) and the median of 20 more with a
device spin between the flush and the call (``spin_ms``: the host's time
to queue the call cannot show), beside the bound (the kernel module's
``work(...)`` bytes, read once and written once, over 3.35 TB/s, as ``chip_smoke.py`` counts them).

``--sass`` compiles the root's two sources with ``nvcc -Xptxas -v`` to a
cubin and counts, in ``cuobjdump -sass``, each kernel's instructions, its
integer-division sequences (``I2F.U32.RP``, one per 32-bit division by a
run-time value) and its global loads and stores by width. ``--trial`` times
the current checkout's K3 at each channels-a-thread plan and K7 at several
tiles a block, through the C entries, at the small shapes where the grid's
fill decides. Prints one JSON line; needs a GPU and, for ``--sass``, nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

K3_MASKED = [
    ("windowed_compact", "block1", (26240, 12, 12, 12, 32)),
    ("windowed_compact", "block2", (26240, 4, 4, 4, 64)),
    ("windowed_compact", "block3", (128, 16, 16, 16, 128)),
    ("windowed_compact", "block4", (128, 8, 8, 8, 256)),
    ("windowed_compact", "block5", (128, 4, 4, 4, 512)),
    ("dense_plan", "block1", (32768, 8, 8, 8, 32)),
    ("dense_plan", "block2", (32768, 4, 4, 4, 64)),
    ("c13_128", "block1", (27680, 12, 12, 12, 32)),
    ("c13_128", "block2", (27680, 4, 4, 4, 64)),
    ("c13_128", "block3", (32, 32, 32, 32, 128)),
    ("c13_128", "block4", (32, 16, 16, 16, 256)),
    ("c13_128", "block5", (32, 8, 8, 8, 512)),
]
K3_UNMASKED = [(f"block{i + 1}", (128, 64 >> i, 64 >> i, 64 >> i, 32 << i))
               for i in range(5)]
K7_CASES = [("x1", 64, 4, 8, 1), ("mask1", 64, 1, 8, 0), ("x2", 32, 32, 4, 1),
            ("mask2", 32, 1, 4, 0)]
K7_BATCH, K7_BUDGET, K7_ACTIVE = 128, 32768, 14279


def samples(torch, fn, flush, spin: int = 0, repeats: int = 20, warmup: int = 3) -> list:
    """CUDA-event times of ``repeats`` calls, each after the L2 flush and,
    with ``spin``, a device spin of that many cycles: the device is then
    still busy when the host has queued the call, so no host time shows in
    the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        flush()
        if spin:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(torch, fn, flush) -> float:
    return statistics.median(samples(torch, fn, flush))


def timings(torch, fn, flush) -> dict:
    """The median as ``chip_smoke.py`` takes it (after the flush), the
    fastest of those calls, and the median behind a 200,000-cycle spin."""
    plain = samples(torch, fn, flush)
    return {"ms": statistics.median(plain), "min_ms": min(plain),
            "spin_ms": statistics.median(samples(torch, fn, flush, spin=200_000))}


def k3_inputs(torch, shape, masked, gen):
    N, D, H, W, C = shape
    pooled = (N, D // 2, H // 2, W // 2, C)
    y = (torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int8)
         .to(torch.bfloat16) / 8.0)
    ga = torch.randn(pooled, generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randint(0, 8, pooled, generator=gen, device="cuda", dtype=torch.uint8)
    mask = None
    if masked:
        mask = (torch.rand((N, D, H, W, 1), generator=gen, device="cuda") < 0.5).to(y.dtype)
    vectors = [torch.randn(C, generator=gen, device="cuda") for _ in range(4)]
    return y, ga, idx, mask, vectors


def k7_inputs(torch, gen):
    n = K7_BATCH * 8**3
    active = torch.randperm(n, generator=gen, device="cuda")[:K7_ACTIVE].sort().values
    ids = torch.full((K7_BUDGET,), n, dtype=torch.int32, device="cuda")
    ids[:K7_ACTIVE] = active.to(torch.int32)
    return ids


def time_k3(torch, ops, flush, gen) -> list:
    from tricolo_tpu_torch.ops.bn_relu_pool import work as k3_work

    rows = []
    cases = [(plan, block, shape, True) for plan, block, shape in K3_MASKED]
    cases += [("unmasked", block, shape, False) for block, shape in K3_UNMASKED]
    for plan, block, shape, masked in cases:
        y, ga, idx, mask, vectors = k3_inputs(torch, shape, masked, gen)
        if masked:
            fn = lambda: ops.bn_relu_pool_bwd(y, ga, idx, mask, *vectors)  # noqa: E731
        else:
            fn = lambda: ops.bn_relu_pool_bwd_unmasked(y, ga, idx, *vectors)  # noqa: E731
        bound = k3_work("K3", shape, y.element_size(), int(masked))[0] / HBM_BYTES_PER_S * 1e3
        rows.append({"kernel": "K3", "plan": plan, "block": block, "shape": list(shape),
                     **timings(torch, fn, flush), "bound_ms": bound})
        del y, ga, idx, mask, vectors, fn
        torch.cuda.empty_cache()
    return rows


def time_k7(torch, ops, flush, gen) -> list:
    from tricolo_tpu_torch.ops.tile_gather import work as k7_work

    rows = []
    ids = k7_inputs(torch, gen)
    for name, D, C, tile, halo in K7_CASES:
        x = torch.randn((K7_BATCH, D, D, D, C), generator=gen, device="cuda").to(torch.bfloat16)
        out = ops.gather_tiles(x, ids, tile, halo)
        moved = k7_work(K7_ACTIVE, tile, halo, C, x.element_size(), ids.numel())[0]
        bound = moved / HBM_BYTES_PER_S * 1e3
        rows.append({"kernel": "K7", "tensor": name, "out": list(out.shape),
                     **timings(torch, lambda: ops.gather_tiles(x, ids, tile, halo), flush),
                     "bound_ms": bound})
        del x, out
        torch.cuda.empty_cache()
    return rows


def trial(torch, flush, gen) -> list:
    """The current checkout's K3 at each channels-a-thread plan (bf16) and
    K7 at 1-64 tiles a block, through the C entries."""
    from tricolo_tpu_torch.ops import _build, tile_gather
    from tricolo_tpu_torch.ops.bn_relu_pool import _lib_bwd

    rows = []
    fn = _lib_bwd().bn_relu_pool_bwd_bf16
    stream = torch.cuda.current_stream().cuda_stream
    cases = [(plan, block, shape, True) for plan, block, shape in K3_MASKED[2:7] + K3_MASKED[9:]]
    cases += [("unmasked", block, shape, False) for block, shape in K3_UNMASKED[2:]]
    for plan, block, shape, masked in cases:
        y, ga, idx, mask, vectors = k3_inputs(torch, shape, masked, gen)
        dy = torch.empty_like(y)
        N, D, H, W, C = shape
        for vec in (8, 4, 2):
            def call(vec=vec):
                status = fn(y.data_ptr(), ga.data_ptr(), idx.data_ptr(),
                            None if mask is None else mask.data_ptr(),
                            *(v.data_ptr() for v in vectors), dy.data_ptr(), N, D // 2,
                            H // 2, W // 2, C, vec, 0, stream)
                _build.check(status, "bn_relu_pool_bwd")

            rows.append({"kernel": "K3", "plan": plan, "block": block, "vec": vec,
                         "threads": N * D * H * W // 8 * C // vec,
                         "ms": time_ms(torch, call, flush)})
        del y, ga, idx, mask, vectors, dy
        torch.cuda.empty_cache()
    ids = k7_inputs(torch, gen)
    lib = tile_gather._lib()
    for name, D, C, tile, halo in K7_CASES:
        x = torch.randn((K7_BATCH, D, D, D, C), generator=gen, device="cuda").to(torch.bfloat16)
        s = tile + 2 * halo
        out = torch.empty((K7_BUDGET, s, s, s, C), dtype=x.dtype, device="cuda")
        plan = tile_gather.launch_plan(K7_BATCH, D, C, tile, halo, 2, x, out)
        for tpb in sorted({1, 2, 4, 8, 16, 32, 64, plan.tiles_per_block}):
            def call(tpb=tpb):
                status = lib.tile_gather(x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                         K7_BUDGET, K7_BATCH, D, C, tile, halo, 2,
                                         plan.vec_bytes, tpb, 1, stream)
                _build.check(status, "tile_gather")

            rows.append({"kernel": "K7", "tensor": name, "tiles_per_block": tpb,
                         "plan": tpb == plan.tiles_per_block,
                         "ms": time_ms(torch, call, flush)})
        del x, out
        torch.cuda.empty_cache()
    return rows


def sass(root: Path) -> dict:
    """Registers (ptxas) and SASS counts of each kernel instantiation."""
    from tricolo_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    report = {}
    for name in ("bn_relu_pool_bwd", "tile_gather"):
        with tempfile.TemporaryDirectory() as tmp:
            cubin = Path(tmp) / f"{name}.cubin"
            ptxas = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-cubin", "-Xptxas", "-v", "-o", str(cubin),
                 str(root / "tricolo_tpu_torch" / "csrc" / f"{name}.cu")],
                capture_output=True, text=True, check=True).stderr
            listing = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                                     text=True, check=True).stdout
        ptx = {}
        for part in ptxas.split("Compiling entry function '")[1:]:
            used = re.search(r"Used (\d+) registers", part)
            spills = re.search(r"(\d+) bytes spill stores", part)
            ptx[part.split("'", 1)[0]] = (int(used.group(1)) if used else None,
                                          int(spills.group(1)) if spills else None)
        kernels = {}
        for block in re.split(r"\n\s*Function : ", listing)[1:]:
            fname = block.split("\n", 1)[0].strip()
            code = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)
            ops = [c.split()[1] if c.startswith("@") else c.split()[0] for c in code if c.strip()]
            memory = {}
            for op in ops:
                if op.startswith(("LDG", "STG", "LDS", "STS")):
                    memory[op] = memory.get(op, 0) + 1
            registers, spill_bytes = ptx.get(fname, (None, None))
            kernels[fname] = {"registers": registers, "spill_bytes": spill_bytes,
                              "instructions": len(ops),
                              "int_divisions": sum(op.startswith("I2F.U32.RP") for op in ops),
                              "memory": memory}
        report[name] = kernels
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--trial", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    from tricolo_tpu_torch import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": str(root), "card": card,
              "rows": time_k3(torch, ops, flush, gen) + time_k7(torch, ops, flush, gen)}
    if args.trial:
        result["trial"] = trial(torch, flush, gen)
    if args.sass:
        result["sass"] = sass(root)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

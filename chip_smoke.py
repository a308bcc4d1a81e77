#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card — ``nvidia-smi`` name and power limit;
2. build — every ``tricolo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, all
   sources at once (K1-K7);
3. kernels — each against its plain PyTorch version on the card, timed
   beside its bound: K1 (bn_relu_pool) at the five flagship voxel-block
   shapes and the dense plan's two tile-sparse blocks, idx off and on, in
   f32 and bf16, bit-exact, timed in both forms (eval: idx off; train: idx
   on), and K2 (scatter_tiles_ps) at the block-2 handoff, in f32 and bf16,
   bit-exact (its bound reads only the rows with a valid id); K3
   (bn_relu_pool_bwd) at the five flagship shapes, in f32 and bf16, on
   K1's argmax of inputs with ties and dead windows, bit-exact, also at the
   dense plan's two tile-sparse blocks;
   K4-K6 (nt_xent_fwd / _bwd_rows / _bwd_cols), the pair forward
   (nt_xent_fwd_pair, both directions' logsumexps from one pass over the
   logits: the loss's forward) and the two-term backward (nt_xent_bwd,
   K5's and K6's terms of one operand in one launch: the loss's backward)
   at B = 128 and 8192, D = 512, f32, within
   ``NT_XENT_TOL``·max|plain|; K7 (gather_tiles) at the dense
   plan's four gathers and K2's global entry (scatter_tiles_global) at its
   four handoffs, on the active tiles of a real packed batch (budget 32,768
   rows), in f32 and bf16, bit-exact, K7 timed beside its one-call
   yardstick (``aten::index`` over an ``unfold`` view of the padded grid);
   K1's and K3's unmasked entries
   (bn_relu_pool_unmasked idx off and on, bn_relu_pool_bwd_unmasked) at
   the five dense blocks of the masked_bn=false flagship, (128, 64³, 32) …
   (128, 4³, 512), in f32 and bf16, bit-exact, on inputs with ties, dead
   windows and one γ = 0 channel (K3 on K1's argmax of them);
4. serving — ``RetrievalServer.build_index`` over a 256-model synthetic
   split at the flagship widths (Tri(I+V), 64³ voxels, 6×128² views,
   batch 128, bf16), four token queries and one image query, with the
   kernels' launch counts taken over exactly this phase; every array that
   reaches ``to_device_batch`` comes from pinned memory and every batch
   through the C++ windowed_compact sweep (so in phases 7, 10d and 10f); the
   build's wall split by part, through the prefetching loader;
5. serving plain path — the same index in f32 (TF32 off) through the
   kernels and through their plain versions; the two must agree to 1e-5;
6. one flagship eval batch — 128 solid-ellipsoid shapes, CUDA-event median;
6b. the dense-input plan (``data.voxel_transfer=packed``,
    ``VoxelCNNEncoder.tile_sparse=true``) with phase 4's weights: the index
    in bf16 with launches per batch (K7 4, K2-global 4, K1 5, per-sample K2
    0), in f32 against its plain path (1e-5) and against phase 5's
    windowed_compact f32 index (``CROSS_PLAN_TOL``), one ellipsoid batch
    with and without the tile-sparse blocks, and the ``dense`` transfer's
    host densify and copy of one batch;
7. training — ``Trainer.fit`` for one epoch of the 256-model synthetic
   train split (768 captions: 6 steps of 128) at the flagship widths, bf16,
   ``use_pallas=true``; per-step losses (finite), CUDA-event step times and
   launches (K1 5, K2 2, K3 5, pair forward 3, two-term backward 6, K4/K5/K6
   alone 0 a step), peak memory; the
   launch counts are reset just before ``fit`` and read just after it;
8. the trained checkpoint (the fit's best ``epoch=0.ckpt``) serves:
   ``RetrievalServer.from_checkpoint`` builds an index and answers a query;
9. train plain path — one f32 train step (TF32 off, deterministic cuDNN)
   through the kernels and through their plain versions from the same
   state: losses, gradients and running variances within stated tolerances;
10. one flagship train step on 128 solid ellipsoids, CUDA-event median,
    and a ``torch.profiler`` breakdown of one such step;
10b. dense-plan training — ``Trainer.fit`` for one epoch on the packed
    transfer with tile-sparse blocks 1-2 (launches a step exactly K7 4,
    K2-global 4, K1 5, K3 5, pair forward 3, two-term backward 6, per-sample
    K2 and K4/K5/K6 alone 0), the f32 step
    kernel-vs-plain with phase 9's tolerances, a profiled step;
10c. a diagnostic beside the main path: the windowed and dense-plan train
    steps with ``VoxelCNNEncoder.explicit_dgrad`` set off and on (whatever
    the config default), a profile of
    one explicit-dgrad dense-plan step (top device kernels and operators,
    idle share, the port kernels' share), and block 2's input gradient alone
    both ways with the kernels that compute it;
10d. the training-run lifecycle — Bi(V) on ``data=structured
    data.num_models=150`` at the flagship widths (450 captions, 3 steps an
    epoch): ``Trainer.fit`` for 2 epochs with validation every epoch (finite
    val losses), async top-1 and ``last.ckpt`` saves, launches a step
    exactly K1 5, K2 2, K3 5, pair forward 1, two-term backward 2; then the
    train CLI with ``+auto_resume`` to epoch 3 (step and Adam step 9 in
    ``last.ckpt``); ``python -m tricolo_tpu_torch.test`` on the best
    checkpoint with ``inference.device_eval=true`` and ``python -m
    tricolo_tpu_torch.eval`` (which ranks on the card) on its ``output.p``
    (equal metrics); the device ranking against the numpy
    metrics (RR exact, NDCG and MRR within 1e-6); the split's k and T and
    the step's CUDA-event median; its launch counts are reset just before
    the fit and the resumed run and read just after each;
10e. the unmasked (all-site BN) flagship — Tri(I+V) with
    ``VoxelCNNEncoder.masked_bn=false data.voxel_transfer=packed``, bf16,
    random weights: the synthetic-256 index with launches per batch exactly
    K1-unmasked 5 and every other kernel 0, the f32 index kernel-vs-plain
    (1e-5), one ellipsoid eval batch, ``Trainer.fit`` for one epoch (6
    steps; launches a step exactly K1-unmasked 5, K3-unmasked 5, pair
    forward 3, two-term backward 6, every other kernel 0; finite losses,
    CUDA-event step median, peak memory), the f32 step kernel-vs-plain with
    phase 9's tolerances, a profiled step;
10f. the CLIP flagship — Tri(CLIP-I+V): ``model.text_encoder=CLIPTextEncoder
    model.image_encoder=CLIPImageEncoder`` at the flagship widths (CLIP heads
    768 → 512 → 512, dropout 0.1, over the synthetic split's seeded 768-d
    features; the voxel encoder of phase 7), bf16, random weights: the
    synthetic-256 index with launches per batch exactly K1 5 and K2 2
    (every other kernel 0), four token queries through a stub CLIP text
    backend (a fixed seeded projection of the 77 token ids), the f32 index
    kernel-vs-plain (1e-5), ``Trainer.fit`` for one epoch (6 steps; a step
    exactly K1 5, K2 2, K3 5, pair forward 3, two-term backward 6, K4/K5/K6
    alone 0; finite losses, CUDA-event step median, peak memory), the fit's
    best checkpoint served through ``RetrievalServer.from_checkpoint``, the
    f32 step kernel-vs-plain from one dropout generator seed with phase 9's
    tolerances, and a profiled step; its index build and fit also require
    pinned copies and one C++ sweep a batch;
11. host path — the host loader (``csrc/host_loader.cpp``) built with g++
    on the card's host; its four sweeps (windowed_compact halo 3, windowed
    halo 1 and 3, dense, and the RGBA packing of each sample's grid)
    bit-exact against their numpy versions on the flagship synthetic-256
    val batch and a structured-300 train batch, each timed (C++ median of
    5, numpy the one run that is compared) beside the host CPU model and thread count;
12. data parallel (``tricolo_tpu_torch.parallel``), each rank a subprocess
    of this script (``--dp-rank``): 12a, the flagship Tri(I+V) (synthetic-256,
    windowed_compact) in a 1-rank NCCL world beside the non-parallel
    ``Trainer`` in the same process: bf16 steps in turns over the epoch's
    six batches (step medians of 2-6; 1-rank launches a step exactly K1 5,
    K2 2, K3 5, pair 3, two-term 6); one bf16 step with
    ``precision.remat_voxel`` off and on (a remat step: K1 10, K2 4, K3 5,
    pair 3, two-term 6; peak memory of both); then, from the non-parallel
    trainer's weights after its six steps, one f32 step each on the first
    batch (TF32 off, deterministic cuDNN; the non-parallel one twice for the
    run-to-run floor): bit-equal where that floor is 0, else within phase
    9's tolerances; and the non-parallel step on its batch reordered, each
    gradient's rounding spread (also at the seeded init). 12b, two gloo
    ranks both on cuda:0, global batch 128 (64 a rank): one f32 step on
    each rank's stripe from those weights against the non-parallel f32
    step: losses and running variances under phase 9's tolerances, each
    gradient within phase 9's 1e-3 of max or ``DP_SPREAD`` times its
    rounding spread; the ranks' gradients equal, launches exactly as above
    a rank with the loss kernels planned for B = 128; then one bf16 epoch
    through ``Trainer.fit`` on both ranks (6 steps, launches a step as
    above, rank 0 alone writing the checkpoint);
13. the reference's other image backbones and the triplet loss, Tri(I+V)
    at the flagship widths (synthetic-256, B = 128, 6×128² views, 64³
    voxels windowed_compact, bf16, random weights): 13a ResNet50 with
    ``loss.name=TripletLoss`` and 13b EfficientNet-B3 with NT-Xent, each
    through the index (launches per batch exactly K1 5 and K2 2, every
    other kernel 0; four token queries and one image query; the f32 index
    kernel-vs-plain, 1e-5), ``Trainer.fit`` for one epoch (a step exactly
    K1 5, K2 2, K3 5 and, for NT-Xent, pair 3 and two-term 6; finite
    losses, step median, peak memory; every stochastic-depth draw from the
    step's generator), the fit's checkpoint served with an image query, the
    f32 step kernel-vs-plain under phase 9's tolerances (with its max |Δ|;
    a gradient below ``ZERO_GRAD`` of the step's largest, an exact 0, must
    stay below it on both paths) and a profiled step; 13c ResNet34 and
    EfficientNet-B0: the index (launches as above), the CUDA-event median
    of 10 eval batches and two bf16 train steps with finite losses;
14. the C13/128³ configuration (the README's recipe: ``data=text2shape_c13
    data.voxel_size=128 data.batch_size=32 precision.remat_voxel=true
    data.voxel_transfer=windowed_compact``, Tri(I+V), bf16, random weights)
    over a C13-shaped fixture the script writes (13 categories × 8 models,
    solid-ellipsoid voxel32/64/128 members, seeded views, the ellipsoids'
    OBJs; ``data/fixture.py``): 14a the val split through the fused npz
    reader (one call a model) and through ``np.load`` + the RGBA sweep,
    bit-exact, host ms of both; 14b K1 and K3 at the five 128³ blocks and
    K2 per-sample onto the 32³ grid, shaped by a real train batch (T = B·k
    rows) and on its ids, bit-exact in f32 and bf16, timed beside the
    bound; 14c the val index (launches per batch exactly K1 5 and K2 2;
    its wall by part), the f32 index kernel-vs-plain (1e-5), one epoch
    through ``Trainer.fit`` (a remat step exactly K1 10, K2 4, K3 5, pair 3,
    two-term 6; finite losses, step median of 2-6 and pairs/s, peak memory,
    the train loop's device idle share), one bf16 step with remat off and
    on (peak memory, bytes saved for the backward), a profiled step, the
    host sweep and pin of one batch, the f32 step kernel-vs-plain with
    phase 9's tolerances; 14d ``python -m tricolo_tpu_torch.test`` on the
    fit's checkpoint (``nearest.jsonl``), ``python -m
    tricolo_tpu_torch.calculate_f1`` over it and the fixture's OBJs on the
    card (the mean F1@0.1), and each scored pair's threshold decisions
    against a float64 k-d tree oracle on the host (the port's search, and
    beside the path the f32 expansion with TF32 off and on);
15. bf16 parameters (``precision.param_dtype=bfloat16``) on the flagship
    Tri(I+V) (synthetic-256, windowed_compact, masked BN): 15a a seeded
    bf16 model saved as a port checkpoint, served by
    ``RetrievalServer.from_checkpoint``: its bf16 index (launches per batch
    exactly K1 5 and K2 2, every other kernel 0), four token queries and
    one image query; 15b one epoch through ``Trainer.fit`` at bf16 compute
    (a step exactly K1 5, K2 2, K3 5, pair 3, two-term 6; finite losses,
    step median of 2-6 and pairs/s, peak memory) and a profiled step,
    beside phase 7's f32-parameter numbers (reported, not a gate); 15c the
    index at f32 compute through the kernels and the plain path (1e-5) and
    one f32-compute step kernel-vs-plain with phase 9's tolerances (each
    bf16 gradient element also allowed one bf16 ulp: each path rounds its
    f32 gradient once), its updated bf16 parameters each within one bf16 ulp or within 2·lr and one
    ulp, at most ``BF16_BEYOND_ULP`` of them beyond one ulp (the counts
    printed); 15d parameters and Adam's moments bf16, BN running
    statistics f32, on the card;
16. FSDP (``parallel.param_sharding=fsdp``) on the flagship Tri(I+V)
    (synthetic-256, windowed_compact, masked BN, global batch 128), each
    rank a subprocess of this script (``--dp-rank``) as in phase 12: 16a a
    1-rank NCCL world at f32 and at bf16 parameters, a replicated and an
    FSDP trainer from the same seed: bf16 steps in turns over the epoch's
    six batches (medians of steps 2-6; every step exactly K1 5, K2 2, K3 5,
    pair 3, two-term 6; each step's peak above its start), the sharded
    leaves and elements, the bytes of parameters and moments, bf16
    parameters and moments on the card; then one f32 step each from the
    replicated trainer's weights after its six steps (TF32 off,
    deterministic cuDNN; the replicated one twice for the run-to-run
    floor): bit-equal where that floor is 0, else within phase 9's
    tolerances; one FSDP remat step (K1 10, K2 4, K3 5, pair 3, two-term
    6). 16b two gloo ranks on cuda:0, 64 rows each: one f32 FSDP step
    against the replicated two-rank step from 16a's weights, bit-equal
    (a gradient element is the sum of two terms, which commutes; Adam is
    elementwise), launches as above, each rank's local elements equal to
    ``fsdp_axis``'s arithmetic. 16c one bf16 epoch through ``Trainer.fit``
    on both ranks under FSDP (6 steps, launches a step as above, rank 0
    alone writing the checkpoint, whose tensors are whole), then that
    checkpoint served: index launches per batch exactly K1 5 and K2 2, the
    f32 index kernel vs plain (1e-5);
17. the measuring entry points as a user runs them, each a subprocess:
    ``python -m tricolo_tpu_torch.bench`` at the flagship widths (2
    warm-up steps, N = 4, 2 two-point pairs) on the default
    windowed_compact transfer and on the dense plan, each with ``--trace``
    and ``python -m tricolo_tpu_torch.trace_report --json`` on that trace,
    and ``python -m tricolo_tpu_torch.bench_loader`` in ``--mode host``
    and ``--mode e2e`` over 6 batches: each prints exactly one JSON line;
    the bench's are not salvaged, hold 2 pairs and this card's name, with
    launches per timed step exactly phase 7's (K1 5, K2 2, K3 5, pair 3,
    two-term 6) and the dense plan's (K7 4, K2-global 4, K1 5, K3 5, pair
    3, two-term 6); the traces show device time in K1-K6 (default) and K7
    (dense plan); the readings beside phase 7's and phase 10's steps;
18. the tools' short forms, each through its CLI: 18a ``bench --roofline``
    on the default config (2 warm-up steps, N = 4, 1 pair), then
    ``roofline_report --json``: at least 0.95 of device time attributed to
    a counted op, rows for K1, K2, K3, the pair forward and the two-term
    backward (and no other port kernel) with launches a step exactly phase
    7's, each K row's floor equal to the kernel module's ``work(...)``
    summed over its recorded launches (and, for K1, K3 and the loss
    kernels, at phase 3's block shapes for the bench's k), no row above
    105% of its floor, under 0.1 ms a step of floor in ops that launched
    nothing, a floor share in (0, 1], ``convolution_backward`` counted with
    device time (the autograd thread's ops reach the counter), device ms a
    step within 10% of phase 17's trace; 18b ``profile_step --iters 3``:
    every row finite and > 0, the full step within 10% of phase 17's
    bench; 18c ``profile_voxel_blocks --iters 3`` (five blocks, B 128):
    every cell > 0, the kernel columns launching K1's unmasked entry once
    and (with the backward) K3's once, the other columns nothing; 18d
    ``measure_collectives`` over gloo worlds 1 and 2 and one NCCL rank: the
    gathered bytes equal the JAX formula; 18e ``dryrun 2 --device cuda``
    (two gloo ranks on cuda:0): all five modes and every check; 18f
    ``dress_rehearsal`` at scale 0.01 (68 train / 15 val models), one
    epoch: rc 0 and the report holds every key (the split is deleted);
    18a-c run alone in turn, 18d-f at once (their gates time nothing);
19. the kernels line (ten rows: K1-K7, K2's global entry, and K1's and
    K3's unmasked entries; K7's ``library_ms`` is its yardstick's; the row
    of K4 counts the pair launches, each of which computes K4 twice, and carries
    the pair entry's times, the rows of K5 and K6 likewise the two-term
    launches and times), then the card line, then
    ``{"ok": true, ...}``.

Details go to ``chiprun_out/chip_smoke.json``. The script imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
F32_TOL = 1e-5
# K4-K6 (and the pair forward, the two-term backward) against their plain
# versions: the logits' 512-term dot products and
# the B-term sums run in another order (errors ~1e-6 relative per logit,
# carried through exp by at most |logit| <= 1/τ = 10).
NT_XENT_TOL = 1e-4
INV_TAU = 10.0
# One f32 train step, kernel path vs plain path from the same state. Only
# the NT-Xent kernels differ from their plain versions (K1-K3 are
# bit-exact): the losses
# to f32 rounding of the logsumexps; the gradients by that relative error
# carried back through the encoders (per tensor, of its largest magnitude);
# the running variances come from the bit-identical forward.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
TRAIN_VAR_TOL = 1e-6
# A gradient whose largest magnitude is below this share of the step's
# largest gradient is an exact 0 in f32 rounding noise (EfficientNet-B3's
# bn_project biases: 5e-9 to 4.3e-7 of it): both paths must keep it below
# this floor, where a deviation relative to its own max would be noise
# over noise.
ZERO_GRAD = 1e-5
# bf16 parameters (phase 15): the share of updated parameter elements that
# may lie beyond one bf16 ulp between two steps from one state (each within
# 2·lr: Adam's first step on a gradient near zero or near eps).
BF16_BEYOND_ULP = 1e-3
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
# The dense-input plan: packed transfer, tile-sparse blocks 1-2.
DENSE = [
    "data.voxel_transfer=packed",
    "model.modules.VoxelCNNEncoder.tile_sparse=true",
]
# The dense-plan f32 index against the windowed_compact f32 index from the
# same weights: both plans are exact restrictions of the dense masked path,
# so only convolution rounding (another cuDNN algorithm on other tile
# shapes) separates them.
CROSS_PLAN_TOL = 1e-4
TRAIN = [
    "loss.NTXentLoss.use_pallas=true",
    "trainer.max_epochs=1",
    "experiment_name=chip_smoke",
    f"project_root_path={ROOT / 'build' / 'chip_smoke'}",
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
    """K1 against its plain version, bit-exact in f32 and bf16 with idx off
    and on; timed in bf16 in both forms: eval (idx off, serving) and train
    (idx on, the train step's). Rows of ``plan`` windowed_compact in the
    eval form are the kernels line's total, as in earlier runs."""
    from tricolo_tpu_torch.ops import bn_relu_pool, bn_relu_pool_plain
    from tricolo_tpu_torch.ops.bn_relu_pool import work

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, rows = 0.0, []
    for plan, name, shape, two in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_inputs(torch, shape, dtype, two, gen)
            for want_idx in (False, True):
                got = bn_relu_pool(*args, want_idx=want_idx)
                torch.cuda.synchronize()
                ref = bn_relu_pool_plain(*args, want_idx=want_idx)
                for a, b in zip(got, ref):
                    err = (a.float() - b.float()).abs().max().item()
                    max_err = max(max_err, err)
                    require(torch.equal(a, b), f"K1 {plan} {name} {dtype} idx={want_idx}: "
                            f"kernel != plain (max err {err})")
                del got, ref
            if dtype != torch.bfloat16:  # the main path's dtype is timed
                del args
                torch.cuda.empty_cache()
                continue
            y = args[0]
            for form, want_idx in (("eval", False), ("train", True)):
                bound = (work("K1", shape, y.element_size(), 2 if two else 1, want_idx)[0]
                         / HBM_BYTES_PER_S * 1e3)
                ms = time_ms(lambda: bn_relu_pool(*args, want_idx=want_idx), torch,
                             flush=flush)
                plain = time_ms(lambda: bn_relu_pool_plain(*args, want_idx=want_idx), torch,
                                repeats=5, flush=flush)
                rows.append({"plan": plan, "block": name, "form": form, "shape": list(shape),
                             "masks": 2 if two else 1, "dtype": "bf16", "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "main": plan == "windowed_compact" and form == "eval"})
                log(f"  K1 {plan:16s} {name:6s} {form:5s} {tuple(shape)} bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms, {bound / ms:.0%} of bound)")
            del args, y
            torch.cuda.empty_cache()
    return max_err, rows


def check_k2(torch, ids, grid, flush):
    from tricolo_tpu_torch.ops import scatter_tiles_ps, scatter_tiles_ps_plain
    from tricolo_tpu_torch.ops.tile_scatter import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, k = ids.shape
    n_valid = int(((ids >= 0) & (ids < (grid // 2) ** 3)).sum())
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
                # Only the rows with a valid id are read (padding rows never).
                bound = (work(n_valid, 2, C, tiles.element_size(), ids.numel(), B, grid)[0]
                         / HBM_BYTES_PER_S * 1e3)
                ms = time_ms(lambda: scatter_tiles_ps(tiles, ids, grid), torch, flush=flush)
                plain = time_ms(lambda: scatter_tiles_ps_plain(tiles, ids, grid), torch,
                                repeats=5, flush=flush)
                rows.append({"tensor": name, "shape": list(tiles.shape), "grid": grid,
                             "valid_rows": n_valid, "dtype": "bf16", "ms": ms,
                             "plain_ms": plain, "bound_ms": bound})
                log(f"  K2 {name:4s} {tuple(tiles.shape)} ({n_valid} valid rows) -> {grid}^3 "
                    f"bf16: {ms:.4f} ms (plain {plain:.4f} ms, bound {bound:.4f} ms, "
                    f"{bound / ms:.0%} of bound)")
    return max_err, rows


def k3_inputs(torch, shape, dtype, two_masks, gen):
    """K1's argmax of quantized activations with dead windows (ties in
    every window), the cotangent at live pooled cells, random per-channel
    coefficients."""
    from tricolo_tpu_torch.ops import bn_relu_pool

    y, mul, add, zmask, smask = k1_inputs(torch, shape, dtype, two_masks, gen)
    pooled, _, idx = bn_relu_pool(y, mul, add, zmask, smask, want_idx=True)
    ga = torch.randn(pooled.shape, generator=gen, device="cuda") * (pooled > 0)
    C = shape[-1]
    vec = lambda s, o: torch.randn(C, generator=gen, device="cuda") * s + o  # noqa: E731
    stats = zmask if smask is None else smask
    return y, ga.to(dtype), idx, stats, vec(1e-3, 0.0), vec(1e-3, 0.0), vec(0.3, 1.0), vec(0.3, 0.0)


def check_k3(torch, shapes, flush):
    """K3 against its plain version, bit-exact in f32 and bf16, timed in
    bf16; rows of ``plan`` windowed_compact are the kernels line's total."""
    from tricolo_tpu_torch.ops import bn_relu_pool_bwd, bn_relu_pool_bwd_plain
    from tricolo_tpu_torch.ops.bn_relu_pool import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    max_err, rows = 0.0, []
    for plan, name, shape, two in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = k3_inputs(torch, shape, dtype, two, gen)
            got = bn_relu_pool_bwd(*args)
            torch.cuda.synchronize()
            ref = bn_relu_pool_bwd_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, ref), f"K3 {plan} {name} {dtype}: kernel != plain ({err})")
            del got, ref
            if dtype == torch.bfloat16:  # the main path's dtype
                bound = work("K3", shape, args[0].element_size(), 1)[0] / HBM_BYTES_PER_S * 1e3
                ms = time_ms(lambda: bn_relu_pool_bwd(*args), torch, flush=flush)
                plain = time_ms(lambda: bn_relu_pool_bwd_plain(*args), torch, repeats=5,
                                flush=flush)
                rows.append({"plan": plan, "block": name, "shape": list(shape), "dtype": "bf16",
                             "ms": ms, "plain_ms": plain, "bound_ms": bound,
                             "main": plan == "windowed_compact"})
                log(f"  K3 {plan:16s} {name:7s} {tuple(shape)} bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms, {bound / ms:.0%} of bound)")
            del args
            torch.cuda.empty_cache()
    return max_err, rows


def k1_unmasked_inputs(torch, shape, dtype, gen):
    """Quantized activations (exact ties), dead windows (every member below
    the ReLU) and one γ = 0 channel (mul 0, add > 0: eight tied members),
    folded BN from random statistics."""
    from tricolo_tpu_torch.ops import fold_bn

    N, D, H, W, C = shape
    y = torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int8)
    y = y.to(dtype) / 8.0
    y[:, :2, :2, :2] = -4.0
    scale = torch.rand(C, generator=gen, device="cuda") + 0.5
    bias = torch.randn(C, generator=gen, device="cuda") * 0.3
    scale[0], bias[0] = 0.0, 0.5
    mean = torch.randn(C, generator=gen, device="cuda") * 0.3
    var = torch.rand(C, generator=gen, device="cuda") * 1.5 + 0.5
    mul, add = fold_bn(scale, bias, mean, var, 1e-5, dtype)
    return y, mul, add


def check_k1_unmasked(torch, shapes, flush):
    """K1's unmasked entry against its plain version, bit-exact in f32 and
    bf16 with idx off and on; timed in bf16 in both forms (eval: idx off,
    serving; train: idx on). Bound: y read once, pooled (and idx) written
    once."""
    from tricolo_tpu_torch.ops import bn_relu_pool_plain, bn_relu_pool_unmasked
    from tricolo_tpu_torch.ops.bn_relu_pool import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    max_err, rows = 0.0, []
    for name, shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_unmasked_inputs(torch, shape, dtype, gen)
            for want_idx in (False, True):
                got = bn_relu_pool_unmasked(*args, want_idx=want_idx)
                torch.cuda.synchronize()
                ref = bn_relu_pool_plain(*args, want_idx=want_idx)
                pairs = zip(got, ref) if want_idx else [(got, ref)]
                for a, b in pairs:
                    err = (a.float() - b.float()).abs().max().item()
                    max_err = max(max_err, err)
                    require(torch.equal(a, b), f"K1-unmasked {name} {dtype} idx={want_idx}: "
                            f"kernel != plain (max err {err})")
                del got, ref
            if dtype == torch.bfloat16:  # the main path's dtype is timed
                y = args[0]
                for form, want_idx in (("eval", False), ("train", True)):
                    bound = (work("K1", shape, y.element_size(), 0, want_idx)[0]
                             / HBM_BYTES_PER_S * 1e3)
                    ms = time_ms(lambda: bn_relu_pool_unmasked(*args, want_idx=want_idx),
                                 torch, flush=flush)
                    plain = time_ms(lambda: bn_relu_pool_plain(*args, want_idx=want_idx),
                                    torch, repeats=5, flush=flush)
                    rows.append({"block": name, "form": form, "shape": list(shape),
                                 "dtype": "bf16", "ms": ms, "plain_ms": plain, "bound_ms": bound})
                    log(f"  K1-unmasked {name:6s} {form:5s} {tuple(shape)} bf16: {ms:.4f} ms "
                        f"(plain {plain:.4f} ms, bound {bound:.4f} ms, {bound / ms:.0%} of bound)")
                del y
            del args
            torch.cuda.empty_cache()
    return max_err, rows


def check_k3_unmasked(torch, shapes, flush):
    """K3's unmasked entry against its plain version, bit-exact in f32 and
    bf16, on K1-unmasked's argmax of ``k1_unmasked_inputs`` (ties, dead
    windows, the γ = 0 channel, whose A, B and C are 0: ga, bcoef and ccoef
    are zero there); timed in bf16. Bound: y, ga and idx read once, dy
    written once."""
    from tricolo_tpu_torch.ops import (bn_relu_pool_bwd_plain, bn_relu_pool_bwd_unmasked,
                                       bn_relu_pool_unmasked)
    from tricolo_tpu_torch.ops.bn_relu_pool import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    max_err, rows = 0.0, []
    for name, shape in shapes:
        C = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            y, mul, add = k1_unmasked_inputs(torch, shape, dtype, gen)
            pooled, idx = bn_relu_pool_unmasked(y, mul, add, want_idx=True)
            ga = torch.randn(pooled.shape, generator=gen, device="cuda") * (pooled > 0)
            ga[..., 0] = 0.0
            del pooled, mul, add
            vec = lambda s, o: torch.randn(C, generator=gen, device="cuda") * s + o  # noqa: E731
            bcoef, ccoef = vec(1e-3, 0.0), vec(1e-3, 0.0)
            bcoef[0] = ccoef[0] = 0.0
            args = (y, ga.to(dtype), idx, bcoef, ccoef, vec(0.3, 1.0), vec(0.3, 0.0))
            del ga
            got = bn_relu_pool_bwd_unmasked(*args)
            torch.cuda.synchronize()
            ref = bn_relu_pool_bwd_plain(*args[:3], None, *args[3:])
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, ref), f"K3-unmasked {name} {dtype}: kernel != plain ({err})")
            del got, ref
            if dtype == torch.bfloat16:  # the main path's dtype
                bound = work("K3", shape, y.element_size(), 0)[0] / HBM_BYTES_PER_S * 1e3
                ms = time_ms(lambda: bn_relu_pool_bwd_unmasked(*args), torch, flush=flush)
                plain = time_ms(lambda: bn_relu_pool_bwd_plain(*args[:3], None, *args[3:]),
                                torch, repeats=5, flush=flush)
                rows.append({"block": name, "shape": list(shape), "dtype": "bf16", "ms": ms,
                             "plain_ms": plain, "bound_ms": bound})
                log(f"  K3-unmasked {name:6s} {tuple(shape)} bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms, {bound / ms:.0%} of bound)")
            del args, y, idx
            torch.cuda.empty_cache()
    return max_err, rows


def check_nt_xent(torch, sizes, flush):
    """K4-K6, the pair forward and the two-term backward against their
    plain versions on L2-normalised f32 (B, D) embeddings; bound = flops /
    67 TFLOP/s (2B²D each forward, the pair included: its column
    statistics reuse the logits; 4B²D each backward, the two-term one
    included: one logits and one coefficient product), the bytes being far
    smaller. The pair's plain version materialises the logits once and
    reduces them both ways; the two-term entry's is K5's plus K6's (the
    logits twice)."""
    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.ops.nt_xent import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs = dict.fromkeys(("nt_xent_fwd", "nt_xent_fwd_pair", "nt_xent_bwd_rows",
                          "nt_xent_bwd_cols", "nt_xent_bwd"), 0.0)
    rows = {name: [] for name in errs}
    for B, D in sizes:
        zi, zj = (torch.nn.functional.normalize(
            torch.randn((B, D), generator=gen, device="cuda"), dim=-1) for _ in range(2))
        lse = ops.nt_xent_fwd_plain(zi, zj, INV_TAU)[:, 1].contiguous()
        lse_b = ops.nt_xent_fwd_plain(zj, zi, INV_TAU)[:, 1].contiguous()
        scale = torch.tensor([0.25 * INV_TAU / B], device="cuda")
        scales = torch.tensor([0.25 * INV_TAU / B, 0.75 * INV_TAU / B], device="cuda")
        cases = [
            ("nt_xent_fwd", ops.nt_xent_fwd, ops.nt_xent_fwd_plain, (zi, zj, INV_TAU)),
            ("nt_xent_fwd_pair", ops.nt_xent_fwd_pair, ops.nt_xent_fwd_pair_plain,
             (zi, zj, INV_TAU)),
            ("nt_xent_bwd_rows", ops.nt_xent_bwd_rows, ops.nt_xent_bwd_rows_plain,
             (zi, zj, lse, scale, INV_TAU)),
            ("nt_xent_bwd_cols", ops.nt_xent_bwd_cols, ops.nt_xent_bwd_cols_plain,
             (zj, zi, lse, scale, INV_TAU)),
            ("nt_xent_bwd", ops.nt_xent_bwd, ops.nt_xent_bwd_plain,
             (zi, zj, lse, lse_b, scales, INV_TAU)),
        ]
        for name, kernel, plain, args in cases:
            got = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            err = (got - ref).abs().max().item()
            limit = NT_XENT_TOL * ref.abs().max().item()
            require(err <= limit, f"{name} B={B}: max |kernel - plain| {err} > {limit}")
            errs[name] = max(errs[name], err)
            moved, flops = work(name, B, D)
            bound = max(flops / F32_FLOPS, moved / HBM_BYTES_PER_S) * 1e3
            ms = time_ms(lambda: kernel(*args), torch, flush=flush)
            plain_ms = time_ms(lambda: plain(*args), torch, repeats=5, flush=flush)
            rows[name].append({"shape": [B, D], "dtype": "f32", "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound, "max_abs_err": err})
            log(f"  {name:16s} ({B}, {D}) f32: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                f"bound {bound:.4f} ms, {bound / ms:.1%} of bound), max |d| {err:.3g} "
                f"(limit {limit:.3g})")
    return errs, rows


def dense_plan_inputs(torch, batch, voxel_size, budget):
    """The dense-input plan's tensors at the flagship shapes, from one real
    ``packed`` batch: the densified block-1 input (RGB + zero pad channel)
    and occupancy, block-2's pooled occupancy, and the active tile ids."""
    from tricolo_tpu_torch.data.device_prep import prepare_device_batch
    from tricolo_tpu_torch.ops.tile_sparse import active_tile_ids

    voxels = prepare_device_batch(batch, voxel_size, torch.float32)["voxels"]
    x1 = torch.nn.functional.pad(voxels[..., :3], (0, 1)).contiguous()
    m1 = voxels[..., 3:].contiguous()
    B, D = m1.shape[:2]
    m2 = m1.reshape(B, D // 2, 2, D // 2, 2, D // 2, 2, 1).amax(dim=(2, 4, 6)).contiguous()
    ids = active_tile_ids(m1, 8, budget)
    n_active = int((ids < B * (D // 8) ** 3).sum())
    return x1, m1, m2, ids, n_active


def k7_library(torch, x, ids, tile, halo):
    """K7's one-call yardstick: ``aten::index`` over an ``unfold`` view of
    the grid padded by ``halo`` (the pad made here, outside any timed
    window), at ids clamped to valid ones. It leaves out the pad and the
    padding tiles' zeros, and returns (T, C, s, s, s), a permuted layout of
    the kernel's output. Returns the call and the mask of valid ids."""
    from tricolo_tpu_torch.ops.tile_gather import _decode

    B, D = x.shape[0], x.shape[1]
    s = tile + 2 * halo
    xp = torch.nn.functional.pad(x, (0, 0) + (halo, halo) * 3)
    windows = xp.unfold(1, s, tile).unfold(2, s, tile).unfold(3, s, tile)
    valid, b, tz, ty, tx = _decode(ids, B, D // tile)
    first = int(valid.nonzero()[0, 0]) if bool(valid.any()) else 0
    fill = lambda t: torch.where(valid, t, t[first])  # noqa: E731
    b, tz, ty, tx = fill(b), fill(tz), fill(ty), fill(tx)
    return lambda: windows[b, tz, ty, tx], valid


def check_k7(torch, cases, ids, n_active, flush):
    """K7 against its plain version, bit-exact in f32 and bf16; bound =
    (bytes written + the active tiles' interiors read once + ids) / HBM;
    library = ``k7_library`` (equal to the kernel on the valid rows)."""
    from tricolo_tpu_torch.ops import gather_tiles, gather_tiles_plain
    from tricolo_tpu_torch.ops.tile_gather import work

    max_err, rows = 0.0, []
    for name, x32, tile, halo in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = gather_tiles(x, ids, tile, halo)
            torch.cuda.synchronize()
            ref = gather_tiles_plain(x, ids, tile, halo)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, ref), f"K7 {name} {dtype}: kernel != plain ({err})")
            if dtype == torch.bfloat16:
                moved = work(n_active, tile, halo, x.shape[-1], x.element_size(), ids.numel())[0]
                bound = moved / HBM_BYTES_PER_S * 1e3
                ms = time_ms(lambda: gather_tiles(x, ids, tile, halo), torch, flush=flush)
                plain = time_ms(lambda: gather_tiles_plain(x, ids, tile, halo), torch,
                                repeats=5, flush=flush)
                library, valid = k7_library(torch, x, ids, tile, halo)
                lib_out = library().permute(0, 2, 3, 4, 1)
                require(torch.equal(lib_out[valid], got[valid]),
                        f"K7 {name}: the library yardstick != kernel on the valid rows")
                del lib_out
                lib_ms = time_ms(library, torch, flush=flush)
                rows.append({"tensor": name, "shape": list(x.shape), "out": list(got.shape),
                             "tile": tile, "halo": halo, "dtype": "bf16", "ms": ms,
                             "plain_ms": plain, "bound_ms": bound, "library_ms": lib_ms})
                log(f"  K7 {name:8s} {tuple(x.shape)} -> {tuple(got.shape)} bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms, "
                    f"{bound / ms:.0%} of bound)")
                del library, valid
            del x, got, ref
            torch.cuda.empty_cache()
    return max_err, rows


def check_k2_global(torch, cases, ids, n_active, batch, flush):
    """K2's global entry against its plain version, bit-exact in f32 and
    bf16; bound = (the active tiles read once + ids + grid written) / HBM:
    padding rows are never read."""
    from tricolo_tpu_torch.ops import scatter_tiles_global, scatter_tiles_global_plain
    from tricolo_tpu_torch.ops.tile_scatter import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    T = ids.shape[0]
    max_err, rows = 0.0, []
    for name, t, C, grid in cases:
        for dtype in (torch.float32, torch.bfloat16):
            tiles = torch.randn((T, t, t, t, C), generator=gen, device="cuda").to(dtype)
            got = scatter_tiles_global(tiles, ids, batch, grid)
            torch.cuda.synchronize()
            ref = scatter_tiles_global_plain(tiles, ids, batch, grid)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, ref), f"K2-global {name} {dtype}: kernel != plain ({err})")
            if dtype == torch.bfloat16:
                bound = (work(n_active, t, C, tiles.element_size(), T, batch, grid)[0]
                         / HBM_BYTES_PER_S * 1e3)
                ms = time_ms(lambda: scatter_tiles_global(tiles, ids, batch, grid), torch,
                             flush=flush)
                plain = time_ms(lambda: scatter_tiles_global_plain(tiles, ids, batch, grid),
                                torch, repeats=5, flush=flush)
                rows.append({"tensor": name, "shape": list(tiles.shape), "grid": grid,
                             "dtype": "bf16", "ms": ms, "plain_ms": plain, "bound_ms": bound})
                log(f"  K2g {name:8s} {tuple(tiles.shape)} -> {grid}^3 bf16: {ms:.4f} ms "
                    f"(plain {plain:.4f} ms, bound {bound:.4f} ms, {bound / ms:.0%} of bound)")
            del tiles, got, ref
            torch.cuda.empty_cache()
    return max_err, rows


# -------------------------------------------------------------- phase 4


def index_breakdown(torch, dm, model) -> dict:
    """Where an index build's wall time goes, through the loader
    ``RetrievalServer.build_index`` uses (prefetch thread, pinned
    batches): split construction, the wait for the next batch on the
    prefetch queue (``collate_s``: the collation the thread did not hide),
    the host→device copy (non_blocking from pinned memory, then
    synchronised), and the eval forward's device time (CUDA events).
    ``device_idle_share`` = 1 − forward device time / wall."""
    from tricolo_tpu_torch.inference import eval_step, shape_embedding_sum, to_device_batch

    wall = time.perf_counter()
    tic = time.perf_counter()
    dm.setup("test")
    parts = {"setup_s": time.perf_counter() - tic, "collate_s": 0.0, "h2d_s": 0.0,
             "forward_device_s": 0.0}
    batches = iter(dm.test_loader(pin_memory=True))
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


def reset_host_counts() -> None:
    from tricolo_tpu_torch import native, tracing

    native.reset_calls()
    tracing.reset_counts("to_device.")


def check_host_path(path: str, batches: int) -> dict:
    """Since ``reset_host_counts``: every array that reached
    ``to_device_batch`` came from pinned memory (no synchronous pageable
    copy), and each of the ``batches`` batches went through the C++
    windowed_compact sweep."""
    from tricolo_tpu_torch import native, tracing

    copies = {k: tracing.counter("to_device." + k) for k in ("pinned", "pageable")}
    calls = native.call_counts()
    require(copies["pageable"] == 0 and copies["pinned"] > 0,
            f"{path}: {copies['pageable']} arrays reached to_device_batch from pageable "
            f"memory, {copies['pinned']} from pinned memory")
    require(calls["packed_to_windowed_compact"] == batches,
            f"{path}: {calls['packed_to_windowed_compact']} C++ windowed_compact sweeps for "
            f"{batches} batches")
    return {"copies": copies, "sweeps": calls}


# -------------------------------------------------------------- phase 6


def ellipsoid_batch(cfg, n_points=8192, packed=False):
    """One flagship batch of 128 solid ellipsoids (``bench_data.host_batch``
    of seed ``SEED``): windowed_compact rows (halo 3), or with ``packed``
    the packed site/RGB words. Returns (batch, k = the max per-sample
    active tiles)."""
    from tricolo_tpu_torch.bench_data import host_batch
    from tricolo_tpu_torch.data.device_prep import windowed_compact_on_host
    from tricolo_tpu_torch.ops.tile_sparse import host_sample_tile_counts, sample_tile_budget

    batch = host_batch(cfg, n_points, seed=SEED)
    D = cfg.data.voxel_size
    k = sample_tile_budget("auto", (D // 8) ** 3,
                           max(host_sample_tile_counts(batch["voxel_flat"], D)))
    if not packed:
        flat, rgb = batch.pop("voxel_flat"), batch.pop("voxel_rgb")
        batch["voxel_rows"], batch["voxel_row_ids"], _ = windowed_compact_on_host(
            flat, rgb, D, k, halo=3)
    return batch, k


# ------------------------------------------------------------ phases 7-10

# A train step: 3 pairwise losses, each 1 pair-forward and 2 two-term
# backward launches (d_zis and d_zjs); K4, K5 and K6 alone are not on the
# path.
TRAIN_LAUNCHES = {"bn_relu_pool": 5, "scatter_tiles_ps": 2, "bn_relu_pool_bwd": 5,
                  "nt_xent_fwd": 0, "nt_xent_fwd_pair": 3, "nt_xent_bwd_rows": 0,
                  "nt_xent_bwd_cols": 0, "nt_xent_bwd": 6, "gather_tiles": 0,
                  "scatter_tiles_global": 0, "bn_relu_pool_unmasked": 0,
                  "bn_relu_pool_bwd_unmasked": 0}
# The dense-input plan, 2 sparse blocks: K7 for x and the mask of each, K2's
# global entry for each handoff, K1 in all five blocks; no per-sample K2.
DENSE_EVAL_LAUNCHES = {"bn_relu_pool": 5, "scatter_tiles_ps": 0, "bn_relu_pool_bwd": 0,
                       "nt_xent_fwd": 0, "nt_xent_fwd_pair": 0, "nt_xent_bwd_rows": 0,
                       "nt_xent_bwd_cols": 0, "nt_xent_bwd": 0, "gather_tiles": 4,
                       "scatter_tiles_global": 4, "bn_relu_pool_unmasked": 0,
                       "bn_relu_pool_bwd_unmasked": 0}
DENSE_TRAIN_LAUNCHES = dict(DENSE_EVAL_LAUNCHES, bn_relu_pool_bwd=5, nt_xent_fwd_pair=3,
                            nt_xent_bwd=6)


def timed_step(torch, step, rows):
    """Wrap a train step: CUDA-event time, host wall, launches and losses
    of every call go to ``rows``."""
    from tricolo_tpu_torch import ops

    def wrapped(batch, lr, *args):
        before = ops.launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        tic = time.perf_counter()
        start.record()
        losses = step(batch, lr, *args)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
        after = ops.launches()
        rows.append({"ms": start.elapsed_time(end), "wall_ms": wall_ms,
                     "launches": {k: after[k] - before[k] for k in after},
                     "losses": {k.split("/")[-1]: float(v) for k, v in losses.items()}})
        return losses

    return wrapped


def train_plain_compare(torch, cfg, batch) -> dict:
    """One f32 train step from the same state through the kernels and
    through their plain versions (TF32 off, deterministic cuDNN), each
    drawing its dropout and stochastic-depth masks from a generator of the
    same seed. Each gradient's deviation is of its own max, except for the
    exact zeros below ``ZERO_GRAD`` of the step's largest gradient."""
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import dropout_generator, make_optimizer, make_train_step

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.manual_seed(SEED)
    model = TriCoLoNet.from_config(cfg).cuda()
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for use_kernels in (True, False):
        model.load_state_dict(state0)
        model.voxel_encoder.use_kernels = use_kernels
        step = make_train_step(model, make_optimizer(cfg, model), cfg, use_kernels=use_kernels)
        losses = step(batch, cfg.optimizer.lr, dropout_generator(cfg.train_seed, 0, "cuda"))
        runs[use_kernels] = (
            {k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers() if n.endswith("running_var")},
            {n: p.detach().clone() for n, p in model.named_parameters()},
        )
        del step
    (loss_k, grad_k, var_k, new_k), (loss_p, grad_p, var_p, new_p) = runs[True], runs[False]
    loss_dev = max(abs(loss_k[n] / loss_p[n] - 1) for n in loss_p)
    top = max(g.abs().max().item() for g in grad_p.values())
    # A gradient below ZERO_GRAD of the step's largest is an exact 0 in f32
    # noise (EfficientNet's bn_project biases feed only later BNs' mean
    # subtraction): both paths must keep it below that floor; every other
    # gradient is held to its own max.
    floor = ZERO_GRAD * top
    zeros = {n: max(g.abs().max().item(), grad_k[n].abs().max().item()) / top
             for n, g in grad_p.items() if g.abs().max().item() < floor}
    per = {n: ((grad_k[n] - g).abs().max() / g.abs().max()).item()
           for n, g in grad_p.items() if n not in zeros}
    grad_dev = max(per.values())
    # A bf16 parameter's gradient is bf16 (JAX's cotangent of a bf16 leaf):
    # each path rounds its f32 gradient once, so an element may also lie one
    # bf16 ulp apart (2⁻⁷ of its magnitude at most) where the f32 values
    # straddle a rounding boundary.
    bf16 = {g.dtype for g in grad_p.values()} == {torch.bfloat16}
    ulp = torch.finfo(torch.bfloat16).eps if bf16 else 0.0
    past = {n: float(((grad_k[n].float() - g.float()).abs() - TRAIN_GRAD_TOL * g.abs().max()
                      - ulp * g.float().abs()).max())
            for n, g in grad_p.items() if n not in zeros}
    worst = [(n, d, grad_p[n].abs().max().item(), (grad_k[n] - grad_p[n]).abs().max().item())
             for n, d in sorted(per.items(), key=lambda kv: -kv[1])[:6]]
    var_dev = max((var_k[n] - v).abs().max().item() for n, v in var_p.items())
    max_abs = max([abs(loss_k[n] - v) for n, v in loss_p.items()]
                  + [(grad_k[n] - g).abs().max().item() for n, g in grad_p.items()]
                  + [(var_k[n] - v).abs().max().item() for n, v in var_p.items()])
    require(loss_dev <= TRAIN_LOSS_RTOL, f"train step losses: kernel vs plain {loss_dev}")
    require(all(v <= 0 for v in past.values()),
            f"train step gradients: kernel vs plain {grad_dev} of max (tol {TRAIN_GRAD_TOL}"
            + (" and one bf16 ulp" if bf16 else "") + ")")
    require(all(v < ZERO_GRAD for v in zeros.values()),
            f"train step exact-zero gradients past {ZERO_GRAD} of the largest: {zeros}")
    require(var_dev <= TRAIN_VAR_TOL, f"train step running_var: kernel vs plain {var_dev}")
    torch.backends.cudnn.deterministic = False
    out = {"loss_rel": loss_dev, "grad_rel_of_max": grad_dev, "running_var_abs": var_dev,
           "grad_gate_margin": max(past.values()),
           "max_abs": max_abs, "grad_max": top, "worst": worst, "zero_grads": zeros,
           "losses_kernel": loss_k, "losses_plain": loss_p}
    if {p.dtype for p in new_p.values()} == {torch.bfloat16}:
        out["bf16_updates"] = bf16_updates(torch, new_k, new_p, cfg.optimizer.lr)
    return out


def bf16_updates(torch, got: dict, ref: dict, lr: float) -> dict:
    """Two steps' updated bf16 parameters, element by element, in bf16
    steps (ulps): each within one ulp, or within 2·lr and one ulp (Adam's
    first step lr·g/(|g| + eps): a gradient that rounding moves across
    zero, or one of the size of eps, moves its parameter up to 2·lr),
    and at most ``BF16_BEYOND_ULP`` of the elements beyond one ulp.
    Returns how many differ at all and beyond one ulp."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    eps = torch.finfo(torch.bfloat16).eps
    differ = beyond = total = 0
    worst = 0.0
    for name, want in ref.items():
        ulps = (ordered(got[name]) - ordered(want)).abs()
        far = ulps > 1
        gap = (got[name].float() - want.float()).abs()
        excess = (gap - 2 * lr - eps * want.float().abs())[far]
        if excess.numel():
            worst = max(worst, float(gap[far].max()))
            require(bool((excess <= 0).all()), f"bf16 update {name}: {float(excess.max())} "
                    "past 2·lr and one ulp")
        differ += int((ulps > 0).sum())
        beyond += int(far.sum())
        total += ulps.numel()
    require(beyond <= BF16_BEYOND_ULP * total,
            f"bf16 updates: {beyond} of {total} elements beyond one ulp")
    return {"elements": total, "differ": differ, "beyond_one_ulp": beyond,
            "beyond_max_abs": worst}


def profile_step(torch, step, batch, lr) -> dict:
    """``torch.profiler`` over one train step: device time by kernel and the
    device busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tic = time.perf_counter()
        step(batch, lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    return profile_summary(prof.key_averages(), prof.key_averages(group_by_input_shape=True),
                           wall_us)


def profile_summary(rows, shape_rows, wall_us: float) -> dict:
    """A step's profile from ``key_averages()`` rows (``shape_rows``: grouped
    by input shape) and its host wall: device busy ms and idle share, the
    port kernels' ms (``trace_report.device_summary``, the arithmetic the
    trace report uses), the top device kernels and operators."""
    from tricolo_tpu_torch.trace_report import device_summary

    def device_us(event):
        return getattr(event, "self_device_time_total", None) or getattr(
            event, "self_cuda_time_total", 0.0)

    # Device-side events only (kernels, copies): an operator's own row also
    # carries the device time of the kernels it launched.
    events = [e for e in rows
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    events.sort(key=device_us, reverse=True)
    if not events:  # the profiler saw no device activity: nothing measured
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": None, "device_idle_share": None,
                "port_kernels_ms": None, "top": []}
    summary = device_summary(((e.key, device_us(e)) for e in events), wall_us)

    # The operators behind the device time, with their input shapes.
    def total_us(event):
        return getattr(event, "device_time_total", None) or getattr(
            event, "cuda_time_total", 0.0)

    op_rows = [e for e in shape_rows if e.key.startswith("aten::") and total_us(e) > 0]
    op_rows.sort(key=total_us, reverse=True)
    return {
        "wall_ms": wall_us / 1e3, **summary,
        "top": [{"name": e.key[:120], "device_ms": device_us(e) / 1e3, "count": e.count}
                for e in events[:25]],
        "top_ops": [{"op": e.key, "device_ms": total_us(e) / 1e3, "count": e.count,
                     "shapes": str(e.input_shapes)[:200]} for e in op_rows[:12]],
    }


# --------------------------------------------------- phases 6b, 10b, 10c


def dense_serving(torch, cfg, dense_cfg, dense_dm, model, index, windowed32, first, card):
    """The dense-input plan through ``RetrievalServer.build_index`` with the
    weights of phase 4's model: bf16 launches per batch, the f32 kernel path
    against its plain path and against the windowed_compact f32 index, one
    ellipsoid batch with and without tile-sparse blocks, and the dense
    transfer's host densify and copy of one batch."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data.device_prep import densify_on_host
    from tricolo_tpu_torch.inference import eval_step, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.ops.tile_sparse import host_tile_count
    from tricolo_tpu_torch.serving import RetrievalServer

    out: dict = {}
    dense_model = TriCoLoNet.from_config(dense_cfg)
    dense_model.load_state_dict(model.state_dict())
    server = RetrievalServer(dense_cfg, dense_model)  # device: cuda
    n_batches = len(dense_dm.test_loader())
    ops.reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    dense_index = server.build_index(dense_dm)
    torch.cuda.synchronize()
    out["index_build_s"] = time.perf_counter() - tic
    out["launches"] = launches = ops.launches()
    want = {name: n * n_batches for name, n in DENSE_EVAL_LAUNCHES.items()}
    require(launches == want, f"dense-plan index launches {launches} != {want}")
    require(dense_index.model_ids == index.model_ids, "dense-plan index lists other models")
    require(bool(np.isfinite(dense_index.matrix).all()), "dense-plan index non-finite")
    log(f"dense-plan index: {dense_index.matrix.shape} in {out['index_build_s']:.3f} s over "
        f"{n_batches} batches; launches {launches} [{card}]")
    bf16_matrix = dense_index.matrix.copy()

    dense_model.set_compute_dtype(torch.float32)  # TF32 is off since phase 5
    kernel32 = server.build_index(dense_dm).matrix.copy()
    dense_model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dense_dm).matrix.copy()
    dense_model.voxel_encoder.use_kernels = True
    dense_model.set_compute_dtype(torch.bfloat16)
    out["plain_vs_kernel_f32_max_abs"] = dev_plain = float(np.abs(kernel32 - plain32).max())
    out["vs_windowed_compact_f32_max_abs"] = dev_cross = float(np.abs(kernel32 - windowed32).max())
    out["bf16_vs_f32_max_abs"] = float(np.abs(bf16_matrix - kernel32).max())
    require(dev_plain <= F32_TOL, f"dense plan f32 kernel vs plain path: {dev_plain} > {F32_TOL}")
    require(dev_cross <= CROSS_PLAN_TOL,
            f"dense plan vs windowed_compact f32 index: {dev_cross} > {CROSS_PLAN_TOL}")
    log(f"dense plan f32: kernel vs plain max |d| = {dev_plain} (tol {F32_TOL}); vs the "
        f"windowed_compact index max |d| = {dev_cross} (tol {CROSS_PLAN_TOL}); bf16 vs f32 "
        f"{out['bf16_vs_f32_max_abs']}")

    host, k_ell = ellipsoid_batch(cfg, packed=True)
    batch = to_device_batch(host, torch.device("cuda"))
    out["ellipsoid"] = rows = {
        "k": k_ell, "active_tiles": host_tile_count(host["voxel_flat"], cfg.data.voxel_size)}
    nosparse = TriCoLoNet.from_config(load_config(
        FLAGSHIP + DENSE + ["model.modules.VoxelCNNEncoder.tile_sparse=false"])).cuda().eval()
    nosparse.load_state_dict(model.state_dict())
    dense_model.eval()
    for label, m in (("tile_sparse", dense_model), ("dense_masked", nosparse)):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eval_step(m, batch)
        per_batch = ops.launches()
        ms = time_ms(lambda: eval_step(m, batch), torch, repeats=10, warmup=2)
        rows[label] = {"ms": ms, "launches": per_batch,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"dense-plan eval batch (128 ellipsoids, {rows['active_tiles']} active tiles, "
            f"packed, {label}): {ms:.3f} ms, launches "
            f"{per_batch}, peak {rows[label]['peak_gib']:.2f} GiB [{card}]")
    require(rows["tile_sparse"]["launches"] == DENSE_EVAL_LAUNCHES,
            f"ellipsoid dense-plan launches {rows['tile_sparse']['launches']}")
    require(rows["dense_masked"]["launches"]["bn_relu_pool"] == 5
            and rows["dense_masked"]["launches"]["gather_tiles"] == 0,
            "tile_sparse=false must run all five blocks dense")
    del nosparse, batch

    tic = time.perf_counter()
    grid = densify_on_host(first["voxel_flat"], first["voxel_rgb"], cfg.data.voxel_size)
    out["dense_transfer_densify_s"] = time.perf_counter() - tic
    torch.cuda.synchronize()
    tic = time.perf_counter()
    torch.from_numpy(grid.view(np.int32)).cuda()
    torch.cuda.synchronize()
    out["dense_transfer_h2d_s"] = time.perf_counter() - tic
    out["dense_transfer_bytes"] = int(grid.nbytes)
    log(f"dense transfer, one batch: host densify {out['dense_transfer_densify_s']:.4f} s, "
        f"H2D of {grid.nbytes / 1e6:.1f} MB {out['dense_transfer_h2d_s']:.4f} s [{card}]")
    return out


def dense_training(torch, card):
    """One dense-plan epoch (6 steps of 128, bf16, use_pallas) through
    ``Trainer.fit`` with per-step launches, the f32 kernel-vs-plain step
    and a profiled step. Returns (report, trainer, step, device batch)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    train_cfg = load_config(FLAGSHIP + DENSE + TRAIN + ["experiment_name=chip_smoke_dense"])
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    trainer.train_step = timed_step(torch, step, steps)
    dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tic = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(len(steps) == 6, f"one dense-plan epoch ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"dense-plan train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == DENSE_TRAIN_LAUNCHES,
                f"dense-plan train step {i}: launches {row['launches']} != "
                f"{DENSE_TRAIN_LAUNCHES}")
        log(f"  dense-plan train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) "
            "losses " + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    out = {"steps": steps, "step_ms_median_2_6": step_ms,
           "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
           "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
           "launches_fit": fit_launches, "val_rr5": trainer.metrics.summary("")["RR@5"],
           "fit_s": fit_s}
    log(f"dense-plan train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{out['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB, launches/step "
        f"{steps[-1]['launches']}, fit {fit_s:.1f} s [{card}]")

    batch = to_device_batch(next(iter(dm.train_loader())), torch.device("cuda"))
    cfg32 = load_config(FLAGSHIP + DENSE + TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    log(f"dense-plan train plain path (f32, TF32 off, deterministic): losses rel "
        f"{cmp['loss_rel']:.3g}, grads rel-of-max {cmp['grad_rel_of_max']:.3g}, running_var "
        f"|d| {cmp['running_var_abs']:.3g}")
    torch.cuda.empty_cache()
    lr = train_cfg.optimizer.lr
    step(batch, lr)  # warm the bf16 path after the f32 phase
    out["profile"] = prof = profile_step(torch, step, batch, lr)
    log(f"profiled dense-plan train step: device busy {prof['device_busy_ms']} ms of "
        f"{prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port kernels "
        f"{prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:10]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in prof["top_ops"][:6]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    return out, trainer, step, batch


def block2_dgrad(torch, rows, flush):
    """Block 2's VALID conv input gradient alone at the flagship shape
    (bf16, channels-last): autograd's transposed convolution against the
    explicit forward conv — CUDA-event times of each, and the kernels the
    profiler sees (the transposed one profiled with its forward conv, as
    a train step runs it)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    bf16 = torch.bfloat16
    x = torch.randn((rows, 6, 6, 6, 32), generator=gen, device="cuda").to(bf16)
    x = x.permute(0, 4, 1, 2, 3)
    w = (torch.randn((64, 32, 3, 3, 3), generator=gen, device="cuda") * 0.05).to(bf16)
    dy = torch.randn((rows, 4, 4, 4, 64), generator=gen, device="cuda").to(bf16)
    dy = dy.permute(0, 4, 1, 2, 3)

    def transposed():
        return torch.ops.aten.convolution_backward(
            dy, x, w, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1,
            [True, False, False])[0]

    def explicit():
        return F.conv3d(F.pad(dy, (2, 2, 2, 2, 2, 2)), w.flip((2, 3, 4)).transpose(0, 1))

    def transposed_autograd():  # the step's own path, for the profiler
        F.conv3d(x.detach().requires_grad_(), w).backward(dy)

    a, b = transposed().float(), explicit().float()
    rel = ((a - b).abs().max() / a.abs().max()).item()
    out = {"rows": rows, "rel_diff_of_max": rel}
    for name, fn, traced in (("transposed", transposed, transposed_autograd),
                             ("explicit", explicit, explicit)):
        ms = time_ms(fn, torch, repeats=10, flush=flush)
        prof = profile_step(torch, lambda *_: traced(), None, None)
        out[name] = {"ms": ms, "kernels": prof["top"][:4]}
    return out


def explicit_dgrad_diagnostic(torch, trainer, step, batch, dense_trainer, dense_step,
                              dense_batch, rows, card):
    """Beside the main path: the windowed and the dense-plan train steps
    with ``VoxelCNNEncoder.explicit_dgrad`` off and on (CUDA-event medians,
    in turns), a profile of one explicit-dgrad dense-plan step, and block
    2's input gradient alone both ways."""
    out = {}
    lr = trainer.cfg.optimizer.lr
    for label, tr, fn, b in (("windowed_compact", trainer, step, batch),
                             ("dense_plan", dense_trainer, dense_step, dense_batch)):
        enc = tr.model.voxel_encoder
        times = {}
        for explicit in (False, True, True, False):
            enc.explicit_dgrad = explicit
            times.setdefault(explicit, []).append(
                time_ms(lambda: fn(b, lr), torch, repeats=3, warmup=1))
        enc.explicit_dgrad = False
        out[label] = {"autograd_ms": min(times[False]), "explicit_ms": min(times[True]),
                      "runs": {"autograd": times[False], "explicit": times[True]}}
        log(f"explicit_dgrad, {label} train step: autograd {out[label]['autograd_ms']:.3f} ms, "
            f"explicit {out[label]['explicit_ms']:.3f} ms [{card}]")
    # Where an explicit-dgrad dense-plan step spends its device time.
    enc = dense_trainer.model.voxel_encoder
    enc.explicit_dgrad = True
    dense_step(dense_batch, lr)  # warm
    out["dense_plan"]["explicit_profile"] = prof = profile_step(torch, dense_step, dense_batch,
                                                                lr)
    enc.explicit_dgrad = False
    if prof["device_busy_ms"]:
        prof["port_kernels_share_of_busy"] = {
            k: v / prof["device_busy_ms"] for k, v in prof["port_kernels_ms"].items()}
    log(f"profiled explicit-dgrad dense-plan train step: device busy {prof['device_busy_ms']} "
        f"ms of {prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port "
        f"kernels {prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:15]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in prof["top_ops"][:8]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    flush = make_flush(torch)
    out["block2_dgrad"] = alone = block2_dgrad(torch, rows, flush)
    for name in ("transposed", "explicit"):
        top = alone[name]["kernels"][0] if alone[name]["kernels"] else {"name": "?"}
        log(f"  block-2 input gradient ({rows} rows), {name}: {alone[name]['ms']:.3f} ms, "
            f"top kernel {top['name'][:100]} [{card}]")
    log(f"  explicit vs transposed dgrad: max |d| / max = {alone['rel_diff_of_max']:.3g}")
    return out


# -------------------------------------------------------------- phase 10d

# The training-run lifecycle on the structured dataset: Bi(V) at the
# flagship widths (64³ voxels, ef 32, z 512, batch 128, bf16, masked BN,
# windowed_compact), 150 models = 450 captions = 3 steps an epoch.
LIFECYCLE = [
    "data=structured",
    "data.num_models=150",
    "model.voxel_encoder=VoxelCNNEncoder",
    "precision.compute_dtype=bfloat16",
    "loss.NTXentLoss.use_pallas=true",
    "trainer.check_val_every_n_epoch=1",
    "trainer.log_every_n_steps=1",
    "trainer.profiler=none",
    "logger.backend=jsonl",
    "checkpoint_monitor.save_top_k=1",
    "checkpoint_monitor.save_last=true",
    "checkpoint_monitor.async_save=true",
    "experiment_name=chip_smoke_lifecycle",
    f"project_root_path={ROOT / 'build' / 'chip_smoke'}",
]
# One modality pair: 1 pair-forward and 2 two-term backward launches a step.
LIFECYCLE_LAUNCHES = dict(TRAIN_LAUNCHES, nt_xent_fwd_pair=1, nt_xent_bwd=2)
# device_eval against the numpy pipeline: hit counts exact, the float sums
# of NDCG and MRR to f32 rounding.
DEVICE_EVAL_TOL = 1e-6


def _run_module(module: str, args: list[str], cwd: Path) -> subprocess.CompletedProcess:
    """Run ``python -m tricolo_tpu_torch.<module>`` as a user would; it
    must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-m", f"tricolo_tpu_torch.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"{module} CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return proc


def _cli(module: str, args: list[str], cwd: Path) -> list[str]:
    """Run the CLI; its printed "RR@1 RR@5 NDCG@5 MRR" numbers."""
    lines = _run_module(module, args, cwd).stdout.strip().splitlines()
    return lines[lines.index("RR@1 RR@5 NDCG@5 MRR") + 1].split()


def lifecycle(torch, card) -> tuple[dict, dict]:
    """Fit 2 epochs (validation and an async top-1 + last save each epoch),
    resume to epoch 3 through the train CLI with ``+auto_resume``, test the
    best checkpoint through the test CLI and score its ``output.p`` through
    the eval CLI, and hold ``device_eval`` against the numpy metrics.
    Returns (report, launches of the fit and the resumed run)."""
    import pickle

    import numpy as np

    from tricolo_tpu_torch import ops, train
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.evaluation import compute_metrics, compute_metrics_on_device
    from tricolo_tpu_torch.training import Trainer
    from tricolo_tpu_torch.training.checkpoint import load_checkpoint

    cfg = load_config(LIFECYCLE + ["trainer.max_epochs=2"])
    shutil.rmtree(cfg.experiment_output_path, ignore_errors=True)
    trainer = Trainer(cfg, device=cfg.get("device", None))  # cuda unless +device=...
    device = trainer.device
    steps: list = []
    trainer.train_step = timed_step(torch, trainer.train_step, steps)
    dm = DataModule(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    manager = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    launches = ops.launches()
    # 2 epochs of 3 train batches, each followed by a validation of 4.
    host = check_host_path("lifecycle fit", 2 * 3 + 2 * 4)
    k = dm.train_loader().tile_budget_rows
    B = cfg.data.batch_size
    require(len(dm.train_set) == 450 and len(steps) == 6,
            f"2 epochs of {len(dm.train_set)} structured captions ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"structured step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == LIFECYCLE_LAUNCHES,
                f"structured step {i}: launches {row['launches']} != {LIFECYCLE_LAUNCHES}")
    with open(os.path.join(cfg.logger.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    val_rows = [r for r in rows if "val_loss/total_loss" in r]
    require(len(val_rows) == 2 and all(np.isfinite(r[key]) for r in val_rows
                                       for key in r if key.startswith("val_loss/")),
            f"validation losses: {val_rows}")
    best = manager.best_path
    saved = sorted(os.listdir(manager.dirpath))
    require(best is not None and os.path.exists(best) and "last.ckpt" in saved
            and sum(name.startswith("epoch=") for name in saved) == 1,
            f"top-1 + last checkpoints: {saved}")
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    out = {"captions": len(dm.train_set), "k": k, "T": B * k, "steps": steps,
           "step_ms_median_2_6": step_ms, "fit_s": fit_s, "launches_fit": launches,
           "val_rows": val_rows, "best": os.path.basename(best), "saved": saved,
           "host_path": host}
    log(f"lifecycle: structured split {len(dm.train_set)} captions, k={k} tiles/sample, "
        f"T={B * k} rows/batch; 2 epochs in {fit_s:.1f} s, median step (2-6) {step_ms:.3f} ms, "
        f"launches/step {steps[-1]['launches']}; val losses "
        f"{[round(r['val_loss/total_loss'], 5) for r in val_rows]}; kept {saved} [{card}]")
    del trainer
    torch.cuda.empty_cache()

    # Resume through the train CLI: the newest surviving epoch=N.ckpt.
    buffer = io.StringIO()
    ops.reset_launches()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(buffer):
        best = train.main(LIFECYCLE + ["trainer.max_epochs=3", "+auto_resume=true"])
    out["resume_s"] = time.perf_counter() - tic
    resume_launches = ops.launches()
    printed = buffer.getvalue()
    require("auto_resume: resuming from " in printed, f"no resume: {printed[-500:]}")
    last = load_checkpoint(os.path.join(manager.dirpath, "last.ckpt"))
    adam_steps = {int(e["step"]) for e in last["optimizer"]["state"].values()}
    require(last["epoch"] == 2 and last["step"] == 9 and adam_steps == {9},
            f"resumed run ended at epoch {last['epoch']}, step {last['step']}, "
            f"Adam steps {adam_steps}; want 2, 9, 9")
    out["resumed_from"] = printed.split("auto_resume: resuming from ")[1].split()[0]
    log(f"lifecycle: resumed from {Path(out['resumed_from']).name} to epoch 2, step 9, Adam "
        f"step 9 in {out['resume_s']:.1f} s [{card}]")

    # The test CLI on the best checkpoint, the eval CLI on its output.p; both
    # rank on the card, so their printed metrics are equal to the digit.
    tic = time.perf_counter()
    tested = _cli("test", LIFECYCLE + [f"+ckpt_path={best}", "inference.device_eval=true"],
                  Path(manager.dirpath))
    output_p = os.path.join(load_config(LIFECYCLE).inference.output_dir, "output.p")
    evaluated = _cli("eval", [f"+prediction_file_path={output_p}"], Path(manager.dirpath))
    out["cli_s"] = time.perf_counter() - tic
    require(tested == evaluated, f"test CLI {tested} != eval CLI {evaluated}")
    with open(output_p, "rb") as f:
        embeddings = pickle.load(f)
    reference = compute_metrics(embeddings, nearest_path=None)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    on_device = compute_metrics_on_device(embeddings, device)[0]
    out["device_eval_ms"] = (time.perf_counter() - tic) * 1e3
    ndcg_dev = float(np.abs(on_device.ndcg - reference.ndcg).max())
    mrr_dev = abs(on_device.mrr - reference.mrr)
    require(np.array_equal(on_device.recall_rate, reference.recall_rate),
            f"device_eval RR {on_device.recall_rate} != numpy {reference.recall_rate}")
    require(ndcg_dev <= DEVICE_EVAL_TOL and mrr_dev <= DEVICE_EVAL_TOL,
            f"device_eval NDCG |d| {ndcg_dev}, MRR |d| {mrr_dev} > {DEVICE_EVAL_TOL}")
    out.update(tested=best, test_cli=tested, eval_cli=evaluated, device_eval_ndcg_abs=ndcg_dev,
               device_eval_mrr_abs=mrr_dev, resume_launches=resume_launches)
    log(f"lifecycle: test CLI on {Path(best).name} -> RR@1 RR@5 NDCG@5 MRR {tested}, eval CLI "
        f"on its output.p equal; device_eval RR equal, NDCG |d| {ndcg_dev:.3g}, MRR |d| "
        f"{mrr_dev:.3g} (tol {DEVICE_EVAL_TOL}); CLIs {out['cli_s']:.1f} s [{card}]")
    return out, {"lifecycle_fit": launches, "lifecycle_resume": resume_launches}


# -------------------------------------------------------------- phase 10e

# The unmasked (all-site BN) flagship: masked_bn=false runs five dense
# SAME-conv blocks through K1's and K3's unmasked entries on the packed
# transfer; no tile kernel and no masked entry is on its path.
UNMASKED = ["model.modules.VoxelCNNEncoder.masked_bn=false", "data.voxel_transfer=packed"]
UNMASKED_EVAL_LAUNCHES = dict(dict.fromkeys(TRAIN_LAUNCHES, 0), bn_relu_pool_unmasked=5)
UNMASKED_TRAIN_LAUNCHES = dict(UNMASKED_EVAL_LAUNCHES, bn_relu_pool_bwd_unmasked=5,
                               nt_xent_fwd_pair=3, nt_xent_bwd=6)


def unmasked_flagship(torch, card) -> tuple[dict, dict]:
    """The masked_bn=false flagship (Tri(I+V), packed, bf16, random weights
    from the seed): the synthetic-256 index with launches per batch, the f32
    index through the kernels against the plain path, one ellipsoid eval
    batch, one epoch through ``Trainer.fit`` with launches per step, the f32
    train step kernel-vs-plain and a profiled step. Returns (report,
    launches of the index build and of the fit)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import eval_step, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer

    out: dict = {}
    cfg = load_config(FLAGSHIP + UNMASKED)
    cfg.experiment_name = "chip_smoke"
    dm = DataModule(cfg)
    dm.setup("test")
    torch.manual_seed(SEED)
    model = TriCoLoNet.from_config(cfg)
    require(not model.voxel_encoder.masked_bn, "masked_bn=false built a masked encoder")
    server = RetrievalServer(cfg, model)  # device: cuda
    n_batches = len(dm.test_loader())
    ops.reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    out["index_build_s"] = time.perf_counter() - tic
    out["launches"] = serve_launches = ops.launches()
    want = {name: n * n_batches for name, n in UNMASKED_EVAL_LAUNCHES.items()}
    require(serve_launches == want, f"unmasked index launches {serve_launches} != {want}")
    require(index.matrix.shape == (256, cfg.model.out_dim), f"unmasked index {index.matrix.shape}")
    require(bool(np.isfinite(index.matrix).all()), "unmasked index non-finite")
    log(f"unmasked index: {index.matrix.shape} in {out['index_build_s']:.3f} s over "
        f"{n_batches} batches; launches {serve_launches} [{card}]")
    bf16_matrix = index.matrix.copy()

    model.set_compute_dtype(torch.float32)  # TF32 is off since phase 5
    kernel32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = True
    model.set_compute_dtype(torch.bfloat16)
    out["plain_vs_kernel_f32_max_abs"] = dev = float(np.abs(kernel32 - plain32).max())
    out["bf16_vs_f32_max_abs"] = float(np.abs(bf16_matrix - kernel32).max())
    require(dev <= F32_TOL, f"unmasked f32 kernel vs plain path: {dev} > {F32_TOL}")
    log(f"unmasked f32: kernel vs plain max |d| = {dev} (tol {F32_TOL}); bf16 vs f32 "
        f"{out['bf16_vs_f32_max_abs']}")

    host, _ = ellipsoid_batch(cfg, packed=True)
    batch = to_device_batch(host, torch.device("cuda"))
    model.eval()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eval_step(model, batch)
    per_batch = ops.launches()
    require(per_batch == UNMASKED_EVAL_LAUNCHES, f"unmasked eval batch launches {per_batch}")
    ms = time_ms(lambda: eval_step(model, batch), torch, repeats=10, warmup=2)
    model.voxel_encoder.use_kernels = False
    plain_ms = time_ms(lambda: eval_step(model, batch), torch, repeats=10, warmup=2)
    model.voxel_encoder.use_kernels = True
    out["ellipsoid_eval"] = {"ms": ms, "plain_ms": plain_ms,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"unmasked eval batch (128 ellipsoids, packed): {ms:.3f} ms (plain kernels "
        f"{plain_ms:.3f} ms), peak {out['ellipsoid_eval']['peak_gib']:.2f} GiB [{card}]")
    del server, model, index, batch
    torch.cuda.empty_cache()

    train_cfg = load_config(FLAGSHIP + UNMASKED + TRAIN + ["experiment_name=chip_smoke_unmasked"])
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    trainer.train_step = timed_step(torch, step, steps)
    train_dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tic = time.perf_counter()
    trainer.fit(train_dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(len(steps) == 6, f"one unmasked epoch ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"unmasked train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == UNMASKED_TRAIN_LAUNCHES,
                f"unmasked train step {i}: launches {row['launches']} != "
                f"{UNMASKED_TRAIN_LAUNCHES}")
        log(f"  unmasked train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) "
            "losses " + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    out["train"] = {"steps": steps, "step_ms_median_2_6": step_ms,
                    "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
                    "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
                    "launches_fit": fit_launches, "fit_s": fit_s,
                    "val_rr5": trainer.metrics.summary("")["RR@5"]}
    log(f"unmasked train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{out['train']['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB, launches/step "
        f"{steps[-1]['launches']}, fit {fit_s:.1f} s [{card}]")

    batch = to_device_batch(next(iter(train_dm.train_loader())), torch.device("cuda"))
    cfg32 = load_config(FLAGSHIP + UNMASKED + TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    log(f"unmasked train plain path (f32, TF32 off, deterministic): losses rel "
        f"{cmp['loss_rel']:.3g} (tol {TRAIN_LOSS_RTOL}), grads rel-of-max "
        f"{cmp['grad_rel_of_max']:.3g} (tol {TRAIN_GRAD_TOL}), running_var |d| "
        f"{cmp['running_var_abs']:.3g} (tol {TRAIN_VAR_TOL})")
    torch.cuda.empty_cache()
    lr = train_cfg.optimizer.lr
    step(batch, lr)  # warm the bf16 path after the f32 phase
    out["profile"] = prof = profile_step(torch, step, batch, lr)
    log(f"profiled unmasked train step: device busy {prof['device_busy_ms']} ms of "
        f"{prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port kernels "
        f"{prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:12]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in prof["top_ops"][:8]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    del trainer, step, batch
    torch.cuda.empty_cache()
    return out, {"unmasked_serving": serve_launches, "unmasked_train": fit_launches}


# -------------------------------------------------------------- phase 10f

# The CLIP flagship, Tri(CLIP-I+V): the CLIP text and image heads (768 →
# 512 → 512, dropout 0.1: two nn.Linear each, cuBLAS) over the synthetic
# split's seeded 768-d features, and the voxel encoder of phase 7
# (windowed_compact, masked BN). The kernels on its path are the voxel
# encoder's (K1, K2 per-sample, K3) and the loss's (3 pairs).
CLIP = ["model.text_encoder=CLIPTextEncoder", "model.image_encoder=CLIPImageEncoder"]
CLIP_EVAL_LAUNCHES = dict(dict.fromkeys(TRAIN_LAUNCHES, 0), bn_relu_pool=5, scatter_tiles_ps=2)
CLIP_TRAIN_LAUNCHES = TRAIN_LAUNCHES


class StubClipBackend:
    """Stands in for a local CLIP checkpoint (none ships): a fixed seeded
    projection of the 77 CLIP token ids (/ 1000) to 768 dimensions."""

    def __init__(self, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.projection = (rng.standard_normal((77, 768)) / np.sqrt(77)).astype(np.float32)

    def encode_text(self, tokens):
        import numpy as np

        return (np.asarray(tokens, np.float32) / 1000.0) @ self.projection


def clip_flagship(torch, card) -> tuple[dict, dict]:
    """Tri(CLIP-I+V) at the flagship widths (bf16, random weights from the
    seed): the synthetic-256 index with launches per batch and four token
    queries through the stub backend, the f32 index through the kernels
    against the plain path, one epoch through ``Trainer.fit`` with launches
    per step, the fit's best checkpoint served, the f32 train step
    kernel-vs-plain from one dropout seed, and a profiled step. Returns
    (report, launches of the index build and of the fit)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.clip_heads import CLIPImageEncoder, CLIPTextEncoder
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer, dropout_generator

    out: dict = {}
    backend = StubClipBackend(SEED)
    cfg = load_config(FLAGSHIP + CLIP)
    cfg.experiment_name = "chip_smoke"
    dm = DataModule(cfg)
    dm.setup("test")
    torch.manual_seed(SEED)
    model = TriCoLoNet.from_config(cfg)
    require(isinstance(model.text_encoder, CLIPTextEncoder)
            and isinstance(model.image_encoder, CLIPImageEncoder), "CLIP heads not built")
    server = RetrievalServer(cfg, model, clip_backend=backend)  # device: cuda
    n_batches = len(dm.test_loader())
    ops.reset_launches()
    reset_host_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    out["index_build_s"] = time.perf_counter() - tic
    out["launches"] = serve_launches = ops.launches()
    out["host_path"] = check_host_path("CLIP index build", n_batches)
    want = {name: n * n_batches for name, n in CLIP_EVAL_LAUNCHES.items()}
    require(serve_launches == want, f"CLIP index launches {serve_launches} != {want}")
    require(index.matrix.shape == (256, cfg.model.out_dim), f"CLIP index {index.matrix.shape}")
    require(bool(np.isfinite(index.matrix).all()), "CLIP index non-finite")
    log(f"CLIP index: {index.matrix.shape} in {out['index_build_s']:.3f} s over {n_batches} "
        f"batches; launches {serve_launches} [{card}]")
    queries = [dm.val_set[i]["tokens"] for i in (0, 3, 100, 500)]
    tic = time.perf_counter()
    answers = [server.query(tokens=q, k=5) for q in queries]
    out["token_queries_s"] = time.perf_counter() - tic
    for q, a in zip(queries, answers):
        require(len(a) == 5 and all(np.isfinite(s) for _, s in a), "bad CLIP text answer")
        log(f"  CLIP query {q[q != 0][:6].tolist()}...: {[m for m, _ in a]}")
    out["topk"] = [[m for m, _ in a] for a in answers]
    log(f"CLIP queries: 4 token queries in {out['token_queries_s']:.3f} s [{card}]")
    bf16_matrix = index.matrix.copy()

    model.set_compute_dtype(torch.float32)  # TF32 is off since phase 5
    kernel32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = True
    out["plain_vs_kernel_f32_max_abs"] = dev = float(np.abs(kernel32 - plain32).max())
    out["bf16_vs_f32_max_abs"] = float(np.abs(bf16_matrix - kernel32).max())
    require(dev <= F32_TOL, f"CLIP f32 kernel vs plain path: {dev} > {F32_TOL}")
    log(f"CLIP f32: kernel vs plain max |d| = {dev} (tol {F32_TOL}); bf16 vs f32 "
        f"{out['bf16_vs_f32_max_abs']}")
    del server, model, index
    torch.cuda.empty_cache()

    train_cfg = load_config(FLAGSHIP + CLIP + TRAIN + ["experiment_name=chip_smoke_clip"])
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    trainer.train_step = timed_step(torch, step, steps)
    train_dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    ckpt = trainer.fit(train_dm).best_path
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    host = check_host_path("CLIP train fit", 12)  # 6 train batches, 6 validation
    require(len(steps) == 6, f"one CLIP epoch ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"CLIP train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == CLIP_TRAIN_LAUNCHES,
                f"CLIP train step {i}: launches {row['launches']} != {CLIP_TRAIN_LAUNCHES}")
        log(f"  CLIP train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) losses "
            + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    out["train"] = {"steps": steps, "step_ms_median_2_6": step_ms,
                    "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
                    "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
                    "launches_fit": fit_launches, "fit_s": fit_s, "host_path": host,
                    "val_rr5": trainer.metrics.summary("")["RR@5"]}
    log(f"CLIP train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{out['train']['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB, launches/step "
        f"{steps[-1]['launches']}, fit {fit_s:.1f} s [{card}]")

    tic = time.perf_counter()
    trained = RetrievalServer.from_checkpoint(train_cfg, ckpt, clip_backend=backend)
    trained_index = trained.build_index(train_dm)
    answer = trained.query(tokens=queries[0], k=5)
    out["trained_index_s"] = time.perf_counter() - tic
    require(trained_index.matrix.shape == (256, train_cfg.model.out_dim), "trained CLIP index")
    require(bool(np.isfinite(trained_index.matrix).all()), "trained CLIP index non-finite")
    require(len(answer) == 5 and all(np.isfinite(s) for _, s in answer), "trained CLIP query")
    log(f"trained CLIP checkpoint {Path(ckpt).name} serves: index {trained_index.matrix.shape}, "
        f"query -> {[m for m, _ in answer]}")
    del trained, trained_index

    batch = to_device_batch(next(iter(train_dm.train_loader())), torch.device("cuda"))
    cfg32 = load_config(FLAGSHIP + CLIP + TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    log(f"CLIP train plain path (f32, TF32 off, deterministic, one dropout seed): losses rel "
        f"{cmp['loss_rel']:.3g} (tol {TRAIN_LOSS_RTOL}), grads rel-of-max "
        f"{cmp['grad_rel_of_max']:.3g} (tol {TRAIN_GRAD_TOL}), running_var |d| "
        f"{cmp['running_var_abs']:.3g} (tol {TRAIN_VAR_TOL})")
    torch.cuda.empty_cache()
    lr = train_cfg.optimizer.lr

    def seeded_step(b, rate):
        return step(b, rate, dropout_generator(train_cfg.train_seed, trainer.step, "cuda"))

    seeded_step(batch, lr)  # warm the bf16 path after the f32 phase
    out["profile"] = prof = profile_step(torch, seeded_step, batch, lr)
    log(f"profiled CLIP train step: device busy {prof['device_busy_ms']} ms of "
        f"{prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port kernels "
        f"{prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:10]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    del trainer, step, batch
    torch.cuda.empty_cache()
    return out, {"clip_serving": serve_launches, "clip_train": fit_launches}


# -------------------------------------------------------------- phase 11

# The structured quality run's configuration (python -m
# tricolo_tpu_torch.bn_experiment): its train batches are what a structured
# run collates.
STRUCTURED_300 = ["data=structured", "data.num_models=300",
                  "model.voxel_encoder=VoxelCNNEncoder", "precision.compute_dtype=bfloat16"]


def host_cpu() -> str:
    """The host CPU as ``lscpu`` names it: model name, vendor, family and
    model numbers (a virtual machine may report the name as unknown)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    fields = {key.strip(): value.strip() for key, value in fields.items()}
    return (f"{fields.get('Model name', 'unknown')} ({fields.get('Vendor ID', '?')}, family "
            f"{fields.get('CPU family', '?')} model {fields.get('Model', '?')})")


def rgba_grids(flat, rgb, d):
    """Each sample's packed words → its (4, d, d, d) u8 RGBA grid (alpha
    255 on occupied sites), in numpy."""
    import numpy as np

    grids = np.zeros((len(flat), 4, d, d, d), np.uint8)
    for i in range(len(flat)):
        words = flat[i][flat[i] != 0xFFFFFFFF]
        x, y, z = (words >> 16) & 0xFF, (words >> 8) & 0xFF, words & 0xFF
        colors = rgb[i][: len(words)]
        for c in range(3):
            grids[i, c, x, y, z] = (colors >> (8 * c)) & 0xFF
        grids[i, 3, x, y, z] = 255
    return grids


def host_path(torch, card, dm) -> dict:
    """The host loader's build on this host, then its four sweeps against
    their numpy versions, bit-exact, on the first flagship val batch and
    the first structured-300 train batch, with host times (C++ the median
    of 5, numpy the one run that is compared)."""
    import numpy as np

    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule, datasets, device_prep

    tic = time.perf_counter()
    native.build(build_dir=ROOT / "build" / "chip_smoke" / "host_loader")  # a fresh build
    out = {"build_s": time.perf_counter() - tic, "cpu": host_cpu(), "threads": native.threads(),
           "batches": {}}
    log(f"host loader: g++ build {out['build_s']:.2f} s on {out['cpu']}, "
        f"{out['threads']} sweep threads [{card}]")

    structured = DataModule(load_config(STRUCTURED_300))
    structured.setup("fit")
    for name, loader in (("synthetic-256 val", dm.test_loader()),
                         ("structured-300 train", structured.train_loader())):
        k, d = loader.tile_budget_rows, loader.voxel_size
        loader.voxel_transfer = "packed"  # the batch's packed words, collated as usual
        first = loader.peek()
        flat, rgb = first["voxel_flat"], first["voxel_rgb"]
        grids = rgba_grids(flat, rgb, d)
        cases = [
            ("windowed_compact halo 3",
             lambda: native.packed_to_windowed_compact(flat, rgb, d, k, 8, 3),
             lambda: device_prep.windowed_compact_on_host_plain(flat, rgb, d, k, halo=3)),
            ("windowed halo 1", lambda: native.packed_to_windowed(flat, rgb, d, 8, 1),
             lambda: device_prep.windowed_on_host_plain(flat, rgb, d, halo=1)),
            ("windowed halo 3", lambda: native.packed_to_windowed(flat, rgb, d, 8, 3),
             lambda: device_prep.windowed_on_host_plain(flat, rgb, d, halo=3)),
            ("dense", lambda: native.packed_to_dense(flat, rgb, d),
             lambda: device_prep.densify_on_host_plain(flat, rgb, d)),
            ("dense_rgba_to_packed x B",
             lambda: [native.dense_rgba_to_packed(g) for g in grids],
             lambda: [datasets.dense_rgba_to_packed_plain(g) for g in grids]),
        ]
        rows = []
        for label, fast, plain in cases:
            tic = time.perf_counter()
            want = _arrays(plain())
            plain_ms = (time.perf_counter() - tic) * 1e3  # one run: numpy takes up to 2 s
            got = _arrays(fast())
            exact = len(got) == len(want) and all(
                a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
            require(exact, f"host sweep {label} on the {name} batch differs from numpy")
            if label.startswith("dense_rgba"):
                n = (flat != 0xFFFFFFFF).sum(axis=1)
                require(all(np.array_equal(got[2 * i], flat[i, : n[i]])
                            and np.array_equal(got[2 * i + 1], rgb[i, : n[i]])
                            for i in range(len(flat))),
                        f"RGBA packing does not give back the {name} batch's words")
            del got, want
            ms = statistics.median(_host_ms(fast) for _ in range(5))
            rows.append({"sweep": label, "ms": ms, "plain_ms": plain_ms, "bit_exact": True})
            log(f"  host sweep, {name} batch (B={len(flat)}, N={flat.shape[1]}, k={k}), "
                f"{label}: C++ {ms:.2f} ms vs numpy {plain_ms:.1f} ms, bit-exact "
                f"[{out['cpu']}, {out['threads']} threads] [{card}]")
        out["batches"][name] = {"B": len(flat), "N": int(flat.shape[1]), "k": k,
                                "sites": int((flat != 0xFFFFFFFF).sum()), "sweeps": rows}
    return out


def _arrays(result) -> list:
    """A sweep's output as a flat list of arrays: one array, a tuple of
    them, or a list of (flat, rgb) pairs."""
    if isinstance(result, tuple):
        return list(result)
    if isinstance(result, list):
        return [a for pair in result for a in pair]
    return [result]


def _host_ms(fn) -> float:
    tic = time.perf_counter()
    fn()
    return (time.perf_counter() - tic) * 1e3


# -------------------------------------------------------------- phase 12

# Data parallel, one process a rank (``tricolo_tpu_torch.parallel``), each
# rank a subprocess of this script (``--dp-rank``) so that no process group
# outlives the phase. 12a: a 1-rank NCCL world beside the non-parallel
# trainer in the same process; 12b: two gloo ranks sharing cuda:0, global
# batch 128 (64 a rank).
DP_DIR = ROOT / "build" / "chip_smoke" / "dp"
# A rank's train step: its stripe through the voxel kernels, the loss
# kernels at the global batch over the gathered embeddings.
DP_TRAIN_LAUNCHES = TRAIN_LAUNCHES
# 12b against one process. 12a trains the non-parallel trainer six bf16
# steps and compares there, against the non-parallel f32 step. Some of
# that step's gradients are the small residue of large cancelling sums
# (a conv weight under BatchNorm), so any change in the order of the f32
# sums moves them: the step against itself on its batch reordered moves
# them by up to several % of their max, at the seeded init as after the
# six steps (12a measures both; PERF.md §6). The ranks sum in
# another order and the ResNet's BN takes its global-batch form, so each
# gradient must be within phase 9's 1e-3 of max, or, where the step's own
# reorder spread already exceeds that, within DP_SPREAD times the spread.
DP_SPREAD = 2.0


def _dp_cfg(world: int, rank: int, port: str, dtype: str, extra=()):
    from tricolo_tpu_torch.config import load_config

    return load_config([*FLAGSHIP, *TRAIN, f"precision.compute_dtype={dtype}",
                        "parallel.multiprocess=true",
                        f"parallel.coordinator_address=127.0.0.1:{port}",
                        f"parallel.num_processes={world}", f"parallel.process_id={rank}",
                        *extra])


def _deterministic_f32(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _f32_step(torch, trainer, state, batch) -> dict:
    """One f32 train step of ``trainer`` from ``state`` (full tensors; an
    FSDP model keeps its shards of them): losses, full gradients and
    running variances (on the host)."""
    from tricolo_tpu_torch.parallel.sharding_rules import gathered, placed_like
    from tricolo_tpu_torch.training import dropout_generator

    live = trainer.model.state_dict()
    trainer.model.load_state_dict({k: placed_like(v, live[k]) for k, v in state.items()})
    losses = trainer.train_step(batch, trainer.cfg.optimizer.lr,
                                dropout_generator(trainer.cfg.train_seed, 0, trainer.device))
    torch.cuda.synchronize()
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {n: gathered(p.grad).detach().to("cpu", copy=True)
                      for n, p in trainer.model.named_parameters()},
            "vars": {n: b.detach().to("cpu", copy=True) for n, b in trainer.model.named_buffers()
                     if n.endswith("running_var")}}


def _grad_devs(got: dict, ref: dict) -> dict:
    """Each gradient's max |Δ| over its largest reference magnitude."""
    return {n: ((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
            for n, g in ref["grads"].items()}


def _f32_deviation(got: dict, ref: dict) -> dict:
    """Phase 9's measures of one f32 step against another, and max |Δ|."""
    return {
        "loss_rel": max(abs(got["losses"][n] / v - 1) for n, v in ref["losses"].items()),
        "grad_rel_of_max": max(_grad_devs(got, ref).values()),
        "running_var_abs": max((got["vars"][n] - v).abs().max().item()
                               for n, v in ref["vars"].items()),
        "max_abs": max([abs(got["losses"][n] - v) for n, v in ref["losses"].items()]
                       + [(got["grads"][n] - g).abs().max().item()
                          for n, g in ref["grads"].items()]
                       + [(got["vars"][n] - v).abs().max().item()
                          for n, v in ref["vars"].items()]),
    }


def _reorder_spread(torch, trainer, state, batch, ref) -> dict:
    """Each gradient's largest move, of its max, when ``trainer``'s f32
    step from ``state`` takes ``batch`` with its samples reordered (halves
    swapped, reversed, shuffled): the same step, summed in other orders."""
    n = batch["tokens"].shape[0]
    gen = torch.Generator().manual_seed(SEED)
    spread: dict = {}
    for order in (torch.arange(n).roll(n // 2), torch.arange(n).flip(0),
                  torch.randperm(n, generator=gen)):
        order = order.to(trainer.device)
        moved = {k: v.index_select(0, order) for k, v in batch.items()}
        for name, d in _grad_devs(_f32_step(torch, trainer, state, moved), ref).items():
            spread[name] = max(spread.get(name, 0.0), d)
    return spread


def dp_world1(port: str) -> dict:
    """12a, in a rank's process: the flagship non-parallel ``Trainer`` and a
    1-rank NCCL ``Trainer`` from the same seed, bf16 steps in turns on the
    epoch's six batches; the remat step; then, from the non-parallel
    trainer's weights after its six steps, one f32 step of each on the
    first batch (the non-parallel one twice, for the run-to-run floor, and
    on the batch reordered, for each gradient's rounding spread, also at
    the seeded init): 12b's reference."""
    import torch

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer, dropout_generator

    DP_DIR.mkdir(parents=True, exist_ok=True)
    plain = Trainer(load_config([*FLAGSHIP, *TRAIN]))
    init = {k: v.clone() for k, v in plain.model.state_dict().items()}
    dp = Trainer(_dp_cfg(1, 0, port, "bfloat16"))
    require(dp.world is not None and dp.world.size == 1
            and torch.distributed.get_backend() == "nccl", "12a: no 1-rank NCCL world")
    dm = DataModule(dp.cfg)
    dm.setup("fit")
    loader = dm.train_loader(pin_memory=True)
    first = loader.peek()
    rows = {"plain": [], "dp": []}
    launches = []
    for i, host in enumerate(loader):
        batch = to_device_batch(host, dp.device)
        for name, trainer in (("plain", plain), ("dp", dp)):
            generator = dropout_generator(trainer.cfg.train_seed, i, trainer.device)
            before = ops.launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = trainer.train_step(batch, trainer.cfg.optimizer.lr, generator)
            end.record()
            end.synchronize()
            after = ops.launches()
            rows[name].append({"ms": start.elapsed_time(end),
                               "total_loss": losses["train_loss/total_loss"].item()})
            if name == "dp":
                launches.append({k: after[k] - before[k] for k in after})
    out = {"rows": rows, "launches_per_step": launches,
           "step_ms_median_2_6": {k: statistics.median(r["ms"] for r in v[1:])
                                  for k, v in rows.items()}}
    state = {k: v.clone() for k, v in plain.model.state_dict().items()}
    torch.save(state, DP_DIR / "state.pt")
    del plain, dp, batch
    torch.cuda.empty_cache()
    out["remat"] = remat_step(torch, host)

    _deterministic_f32(torch)
    plain = Trainer(load_config([*FLAGSHIP, *TRAIN, "precision.compute_dtype=float32"]))
    dp = Trainer(_dp_cfg(1, 0, port, "float32"))
    batch = to_device_batch(first, plain.device)
    ref = _f32_step(torch, plain, state, batch)
    again = _f32_step(torch, plain, state, batch)
    got = _f32_step(torch, dp, state, batch)
    spread = _reorder_spread(torch, plain, state, batch, ref)
    ref_init = _f32_step(torch, plain, init, batch)
    spread_init = _reorder_spread(torch, plain, init, batch, ref_init)
    torch.save({**ref, "model_ids": first["model_id"], "spread": spread}, DP_DIR / "ref_f32.pt")
    torch.backends.cudnn.deterministic = False

    def summary(s):
        return {"max": max(s.values()),
                "within_1e3": sum(d <= TRAIN_GRAD_TOL for d in s.values()),
                "tensors": len(s), "worst": sorted(s.items(), key=lambda kv: -kv[1])[:4]}

    out.update(f32_vs_plain=_f32_deviation(got, ref),
               f32_floor_plain_twice=_f32_deviation(again, ref),
               losses_f32=got["losses"], losses_f32_init=ref_init["losses"],
               reorder_spread={"trained": summary(spread), "init": summary(spread_init)})
    return out


# precision.remat_voxel: the voxel encoder runs again in the backward, so
# K1 and the per-sample K2 launch twice as often; K3 and the loss kernels
# do not.
REMAT_LAUNCHES = dict(TRAIN_LAUNCHES, bn_relu_pool=10, scatter_tiles_ps=4)


def remat_step(torch, host) -> dict:
    """One bf16 flagship step with ``precision.remat_voxel`` off and on from
    the same weights: losses, launches and peak memory of each."""
    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    out = {}
    for remat in (False, True):
        trainer = Trainer(load_config([*FLAGSHIP, *TRAIN,
                                       f"precision.remat_voxel={str(remat).lower()}"]))
        batch = to_device_batch(host, trainer.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses = trainer.train_step(batch, trainer.cfg.optimizer.lr)
        torch.cuda.synchronize()
        out["on" if remat else "off"] = {
            "total_loss": losses["train_loss/total_loss"].item(), "launches": ops.launches(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del trainer, batch, losses
        torch.cuda.empty_cache()
    return out


def dp_two_ranks(rank: int, port: str) -> dict:
    """12b, in rank ``rank`` of two gloo ranks on cuda:0: one f32 step on
    the rank's stripe of the first batch from 12a's trained weights, with the
    launch counts and the batch the loss kernels were planned for; then one
    bf16 epoch through ``Trainer.fit`` (the main path), launches a step."""
    import torch

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.ops import nt_xent
    from tricolo_tpu_torch.training import Trainer

    planned = []
    for name in ("fwd_launch_plan", "bwd_launch_plan"):
        plan = getattr(nt_xent, name)

        def recording(B, *args, _plan=plan):
            planned.append(B)
            return _plan(B, *args)

        setattr(nt_xent, name, recording)

    _deterministic_f32(torch)
    trainer = Trainer(_dp_cfg(2, rank, port, "float32"), device="cuda:0", backend="gloo")
    require(torch.distributed.get_backend() == "gloo" and trainer.world.size == 2,
            "12b: no 2-rank gloo world")
    dm = DataModule(trainer.cfg)
    dm.setup("fit")
    host = dm.train_loader().peek()
    state = torch.load(DP_DIR / "state.pt", map_location=trainer.device)
    ops.reset_launches()
    got = _f32_step(torch, trainer, state, to_device_batch(host, trainer.device))
    out = {"step_f32": got, "launches_f32": ops.launches(), "planned_B": sorted(set(planned)),
           "model_ids": host["model_id"], "local_batch": len(host["model_id"])}
    del trainer
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    trainer = Trainer(_dp_cfg(2, rank, port, "bfloat16", ["experiment_name=chip_smoke_dp"]),
                      device="cuda:0", backend="gloo")
    steps: list = []
    trainer.train_step = timed_step(torch, trainer.train_step, steps)
    ops.reset_launches()
    tic = time.perf_counter()
    best = trainer.fit(DataModule(trainer.cfg)).best_path
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - tic, launches_fit=ops.launches(), steps=steps,
               best_path=best, val_rr5=trainer.metrics.summary("")["RR@5"])
    return out


def dp_rank_main(argv: list[str]) -> int:
    """``chip_smoke.py --dp-rank <12a|12b|16a|16b> <rank> <port>``: one rank
    of phase 12 or 16; its result goes to ``DP_DIR/<case>_rank<rank>.pt``."""
    import torch

    case, rank, port = argv[0], int(argv[1]), argv[2]
    sys.path.insert(0, str(ROOT))
    cases = {"12a": lambda: dp_world1(port), "12b": lambda: dp_two_ranks(rank, port),
             "16a": lambda: fsdp_world1(port), "16b": lambda: fsdp_two_ranks(rank, port)}
    out = cases[case]()
    torch.save(out, DP_DIR / f"{case}_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_ranks(torch, case: str, ranks: int, timeout: float) -> list:
    """Start ``ranks`` rank processes of ``case`` and wait for all; a rank
    that fails fails the phase (its output's tail in the error)."""
    port = _free_port()
    logs = [DP_DIR / f"{case}_rank{r}.log" for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               case, str(r), port],
                              stdout=open(log, "w"), stderr=subprocess.STDOUT, cwd=ROOT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0,
                f"phase {case} rank {r} exited {p.returncode}:\n{log.read_text()[-3000:]}")
    return [torch.load(DP_DIR / f"{case}_rank{r}.pt", weights_only=False) for r in range(ranks)]


def data_parallel(torch, card) -> tuple[dict, dict]:
    """Phase 12: (report, launches of the 2-rank fit's ranks and of the
    1-rank steps)."""
    import numpy as np

    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    out: dict = {}
    (w1,) = run_ranks(torch, "12a", 1, 600)
    cmp = w1["f32_vs_plain"]
    out["world1"] = w1
    log(f"12a 1-rank NCCL f32 step vs the non-parallel step: max |d| {cmp['max_abs']} "
        f"(losses rel {cmp['loss_rel']:.3g}, grads rel-of-max {cmp['grad_rel_of_max']:.3g}, "
        f"running_var |d| {cmp['running_var_abs']:.3g}); the non-parallel step twice: max |d| "
        f"{w1['f32_floor_plain_twice']['max_abs']}")
    # World 1 makes every collective a copy: where the non-parallel step
    # repeats bit for bit, the 1-rank step must equal it bit for bit.
    if w1["f32_floor_plain_twice"]["max_abs"] == 0.0:
        require(cmp["max_abs"] == 0.0, f"12a: 1-rank step vs non-parallel |d| {cmp['max_abs']}")
    require(cmp["loss_rel"] <= TRAIN_LOSS_RTOL and cmp["grad_rel_of_max"] <= TRAIN_GRAD_TOL
            and cmp["running_var_abs"] <= TRAIN_VAR_TOL, f"12a: 1-rank step vs non-parallel {cmp}")
    for state, spread in w1["reorder_spread"].items():
        log(f"12a: the non-parallel f32 step against itself on its batch reordered ({state} "
            f"weights): gradients move up to {spread['max']:.3g} of max, {spread['within_1e3']} "
            f"of {spread['tensors']} tensors within {TRAIN_GRAD_TOL}; worst {spread['worst']}")
    for i, counts in enumerate(w1["launches_per_step"]):
        require(counts == DP_TRAIN_LAUNCHES, f"12a step {i}: launches {counts}")
    remat = w1["remat"]
    for key, want in (("off", TRAIN_LAUNCHES), ("on", REMAT_LAUNCHES)):
        require(remat[key]["launches"] == want, f"remat {key}: launches {remat[key]['launches']}")
        require(bool(np.isfinite(remat[key]["total_loss"])), f"remat {key}: non-finite loss")
    log(f"remat_voxel off / on, one bf16 step: total loss {remat['off']['total_loss']:.6f} / "
        f"{remat['on']['total_loss']:.6f}, peak {remat['off']['peak_gib']:.2f} / "
        f"{remat['on']['peak_gib']:.2f} GiB, K1 {remat['off']['launches']['bn_relu_pool']} / "
        f"{remat['on']['launches']['bn_relu_pool']} [{card}]")
    med = w1["step_ms_median_2_6"]
    log(f"12a bf16 step median (2-6): non-parallel {med['plain']:.3f} ms, 1-rank NCCL "
        f"{med['dp']:.3f} ms (+{med['dp'] - med['plain']:.3f} ms) [{card}]")

    ranks = run_ranks(torch, "12b", 2, 900)
    ref = torch.load(DP_DIR / "ref_f32.pt", weights_only=False)
    out["two_ranks"] = two = {}
    require(ranks[0]["model_ids"] + ranks[1]["model_ids"] == ref["model_ids"],
            "12b: the stripes are not the single-process batch")
    for r, res in enumerate(ranks):
        global_b = len(ref["model_ids"])  # the flagship's 128
        require(res["local_batch"] == global_b // 2,
                f"12b rank {r}: local batch {res['local_batch']}")
        require(res["planned_B"] == [global_b], f"12b rank {r}: loss kernels planned for "
                                                f"B {res['planned_B']}, not {global_b}")
        require(res["launches_f32"] == DP_TRAIN_LAUNCHES,
                f"12b rank {r}: f32 step launches {res['launches_f32']}")
        dev = _f32_deviation(res["step_f32"], ref)
        spread = ref["spread"]
        per = _grad_devs(res["step_f32"], ref)
        over = {n: d for n, d in per.items() if d > max(TRAIN_GRAD_TOL, DP_SPREAD * spread[n])}
        ratios = {n: d / max(spread[n], 1e-30) for n, d in per.items() if d > TRAIN_GRAD_TOL}
        dev.update(within_1e3=sum(d <= TRAIN_GRAD_TOL for d in per.values()),
                   tensors=len(per), max_ratio_to_spread=max(ratios.values(), default=0.0),
                   worst=[(n, d, spread[n]) for n, d in
                          sorted(per.items(), key=lambda kv: -kv[1])[:8]])
        two[f"rank{r}_f32_vs_single"] = dev
        log(f"12b rank {r}: worst gradients (name, rel-of-max, reorder spread) {dev['worst']}")
        require(dev["loss_rel"] <= TRAIN_LOSS_RTOL, f"12b rank {r}: losses {dev['loss_rel']}")
        require(not over, f"12b rank {r}: gradients past max(1e-3, {DP_SPREAD} x spread): "
                          f"{[(n, d, spread[n]) for n, d in over.items()]}")
        require(dev["running_var_abs"] <= TRAIN_VAR_TOL,
                f"12b rank {r}: running_var {dev['running_var_abs']}")
        require(len(res["steps"]) == 6, f"12b rank {r}: the fit ran {len(res['steps'])} steps")
        for i, row in enumerate(res["steps"]):
            require(all(np.isfinite(v) for v in row["losses"].values()),
                    f"12b rank {r} step {i}: non-finite losses")
            require(row["launches"] == DP_TRAIN_LAUNCHES,
                    f"12b rank {r} step {i}: launches {row['launches']}")
        log(f"12b rank {r}: f32 step vs the non-parallel step at B = {global_b}: losses rel "
            f"{dev['loss_rel']:.3g} (tol {TRAIN_LOSS_RTOL}), grads rel-of-max "
            f"{dev['grad_rel_of_max']:.3g}: {dev['within_1e3']} of {dev['tensors']} within "
            f"{TRAIN_GRAD_TOL}, the others at most {dev['max_ratio_to_spread']:.3g} x their "
            f"reorder spread (tol {DP_SPREAD}), running_var |d| {dev['running_var_abs']:.3g} "
            f"(tol {TRAIN_VAR_TOL}); loss kernels at B {res['planned_B']}; fit "
            f"{res['fit_s']:.1f} s, step median (2-6) "
            f"{statistics.median(s['ms'] for s in res['steps'][1:]):.3f} ms [{card}]")
    same = all(torch.equal(ranks[0]["step_f32"]["grads"][n], g)
               for n, g in ranks[1]["step_f32"]["grads"].items())
    require(same, "12b: the ranks' summed gradients differ")
    require(ranks[1]["best_path"] is None and ranks[0]["best_path"] is not None,
            "12b: rank 0 alone must write the checkpoint")
    for res in ranks:
        del res["step_f32"]  # gradients: not for the report
    two.update(ranks=ranks)
    return out, {"dp_world1": {k: sum(s[k] for s in w1["launches_per_step"])
                               for k in DP_TRAIN_LAUNCHES},
                 "dp_rank0_fit": ranks[0]["launches_fit"], "dp_rank1_fit": ranks[1]["launches_fit"]}



# -------------------------------------------------------------- phase 13

# The reference's other image backbones and the triplet loss, Tri(I+V) at
# the flagship widths with the voxel encoder of phase 7 (windowed_compact,
# masked BN). An index batch launches K1 5 and K2 2 (the voxel encoder);
# a triplet step K1 5, K2 2, K3 5 and no loss kernel (the triplet loss is
# plain torch); an NT-Xent step also the pair and two-term kernels.
BACKBONE = "model.modules.MVCNNEncoder.cnn_name="
BACKBONE_EVAL_LAUNCHES = CLIP_EVAL_LAUNCHES
TRIPLET_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, nt_xent_fwd_pair=0, nt_xent_bwd=0)


def backbone_index(torch, card, label, cfg, queries=True,
                   server=None) -> tuple[dict, object, object]:
    """The synthetic-256 index of ``cfg`` (bf16, random weights from the
    seed, or ``server``'s) with launches per batch, the text and image
    queries, and the f32 index through the kernels against the plain path.
    Returns (report, server, data module)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer

    out: dict = {}
    dm = DataModule(cfg)
    dm.setup("test")
    if server is None:
        torch.manual_seed(SEED)
        server = RetrievalServer(cfg, TriCoLoNet.from_config(cfg))  # device: cuda
    model = server.model
    n_batches = len(dm.test_loader())
    ops.reset_launches()
    reset_host_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    out["index_build_s"] = time.perf_counter() - tic
    out["launches"] = launches = ops.launches()
    out["host_path"] = check_host_path(f"{label} index build", n_batches)
    want = {name: n * n_batches for name, n in BACKBONE_EVAL_LAUNCHES.items()}
    require(launches == want, f"{label} index launches {launches} != {want}")
    require(index.matrix.shape == (256, cfg.model.out_dim), f"{label} index {index.matrix.shape}")
    require(bool(np.isfinite(index.matrix).all()), f"{label} index non-finite")
    log(f"{label} index: {index.matrix.shape} in {out['index_build_s']:.3f} s over {n_batches} "
        f"batches; launches {launches} [{card}]")
    if queries:
        tokens = [dm.val_set[i]["tokens"] for i in (0, 3, 100, 500)]
        answers = [server.query(tokens=q, k=5) for q in tokens]
        image = server.query_image(dm.val_set[0]["images"], k=5)
        for a in answers + [image]:
            require(len(a) == 5 and all(np.isfinite(s) for _, s in a), f"bad {label} answer")
        out["topk"] = [[m for m, _ in a] for a in answers]
        out["image_topk"] = [m for m, _ in image]
        log(f"  {label} queries: 4 token queries, image query (views of "
            f"{dm.val_set[0]['model_id']}) -> {out['image_topk']}")
    bf16_matrix = index.matrix.copy()
    model.set_compute_dtype(torch.float32)  # TF32 is off since phase 5
    kernel32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dm).matrix.copy()
    model.voxel_encoder.use_kernels = True
    model.set_compute_dtype(torch.bfloat16)
    out["plain_vs_kernel_f32_max_abs"] = dev = float(np.abs(kernel32 - plain32).max())
    out["bf16_vs_f32_max_abs"] = float(np.abs(bf16_matrix - kernel32).max())
    require(dev <= F32_TOL, f"{label} f32 kernel vs plain path: {dev} > {F32_TOL}")
    log(f"  {label} f32 index: kernel vs plain max |d| = {dev} (tol {F32_TOL}); bf16 vs f32 "
        f"{out['bf16_vs_f32_max_abs']}")
    return out, server, dm


def backbone_flagship(torch, card, label, extra, train_launches) -> tuple[dict, dict]:
    """13a / 13b: ``FLAGSHIP + extra`` through the index (``backbone_index``),
    one epoch through ``Trainer.fit`` (launches per step exactly
    ``train_launches``, finite losses, step median of 2-6, peak memory;
    every stochastic-depth draw from the step's own generator), the fit's
    best checkpoint served, the f32 train step kernel-vs-plain (TF32 off,
    deterministic cuDNN, one generator seed) and a profiled step. Returns
    (report, launches of the index build and of the fit)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models import efficientnet
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer, dropout_generator

    out, server, _ = backbone_index(torch, card, label, load_config(FLAGSHIP + extra))
    serve_launches = out["launches"]
    del server
    torch.cuda.empty_cache()

    train_cfg = load_config(FLAGSHIP + extra + TRAIN + [f"experiment_name=chip_smoke_{label}"])
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    seeds: list = []

    def seeded(batch, lr, generator):
        seeds.append(generator.initial_seed())
        return step(batch, lr, generator)

    trainer.train_step = timed_step(torch, seeded, steps)
    draws: list = []
    draw = efficientnet.stochastic_depth

    def counted(x, rate, generator, rows=(0, 1)):
        draws.append(generator.initial_seed())
        return draw(x, rate, generator, rows)

    efficientnet.stochastic_depth = counted
    train_dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    try:
        ckpt = trainer.fit(train_dm).best_path
    finally:
        efficientnet.stochastic_depth = draw
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    host = check_host_path(f"{label} train fit", 12)  # 6 train batches, 6 validation
    require(len(steps) == 6, f"one {label} epoch ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"{label} train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == train_launches,
                f"{label} train step {i}: launches {row['launches']} != {train_launches}")
        log(f"  {label} train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) "
            "losses " + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    blocks = [m for m in trainer.model.modules()
              if isinstance(m, efficientnet.MBConv) and m.has_residual and m.drop_rate > 0]
    want = [s for s in seeds for _ in blocks]
    require(sorted(draws) == sorted(want) and len(set(seeds)) == 6,
            f"{label}: {len(draws)} stochastic-depth draws, {len(want)} expected from the "
            "steps' own generators")
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    out["train"] = {"steps": steps, "step_ms_median_2_6": step_ms,
                    "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
                    "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
                    "launches_fit": fit_launches, "fit_s": fit_s, "host_path": host,
                    "stochastic_depth_draws": len(draws),
                    "val_rr5": trainer.metrics.summary("")["RR@5"]}
    log(f"{label} train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{out['train']['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB, launches/step "
        f"{steps[-1]['launches']}, {len(draws)} stochastic-depth draws, fit {fit_s:.1f} s "
        f"[{card}]")

    trained = RetrievalServer.from_checkpoint(train_cfg, ckpt)
    trained_index = trained.build_index(train_dm)
    answer = trained.query_image(train_dm.val_set[0]["images"], k=5)
    require(trained_index.matrix.shape == (256, train_cfg.model.out_dim)
            and bool(np.isfinite(trained_index.matrix).all()), f"trained {label} index")
    require(len(answer) == 5 and all(np.isfinite(s) for _, s in answer),
            f"trained {label} image query")
    log(f"trained {label} checkpoint {Path(ckpt).name} serves: index "
        f"{trained_index.matrix.shape}, image query -> {[m for m, _ in answer]}")
    del trained, trained_index

    batch = to_device_batch(next(iter(train_dm.train_loader())), torch.device("cuda"))
    cfg32 = load_config(FLAGSHIP + extra + TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    log(f"{label} train plain path (f32, TF32 off, deterministic, one generator seed): "
        f"losses rel {cmp['loss_rel']:.3g} (tol {TRAIN_LOSS_RTOL}), grads rel-of-max "
        f"{cmp['grad_rel_of_max']:.3g} (tol {TRAIN_GRAD_TOL}), running_var |d| "
        f"{cmp['running_var_abs']:.3g} (tol {TRAIN_VAR_TOL}), max |d| {cmp['max_abs']}")
    torch.cuda.empty_cache()
    lr = train_cfg.optimizer.lr

    def seeded_step(b, rate):
        return step(b, rate, dropout_generator(train_cfg.train_seed, trainer.step, "cuda"))

    seeded_step(batch, lr)  # warm the bf16 path after the f32 phase
    out["profile"] = prof = profile_step(torch, seeded_step, batch, lr)
    log(f"profiled {label} train step: device busy {prof['device_busy_ms']} ms of "
        f"{prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port kernels "
        f"{prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:10]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in prof["top_ops"][:6]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    del trainer, step, batch
    torch.cuda.empty_cache()
    return out, {f"{label}_serving": serve_launches, f"{label}_train": fit_launches}


def backbone_quick(torch, card, label, extra) -> tuple[dict, dict]:
    """13c: ``FLAGSHIP + extra``'s index (launches per batch), the CUDA-event
    median of 10 eval batches (the first val batch), and two bf16 train
    steps with finite losses."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.inference import eval_step, to_device_batch
    from tricolo_tpu_torch.training import Trainer, dropout_generator

    cfg = load_config(FLAGSHIP + extra)
    out, server, dm = backbone_index(torch, card, label, cfg, queries=False)
    batch = to_device_batch(dm.test_loader().peek(), torch.device("cuda"))
    out["eval_batch_ms"] = ms = time_ms(lambda: eval_step(server.model, batch), torch,
                                        repeats=10, warmup=2)
    del server, batch
    torch.cuda.empty_cache()
    trainer = Trainer(load_config(FLAGSHIP + extra + TRAIN))  # device: cuda
    dm.setup("fit")
    loader = iter(dm.train_loader())
    steps: list = []
    ops.reset_launches()
    for i in range(2):
        losses = trainer.train_step(to_device_batch(next(loader), trainer.device),
                                    trainer.cfg.optimizer.lr,
                                    dropout_generator(trainer.cfg.train_seed, i, trainer.device))
        steps.append({k.split("/")[-1]: v.item() for k, v in losses.items()})
        require(all(np.isfinite(v) for v in steps[-1].values()),
                f"{label} train step {i}: non-finite losses {steps[-1]}")
    train_launches = ops.launches()
    require(train_launches == {k: 2 * n for k, n in TRAIN_LAUNCHES.items()},
            f"{label}: two train steps launched {train_launches}")
    out["train_losses"] = steps
    log(f"{label}: eval batch median of 10 {ms:.3f} ms; two bf16 train steps, total losses "
        f"{[round(s['total_loss'], 5) for s in steps]} [{card}]")
    del trainer
    torch.cuda.empty_cache()
    return out, {f"{label}_serving": out["launches"], f"{label}_train": train_launches}


def other_backbones(torch, card) -> tuple[dict, dict]:
    """Phase 13: 13a Tri(I+V) with ResNet50 and the triplet loss, 13b with
    EfficientNet-B3 and NT-Xent, 13c ResNet34 and EfficientNet-B0."""
    out: dict = {}
    paths: dict = {}
    walls = out["walls_s"] = {}
    for label, extra, launches in (
            ("resnet50_triplet", [BACKBONE + "resnet50", "loss.name=TripletLoss"],
             TRIPLET_TRAIN_LAUNCHES),
            ("efficientnet_b3", [BACKBONE + "efficientnet_b3"], TRAIN_LAUNCHES)):
        tic = time.perf_counter()
        out[label], launch_paths = backbone_flagship(torch, card, label, extra, launches)
        paths.update(launch_paths)
        walls[label] = time.perf_counter() - tic
    for name in ("resnet34", "efficientnet_b0"):
        tic = time.perf_counter()
        out[name], launch_paths = backbone_quick(torch, card, name, [BACKBONE + name])
        paths.update(launch_paths)
        walls[name] = time.perf_counter() - tic
    log("phase 13 walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return out, paths


# -------------------------------------------------------------- phase 14

# The C13/128³ configuration (BASELINE.json's fifth), the README's recipe:
# Tri(I+V) on data=text2shape_c13 (vocab 3968) at 128³ voxels, batch 32,
# precision.remat_voxel, windowed_compact at halo 3 (k the split's max),
# bf16, random weights, over a C13-shaped fixture written from the seed
# (13 categories × 8 models: 6 train, 1 val, 1 test each; 3 captions a
# model; solid-ellipsoid voxel32/64/128 members, seeded views, the
# ellipsoids' OBJs). An index batch launches K1 5 and K2 2; a remat step
# K1 10, K2 4, K3 5, pair 3, two-term 6.
C13_ROOT = ROOT / "build" / "chip_smoke" / "c13"
C13_128 = [
    "data=text2shape_c13",
    f"data.dataset_root_path={C13_ROOT}",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "precision.compute_dtype=bfloat16",
    "data.voxel_size=128",
    "data.batch_size=32",
    "precision.remat_voxel=true",
    "data.voxel_transfer=windowed_compact",
]
C13_TRAIN = [
    "loss.NTXentLoss.use_pallas=true",
    "trainer.max_epochs=1",
    "experiment_name=chip_smoke_c13",
    f"project_root_path={ROOT / 'build' / 'chip_smoke'}",
]
F1_THRESHOLD = 0.1


def c13_fixture(card) -> dict:
    """14a: the fixture on disk; the val split through the fused npz reader
    (``GeneralDataset``: one reader call a model, no RGBA packing) and
    through ``np.load`` + the host loader's RGBA sweep, bit-exact, with
    the host ms of both."""
    import numpy as np

    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data.datasets import GeneralDataset
    from tricolo_tpu_torch.data.fixture import exp_data_dir, write_c13_fixture
    from tricolo_tpu_torch.native import npz_reader

    shutil.rmtree(C13_ROOT, ignore_errors=True)
    tic = time.perf_counter()
    splits = write_c13_fixture(str(C13_ROOT), seed=SEED)
    out = {"fixture_s": time.perf_counter() - tic,
           "models": {split: len(models) for split, models in splits.items()}}
    npz_reader.reset_calls()
    native.reset_calls()
    tic = time.perf_counter()
    val = GeneralDataset(load_config(C13_128), "val")
    out["val_load_s"] = time.perf_counter() - tic
    reads = npz_reader.call_counts()
    require(reads["load_npz_voxels_packed"] == len(splits["val"])
            and native.call_counts()["dense_rgba_to_packed"] == 0,
            f"val split load: {reads} fused reads, {native.call_counts()} host sweeps for "
            f"{len(splits['val'])} models")
    paths = [os.path.join(exp_data_dir(str(C13_ROOT)), c, f"{m}.npz") for c, m in splits["val"]]

    def fused():
        return [npz_reader.load_npz_voxels_packed(p, "voxel128") for p in paths]

    def plain():
        grids = []
        for p in paths:
            with np.load(p) as npz:
                grids.append(native.dense_rgba_to_packed(npz["voxel128"]))
        return grids

    loaded = [(val.vision_data[key]["flat"], val.vision_data[key]["rgb"])
              for key in splits["val"]]
    for got, want, item in zip(fused(), plain(), loaded):
        require(all(np.array_equal(a, b) and np.array_equal(a, c)
                    for a, b, c in zip(got, want, item)),
                "fused npz reader != np.load + RGBA sweep at 128³")
    out["fused_ms"] = statistics.median(_host_ms(fused) for _ in range(5))
    out["np_load_sweep_ms"] = statistics.median(_host_ms(plain) for _ in range(5))
    out["sites"] = [int(len(f)) for f, _ in loaded]
    log(f"c13 fixture: {out['models']} models in {out['fixture_s']:.1f} s; val split "
        f"({len(val)} captions) loaded in {out['val_load_s']:.2f} s through {reads} fused "
        f"reads; voxel128 of {len(paths)} models: fused reader {out['fused_ms']:.1f} ms vs "
        f"np.load + sweep {out['np_load_sweep_ms']:.1f} ms (host, median of 5), bit-exact; "
        f"{min(out['sites'])}-{max(out['sites'])} sites a model [{host_cpu()}] [{card}]")
    return out


def c13_kernels(torch, cfg, first) -> dict:
    """14b: K1 and K3 at the recipe's five blocks and K2 per-sample on its
    32³ grid, shaped by a real train batch (T = B·k rows) and K2 on its
    ids, against their plain versions, bit-exact, timed beside the bound."""
    B, k = first["voxel_row_ids"].shape
    T, D = B * k, cfg.data.voxel_size
    shapes = [
        ("c13_128", "block1", (T, 12, 12, 12, 32), True),
        ("c13_128", "block2", (T, 4, 4, 4, 64), False),
        ("c13_128", "block3", (B, D // 4, D // 4, D // 4, 128), False),
        ("c13_128", "block4", (B, D // 8, D // 8, D // 8, 256), False),
        ("c13_128", "block5", (B, D // 16, D // 16, D // 16, 512), False),
    ]
    flush = make_flush(torch)
    k1_err, k1_rows = check_k1(torch, shapes, flush)
    k3_err, k3_rows = check_k3(torch, shapes, flush)
    ids = torch.from_numpy(first["voxel_row_ids"]).cuda()
    k2_err, k2_rows = check_k2(torch, ids, D // 4, flush)
    del flush, ids
    torch.cuda.empty_cache()
    return {"B": B, "k": k, "T": T, "k1_err": k1_err, "k1": k1_rows, "k2_err": k2_err,
            "k2": k2_rows, "k3_err": k3_err, "k3": k3_rows}


def c13_host_batch(first, d) -> dict:
    """The host side of one 128³ batch: the windowed_compact sweep (C++,
    median of 5) and ``pin_batch``'s copy into page-locked memory, host
    ms, and the batch's bytes."""
    import numpy as np

    from tricolo_tpu_torch import native
    from tricolo_tpu_torch.data.loader import pin_batch

    flat, rgb = first["voxel_flat"], first["voxel_rgb"]
    k = first["k"]
    sweep_ms = statistics.median(
        _host_ms(lambda: native.packed_to_windowed_compact(flat, rgb, d, k, 8, 3))
        for _ in range(5))
    rows, ids, _ = native.packed_to_windowed_compact(flat, rgb, d, k, 8, 3)
    batch = {"voxel_rows": rows, "voxel_row_ids": ids}
    pin_ms = statistics.median(_host_ms(lambda: pin_batch(batch)) for _ in range(3))
    return {"sweep_ms": sweep_ms, "pin_ms": pin_ms, "rows_bytes": int(rows.nbytes),
            "sites": int((flat != np.uint32(0xFFFFFFFF)).sum())}


def c13_index(torch, card, cfg) -> dict:
    """14c (serving): the val split's index in bf16 with launches per batch
    exactly K1 5 and K2 2, its wall split by part (``index_breakdown``),
    and the f32 index through the kernels against the plain path (1e-5)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer

    dm = DataModule(cfg)
    dm.setup("test")
    n_batches, n_models = len(dm.test_loader()), len(dm.val_set.vision_data)
    torch.manual_seed(SEED)
    server = RetrievalServer(cfg, TriCoLoNet.from_config(cfg))  # device: cuda
    ops.reset_launches()
    reset_host_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    out = {"index_build_s": time.perf_counter() - tic, "launches": ops.launches(),
           "batches": n_batches}
    out["host_path"] = check_host_path("c13 index build", n_batches)
    want = {name: n * n_batches for name, n in CLIP_EVAL_LAUNCHES.items()}
    require(out["launches"] == want, f"c13 index launches {out['launches']} != {want}")
    require(index.matrix.shape == (n_models, cfg.model.out_dim)
            and bool(np.isfinite(index.matrix).all()), f"c13 index {index.matrix.shape}")
    out["breakdown"] = index_breakdown(torch, dm, server.model)
    bf16_matrix = index.matrix.copy()
    server.model.set_compute_dtype(torch.float32)  # TF32 is off since phase 5
    kernel32 = server.build_index(dm).matrix.copy()
    server.model.voxel_encoder.use_kernels = False
    plain32 = server.build_index(dm).matrix.copy()
    out["plain_vs_kernel_f32_max_abs"] = dev = float(np.abs(kernel32 - plain32).max())
    out["bf16_vs_f32_max_abs"] = float(np.abs(bf16_matrix - kernel32).max())
    require(dev <= F32_TOL, f"c13 f32 index: kernel vs plain {dev} > {F32_TOL}")
    log(f"c13 index: {index.matrix.shape} in {out['index_build_s']:.3f} s over {n_batches} "
        f"batches, launches {out['launches']}; f32 kernel vs plain max |d| {dev} (tol "
        f"{F32_TOL}), bf16 vs f32 {out['bf16_vs_f32_max_abs']:.3g}; breakdown " + ", ".join(
            f"{key} {value:.4f}" for key, value in out["breakdown"].items()) + f" [{card}]")
    del server, index
    torch.cuda.empty_cache()
    return out


def c13_fit(torch, card, cfg) -> tuple[dict, str]:
    """14c (training): one epoch through ``Trainer.fit`` with remat (launches
    a step exactly ``REMAT_LAUNCHES``, finite losses, step median of 2-6 and
    pairs/s, peak memory, the train loop's device idle share over the
    epoch), one bf16 step each with remat off and on from the trained
    weights (peak memory of each), the f32 step kernel-vs-plain with phase
    9's tolerances and a profiled step. Returns (report, best checkpoint)."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    train_cfg = load_config(C13_128 + C13_TRAIN)
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    trainer.train_step = timed_step(torch, step, steps)
    dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    ckpt = trainer.fit(dm).best_path
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(dm.train_set) // train_cfg.data.batch_size
    n_val = len(dm.test_loader())
    host = check_host_path("c13 train fit", n_train + n_val)
    require(len(steps) == n_train >= 6, f"one c13 epoch ran {len(steps)} steps, not {n_train}")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"c13 train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == REMAT_LAUNCHES,
                f"c13 train step {i}: launches {row['launches']} != {REMAT_LAUNCHES}")
        log(f"  c13 train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) losses "
            + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    step_ms = statistics.median(r["ms"] for r in steps[1:6])
    loop_s = trainer.timers["train"]
    out = {"steps": steps, "step_ms_median_2_6": step_ms,
           "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:6]),
           "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
           "launches_fit": fit_launches, "fit_s": fit_s, "host_path": host,
           "train_loop_s": loop_s,
           "train_loop_idle_share": 1.0 - sum(r["ms"] for r in steps) / 1e3 / loop_s,
           "timers_s": dict(trainer.timers), "k": dm.train_loader().tile_budget_rows}
    log(f"c13 train: {len(steps)} steps of {train_cfg.data.batch_size} (k={out['k']}), median "
        f"step (2-6) {step_ms:.3f} ms = {out['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB "
        f"(remat on), launches/step {steps[-1]['launches']}; train loop {loop_s:.2f} s, device "
        f"idle share over it {out['train_loop_idle_share']:.3f}; fit {fit_s:.1f} s [{card}]")

    first = next(iter(dm.train_loader()))
    batch = to_device_batch(first, torch.device("cuda"))
    lr = train_cfg.optimizer.lr
    out["remat"] = {}
    for remat in (False, True):
        # The storages the autograd graph keeps for the backward (each once),
        # beside the step's peak.
        saved: dict = {}

        def pack(t):
            saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        trainer.model.voxel_encoder.remat = remat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                peak_segments(torch, trainer.model) as segments:
            losses = step(batch, lr)
        torch.cuda.synchronize()
        out["remat"]["on" if remat else "off"] = row = {
            "total_loss": losses["train_loss/total_loss"].item(), "launches": ops.launches(),
            "peak_gib": max(peak for _, peak, _ in segments),
            "saved_gib": sum(saved.values()) / 2**30, "segments": segments}
        require(row["launches"] == (REMAT_LAUNCHES if remat else TRAIN_LAUNCHES),
                f"c13 remat={remat} step launches {row['launches']}")
    log("c13 one bf16 step, remat off / on: peak "
        f"{out['remat']['off']['peak_gib']:.2f} / {out['remat']['on']['peak_gib']:.2f} GiB, "
        f"saved for the backward {out['remat']['off']['saved_gib']:.2f} / "
        f"{out['remat']['on']['saved_gib']:.2f} GiB [{card}]")
    for key in ("off", "on"):
        log(f"  remat {key}, peak GiB by segment (allocated at its end): " + ", ".join(
            f"{label} {peak:.2f} ({held:.2f})" for label, peak, held in out["remat"][key][
                "segments"]))
    out["profile"] = prof = profile_step(torch, step, batch, lr)
    log(f"profiled c13 train step: device busy {prof['device_busy_ms']} ms of "
        f"{prof['wall_ms']:.3f} ms wall, idle share {prof['device_idle_share']}, port kernels "
        f"{prof['port_kernels_ms']} [{card}]")
    for row in prof["top"][:10]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in prof["top_ops"][:6]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    out["host_batch"] = c13_host_batch(_packed_first(dm, out["k"]), train_cfg.data.voxel_size)
    hb = out["host_batch"]
    log(f"c13 host batch: {hb['sites']} sites -> {hb['rows_bytes'] / 2**20:.1f} MiB of rows; "
        f"C++ windowed_compact sweep {hb['sweep_ms']:.2f} ms, pin_batch {hb['pin_ms']:.2f} ms "
        f"(host) [{host_cpu()}] [{card}]")
    del trainer, step
    torch.cuda.empty_cache()

    cfg32 = load_config(C13_128 + C13_TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    log(f"c13 train plain path (f32, TF32 off, deterministic): losses rel {cmp['loss_rel']:.3g} "
        f"(tol {TRAIN_LOSS_RTOL}), grads rel-of-max {cmp['grad_rel_of_max']:.3g} (tol "
        f"{TRAIN_GRAD_TOL}), running_var |d| {cmp['running_var_abs']:.3g} (tol "
        f"{TRAIN_VAR_TOL}), max |d| {cmp['max_abs']}")
    del batch
    torch.cuda.empty_cache()
    return out, ckpt


@contextlib.contextmanager
def peak_segments(torch, model):
    """Peak device memory by segment of a train step: forward hooks on the
    encoders and the voxel blocks close a segment at each module's start
    and end (the peak since the last mark, in GiB, and what is allocated
    there); the last segment is the backward and the optimizer step. The
    allocator's counters are host-side, so marking needs no synchronise."""
    segments: list = []

    def mark(label):
        segments.append((label, torch.cuda.max_memory_allocated() / 2**30,
                         torch.cuda.memory_allocated() / 2**30))
        torch.cuda.reset_peak_memory_stats()

    modules = [("text", model.text_encoder), ("image", model.image_encoder)]
    modules += [(f"voxel block {i + 1}", b) for i, b in enumerate(model.voxel_encoder.blocks)]
    modules.append(("voxel head", model.voxel_encoder.head))
    handles = []
    for label, module in modules:
        handles.append(module.register_forward_pre_hook(
            lambda m, a, label=label: mark(f"to {label}")))
        handles.append(module.register_forward_hook(
            lambda m, a, o, label=label: mark(f"{label} forward")))
    torch.cuda.reset_peak_memory_stats()
    try:
        yield segments
    finally:
        for handle in handles:
            handle.remove()
        mark("backward + optimizer")


def _packed_first(dm, k) -> dict:
    """The first train batch's packed words (the loader's collation with
    the packed transfer) and the split's k."""
    loader = dm.train_loader()
    loader.voxel_transfer = "packed"
    return dict(loader.peek(), k=k)


def f1_decisions(torch, cache_dir: str, pairs) -> dict:
    """Each scored (gt, pred) pair's threshold decisions, both directions:
    the port's search on the card against a float64 oracle on the host
    (scipy's exact k-d tree over the same f32 points), and, beside the main
    path, the JAX package's expansion |a|² − 2a·bᵀ + |b|² in f32 on the card
    with TF32 off and on. Counts of decisions that differ from the oracle."""
    import numpy as np
    from scipy.spatial import cKDTree

    from tricolo_tpu_torch.evaluation.f1_mesh import min_dists

    def expansion(a, b, tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            a_t, b_t = (torch.as_tensor(x, device="cuda") for x in (a, b))
            b_sq = (b_t * b_t).sum(1)
            out = []
            for start in range(0, len(a_t), 2048):
                blk = a_t[start : start + 2048]
                d2 = (blk * blk).sum(1)[:, None] - 2.0 * (blk @ b_t.T) + b_sq[None]
                out.append(d2.amin(1).clamp_min(0).sqrt())
            return torch.cat(out).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    counts = {"decisions": 0, "port": 0, "expansion_f32": 0, "expansion_tf32": 0}
    search_s = oracle_s = 0.0
    t = F1_THRESHOLD
    for gt, pred in pairs:
        g, p = (np.load(os.path.join(cache_dir, f"{m}.npy")) for m in (gt, pred))
        for a, b in ((p, g), (g, p)):
            tic = time.perf_counter()
            port = min_dists(a, b, device="cuda")
            search_s += time.perf_counter() - tic
            tic = time.perf_counter()
            oracle = cKDTree(b.astype(np.float64)).query(a.astype(np.float64), k=1)[0]
            oracle_s += time.perf_counter() - tic
            truth = oracle < t
            counts["decisions"] += len(a)
            counts["port"] += int(((port < t) != truth).sum())
            counts["expansion_f32"] += int(((expansion(a, b, False) < t) != truth).sum())
            counts["expansion_tf32"] += int(((expansion(a, b, True) < t) != truth).sum())
    return {"flips": counts, "search_s": search_s, "oracle_s": oracle_s}


def c13_test_and_f1(torch, card, ckpt) -> dict:
    """14d: the test CLI on the fit's checkpoint (it writes nearest.jsonl
    in its CWD), then ``python -m tricolo_tpu_torch.calculate_f1`` over that
    file and the fixture's OBJs on the card; the mean F1 and the threshold
    decisions that differ from a float64 oracle."""
    from tricolo_tpu_torch.data.fixture import exp_data_dir, shapenet_dir

    run_dir = C13_ROOT / "test_run"
    run_dir.mkdir(parents=True, exist_ok=True)
    tic = time.perf_counter()
    metrics = _cli("test", C13_128 + C13_TRAIN + [f"+ckpt_path={ckpt}"], run_dir)
    out = {"test_cli": metrics, "test_cli_s": time.perf_counter() - tic}
    nearest = run_dir / "nearest.jsonl"
    rows = [json.loads(line) for line in nearest.read_text().splitlines() if line.strip()]
    val_map = os.path.join(exp_data_dir(str(C13_ROOT)), "val_map.json")
    cache = run_dir / "point_cache"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    tic = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tricolo_tpu_torch.calculate_f1", f"+nearest_path={nearest}",
         f"+val_map_path={val_map}", f"+shapenet_root={shapenet_dir(str(C13_ROOT))}",
         f"+point_cache_dir={cache}"],
        cwd=run_dir, env=env, capture_output=True, text=True, timeout=600)
    out["f1_cli_s"] = time.perf_counter() - tic
    require(proc.returncode == 0, f"calculate_f1 CLI failed ({proc.returncode}): "
            f"{proc.stderr[-2000:]}")
    out["mean_f1"] = mean_f1 = float(proc.stdout.strip().splitlines()[-1])
    require(0.0 <= mean_f1 <= 100.0, f"mean F1 {mean_f1} outside [0, 100]")
    pairs = sorted({(r["groundtruth"].rsplit("-", 1)[0], r["retrieved_models"][0])
                    for r in rows})
    hits = sum(r["groundtruth"].rsplit("-", 1)[0] == r["retrieved_models"][0] for r in rows)
    out.update(queries=len(rows), pairs=len(pairs), top1_hits=hits)
    out.update(f1_decisions(torch, str(cache), pairs))
    flips = out["flips"]
    log(f"c13 test CLI on {Path(ckpt).name}: RR@1 RR@5 NDCG@5 MRR {metrics} "
        f"({out['test_cli_s']:.1f} s); calculate_f1 on the card over {len(rows)} queries "
        f"({len(pairs)} pairs, {hits} top-1 hits): mean F1@{F1_THRESHOLD} = {mean_f1} in "
        f"{out['f1_cli_s']:.1f} s; threshold decisions differing from the float64 oracle: "
        f"port {flips['port']} of {flips['decisions']} (search {out['search_s']:.2f} s, "
        f"oracle {out['oracle_s']:.2f} s host); beside the path, the f32 expansion "
        f"{flips['expansion_f32']}, with TF32 {flips['expansion_tf32']} [{card}]")
    return out


def c13_128(torch, card) -> tuple[dict, dict]:
    """Phase 14: 14a the fixture and the fused reader, 14b the kernels at
    the 128³ shapes, 14c the index and the fit, 14d the test CLI and mesh
    F1. Returns (report, launches of the index build and of the fit)."""
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule

    out: dict = {}
    walls = out["walls_s"] = {}
    tic = time.perf_counter()
    out["fixture"] = c13_fixture(card)
    walls["fixture"] = time.perf_counter() - tic

    tic = time.perf_counter()
    cfg = load_config(C13_128)
    dm = DataModule(cfg)
    dm.setup("fit")
    out["kernels"] = c13_kernels(torch, cfg, dm.train_loader().peek())
    kr = out["kernels"]
    log(f"c13 kernels (B={kr['B']}, k={kr['k']}, T={kr['T']}): K1 max err {kr['k1_err']}, "
        f"K2 max err {kr['k2_err']}, K3 max err {kr['k3_err']} (bit-exact required)")
    del dm
    walls["kernels"] = time.perf_counter() - tic

    tic = time.perf_counter()
    out["index"] = c13_index(torch, card, cfg)
    walls["index"] = time.perf_counter() - tic
    tic = time.perf_counter()
    out["train"], ckpt = c13_fit(torch, card, cfg)
    walls["fit"] = time.perf_counter() - tic
    tic = time.perf_counter()
    out["test_f1"] = c13_test_and_f1(torch, card, ckpt)
    walls["test_f1"] = time.perf_counter() - tic
    log("phase 14 walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return out, {"c13_serving": out["index"]["launches"], "c13_train": out["train"]["launches_fit"]}


# -------------------------------------------------------------- phase 15

# bf16 parameters on the flagship Tri(I+V) (windowed_compact, masked BN):
# the launches of phases 4 and 7, each kernel's γ, β in bf16.
BF16_PARAMS = ["precision.param_dtype=bfloat16"]


def bf16_dtypes(torch, model, optimizer=None) -> dict:
    """Every parameter (and Adam moment) bf16, every BN running statistic
    f32: the counts, or a failure."""
    params = list(model.parameters())
    stats = [b for name, b in model.named_buffers() if "running_" in name]
    require({p.dtype for p in params} == {torch.bfloat16}, "a parameter is not bf16")
    require(bool(stats) and {b.dtype for b in stats} == {torch.float32},
            "a BN running statistic is not f32")
    out = {"params": len(params), "running_stats": len(stats)}
    if optimizer is not None:
        moments = [optimizer.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")]
        require(len(moments) == 2 * len(params)
                and {m.dtype for m in moments} == {torch.bfloat16}, "an Adam moment is not bf16")
        out["moments"] = len(moments)
    return out


def bf16_params(torch, card, f32_train: dict) -> tuple[dict, dict]:
    """Phase 15: the flagship at ``precision.param_dtype=bfloat16``. 15a a
    seeded bf16 model saved as a port checkpoint and served by
    ``RetrievalServer.from_checkpoint``: its index (launches per batch
    exactly K1 5, K2 2), four token queries and one image query, then the
    same index at f32 compute through the kernels and the plain path (15c,
    ≤ ``F32_TOL``); 15b one epoch through ``Trainer.fit`` at bf16 compute
    (a step exactly K1 5, K2 2, K3 5, pair 3, two-term 6; finite losses,
    step median of 2-6 and pairs/s, peak memory) and a profiled step, beside
    phase 7's f32-parameter numbers (``f32_train``; reported, not a gate);
    15c the f32-compute step kernel-vs-plain from one state with phase 9's
    tolerances, one bf16 ulp more for each bf16 gradient element
    (``train_plain_compare``), and the updated bf16 parameters
    (``bf16_updates``); 15d the
    dtypes of the served and trained models and of Adam's moments."""
    import numpy as np

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer
    from tricolo_tpu_torch.training.checkpoint import save_checkpoint

    label = "bf16_params"
    cfg = load_config(FLAGSHIP + BF16_PARAMS)
    torch.manual_seed(SEED)
    seeded = TriCoLoNet.from_config(cfg)
    ckpt = ROOT / "build" / "chip_smoke" / label / "seeded.ckpt"
    save_checkpoint(str(ckpt), {"model": seeded.state_dict(), "optimizer": {}, "step": 0},
                    epoch=0)
    del seeded
    server = RetrievalServer.from_checkpoint(cfg, str(ckpt))  # device: cuda
    dtypes = {"served": bf16_dtypes(torch, server.model)}
    out, server, _ = backbone_index(torch, card, label, cfg, server=server)
    serve_launches = out["launches"]
    del server
    torch.cuda.empty_cache()

    train_cfg = load_config(FLAGSHIP + BF16_PARAMS + TRAIN + [f"experiment_name=chip_smoke_{label}"])
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    step = trainer.train_step
    trainer.train_step = timed_step(torch, step, steps)
    train_dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    trainer.fit(train_dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    fit_launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    host = check_host_path(f"{label} train fit", 12)  # 6 train batches, 6 validation
    require(len(steps) == 6, f"one {label} epoch ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        require(all(np.isfinite(v) for v in row["losses"].values()),
                f"{label} train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == TRAIN_LAUNCHES,
                f"{label} train step {i}: launches {row['launches']} != {TRAIN_LAUNCHES}")
        log(f"  {label} train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) "
            "losses " + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    dtypes["trained"] = bf16_dtypes(torch, trainer.model, trainer.optimizer)
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    lr = train_cfg.optimizer.lr
    batch = to_device_batch(next(iter(train_dm.train_loader())), torch.device("cuda"))
    step(batch, lr)  # a step outside the profile: the profiled one is warm
    prof = profile_step(torch, step, batch, lr)
    out["train"] = {"steps": steps, "step_ms_median_2_6": step_ms,
                    "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
                    "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3), "peak_gib": peak,
                    "allocated_at_fit_start_gib": base, "launches_fit": fit_launches,
                    "fit_s": fit_s, "host_path": host, "profile": prof}
    f32_base = f32_train["allocated_at_fit_start_gib"]
    out["f32_params_same_run"] = {
        "step_ms_median_2_6": f32_train["step_ms_median_2_6"],
        "pairs_per_s": f32_train["pairs_per_s"], "peak_gib": f32_train["peak_gib"],
        "allocated_at_fit_start_gib": f32_base,
        "device_idle_share": f32_train["profile"]["device_idle_share"]}
    log(f"{label} train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{out['train']['pairs_per_s']:.1f} pairs/s, peak {peak:.2f} GiB ({peak - base:.2f} "
        f"above the {base:.2f} allocated at the fit's start), profiled step idle share "
        f"{prof['device_idle_share']}, launches/step {steps[-1]['launches']}, fit {fit_s:.1f} "
        f"s; f32 parameters (phase 7, 10): {f32_train['step_ms_median_2_6']:.3f} ms = "
        f"{f32_train['pairs_per_s']:.1f} pairs/s, peak {f32_train['peak_gib']:.2f} GiB "
        f"({f32_train['peak_gib'] - f32_base:.2f} above {f32_base:.2f}), idle share "
        f"{f32_train['profile']['device_idle_share']} [{card}]")
    for row in prof["top"][:6]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    del trainer, step
    torch.cuda.empty_cache()

    cfg32 = load_config(FLAGSHIP + BF16_PARAMS + TRAIN + ["precision.compute_dtype=float32"])
    out["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, batch)
    upd = cmp["bf16_updates"]
    log(f"{label} train plain path (f32 compute, TF32 off, deterministic): losses rel "
        f"{cmp['loss_rel']:.3g} (tol {TRAIN_LOSS_RTOL}), grads rel-of-max "
        f"{cmp['grad_rel_of_max']:.3g} (tol {TRAIN_GRAD_TOL} and one bf16 ulp of each "
        f"element; margin {cmp['grad_gate_margin']:.3g}), running_var |d| "
        f"{cmp['running_var_abs']:.3g} (tol {TRAIN_VAR_TOL}); updated bf16 parameters: "
        f"{upd['differ']} of {upd['elements']} differ, {upd['beyond_one_ulp']} beyond one "
        f"ulp (max |d| {upd['beyond_max_abs']:.3g}, within 2·lr + 1 ulp)")
    out["dtypes"] = dtypes
    log(f"{label} dtypes: {dtypes} (parameters and moments bf16, BN statistics f32)")
    del batch
    torch.cuda.empty_cache()
    return out, {f"{label}_serving": serve_launches, f"{label}_train": fit_launches}


# -------------------------------------------------------------- phase 16

# FSDP (``parallel.param_sharding=fsdp``, ``parallel.sharding_rules``) on the
# flagship Tri(I+V), each rank a subprocess of this script (``--dp-rank``),
# as in phase 12: 16a a 1-rank NCCL world, 16b and 16c two gloo ranks on
# cuda:0. A sharded step launches what a replicated step launches.
FSDP = ["parallel.param_sharding=fsdp"]


def _state_bytes(torch, trainer) -> int:
    """Bytes of the parameters and Adam moments this rank holds."""
    from tricolo_tpu_torch.training.optim import _local

    tensors = [_local(p) for p in trainer.model.parameters()]
    tensors += [_local(m) for s in trainer.optimizer.state.values()
                for k, m in s.items() if k != "step"]
    return sum(t.numel() * t.element_size() for t in tensors)


def _fsdp_turns(torch, port, param_dtype) -> tuple[dict, dict]:
    """16a at one parameter dtype: a replicated and an FSDP ``Trainer`` of
    the 1-rank world from the same seed, bf16 steps in turns on the epoch's
    six batches (CUDA events, launches, each step's peak above its start);
    (report, the replicated trainer's state after its six steps)."""
    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.parallel import sharded_leaves
    from tricolo_tpu_torch.training import Trainer, dropout_generator

    extra = [f"precision.param_dtype={param_dtype}"]
    trainers = {"replicated": Trainer(_dp_cfg(1, 0, port, "bfloat16", extra)),
                "fsdp": Trainer(_dp_cfg(1, 0, port, "bfloat16", extra + FSDP))}
    require(torch.distributed.get_backend() == "nccl"
            and trainers["fsdp"].world.size == 1, "16a: no 1-rank NCCL world")
    leaves = sharded_leaves(trainers["fsdp"].model)
    dm = DataModule(trainers["fsdp"].cfg)
    dm.setup("fit")
    loader = dm.train_loader(pin_memory=True)
    rows: dict = {name: [] for name in trainers}
    for i, host in enumerate(loader):
        batch = to_device_batch(host, trainers["fsdp"].device)
        for name, trainer in trainers.items():
            generator = dropout_generator(trainer.cfg.train_seed, i, trainer.device)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = ops.launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = trainer.train_step(batch, trainer.cfg.optimizer.lr, generator)
            end.record()
            end.synchronize()
            after = ops.launches()
            rows[name].append({"ms": start.elapsed_time(end),
                               "total_loss": losses["train_loss/total_loss"].item(),
                               "launches": {k: after[k] - before[k] for k in after},
                               "peak_above_start_gib":
                                   (torch.cuda.max_memory_allocated() - base) / 2**30})
    out = {"rows": rows, "sharded_leaves": len(leaves),
           "sharded_elements": sum(leaves.values()),
           "elements": sum(p.numel() for p in trainers["fsdp"].model.parameters()),
           "step_ms_median_2_6": {k: statistics.median(r["ms"] for r in v[1:])
                                  for k, v in rows.items()},
           "state_gib": {k: _state_bytes(torch, t) / 2**30 for k, t in trainers.items()},
           "step_peak_above_start_gib": {k: max(r["peak_above_start_gib"] for r in v)
                                         for k, v in rows.items()}}
    if param_dtype == "bfloat16":
        out["dtypes"] = bf16_dtypes(torch, trainers["fsdp"].model, trainers["fsdp"].optimizer)
    state = {k: v.clone() for k, v in trainers["replicated"].model.state_dict().items()}
    return out, state


def fsdp_world1(port: str) -> dict:
    """16a, in a rank's process (1-rank NCCL world), at f32 and at bf16
    parameters: ``_fsdp_turns``; then, from the replicated trainer's
    weights after its six steps, one f32-compute step each of a replicated
    and an FSDP trainer on the first batch (TF32 off, deterministic cuDNN;
    the replicated one twice, for the run-to-run floor); last, one remat
    step under FSDP (f32 parameters, bf16 compute)."""
    import torch

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    DP_DIR.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    for param_dtype in ("float32", "bfloat16"):
        out[param_dtype], state = _fsdp_turns(torch, port, param_dtype)
        torch.cuda.empty_cache()
        _deterministic_f32(torch)
        extra = [f"precision.param_dtype={param_dtype}"]
        rep = Trainer(_dp_cfg(1, 0, port, "float32", extra))
        fsdp = Trainer(_dp_cfg(1, 0, port, "float32", extra + FSDP))
        dm = DataModule(rep.cfg)
        dm.setup("fit")
        host = dm.train_loader().peek()
        batch = to_device_batch(host, rep.device)
        ref = _f32_step(torch, rep, state, batch)
        again = _f32_step(torch, rep, state, batch)
        got = _f32_step(torch, fsdp, state, batch)
        out[param_dtype].update(f32_vs_replicated=_f32_deviation(got, ref),
                                f32_floor_replicated_twice=_f32_deviation(again, ref))
        if param_dtype == "float32":
            torch.save(state, DP_DIR / "fsdp_state.pt")
        torch.backends.cudnn.deterministic = False
        del rep, fsdp, batch, state, ref, again, got
        torch.cuda.empty_cache()

    trainer = Trainer(_dp_cfg(1, 0, port, "bfloat16", FSDP + ["precision.remat_voxel=true"]))
    batch = to_device_batch(host, trainer.device)
    ops.reset_launches()
    losses = trainer.train_step(batch, trainer.cfg.optimizer.lr)
    torch.cuda.synchronize()
    out["remat"] = {"total_loss": losses["train_loss/total_loss"].item(),
                    "launches": ops.launches()}
    return out


def fsdp_two_ranks(rank: int, port: str) -> dict:
    """16b and 16c, in rank ``rank`` of two gloo ranks on cuda:0: one f32
    step of a replicated and of an FSDP trainer on the rank's stripe of the
    first batch from 16a's weights (the replicated one twice, for the
    run-to-run floor), the sharded leaves' local element counts; then one
    bf16 epoch through ``Trainer.fit`` under FSDP (launches a step)."""
    import torch

    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.parallel import fsdp_axis, sharded_leaves
    from tricolo_tpu_torch.training import Trainer

    _deterministic_f32(torch)
    rep = Trainer(_dp_cfg(2, rank, port, "float32"), device="cuda:0", backend="gloo")
    fsdp = Trainer(_dp_cfg(2, rank, port, "float32", FSDP), device="cuda:0", backend="gloo")
    require(torch.distributed.get_backend() == "gloo" and fsdp.world.size == 2,
            "16b: no 2-rank gloo world")
    dm = DataModule(rep.cfg)
    dm.setup("fit")
    host = dm.train_loader().peek()
    batch = to_device_batch(host, rep.device)
    state = torch.load(DP_DIR / "fsdp_state.pt", map_location=rep.device)
    ref = _f32_step(torch, rep, state, batch)
    again = _f32_step(torch, rep, state, batch)
    ops.reset_launches()
    got = _f32_step(torch, fsdp, state, batch)
    leaves = sharded_leaves(fsdp.model)
    want = {n: p.numel() // 2 for n, p in fsdp.model.named_parameters()
            if fsdp_axis(p.shape, 2) is not None}
    out = {"f32_vs_replicated": _f32_deviation(got, ref),
           "f32_floor_replicated_twice": _f32_deviation(again, ref),
           "launches_f32": ops.launches(), "local_batch": len(host["model_id"]),
           "leaves_equal_rule": leaves == want, "sharded_leaves": len(leaves),
           "local_elements": sum(leaves.values()),
           "elements": sum(p.numel() for p in fsdp.model.parameters()),
           "state_gib": {"replicated": _state_bytes(torch, rep) / 2**30,
                         "fsdp": _state_bytes(torch, fsdp) / 2**30}}
    torch.backends.cudnn.deterministic = False
    del rep, fsdp, batch, state, ref, again, got
    torch.cuda.empty_cache()

    trainer = Trainer(_dp_cfg(2, rank, port, "bfloat16",
                              FSDP + ["experiment_name=chip_smoke_fsdp"]),
                      device="cuda:0", backend="gloo")
    steps: list = []
    trainer.train_step = timed_step(torch, trainer.train_step, steps)
    ops.reset_launches()
    tic = time.perf_counter()
    best = trainer.fit(DataModule(trainer.cfg)).best_path
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - tic, launches_fit=ops.launches(), steps=steps,
               best_path=best)
    return out


def _fsdp_check_world1(w1: dict, card: str) -> None:
    """16a's gates and lines: launches, the f32 step against replicated,
    the remat step, the dtypes."""
    import numpy as np

    for param_dtype in ("float32", "bfloat16"):
        res = w1[param_dtype]
        cmp, floor = res["f32_vs_replicated"], res["f32_floor_replicated_twice"]
        # World 1 makes FSDP's collectives copies: where the replicated step
        # repeats bit for bit, the FSDP step must equal it bit for bit.
        if floor["max_abs"] == 0.0:
            require(cmp["max_abs"] == 0.0,
                    f"16a {param_dtype}: FSDP f32 step vs replicated |d| {cmp['max_abs']}")
        require(cmp["loss_rel"] <= TRAIN_LOSS_RTOL and cmp["grad_rel_of_max"] <= TRAIN_GRAD_TOL
                and cmp["running_var_abs"] <= TRAIN_VAR_TOL,
                f"16a {param_dtype}: FSDP f32 step vs replicated {cmp}")
        for name, rows in res["rows"].items():
            for i, row in enumerate(rows):
                require(bool(np.isfinite(row["total_loss"])), f"16a {name} step {i}: loss")
                require(row["launches"] == DP_TRAIN_LAUNCHES,
                        f"16a {param_dtype} {name} step {i}: launches {row['launches']}")
        med, state, peak = (res["step_ms_median_2_6"], res["state_gib"],
                            res["step_peak_above_start_gib"])
        log(f"16a 1-rank NCCL, {param_dtype} parameters: FSDP f32 step vs replicated max |d| "
            f"{cmp['max_abs']} (replicated twice: {floor['max_abs']}); bf16 step median (2-6) "
            f"replicated {med['replicated']:.3f} ms, FSDP {med['fsdp']:.3f} ms "
            f"({med['fsdp'] - med['replicated']:+.3f} ms); {res['sharded_leaves']} leaves, "
            f"{res['sharded_elements']} of {res['elements']} elements sharded; parameters and "
            f"moments {state['replicated']:.3f} / {state['fsdp']:.3f} GiB, step peak above its "
            f"start {peak['replicated']:.2f} / {peak['fsdp']:.2f} GiB [{card}]")
    remat = w1["remat"]
    require(remat["launches"] == REMAT_LAUNCHES, f"16a remat: launches {remat['launches']}")
    require(bool(np.isfinite(remat["total_loss"])), "16a remat: non-finite loss")
    log(f"16a FSDP remat step: total loss {remat['total_loss']:.6f}, launches "
        f"{remat['launches']}; bf16-parameter dtypes {w1['bfloat16']['dtypes']}")


def fsdp_phase(torch, card) -> tuple[dict, dict]:
    """Phase 16: (report, launches of 16a's FSDP steps, of the 2-rank FSDP
    fit's ranks and of serving its checkpoint)."""
    import numpy as np

    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.serving import RetrievalServer

    torch.cuda.empty_cache()
    out: dict = {}
    (w1,) = run_ranks(torch, "16a", 1, 600)
    _fsdp_check_world1(w1, card)
    out["world1"] = w1

    ranks = run_ranks(torch, "16b", 2, 600)
    out["two_ranks"] = ranks
    for r, res in enumerate(ranks):
        cmp, floor = res["f32_vs_replicated"], res["f32_floor_replicated_twice"]
        require(res["local_batch"] == 64, f"16b rank {r}: local batch {res['local_batch']}")
        require(res["launches_f32"] == DP_TRAIN_LAUNCHES,
                f"16b rank {r}: FSDP f32 step launches {res['launches_f32']}")
        require(res["leaves_equal_rule"], f"16b rank {r}: local elements unlike fsdp_axis's")
        # Two ranks: each gradient element is a sum of two terms, which
        # commutes, and Adam is elementwise.
        require(floor["max_abs"] == 0.0 and cmp["max_abs"] == 0.0,
                f"16b rank {r}: FSDP f32 step vs replicated |d| {cmp['max_abs']} (replicated "
                f"twice {floor['max_abs']})")
        require(len(res["steps"]) == 6, f"16c rank {r}: the fit ran {len(res['steps'])} steps")
        for i, row in enumerate(res["steps"]):
            require(all(np.isfinite(v) for v in row["losses"].values()),
                    f"16c rank {r} step {i}: non-finite losses")
            require(row["launches"] == DP_TRAIN_LAUNCHES,
                    f"16c rank {r} step {i}: launches {row['launches']}")
        log(f"16b rank {r}: FSDP f32 step vs the replicated 2-rank step max |d| {cmp['max_abs']} "
            f"(replicated twice {floor['max_abs']}); {res['sharded_leaves']} leaves sharded, "
            f"{res['local_elements']} elements held of their {2 * res['local_elements']} "
            f"(rule's arithmetic), parameters and moments {res['state_gib']['replicated']:.3f} "
            f"/ {res['state_gib']['fsdp']:.3f} GiB replicated / FSDP; 16c fit {res['fit_s']:.1f} "
            f"s, step median (2-6) {statistics.median(s['ms'] for s in res['steps'][1:]):.3f} "
            f"ms [{card}]")
    require(ranks[1]["best_path"] is None and ranks[0]["best_path"] is not None,
            "16c: rank 0 alone must write the checkpoint")

    cfg = load_config([*FLAGSHIP, *TRAIN])
    server = RetrievalServer.from_checkpoint(cfg, ranks[0]["best_path"])  # device: cuda
    out["serving"], server, _ = backbone_index(torch, card, "fsdp", cfg, queries=False,
                                               server=server)
    del server
    torch.cuda.empty_cache()
    return out, {"fsdp_world1": {k: sum(s["launches"][k] for p in ("float32", "bfloat16")
                                        for s in w1[p]["rows"]["fsdp"])
                                 for k in DP_TRAIN_LAUNCHES},
                 "fsdp_rank0_fit": ranks[0]["launches_fit"],
                 "fsdp_rank1_fit": ranks[1]["launches_fit"],
                 "fsdp_serving": out["serving"]["launches"]}


# -------------------------------------------------------------- phase 17

# The bench's short form: 2 warm-up steps, N = 4, 2 two-point pairs.
BENCH_RUN = ["--override", "bench.warmup_steps=2", "--override", "bench.steps=4",
             "--pairs", "2", "--idle-wait", "0"]
BENCH_KEYS = {"metric", "value", "unit", "step_ms", "pairs", "salvaged", "config",
              "voxel_size", "batch_size", "card"}
LOADER_STEPS = 6


def _json_line(module: str, proc) -> dict:
    """The one line a measuring CLI prints on stdout, parsed."""
    lines = proc.stdout.strip().splitlines()
    require(len(lines) == 1, f"{module} printed {len(lines)} stdout lines, not one: {lines[:4]}")
    return json.loads(lines[0])


def measuring(torch, card, reference: dict) -> tuple[dict, dict]:
    """Phase 17: the bench (default and dense plan, each traced and
    reported), the loader-included bench in both modes. ``reference``:
    earlier phases' step ms on this card. Returns (report, the benches'
    launches over their timed steps)."""
    out_dir = ROOT / "build" / "chip_smoke" / "bench"
    runs = {"windowed_compact": ([], TRAIN_LAUNCHES, ("K1", "K2", "K3", "K4", "K5-K6")),
            "dense_plan": ([a for o in DENSE for a in ("--override", o)], DENSE_TRAIN_LAUNCHES,
                           ("K7",))}
    out: dict = {"reference_step_ms": reference}
    paths: dict = {}
    torch.cuda.empty_cache()
    for name, (extra, want, labels) in runs.items():
        trace_dir = out_dir / name
        tic = time.perf_counter()
        proc = _run_module("bench", BENCH_RUN + extra + ["--trace", str(trace_dir)], ROOT)
        wall = time.perf_counter() - tic
        result = _json_line("bench", proc)
        require(set(result) == BENCH_KEYS, f"bench {name}: keys {sorted(result)}")
        require(result["salvaged"] is False and result["pairs"] == 2,
                f"bench {name}: salvaged {result['salvaged']}, pairs {result['pairs']}")
        require(result["value"] > 0 and result["card"] == card,
                f"bench {name}: value {result['value']}, card {result['card']!r}")
        counted = json.loads(next(line for line in reversed(proc.stderr.splitlines())
                                  if line.startswith("bench: {"))[len("bench: "):])
        require(counted["launches_per_step"] == want,
                f"bench {name}: launches a step {counted['launches_per_step']} != {want}")
        report = _json_line("trace_report", _run_module(
            "trace_report", [str(trace_dir), "--steps", "4", "--json"], ROOT))
        ours = report["port_kernels_ms_per_step"]
        require(all(ours[label] > 0 for label in labels),
                f"bench {name}: trace shows port kernels {ours}, {labels} required")
        paths[f"bench_{name}"] = {k: v * counted["steps"]
                                  for k, v in counted["launches_per_step"].items()}
        out[name] = {"result": result, "launches": counted, "trace": report, "wall_s": wall}
        log(f"bench {name}: {result['step_ms']:.3f} ms a step = {result['value']:.2f} pairs/s "
            f"(2 pairs, N 4; phase 7 median {reference['phase7']:.3f} ms, phase 10 ellipsoid "
            f"step {reference['phase10_ellipsoid']:.3f} ms), trace: device "
            f"{report['device_ms_per_step']:.3f} ms a step, idle share "
            f"{report['device_idle_share']:.4f}, fwd/bwd {report['phase_ms_per_step']}, port "
            f"kernels {ours}, longest gap {report['gaps'][:1]}; {wall:.1f} s [{card}]")
    for mode in ("host", "e2e"):
        tic = time.perf_counter()
        result = _json_line("bench_loader", _run_module(
            "bench_loader", ["--mode", mode, "--steps", str(LOADER_STEPS)], ROOT))
        require(result["batches"] == LOADER_STEPS and result["value"] > 0,
                f"bench_loader {mode}: {result}")
        out[f"loader_{mode}"] = dict(result, wall_s=time.perf_counter() - tic)
        log(f"bench_loader {mode}: {result} [{card}]")
    return out, paths


# -------------------------------------------------------------- phase 18

# The roofline's short form: the bench's, 1 pair.
ROOFLINE_RUN = ["--override", "bench.warmup_steps=2", "--override", "bench.steps=4",
                "--pairs", "1", "--idle-wait", "0"]
# The roofline's labels of phase 7's kernels (TRAIN_LAUNCHES' keys).
ROOFLINE_LABELS = {"K1": "bn_relu_pool", "K2": "scatter_tiles_ps", "K3": "bn_relu_pool_bwd",
                   "K4-pair": "nt_xent_fwd_pair", "K5-K6": "nt_xent_bwd"}
MIN_ATTRIBUTED = 0.95
MAX_IDLE_FLOOR_MS = 0.1
# A tool's step against phase 17's reading of the same step.
TOOL_STEP_TOL = 0.10
DRESS_SCALE = "0.01"


def _expected_floors(k: int, batch: int, dim: int) -> dict:
    """The K rows' floors a step (ms) from phase 3's windowed_compact block
    shapes at T = batch·k rows (K1 with the argmax, two masks at block 1;
    K3 one mask) and the loss kernels at (batch, dim): 5 K1, 5 K3, 3 pair
    forwards, 6 two-term backwards."""
    from tricolo_tpu_torch.ops.bn_relu_pool import work as k13
    from tricolo_tpu_torch.ops.nt_xent import work as nt
    from tricolo_tpu_torch.work import floor_s

    T = batch * k
    shapes = [((T, 12, 12, 12, 32), 2), ((T, 4, 4, 4, 64), 1), ((batch, 16, 16, 16, 128), 1),
              ((batch, 8, 8, 8, 256), 1), ((batch, 4, 4, 4, 512), 1)]
    out = {"K1": sum(floor_s(*k13("K1", s, 2, m, True), "memory") for s, m in shapes),
           "K3": sum(floor_s(*k13("K3", s, 2, 1), "memory") for s, _ in shapes),
           "K4-pair": 3 * floor_s(*nt("nt_xent_fwd_pair", batch, dim), "f32"),
           "K5-K6": 6 * floor_s(*nt("nt_xent_bwd", batch, dim), "f32")}
    return {label: s * 1e3 for label, s in out.items()}


def _record_floors(record: dict, steps: int) -> dict:
    """Each K label's floor a step (ms), recomputed from the record's
    kernel arguments through the kernel modules' own ``work``."""
    import importlib

    from tricolo_tpu_torch.work import floor_s

    out: dict = {}
    for i, (module, args) in record["kernel_args"].items():
        label, cls = record["ops"][i][0], record["ops"][i][1]
        nbytes, flops = importlib.import_module(module).work(*args)
        out[label] = out.get(label, 0.0) + floor_s(nbytes, flops, cls) * 1e3 / steps
    return out


def roofline_phase(card: str, reference: dict) -> dict:
    """18a: ``bench --roofline`` on the default config, then
    ``roofline_report --json`` on it (gates: module docstring)."""
    from tricolo_tpu_torch.roofline_report import find_record
    from tricolo_tpu_torch.work import load

    out_dir = ROOT / "build" / "chip_smoke" / "roofline"
    proc = _run_module("bench", ROOFLINE_RUN + ["--roofline", str(out_dir)], ROOT)
    result = _json_line("bench", proc)
    require(result["pairs"] == 1 and not result["salvaged"], f"roofline bench: {result}")
    k = int(next(line for line in proc.stderr.splitlines() if "(k " in line)
            .split("(k ", 1)[1].split(")", 1)[0])
    report = _json_line("roofline_report", _run_module(
        "roofline_report", [str(out_dir), "--steps", "4", "--json"], ROOT))
    rows = report["kernel_rows"]
    record = load(find_record(str(out_dir)))
    recomputed = _record_floors(record, 4)
    expected = _expected_floors(k, result["batch_size"], 512)
    require(report["attributed_share"] >= MIN_ATTRIBUTED,
            f"roofline: {report['attributed_share']:.4f} of device time attributed")
    require(set(rows) == set(ROOFLINE_LABELS), f"roofline: kernel rows {sorted(rows)}")
    for label, wrapper in ROOFLINE_LABELS.items():
        row = rows[label]
        require(row["launches"] == TRAIN_LAUNCHES[wrapper],
                f"roofline {label}: {row['launches']} launches a step, "
                f"not {TRAIN_LAUNCHES[wrapper]}")
        require(abs(row["floor_ms"] - recomputed[label]) <= 1e-9 * recomputed[label],
                f"roofline {label}: floor {row['floor_ms']} ms != work() over its launches "
                f"{recomputed[label]} ms")
        if label in expected:
            require(abs(row["floor_ms"] - expected[label]) <= 1e-9 * expected[label],
                    f"roofline {label}: floor {row['floor_ms']} ms != work() at phase 3's "
                    f"shapes, k {k}: {expected[label]} ms")
    require(not report["impossible"], f"roofline: rows above their floor {report['impossible']}")
    require(report["no_device_work_floor_ms"] < MAX_IDLE_FLOOR_MS,
            f"roofline: {report['no_device_work_floor_ms']} ms of floor launched nothing")
    require(0.0 < report["floor_share"] <= 1.0, f"roofline: floor share {report['floor_share']}")
    conv_bwd = [r for r in report["rows"] if r["op"] == "aten::convolution_backward"]
    require(conv_bwd and conv_bwd[0]["device_ms"] > 0,
            "roofline: no convolution_backward with device time (the backward thread's ops "
            "were not counted)")
    ref = reference["trace_device_ms"]
    require(abs(report["device_ms_per_step"] - ref) <= TOOL_STEP_TOL * ref,
            f"roofline: device {report['device_ms_per_step']:.3f} ms a step against phase "
            f"17's trace {ref:.3f}")
    dgrad = [r for r in report["by_kernel"] if "dgrad2d_grouped_direct" in r["kernel"]]
    log(f"roofline (default, k {k}): device {report['device_ms_per_step']:.3f} ms a step "
        f"(phase 17's trace {ref:.3f}), floor {report['floor_ms_per_step']:.3f} ms, share "
        f"{report['floor_share']:.4f}, attributed {report['attributed_share']:.4f}, no-device "
        f"floor {report['no_device_work_floor_ms']:.5f} ms; K rows "
        + ", ".join(f"{lab} {r['device_ms']:.3f}/{r['floor_ms']:.4f} ms x{r['launches']:g}"
                    for lab, r in sorted(rows.items()))
        + f"; dgrad2d_grouped_direct {dgrad[:1]}; top rows "
        + ", ".join(f"{r['op']} {r['device_ms']:.2f}/{r['floor_ms']:.3f}"
                    for r in report["rows"][:6]) + f" [{card}]")
    return {"bench": result, "k": k, "report": report, "expected_floors_ms": expected}


def collectives_phase(card: str, backend: str, worlds: list[str]) -> dict:
    """18d: ``measure_collectives`` over ``worlds`` of ``backend`` ranks:
    every row's gathered bytes equal the JAX formula, its time and loss
    finite."""
    lines = _run_module("measure_collectives", ["--backend", backend, "--worlds", *worlds],
                        ROOT).stdout.strip().splitlines()
    rows = [json.loads(line) for line in lines[:-1]]
    require(len(rows) == 3 * len(worlds), f"measure_collectives {backend}: {lines}")
    for r in rows:
        want = 0 if r["loss"] == "local" else 2 * 2 * 128 * (r["world"] - 1) * 512 * 4
        require(r["gathered_bytes_per_rank"] == want,
                f"measure_collectives {backend}: {r} gathers {want} bytes")
        require(r["ms_per_step"] > 0 and math.isfinite(r["value"]),
                f"measure_collectives {backend}: {r}")
    log(f"measure_collectives {backend}: "
        + ", ".join(f"world {r['world']} {r['loss']} {r['ms_per_step']:.3f} ms" for r in rows)
        + f" [{card}]")
    return {"rows": rows, "summary": json.loads(lines[-1])}


def dress_phase(card: str) -> dict:
    """18f: the dress rehearsal at ``DRESS_SCALE`` for one epoch: generate,
    run (rc 0), report (every key); the split is deleted after."""
    from tricolo_tpu_torch.dress_rehearsal import REPORT_KEYS

    root = ROOT / "build" / "chip_smoke" / "dress"
    shutil.rmtree(root, ignore_errors=True)
    try:
        tic = time.perf_counter()
        _run_module("dress_rehearsal", ["generate", "--root", str(root), "--scale", DRESS_SCALE],
                    ROOT)
        generate_s = time.perf_counter() - tic
        _run_module("dress_rehearsal", ["run", "--root", str(root), "--epochs", "1",
                                        "--extra", "trainer.log_every_n_steps=1"], ROOT)
        result = _json_line("dress_rehearsal", _run_module(
            "dress_rehearsal", ["report", "--root", str(root)], ROOT))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(set(result) == set(REPORT_KEYS), f"dress rehearsal report keys {sorted(result)}")
    require(result["steps"] > 0 and result["total_wall_s"] > 0, f"dress rehearsal: {result}")
    log(f"dress rehearsal x{DRESS_SCALE}: generate {generate_s:.1f} s, {result} [{card}]")
    return dict(result, generate_s=generate_s)


def tools(torch, card: str, reference: dict) -> dict:
    """Phase 18: the measuring and rehearsal tools' short forms, each
    through its CLI (module docstring). The roofline and the two profiles
    run alone, one after another (their times are gated); the collectives,
    the dry run and the rehearsal, whose gates count and check but compare
    no time, then run at once."""
    from concurrent.futures import ThreadPoolExecutor

    out: dict = {"walls_s": {}}

    def timed(name, fn):
        tic = time.perf_counter()
        result = fn()
        out["walls_s"][name] = time.perf_counter() - tic
        return result

    out["roofline"] = timed("roofline", lambda: roofline_phase(card, reference))
    torch.cuda.empty_cache()

    def profile_step():
        result = _json_line("profile_step", _run_module("profile_step", ["--iters", "3"], ROOT))
        rows = result["rows"]
        require(all(math.isfinite(v) and v > 0 for v in rows.values()),
                f"profile_step: rows {rows}")
        ref = reference["bench_step_ms"]
        require(abs(rows["full_step"] - ref) <= TOOL_STEP_TOL * ref,
                f"profile_step: full step {rows['full_step']:.3f} ms against phase 17's bench "
                f"{ref:.3f}")
        log(f"profile_step (B 128, iters 3): "
            + ", ".join(f"{k} {v:.3f}" for k, v in rows.items()) + f" ms [{card}]")
        return result

    out["profile_step"] = timed("profile_step", profile_step)

    def voxel_blocks():
        result = _json_line("profile_voxel_blocks", _run_module(
            "profile_voxel_blocks", ["--iters", "3"], ROOT))
        require(len(result["blocks"]) == 5, f"profile_voxel_blocks: {len(result['blocks'])}")
        one = {"bn_relu_pool_unmasked": 1}
        both = {"bn_relu_pool_unmasked": 1, "bn_relu_pool_bwd_unmasked": 1}
        for row in result["blocks"]:
            cells = {k: v for k, v in row.items() if k not in ("block", "launches")}
            require(all(v > 0 for v in cells.values()),
                    f"profile_voxel_blocks {row['block']}: {cells}")
            want = {"compose_fwd": {}, "compose_fwd_bwd": {}, "plain_fwd": {},
                    "plain_fwd_bwd": {}, "kernel_fwd": one, "kernel_fwd_bwd": both,
                    "block_fwd_bwd": both}
            require(row["launches"] == want,
                    f"profile_voxel_blocks {row['block']}: launches {row['launches']}")
            log(f"profile_voxel_blocks {row['block']}: "
                + ", ".join(f"{k} {v:.3f}" for k, v in cells.items()) + f" ms [{card}]")
        return result

    def dryrun():
        lines = _run_module("dryrun", ["2", "--device", "cuda"], ROOT).stdout.splitlines()
        ran = [line for line in lines if " ran: " in line]
        require(len(ran) == 5 and any("OK: all modes agree" in line for line in lines),
                f"dryrun 2: {lines}")
        log("dryrun(2) on cuda:0: " + "; ".join(line.split(") ", 1)[1] for line in ran)
            + f" [{card}]")
        return ran

    out["profile_voxel_blocks"] = timed("profile_voxel_blocks", voxel_blocks)
    together = {"collectives_gloo": lambda: collectives_phase(card, "gloo", ["1", "2"]),
                "collectives_nccl": lambda: collectives_phase(card, "nccl", ["1"]),
                "dryrun": dryrun, "dress_rehearsal": lambda: dress_phase(card)}
    tic = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(together)) as pool:
        futures = {name: pool.submit(timed, name, fn) for name, fn in together.items()}
        for name, future in futures.items():
            out[name] = future.result()
    out["walls_s"]["together"] = time.perf_counter() - tic
    log(f"phase 18 walls (the last four at once): {out['walls_s']}")
    return out


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
    from tricolo_tpu_torch.ops.tile_sparse import tile_budget
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import make_train_step

    report: dict = {"phases": {}}
    walls = report["phases"]
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)  # earlier runs' outputs

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
    dense_cfg = load_config(FLAGSHIP + DENSE)
    dense_cfg.experiment_name = "chip_smoke"
    dense_dm = DataModule(dense_cfg)
    dense_dm.setup("test")
    dense_first = next(iter(dense_dm.test_loader()))
    voxel_cfg = dense_cfg.model.modules.VoxelCNNEncoder
    budget = tile_budget(voxel_cfg.tile_budget_frac, B, (cfg.data.voxel_size // 8) ** 3)

    # 3. kernels vs plain versions
    tic = time.perf_counter()
    flush = make_flush(torch)
    k1_shapes = [
        ("windowed_compact", "block1", (T, 12, 12, 12, 32), True),
        ("windowed_compact", "block2", (T, 4, 4, 4, 64), False),
        ("windowed_compact", "block3", (B, 16, 16, 16, 128), False),
        ("windowed_compact", "block4", (B, 8, 8, 8, 256), False),
        ("windowed_compact", "block5", (B, 4, 4, 4, 512), False),
        # The dense-input plan's tile-sparse blocks: VALID convs on the
        # budget's rows, one mask (blocks 3-5 are the shapes above).
        ("dense_plan", "block1", (budget, 8, 8, 8, 32), False),
        ("dense_plan", "block2", (budget, 4, 4, 4, 64), False),
    ]
    k1_err, k1_rows = check_k1(torch, k1_shapes, flush)
    ids = torch.from_numpy(first["voxel_row_ids"]).cuda()
    k2_err, k2_rows = check_k2(torch, ids, cfg.data.voxel_size // 4, flush)
    k3_err, k3_rows = check_k3(torch, k1_shapes, flush)
    # The unmasked entries at the five dense blocks of the masked_bn=false
    # flagship (SAME convs on the whole 64³ grid).
    D = cfg.data.voxel_size
    dense_shapes = [(f"block{i + 1}", (B, D >> i, D >> i, D >> i, 32 << i)) for i in range(4)]
    dense_shapes.append(("block5", (B, D >> 4, D >> 4, D >> 4, 512)))
    k1u_err, k1u_rows = check_k1_unmasked(torch, dense_shapes, flush)
    k3u_err, k3u_rows = check_k3_unmasked(torch, dense_shapes, flush)
    nt_errs, nt_rows = check_nt_xent(torch, [(B, cfg.model.out_dim), (8192, cfg.model.out_dim)],
                                     flush)
    # K7 and K2's global entry at the dense-input plan's shapes, on the active
    # tiles of a real packed batch.
    x1, m1, m2, dense_ids, n_active = dense_plan_inputs(
        torch, to_device_batch(dense_first, torch.device("cuda")), cfg.data.voxel_size, budget)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x2 = torch.randn((B, 32, 32, 32, 32), generator=gen, device="cuda")
    k7_err, k7_rows = check_k7(torch, [("x1", x1, 8, 1), ("mask1", m1, 8, 0),
                                       ("x2", x2, 4, 1), ("mask2", m2, 4, 0)],
                               dense_ids, n_active, flush)
    del x1, m1, m2, x2
    k2g_err, k2g_rows = check_k2_global(torch, [("x1", 4, 32, 32), ("mask1", 4, 1, 32),
                                                ("x2", 2, 64, 16), ("mask2", 2, 1, 16)],
                                        dense_ids, n_active, B, flush)
    del flush, dense_ids
    torch.cuda.empty_cache()
    walls["kernels_s"] = time.perf_counter() - tic
    report["k1"], report["k2"], report["k3"], report["nt_xent"] = (
        k1_rows, k2_rows, k3_rows, nt_rows)
    report["k7"], report["k2_global"] = k7_rows, k2g_rows
    report["k1_unmasked"], report["k3_unmasked"] = k1u_rows, k3u_rows
    report["dense_plan_tiles"] = {"budget": budget, "active": n_active}
    log(f"kernels: K1 max err {k1_err}, K2 max err {k2_err}, K3 max err {k3_err}, "
        f"K7 max err {k7_err}, K2-global max err {k2g_err}, K1-unmasked max err {k1u_err}, "
        f"K3-unmasked max err {k3u_err} (bit-exact required); "
        f"K4-K6, pair and two-term max err {nt_errs} (limit {NT_XENT_TOL}·max|plain|); dense "
        f"plan: "
        f"{n_active} active tiles of a {budget}-row budget")

    # 4. serving path at flagship widths, bf16, through the kernels
    torch.manual_seed(SEED)
    model = TriCoLoNet.from_config(cfg)
    server = RetrievalServer(cfg, model)  # device: cuda
    ops.reset_launches()
    reset_host_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    index = server.build_index(dm)
    torch.cuda.synchronize()
    walls["index_build_s"] = time.perf_counter() - tic
    launches = ops.launches()
    n_batches = len(loader)
    host_checks = {"serving": check_host_path("index build", n_batches)}
    require(index.matrix.shape == (256, cfg.model.out_dim), f"index {index.matrix.shape}")
    require(bool(np.isfinite(index.matrix).all()), "index has non-finite values")
    require(len(set(index.model_ids)) == 256, "index model ids are not unique")
    for name in ("bn_relu_pool", "scatter_tiles_ps"):
        require(launches[name] > 0, f"kernel {name} was not launched on the serving path")
    log(f"index: {len(index.model_ids)} models x {index.matrix.shape[1]} in "
        f"{walls['index_build_s']:.3f} s over {n_batches} batches; launches {launches} "
        f"[{card}]")
    report["index_breakdown"] = parts = index_breakdown(torch, dm, model)
    log("index breakdown (second build, same split, prefetching pinned loader): " + ", ".join(
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

    # 6b. the dense-input plan (packed transfer, tile-sparse blocks 1-2):
    # the same weights, index in bf16 with per-batch launches, f32 against
    # its plain path and against the windowed_compact f32 index, one
    # ellipsoid batch with and without the tile-sparse blocks, and the
    # dense transfer's host densify and copy.
    tic = time.perf_counter()
    report["dense_serving"] = dense_serving(torch, cfg, dense_cfg, dense_dm, model, index,
                                            kernel32, dense_first, card)
    walls["dense_serving_s"] = time.perf_counter() - tic

    # 7. training: one epoch of the flagship train split through Trainer.fit
    from tricolo_tpu_torch.training import Trainer

    del server, model, index
    torch.cuda.empty_cache()
    train_cfg = load_config(FLAGSHIP + TRAIN)
    trainer = Trainer(train_cfg)  # device: cuda
    steps: list = []
    plain_step = trainer.train_step
    trainer.train_step = timed_step(torch, plain_step, steps)
    train_dm = DataModule(train_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_base = torch.cuda.memory_allocated() / 2**30
    ops.reset_launches()
    reset_host_counts()
    tic = time.perf_counter()
    ckpt = trainer.fit(train_dm).best_path
    torch.cuda.synchronize()
    walls["train_fit_s"] = time.perf_counter() - tic
    train_launches = ops.launches()
    # One epoch: 6 train batches, then one validation of 6 batches.
    host_checks["train"] = check_host_path("train fit", 12)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    require(len(steps) == 6, f"one epoch of 768 captions ran {len(steps)} steps, not 6")
    for i, row in enumerate(steps):
        finite = all(np.isfinite(v) for v in row["losses"].values())
        require(finite, f"train step {i}: non-finite losses {row['losses']}")
        require(row["launches"] == TRAIN_LAUNCHES,
                f"train step {i}: launches {row['launches']} != {TRAIN_LAUNCHES}")
        log(f"  train step {i}: {row['ms']:.3f} ms (wall {row['wall_ms']:.3f} ms) losses "
            + " ".join(f"{k}={v:.5f}" for k, v in row["losses"].items()))
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    train = {"steps": steps, "step_ms_median_2_6": step_ms,
             "step_wall_ms_median_2_6": statistics.median(r["wall_ms"] for r in steps[1:]),
             "pairs_per_s": train_cfg.data.batch_size / (step_ms / 1e3),
             "peak_gib": train_peak, "allocated_at_fit_start_gib": train_base,
             "launches_fit": train_launches,
             "val_rr5": trainer.metrics.summary("")["RR@5"], "fit_s": walls["train_fit_s"]}
    report["train"] = train
    log(f"train: 6 steps, median step (2-6) {step_ms:.3f} ms = "
        f"{train['pairs_per_s']:.1f} pairs/s, peak {train_peak:.2f} GiB, launches/step "
        f"{steps[-1]['launches']}, fit launches {train_launches}, fit "
        f"{walls['train_fit_s']:.1f} s [{card}]")

    # 8. the trained checkpoint serves
    tic = time.perf_counter()
    trained = RetrievalServer.from_checkpoint(train_cfg, ckpt)
    trained_index = trained.build_index(train_dm)
    answer = trained.query(tokens=train_dm.val_set[0]["tokens"], k=5)
    walls["trained_index_s"] = time.perf_counter() - tic
    require(trained_index.matrix.shape == (256, train_cfg.model.out_dim), "trained index shape")
    require(bool(np.isfinite(trained_index.matrix).all()), "trained index non-finite")
    require(len(answer) == 5 and all(np.isfinite(s) for _, s in answer), "trained query")
    log(f"trained checkpoint {Path(ckpt).name} serves: index {trained_index.matrix.shape}, "
        f"query -> {[m for m, _ in answer]}")
    del trained, trained_index

    # 9. one f32 train step: kernels vs plain versions from the same state
    tic = time.perf_counter()
    train_batch = to_device_batch(next(iter(train_dm.train_loader())), torch.device("cuda"))
    cfg32 = load_config(FLAGSHIP + TRAIN + ["precision.compute_dtype=float32"])
    report["train_plain_compare"] = cmp = train_plain_compare(torch, cfg32, train_batch)
    walls["train_plain_compare_s"] = time.perf_counter() - tic
    log(f"train plain path (f32, TF32 off, deterministic): losses rel {cmp['loss_rel']:.3g} "
        f"(tol {TRAIN_LOSS_RTOL}), grads rel-of-max {cmp['grad_rel_of_max']:.3g} "
        f"(tol {TRAIN_GRAD_TOL}), running_var |d| {cmp['running_var_abs']:.3g} "
        f"(tol {TRAIN_VAR_TOL})")
    torch.cuda.empty_cache()

    # 10. profiled flagship train steps (bf16): one synthetic-256 batch, then
    # 128 solid ellipsoids
    lr = train_cfg.optimizer.lr
    trainer.model.voxel_encoder.use_kernels = True
    plain_step(train_batch, lr)  # warm the bf16 path after the f32 phase
    report["train"]["profile"] = syn = profile_step(torch, plain_step, train_batch, lr)
    log(f"profiled synthetic-256 train step: device busy {syn['device_busy_ms']} ms of "
        f"{syn['wall_ms']:.3f} ms wall, idle share {syn['device_idle_share']}, port kernels "
        f"{syn['port_kernels_ms']} [{card}]")
    for row in syn["top"][:8]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in syn["top_ops"][:6]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    del train_batch
    torch.cuda.reset_peak_memory_stats()
    ell_ms = time_ms(lambda: plain_step(batch, lr), torch, repeats=5, warmup=2)
    ell_peak = torch.cuda.max_memory_allocated() / 2**30
    profile = profile_step(torch, plain_step, batch, lr)
    trainer.model.voxel_encoder.use_kernels = False
    ell_plain = make_train_step(trainer.model, trainer.optimizer, train_cfg, use_kernels=False)
    ell_plain_ms = time_ms(lambda: ell_plain(batch, lr), torch, repeats=5, warmup=2)
    trainer.model.voxel_encoder.use_kernels = True
    report["ellipsoid_train_step"] = {"k": k_ell, "ms": ell_ms, "plain_ms": ell_plain_ms,
                                      "peak_gib": ell_peak, "profile": profile}
    log(f"flagship train step (128 ellipsoids, k={k_ell}): {ell_ms:.3f} ms "
        f"(plain kernels {ell_plain_ms:.3f} ms), peak {ell_peak:.2f} GiB; profiled step: "
        f"device busy {profile['device_busy_ms']} ms of {profile['wall_ms']:.3f} ms wall, "
        f"idle share {profile['device_idle_share']}, port kernels "
        f"{profile['port_kernels_ms']} [{card}]")
    for row in profile["top"][:12]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['name'][:90]}")
    for row in profile["top_ops"][:8]:
        log(f"    {row['device_ms']:9.3f} ms x{row['count']:<4d} {row['op']} {row['shapes']}")
    # Diagnostic beside the main path (not used by it): the same step with
    # cuDNN's autotuner choosing the convolution algorithms.
    torch.backends.cudnn.benchmark = True
    tuned_ms = time_ms(lambda: plain_step(batch, lr), torch, repeats=5, warmup=3)
    torch.backends.cudnn.benchmark = False
    report["ellipsoid_train_step"]["cudnn_benchmark_ms"] = tuned_ms
    log(f"  same step with torch.backends.cudnn.benchmark=True: {tuned_ms:.3f} ms [{card}]")

    # 10b. dense-plan training: one epoch through Trainer.fit (packed,
    # tile-sparse blocks 1-2), the f32 kernel-vs-plain step, a profile.
    tic = time.perf_counter()
    dense_train, dense_trainer, dense_step, dense_batch = dense_training(torch, card)
    report["dense_train"] = dense_train
    walls["dense_train_s"] = time.perf_counter() - tic

    # 10c. diagnostic beside the main path: explicit_dgrad=true on the
    # windowed and the dense-plan steps, and block 2's input gradient alone.
    tic = time.perf_counter()
    report["explicit_dgrad"] = explicit_dgrad_diagnostic(
        torch, trainer, plain_step, to_device_batch(next(iter(train_dm.train_loader())),
                                                    torch.device("cuda")),
        dense_trainer, dense_step, dense_batch, T, card)
    walls["explicit_dgrad_s"] = time.perf_counter() - tic
    del dense_trainer, dense_step, dense_batch
    torch.cuda.empty_cache()

    # 10d. the training-run lifecycle on the structured dataset: fit with
    # validation losses and async top-1 + last saves, resume, test and eval
    # CLIs, device_eval.
    tic = time.perf_counter()
    report["lifecycle"], lifecycle_paths = lifecycle(torch, card)
    walls["lifecycle_s"] = time.perf_counter() - tic
    torch.cuda.empty_cache()

    # 10e. the unmasked (all-site BN) flagship: index, f32 kernel vs plain,
    # one epoch through Trainer.fit, the f32 step, a profile.
    tic = time.perf_counter()
    report["unmasked"], unmasked_paths = unmasked_flagship(torch, card)
    walls["unmasked_s"] = time.perf_counter() - tic

    # 10f. the CLIP flagship, Tri(CLIP-I+V): index and token queries through
    # the stub backend, f32 kernel vs plain, one epoch through Trainer.fit,
    # the checkpoint served, the f32 step from one dropout seed, a profile.
    tic = time.perf_counter()
    report["clip"], clip_paths = clip_flagship(torch, card)
    walls["clip_s"] = time.perf_counter() - tic

    # 11. the host path: the C++ sweeps against numpy, bit-exact, timed
    tic = time.perf_counter()
    report["host_path"] = host = host_path(torch, card, dm)
    host["pinned_paths"] = {**host_checks, "lifecycle": report["lifecycle"]["host_path"],
                            "clip_serving": report["clip"]["host_path"],
                            "clip_train": report["clip"]["train"]["host_path"]}
    walls["host_path_s"] = time.perf_counter() - tic
    log("host path: to_device_batch copies (pinned, pageable) "
        + ", ".join(f"{path} {c['copies']['pinned']}/{c['copies']['pageable']}"
                    for path, c in host["pinned_paths"].items()) + f" [{card}]")

    # 12. data parallel in rank subprocesses: a 1-rank NCCL world against the
    # non-parallel step, two gloo ranks on the card against one process.
    tic = time.perf_counter()
    report["data_parallel"], dp_paths = data_parallel(torch, card)
    walls["data_parallel_s"] = time.perf_counter() - tic

    # 13. the reference's other backbones and the triplet loss: ResNet50 with
    # the triplet loss, EfficientNet-B3, ResNet34 and EfficientNet-B0.
    tic = time.perf_counter()
    report["other_backbones"], backbone_paths = other_backbones(torch, card)
    walls["other_backbones_s"] = time.perf_counter() - tic

    # 14. the C13/128³ configuration: the fixture through the fused npz
    # reader, the kernels at the 128³ shapes, the index and one remat epoch,
    # the test CLI and mesh F1 on the card.
    tic = time.perf_counter()
    report["c13_128"], c13_paths = c13_128(torch, card)
    walls["c13_128_s"] = time.perf_counter() - tic

    # 15. bf16 parameters: the flagship index from a bf16 checkpoint, one
    # epoch through Trainer.fit, the f32-compute kernel-vs-plain index and
    # step, the dtypes on the card.
    tic = time.perf_counter()
    report["bf16_params"], bf16_paths = bf16_params(torch, card, report["train"])
    walls["bf16_params_s"] = time.perf_counter() - tic
    log(f"phase 15: {walls['bf16_params_s']:.1f} s")

    # 16. FSDP in rank subprocesses: a 1-rank NCCL world against replicated
    # at f32 and bf16 parameters, two gloo ranks on the card bit-equal to
    # replicated, one FSDP epoch whose checkpoint serves.
    tic = time.perf_counter()
    report["fsdp"], fsdp_paths = fsdp_phase(torch, card)
    walls["fsdp_s"] = time.perf_counter() - tic
    log(f"phase 16: {walls['fsdp_s']:.1f} s")

    # 17. the measuring entry points: bench (traced, reported) on both
    # plans, the loader-included bench in both modes.
    tic = time.perf_counter()
    report["measuring"], bench_paths = measuring(torch, card, {
        "phase7": report["train"]["step_ms_median_2_6"],
        "phase10_ellipsoid": report["ellipsoid_train_step"]["ms"]})
    walls["measuring_s"] = time.perf_counter() - tic
    log(f"phase 17: {walls['measuring_s']:.1f} s")

    # 18. the tools: roofline, profiles, collectives, dry run, rehearsal.
    tic = time.perf_counter()
    report["tools"] = tools(torch, card, {
        "trace_device_ms": report["measuring"]["windowed_compact"]["trace"]["device_ms_per_step"],
        "bench_step_ms": report["measuring"]["windowed_compact"]["result"]["step_ms"]})
    walls["tools_s"] = time.perf_counter() - tic
    log(f"phase 18: {walls['tools_s']:.1f} s")

    # 19. kernels line, card line, result
    def total(rows, key):
        return sum(r[key] for r in rows)

    paths = {"serving": launches, "train": train_launches,
             "dense_serving": report["dense_serving"]["launches"],
             "dense_train": dense_train["launches_fit"], **lifecycle_paths, **unmasked_paths,
             **clip_paths, **dp_paths, **backbone_paths, **c13_paths, **bf16_paths,
             **fsdp_paths, **bench_paths}

    def both(name):
        return {path: counts[name] for path, counts in paths.items()}

    def on_paths(name):
        return sum(both(name).values())

    k1_main = [r for r in k1_rows if r["main"]]
    k3_main = [r for r in k3_rows if r["main"]]
    k2_main = list(k2_rows)
    # The 128³ rows (phase 14b) ride in the shapes; the totals stay phase 3's.
    c13k = report["c13_128"]["kernels"]
    k1_rows, k2_rows, k3_rows = (k1_rows + c13k["k1"], k2_rows + c13k["k2"],
                                 k3_rows + c13k["k3"])
    k1_err, k2_err, k3_err = (max(k1_err, c13k["k1_err"]), max(k2_err, c13k["k2_err"]),
                              max(k3_err, c13k["k3_err"]))
    kernels = [
        {"name": "bn_relu_pool", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/bn_relu_pool.cu",
         "replaces": "tricolo_tpu/ops/fused_bn_pool.py:99",
         "launches": on_paths("bn_relu_pool"),
         "launches_by_path": both("bn_relu_pool"), "max_abs_err": k1_err,
         "ms": total(k1_main, "ms"), "plain_ms": total(k1_main, "plain_ms"),
         "bound_ms": total(k1_main, "bound_ms"), "bound_by": "bytes",
         "library_ms": None, "shapes": k1_rows},
        {"name": "scatter_tiles_ps", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/tile_scatter.cu",
         "replaces": "tricolo_tpu/ops/_graveyard/dma_tiles.py:128",
         "launches": on_paths("scatter_tiles_ps"),
         "launches_by_path": both("scatter_tiles_ps"), "max_abs_err": k2_err,
         "ms": total(k2_main, "ms"), "plain_ms": total(k2_main, "plain_ms"),
         "bound_ms": total(k2_main, "bound_ms"), "bound_by": "bytes",
         "library_ms": None, "shapes": k2_rows},
        {"name": "bn_relu_pool_bwd", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/bn_relu_pool_bwd.cu",
         "replaces": "tricolo_tpu/ops/fused_bn_pool.py:134",
         "launches": on_paths("bn_relu_pool_bwd"),
         "launches_by_path": both("bn_relu_pool_bwd"), "max_abs_err": k3_err,
         "ms": total(k3_main, "ms"), "plain_ms": total(k3_main, "plain_ms"),
         "bound_ms": total(k3_main, "bound_ms"), "bound_by": "bytes",
         "library_ms": None, "shapes": k3_rows},
    ]
    # K4's row counts the pair launches (each computes K4 for both
    # directions) and carries the pair entry's numbers beside its own; K5's
    # and K6's rows count the two-term launches (each computes both
    # functions) and carry the two-term entry's numbers.
    def entry(name):
        rows = nt_rows[name]
        return {"name": name, "launches": on_paths(name), "launches_by_path": both(name),
                "max_abs_err": nt_errs[name], "ms": total(rows, "ms"),
                "plain_ms": total(rows, "plain_ms"), "bound_ms": total(rows, "bound_ms"),
                "shapes": rows}

    merged = {"nt_xent_fwd": ("pair", entry("nt_xent_fwd_pair")),
              "nt_xent_bwd_rows": ("two_term", entry("nt_xent_bwd")),
              "nt_xent_bwd_cols": ("two_term", entry("nt_xent_bwd"))}
    for name, line in (("nt_xent_fwd", 43), ("nt_xent_bwd_rows", 92), ("nt_xent_bwd_cols", 208)):
        rows = nt_rows[name]
        row = {"name": name, "route": "cuda", "source": "tricolo_tpu_torch/csrc/nt_xent.cu",
               "replaces": f"tricolo_tpu/ops/nt_xent_pallas.py:{line}",
               "launches": on_paths(name), "launches_by_path": both(name),
               "max_abs_err": nt_errs[name], "ms": total(rows, "ms"),
               "plain_ms": total(rows, "plain_ms"), "bound_ms": total(rows, "bound_ms"),
               "bound_by": "operations", "library_ms": None, "shapes": rows}
        key, on_path = merged[name]
        row["launches_alone"] = row["launches"]
        row["launches"] += on_path["launches"]
        row[key] = on_path
        kernels.append(row)
    kernels += [
        {"name": "gather_tiles", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/tile_gather.cu",
         "replaces": "tricolo_tpu/ops/_graveyard/dma_tiles.py:70",
         "launches": on_paths("gather_tiles"), "launches_by_path": both("gather_tiles"),
         "max_abs_err": k7_err, "ms": total(k7_rows, "ms"),
         "plain_ms": total(k7_rows, "plain_ms"), "bound_ms": total(k7_rows, "bound_ms"),
         "bound_by": "bytes", "library_ms": total(k7_rows, "library_ms"), "shapes": k7_rows},
        {"name": "scatter_tiles_global", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/tile_scatter.cu",
         "replaces": "tricolo_tpu/ops/_graveyard/dma_tiles.py:128",
         "launches": on_paths("scatter_tiles_global"),
         "launches_by_path": both("scatter_tiles_global"), "max_abs_err": k2g_err,
         "ms": total(k2g_rows, "ms"), "plain_ms": total(k2g_rows, "plain_ms"),
         "bound_ms": total(k2g_rows, "bound_ms"), "bound_by": "bytes", "library_ms": None,
         "shapes": k2g_rows},
    ]
    # The unmasked entries' rows carry the eval form (K1) over the five
    # dense blocks, as K1's row carries the windowed_compact eval form.
    k1u_eval = [r for r in k1u_rows if r["form"] == "eval"]
    kernels += [
        {"name": "bn_relu_pool_unmasked", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/bn_relu_pool.cu",
         "replaces": "tricolo_tpu/ops/fused_bn_pool.py:99",
         "launches": on_paths("bn_relu_pool_unmasked"),
         "launches_by_path": both("bn_relu_pool_unmasked"), "max_abs_err": k1u_err,
         "ms": total(k1u_eval, "ms"), "plain_ms": total(k1u_eval, "plain_ms"),
         "bound_ms": total(k1u_eval, "bound_ms"), "bound_by": "bytes", "library_ms": None,
         "shapes": k1u_rows},
        {"name": "bn_relu_pool_bwd_unmasked", "route": "cuda",
         "source": "tricolo_tpu_torch/csrc/bn_relu_pool_bwd.cu",
         "replaces": "tricolo_tpu/ops/fused_bn_pool.py:134",
         "launches": on_paths("bn_relu_pool_bwd_unmasked"),
         "launches_by_path": both("bn_relu_pool_bwd_unmasked"), "max_abs_err": k3u_err,
         "ms": total(k3u_rows, "ms"), "plain_ms": total(k3u_rows, "plain_ms"),
         "bound_ms": total(k3u_rows, "bound_ms"), "bound_by": "bytes", "library_ms": None,
         "shapes": k3u_rows},
    ]
    for row in kernels:
        require(row["launches"] > 0, f"kernel {row['name']} was launched on no path")
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
        if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 12
            sys.exit(dp_rank_main(sys.argv[2:]))
        sys.exit(main())
    except Exception:  # any phase: report and fail, never print a result
        import traceback

        traceback.print_exc()
        sys.exit(1)

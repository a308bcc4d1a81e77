"""The port's per-op work counts (``tricolo_tpu_torch.work``) against XLA's
cost analysis, and the kernel modules' ``work(...)`` against the bounds
``chip_smoke.py`` phase 3 and ``kernel_timing.py`` computed before it.

* An f32 matmul and an f32 SAME conv3d count what
  ``jax.jit(...).lower(...).compile().cost_analysis()`` counts on the CPU:
  FLOPs and "bytes accessed" for the matmul, bytes for the convolution.
  The convolution's FLOPs are ``torch.utils.flop_counter``'s 2·MACs over
  every tap (56,623,104); XLA counts only the taps inside the padded
  input (49,836,032), and the test states that difference.
* View, alias and factory ops count 0 bytes; ops that write count what
  they touch; an in-place op counts its tensor once.
* The cuDNN RNN formula: 2·B·3H·(I + H) a time step and direction for the
  GRU, twice that backward.
* Each kernel module's ``work(...)`` equals the byte count (and, for the
  NT-Xent kernels, the FLOPs) of the expressions phase 3 and
  ``kernel_timing.py`` used, at each of their shapes (meta tensors: no
  memory).
* ``bench --roofline`` on a tiny CPU Tri(I+V) step writes a record whose
  FLOPs equal ``FlopCounterMode``'s total over the same step.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch import work  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TINY = ["data.image_size=32", "data.num_views=2", "precision.compute_dtype=float32"]


def _xla_cost(fn, *args):
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    return cost[0] if isinstance(cost, list) else cost


def _counted(fn):
    with work.WorkCounter() as counter:
        fn()
    return counter.records


def test_matmul_matches_xla_cost_analysis():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96, 32)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    records = _counted(lambda: ta @ tb)
    assert [r[1:] for r in records] == [["aten::mm", "f32", 393_216, 45_056]]
    cost = _xla_cost(lambda x, y: x @ y, a, b)
    assert cost["flops"] == 393_216
    assert cost["bytes accessed"] == 45_056


def test_conv3d_matches_xla_bytes_and_counts_every_tap():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 16, 8)).astype(np.float32)  # NDHWC
    w = rng.standard_normal((3, 3, 3, 8, 16)).astype(np.float32)  # DHWIO

    def xla_conv(x, w):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NDHWC", "DHWIO", "NDHWC"))
        return jax.lax.conv_general_dilated(x, w, (1, 1, 1), "SAME", dimension_numbers=dn)

    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    tw = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    records = _counted(lambda: torch.nn.functional.conv3d(tx, tw, padding=1))
    assert [r[1:] for r in records] == [["aten::convolution", "f32", 56_623_104, 800_256]]
    cost = _xla_cost(xla_conv, x, w)
    assert cost["bytes accessed"] == 800_256
    # XLA counts the taps that fall inside the padded input; the port counts
    # every tap of every output site (torch's formula): 2·16³·27·2·8·16.
    assert cost["flops"] == 49_836_032
    assert 2 * 16**3 * 27 * 2 * 8 * 16 == 56_623_104


def test_views_and_factories_count_zero_writes_count_once():
    t = torch.ones(3, 4)
    u = torch.ones(3, 4)
    ops = [
        ("empty", lambda: torch.empty(3, 4), 0),
        ("view", lambda: t.view(12), 0),
        ("permute", lambda: t.permute(1, 0), 0),
        ("t", lambda: t.t(), 0),
        ("detach", lambda: t.detach(), 0),
        ("expand", lambda: t[:1].expand(3, 4), 0),
        ("as_strided", lambda: t.as_strided((2, 2), (1, 1)), 0),
        ("zeros", lambda: torch.zeros(3, 4), 48),
        ("fill_", lambda: t.fill_(2.0), 48),
        ("add_", lambda: t.add_(u), 96),
        ("copy_", lambda: t.copy_(u), 96),
        ("add", lambda: t + u, 144),
    ]
    for name, fn, nbytes in ops:
        records = [r for r in _counted(fn) if r[1] != "aten::select"]
        assert len(records) >= 1, name
        assert records[-1][1] == f"aten::{name}", (name, records)
        assert records[-1][4] == nbytes, (name, records)


def test_gathers_read_what_they_gather_and_factories_not_their_template():
    src = torch.ones(1000, 64)
    idx = torch.zeros(10, 64, dtype=torch.int64)
    records = _counted(lambda: torch.gather(src, 0, idx))
    assert records[-1][1:] == ["aten::gather", "memory", 0, 10 * 64 * (8 + 4 + 4)]
    records = _counted(lambda: torch.nn.functional.embedding(torch.tensor([1, 2, 3]), src))
    assert records[-1][1:] == ["aten::embedding", "memory", 0, 3 * 8 + 2 * 3 * 64 * 4]
    rows = torch.zeros(10, dtype=torch.int64)  # ten lookups of one row read it once
    records = _counted(lambda: src[rows])
    assert records[-1][1:] == ["aten::index", "memory", 0, 10 * 8 + (10 + 1) * 64 * 4]
    records = _counted(lambda: src[src[:, 0] > 0])  # a mask: each selected row once
    assert records[-1][1:] == ["aten::index", "memory", 0, 1000 + 2 * 1000 * 64 * 4]
    records = _counted(lambda: src.new_zeros(5, 5))
    assert records[-1][1:] == ["aten::new_zeros", "memory", 0, 100]
    records = _counted(lambda: torch.zeros_like(src))
    assert records[-1][1:] == ["aten::zeros_like", "memory", 0, 1000 * 64 * 4]


def test_broadcast_views_count_their_distinct_elements():
    row = torch.ones(1, 4)
    assert work.extent_bytes(row.expand(1000, 4)) == 16
    assert work.extent_bytes(torch.ones(8, 8)[::2]) == 4 * 8 * 4


def test_gru_formula():
    B, T, I, H = 4, 16, 256, 128
    x = torch.empty(B, T, I, device="meta")
    flops = work.rnn_flops(x, [], 4, None, None, None, 3, H, 0, 1, True, 0.0, True, True, [])
    assert flops == 2 * 2 * B * T * 3 * H * (I + H)
    back = work.rnn_backward_flops(x, [], 4, None, None, None, None, None, None, None, 3, H, 0,
                                   1, True, 0.0, True, True, [])
    assert back == 2 * flops
    assert work.FLOP_FORMULAS[torch.ops.aten._cudnn_rnn]((x, [], 4, None, None, None, 3, H, 0,
                                                          1, True, 0.0, True, True, []),
                                                         {}, None) == flops


def test_kernel_hook_records_only_while_counting():
    from tricolo_tpu_torch.ops import tile_scatter

    ids = torch.tensor([[0, 3, 100], [5, -1, 7]], dtype=torch.int32)
    hook = work.launch("scatter_tiles_ps", tile_scatter.work,
                       functools.partial(work.valid_ids, ids, 64), 2, 64, 2, 6, 2, 16)
    assert hook is work._NULL  # no counter: a no-op
    with work.WorkCounter() as counter:
        with work.launch("scatter_tiles_ps", tile_scatter.work,
                         functools.partial(work.valid_ids, ids, 64), 2, 64, 2, 6, 2, 16):
            pass
    # 4 rows in the grid read, 6 ids, a (2, 16³, 64) bf16 grid written; the
    # valid-id count dispatched nothing into the record.
    assert counter.records == [[0, "K2", "memory", 0, (4 * 8 + 2 * 16**3) * 64 * 2 + 6 * 4]]
    assert counter.kernel_args == {0: ["tricolo_tpu_torch.ops.tile_scatter",
                                       [4, 2, 64, 2, 6, 2, 16]]}
    assert work._ACTIVE is None


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(*tensors):  # chip_smoke.py's phase-3 helper before the work counts
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


K1_SHAPES = [  # phase 3: (shape, two masks) at the flagship, dense plan and C13/128³
    ((26240, 12, 12, 12, 32), True), ((26240, 4, 4, 4, 64), False),
    ((128, 16, 16, 16, 128), False), ((128, 8, 8, 8, 256), False), ((128, 4, 4, 4, 512), False),
    ((32768, 8, 8, 8, 32), False), ((32768, 4, 4, 4, 64), False),
    ((27680, 12, 12, 12, 32), True), ((27680, 4, 4, 4, 64), False),
    ((32, 32, 32, 32, 128), False), ((32, 16, 16, 16, 256), False), ((32, 8, 8, 8, 512), False),
]
DENSE_SHAPES = [(128, 64 >> i, 64 >> i, 64 >> i, 32 << i) for i in range(5)]


@pytest.mark.parametrize("shape,two", K1_SHAPES)
def test_k1_and_k3_work_equal_phase3_bounds(shape, two):
    from tricolo_tpu_torch.ops.bn_relu_pool import work as k13

    y = _meta(shape)
    mshape = (*shape[:4], 1)
    zmask, smask = _meta(mshape), _meta(mshape) if two else None
    pooled = torch.Size((shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2)).numel()
    out_bytes = pooled * (shape[4] + 1) * y.element_size()
    for want_idx in (False, True):
        idx_bytes = pooled * shape[4] if want_idx else 0
        old = _nbytes(y, zmask, smask) + out_bytes + idx_bytes
        assert k13("K1", shape, 2, 2 if two else 1, want_idx) == (old, 0)
    ga = _meta((shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4]))
    idx = _meta(ga.shape, torch.uint8)
    stats = smask if two else zmask
    assert k13("K3", shape, 2, 1) == (_nbytes(y, ga, idx, stats, y), 0)


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_unmasked_work_equals_phase3_bounds(shape):
    from tricolo_tpu_torch.ops.bn_relu_pool import work as k13

    y = _meta(shape)
    pooled = y.numel() // 8
    for want_idx in (False, True):
        old = _nbytes(y) + pooled * (y.element_size() + (1 if want_idx else 0))
        assert k13("K1", shape, 2, 0, want_idx) == (old, 0)
    ga = _meta((shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4]))
    idx = _meta(ga.shape, torch.uint8)
    assert k13("K3", shape, 2, 0) == (_nbytes(y, ga, idx, y), 0)


def test_k3_work_equals_kernel_timing_bounds():
    from tricolo_tpu_torch.kernel_timing import K3_MASKED, K3_UNMASKED
    from tricolo_tpu_torch.ops.bn_relu_pool import work as k13

    cases = [(shape, True) for _, _, shape in K3_MASKED] + [(s, False) for _, s in K3_UNMASKED]
    for shape, masked in cases:
        N, D, H, W, C = shape
        y = _meta(shape)
        ga = _meta((N, D // 2, H // 2, W // 2, C))
        idx = _meta(ga.shape, torch.uint8)
        mask = _meta((N, D, H, W, 1)) if masked else None
        assert k13("K3", shape, 2, int(masked)) == (_nbytes(y, ga, idx, mask, y), 0)


@pytest.mark.parametrize("case", [
    ("per-sample", (128, 205, 2, 2, 2, 64), 16, 14279),
    ("per-sample", (128, 205, 2, 2, 2, 1), 16, 14279),
    ("per-sample", (32, 865, 2, 2, 2, 64), 32, 12429),
    ("per-sample", (32, 865, 2, 2, 2, 1), 32, 12429),
    ("global", (32768, 4, 4, 4, 32), 32, 14279),
    ("global", (32768, 4, 4, 4, 1), 32, 14279),
    ("global", (32768, 2, 2, 2, 64), 16, 14279),
    ("global", (32768, 2, 2, 2, 1), 16, 14279),
])
def test_k2_work_equals_phase3_bounds(case):
    from tricolo_tpu_torch.ops.tile_scatter import work as k2

    kind, shape, grid, valid = case
    tiles = _meta(shape)
    t, C = shape[-2], shape[-1]
    if kind == "per-sample":
        B = shape[0]
        ids = _meta(shape[:2], torch.int32)
        read = valid * tiles[0, 0].numel() * tiles.element_size()
    else:
        B = 128
        ids = _meta(shape[:1], torch.int32)
        read = valid * t**3 * C * tiles.element_size()
    got = _meta((B, grid, grid, grid, C))
    assert k2(valid, t, C, 2, ids.numel(), B, grid) == (read + _nbytes(ids, got), 0)


def test_k7_work_equals_phase3_and_kernel_timing_bounds():
    from tricolo_tpu_torch.kernel_timing import K7_ACTIVE, K7_BUDGET, K7_CASES
    from tricolo_tpu_torch.ops.tile_gather import work as k7

    ids = _meta((K7_BUDGET,), torch.int32)
    for _, D, C, tile, halo in K7_CASES:
        s = tile + 2 * halo
        out = _meta((K7_BUDGET, s, s, s, C))
        read = K7_ACTIVE * tile**3 * C * 2
        assert k7(K7_ACTIVE, tile, halo, C, 2, K7_BUDGET) == (_nbytes(out, ids) + read, 0)


@pytest.mark.parametrize("B,D", [(128, 512), (8192, 512)])
def test_nt_xent_work_equals_phase3_bounds(B, D):
    from tricolo_tpu_torch.ops.nt_xent import work as nt

    z = _meta((B, D), torch.float32)
    vec, one, two = (_meta(s, torch.float32) for s in ((B,), (1,), (2,)))
    cases = {"nt_xent_fwd": ((z, z), _meta((B, 2), torch.float32), 2),
             "nt_xent_fwd_pair": ((z, z), _meta((B, 3), torch.float32), 2),
             "nt_xent_bwd_rows": ((z, z, vec, one), z, 4),
             "nt_xent_bwd_cols": ((z, z, vec, one), z, 4),
             "nt_xent_bwd": ((z, z, vec, vec, two), z, 4)}
    for name, (args, out, flops_per) in cases.items():
        assert nt(name, B, D) == (_nbytes(*args, out), flops_per * B * B * D), name


def test_bench_roofline_record_flops_equal_flop_counter(tmp_path):
    from torch.utils.flop_counter import FlopCounterMode

    from tricolo_tpu_torch.bench import bench_config, build_step, fit_budgets, stage, to_transfer
    from tricolo_tpu_torch.bench_data import host_batch
    from tricolo_tpu_torch.roofline_report import find_record
    from tricolo_tpu_torch.training import dropout_generator

    args = ["--device", "cpu", "--voxel-size", "32", "--batch-size", "8", "--pairs", "1",
            "--idle-wait", "0", "--roofline", str(tmp_path)]
    for o in [*TINY, "bench.steps=1", "bench.warmup_steps=1"]:
        args += ["--override", o]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "tricolo_tpu_torch.bench", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    traces = list(tmp_path.glob("roofline.*.pt.trace.json"))
    assert len(traces) == 1
    # The roofline loop runs with tracing off: no program span, no anchor.
    assert not [e for e in json.loads(traces[0].read_text())["traceEvents"]
                if e.get("cat") == "program_span" or "tracing.anchor" in e.get("name", "")]
    record = json.loads(Path(find_record(str(tmp_path))).read_text())
    assert record["card"] == "cpu" and record["kernel_args"] == {}  # CPU: the plain versions
    counted = sum(op[3] for op in record["ops"])

    cfg = bench_config("tri", 32, 8, TINY)
    hosts = [host_batch(cfg, 1024, seed=s) for s in range(2)]
    rows = fit_budgets(cfg, hosts)
    cpu = torch.device("cpu")
    batch = stage(to_transfer(cfg, hosts[0], rows), cpu)
    _, _, step = build_step(cfg, cpu)
    with FlopCounterMode(display=False) as flops:
        step(batch, cfg.optimizer.lr, dropout_generator(cfg.train_seed, 0, cpu))
    assert counted == flops.get_total_flops() > 0

"""The voxel encoder's stage spans (``tracing`` level 2), the two tile
counters and the benchmark's five readers of them
(``benchmark/metrics/_voxel_stages.py``).

At level 1 a traced step gives exactly the spans and backward phases it
gave before levels existed, so ``voxel_encoder_step_ms`` keeps its meaning;
at level 2 ``forward.voxel.tiles`` and ``forward.voxel.dense`` nest in
``forward.voxel`` and the phases ``backward.voxel.dense`` and
``backward.voxel.tiles`` take the place of ``backward.voxel``. The
counters read B·k a call and the batch's valid rows. The readers give the
right values on a hand-written merged trace and None without stage spans,
the case of a program without level 2."""

import collections
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from benchmark.metrics import _flops, _spans, _voxel_stages  # noqa: E402
from benchmark.spec import load_benchmark, load_cell  # noqa: E402
from benchmark.tests.sizes import tiny  # noqa: E402
from tricolo_tpu_torch import tracing  # noqa: E402

TINY = [
    "data=synthetic",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "data.batch_size=2",
    "data.num_models=5",
    "model.modules.VoxelCNNEncoder.ef_dim=8",
    "precision.compute_dtype=float32",
]
CPU = torch.device("cpu")
STEP_CHILDREN = ["step.prepare", "forward.text", "forward.image", "forward.voxel",
                 "loss.forward", "backward", "optimizer"]
PHASES = {1: ["backward.loss", "backward.voxel", "backward.image", "backward.text"],
          2: ["backward.loss", "backward.voxel.dense", "backward.voxel.tiles",
              "backward.image", "backward.text"]}
STAGES = ["forward.voxel.tiles", "forward.voxel.dense"]
READERS = {"voxel_tile_blocks_step_ms": "tile_ms", "voxel_dense_blocks_step_ms": "dense_ms",
           "voxel_dense_blocks_mfu": "dense_mfu", "voxel_tile_padding_share": "padding_share",
           "voxel_tile_wgrad_roofline": "wgrad_roofline"}
CELLS = ["tri_iv.chair_table.train_spread", "tri_iv.chair_table.train_narrow",
         "tri_iv.c13_128.train_spread"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _setup():
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer, make_train_step

    cfg = load_config(TINY)
    torch.manual_seed(0)
    model = TriCoLoNet.from_config(cfg)
    optimizer = make_optimizer(cfg, model)
    dm = DataModule(cfg)
    dm.setup("fit")
    return cfg, model, make_train_step(model, optimizer, cfg), dm.train_loader()


def _traced_steps(level, n=2):
    """``n`` steps at tracing ``level``; (spans, the host batches, the
    ``voxel.tile_rows`` counter's moves a step)."""
    from tricolo_tpu_torch.inference import to_device_batch

    _, _, step, loader = _setup()
    batches, rows = [], []
    tracing.enable(level=level)
    for i, batch in enumerate(loader):
        tracing.set_step(i)
        before = tracing.counter(_voxel_stages.ROWS)
        step(to_device_batch(batch, CPU), 1e-3)
        rows.append(tracing.counter(_voxel_stages.ROWS) - before)
        batches.append(batch)
        if i + 1 == n:
            break
    tracing.disable()
    return tracing.spans(), batches, rows


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start) if s.parent is parent]


@pytest.mark.parametrize("level", [1, 2])
def test_each_level_gives_its_span_tree(level):
    spans, _, _ = _traced_steps(level)
    names = {s.name for s in spans}
    roots = [s for s in spans if s.name == "step"]
    assert len(roots) == 2
    for root in roots:
        assert _children(spans, root) == STEP_CHILDREN
        (back,) = [s for s in spans if s.name == "backward" and s.parent is root]
        assert _children(spans, back) == PHASES[level]
        (voxel,) = [s for s in spans if s.name == "forward.voxel" and s.parent is root]
        assert _children(spans, voxel) == (STAGES if level == 2 else [])
    if level == 1:
        # Exactly the spans of a step before levels, with today's records.
        assert not names & {*STAGES, *PHASES[2][1:3]}
        assert all(not s.args for s in spans if s.name in ("forward.voxel", "loader.collate"))
    else:
        assert "backward.voxel" not in names


def test_the_stage_phases_hold_their_blocks():
    """Blocks 1-2 run under the tile stage, 3-5 under the dense one, forward
    and backward (5-d convolutions, by the profiler's shapes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        spans, _, _ = _traced_steps(2, n=1)
    trace = _export(prof)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    found = collections.Counter()
    for span in (e for e in events if e.get("cat") == tracing.CATEGORY
                 and e["name"] in (*STAGES, *PHASES[2][1:3])):
        for e in events:
            if (e.get("cat") == "cpu_op" and e["tid"] == span["tid"]
                    and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]
                    and e["name"] in ("aten::convolution", "aten::convolution_backward")
                    and len(e["args"]["Input Dims"][0]) == 5):
                found[span["name"], e["name"]] += 1
    assert found == {("forward.voxel.tiles", "aten::convolution"): 2,
                     ("forward.voxel.dense", "aten::convolution"): 3,
                     ("backward.voxel.tiles", "aten::convolution_backward"): 2,
                     ("backward.voxel.dense", "aten::convolution_backward"): 3}


def _export(prof):
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    assert tracing.merge_into(trace) > 0
    return trace


def test_level_two_equals_off_bit_for_bit():
    from tricolo_tpu_torch.inference import to_device_batch

    results = []
    for level in (0, 2):
        _, model, step, loader = _setup()
        batch = to_device_batch(loader.peek(), CPU)
        if level:
            tracing.enable(level=level)
        losses = step(batch, 1e-3)
        tracing.disable()
        results.append((losses, model.state_dict()))
    (l0, s0), (l2, s2) = results
    assert all(torch.equal(l0[k], l2[k]) for k in l0)
    assert all(torch.equal(s0[k], s2[k]) for k in s0)


def test_a_level_outside_one_and_two_is_refused():
    with pytest.raises(ValueError):
        tracing.enable(level=3)
    assert tracing.level() == 0 and not tracing.enabled()


def test_the_counters_read_rows_and_valid_rows():
    spans, batches, rows = _traced_steps(2, n=3)
    tg3 = (32 // 8) ** 3  # the synthetic preset's 32³ grid
    for batch, moved in zip(batches, rows):
        B, k = batch["voxel_row_ids"].shape
        assert moved == B * k
    valid = {s.batch: int((b["voxel_row_ids"] < tg3).sum())
             for s, b in zip(sorted((s for s in spans if s.name == "step"),
                                    key=lambda s: s.start), batches)}
    collated = {s.batch: s.args[_voxel_stages.ACTIVE] for s in spans
                if s.name == "loader.collate"}
    assert collated and all(collated[b] == valid[b] for b in collated if b in valid)
    per_step = [s.args for s in sorted((s for s in spans if s.name == "forward.voxel"),
                                       key=lambda s: s.start)]
    assert per_step == [{_voxel_stages.ROWS: b["voxel_row_ids"].size} for b in batches]
    # Always on: with tracing off, collate counts all the same.
    from tricolo_tpu_torch.data.loader import collate

    loader = _setup()[3]
    before = tracing.counter(_voxel_stages.ACTIVE)
    batch = collate([loader.dataset[i] for i in range(2)], loader.dataset.max_voxel_points,
                    "windowed_compact", 32, tile_budget_rows=loader.tile_budget_rows,
                    windowed_halo=loader.windowed_halo)
    moved = tracing.counter(_voxel_stages.ACTIVE) - before
    assert moved == int((batch["voxel_row_ids"] < tg3).sum()) > 0
    assert tracing.spans() == spans  # and records no span


def test_the_encoder_counts_every_path():
    from tricolo_tpu_torch.models.voxel_cnn import VoxelCNNEncoder

    enc = VoxelCNNEncoder(voxel_size=64, ef_dim=4, z_dim=8, out_dim=8)
    assert enc.tile_rows(rows=torch.zeros(3, 7, 14**3)) == 21
    assert enc.tile_rows(windows=torch.zeros(2 * 512, 10**3)) == 512  # budget ½·1024
    assert enc.tile_rows(voxels=torch.zeros(2, 64, 64, 64, 4)) == 0
    enc.tile_sparse = True
    assert enc.tile_rows(voxels=torch.zeros(2, 64, 64, 64, 4)) == 512


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _span(name, batch, **args):
    return SimpleNamespace(name=name, batch=batch, args=args or None)


def test_the_readers_on_a_hand_written_trace():
    """One step in a 1000 µs annotation: the tile stage's forward kernel
    (100 µs) and backward kernel (200), the dense stage's (50 and 150, the
    latter from the engine's thread), a kernel under ``forward.voxel``
    itself (25) that neither stage takes."""
    trace = {"traceEvents": [
        _x("user_annotation", _spans.ANNOTATION, 0.0, 1000.0),
        _x("program_span", "step", 0.0, 900.0, span=1, parent=None),
        _x("program_span", "forward.voxel", 10.0, 100.0, span=2, parent=1),
        _x("program_span", "forward.voxel.tiles", 15.0, 40.0, span=3, parent=2),
        _x("program_span", "forward.voxel.dense", 60.0, 40.0, span=4, parent=2),
        _x("program_span", "backward", 300.0, 500.0, span=5, parent=1),
        _x("program_span", "backward.voxel.dense", 305.0, 50.0, tid=2, span=6, parent=5),
        _x("program_span", "backward.voxel.tiles", 355.0, 50.0, tid=2, span=7, parent=5),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 2.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 70.0, 2.0, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 310.0, 2.0, tid=2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 360.0, 2.0, tid=2, correlation=5),
        _x("kernel", "cast", 100.0, 25.0, tid=7, correlation=1),
        _x("kernel", "k1", 125.0, 100.0, tid=7, correlation=2),
        _x("kernel", "conv", 225.0, 50.0, tid=7, correlation=3),
        _x("kernel", "wgrad", 400.0, 150.0, tid=7, correlation=4),
        _x("kernel", "k8", 550.0, 200.0, tid=7, correlation=5),
    ]}
    spans = [_span("loader.collate", (0, 0), **{_voxel_stages.ACTIVE: 60}),
             _span("loader.collate", (0, 1), **{_voxel_stages.ACTIVE: 70}),
             _span("loader.collate", (0, 2)),  # a level-1 collate: no move recorded
             _span("forward.voxel", (0, 0), **{_voxel_stages.ROWS: 100}),
             _span("forward.voxel", (0, 1), **{_voxel_stages.ROWS: 100}),
             _span("forward.voxel", (0, 3), **{_voxel_stages.ROWS: 100}),  # not collated
             _span("forward.voxel", (0, 2), **{_voxel_stages.ROWS: 100})]
    flops = 0.4e9
    out = _voxel_stages.readings(_spans.analyse(trace), spans, flops)
    assert out["tile_ms"] == pytest.approx(0.3)
    assert out["dense_ms"] == pytest.approx(0.2)
    assert out["dense_mfu"] == pytest.approx(100 * 0.4e9 / (0.2e-3 * 989e12))
    assert out["padding_share"] == pytest.approx(100 * (1 - 130 / 200))
    # Without stage spans (a level-1 trace, a program without level 2).
    trace["traceEvents"] = [e for e in trace["traceEvents"] if ".tiles" not in e["name"]
                            and ".dense" not in e["name"]]
    out = _voxel_stages.readings(_spans.analyse(trace), [], flops)
    assert out == {"tile_ms": None, "dense_ms": None, "dense_mfu": None,
                   "padding_share": None}
    assert _voxel_stages.readings(None, [], flops)["tile_ms"] is None


def test_the_tile_wgrad_on_a_hand_written_trace():
    """Two steps: three ``wgrad`` kernels under ``backward.voxel.tiles`` (one
    from a launch outside the annotation, not counted), one ``wgrad`` under
    ``backward.voxel.dense`` and one other kernel under the tile phase."""
    trace = {"traceEvents": [
        _x("user_annotation", _spans.ANNOTATION, 0.0, 1000.0),
        _x("program_span", "backward.voxel.tiles", 100.0, 100.0, tid=2, span=1, parent=None),
        _x("program_span", "backward.voxel.dense", 300.0, 100.0, tid=2, span=2, parent=None),
        _x("cuda_runtime", "cudaLaunchKernel", 110.0, 2.0, tid=2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 120.0, 2.0, tid=2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 130.0, 2.0, tid=2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 310.0, 2.0, tid=2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 140.0, 2.0, tid=2, correlation=5),
        _x("kernel", "sm90_xmma_wgrad_a", 200.0, 300.0, tid=7, correlation=1),
        _x("kernel", "sm90_xmma_wgrad_a", 500.0, 100.0, tid=7, correlation=2),
        _x("kernel", "k3", 600.0, 50.0, tid=7, correlation=3),
        _x("kernel", "sm90_xmma_wgrad_b", 650.0, 40.0, tid=7, correlation=4),
        _x("kernel", "sm90_xmma_wgrad_a", 1200.0, 40.0, tid=7, correlation=5),
    ]}
    assert _voxel_stages.tile_wgrad(trace, 2) == (pytest.approx(0.2), 1.0)
    trace["traceEvents"] = trace["traceEvents"][:1]
    assert _voxel_stages.tile_wgrad(trace, 2) is None


def test_the_wgrad_floor_counts_both_tile_blocks():
    rows, ef = 10, 2
    hbm, peak = 3.35e12, 989e12
    one = max(2 * (rows * (14**3 * 4 + 12**3 * ef) + 27 * 4 * ef) / hbm,
              2 * rows * 12**3 * 27 * 4 * ef / peak)
    two = max(2 * (rows * (6**3 * ef + 4**3 * 2 * ef) + 27 * ef * 2 * ef) / hbm,
              2 * rows * 4**3 * 27 * ef * 2 * ef / peak)
    assert _voxel_stages.wgrad_floor_s(rows, 14, ef, 2) == pytest.approx(one + two)
    only = max(4 * (rows * (10**3 * 4 + 8**3 * ef) + 27 * 4 * ef) / hbm,
               2 * rows * 8**3 * 27 * 4 * ef / peak)
    assert _voxel_stages.wgrad_floor_s(rows, 10, ef, 4) == pytest.approx(only)
    # The 128³ cell's step (B 128, k 717, ef 32, bf16): 4.29 ms, the
    # memory floor of block 1 and the FLOPs of block 2.
    assert _voxel_stages.wgrad_floor_s(128 * 717, 14, 32, 2) == pytest.approx(4.288e-3, rel=1e-3)


def test_dense_flops_count_blocks_three_to_five_and_the_head():
    m = {"ef_dim": 2, "voxel_z_dim": 4, "voxel_size": 64, "out_dim": 3}
    active = [1000, 300, 50, 10, 2]
    hand = 3 * 2 * 27 * (4 * 8 * 50 + 8 * 16 * 10 + 16 * 4 * 2) + 3 * (
        2 * 5 * 8 * 4 * 3 + 2 * 5 * 3 * 3)
    assert _voxel_stages.dense_flops(m, 5, active) == hand
    channels = (2, 4, 8, 16, 4)
    whole = _flops.voxel(active, channels, 5, 8 * 4, 3)
    assert whole - _voxel_stages.dense_flops(m, 5, active) == pytest.approx(
        2 * 2 * 27 * 3 * 2 * 1000 + 3 * 2 * 27 * 2 * 4 * 300)


def test_the_metrics_list_every_cell():
    bench = load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-5:] == list(READERS)
    for name in READERS:
        entry = entries[name]
        assert entry["workloads"] == CELLS and entry["moves"] == "train_pairs_per_s"
    assert [entries[n]["better"] for n in READERS] == [
        "lower", "lower", "higher", "lower", "higher"]
    # Every older per-layer metric is read in the 128³ cell too.
    assert all(m["workloads"][-1] == CELLS[-1] for m in bench["per_layer"])


def test_a_program_without_levels_reads_nothing(monkeypatch):
    import tricolo_tpu_torch

    cell = load_cell("tri_iv.c13_128.train_spread")
    monkeypatch.delattr(tracing, "level")
    run = SimpleNamespace(m={"voxel": True})  # no stream: no step may run
    assert all(cell.metric_reader(n).read(run) is None for n in READERS)
    assert run.voxel_stages is None
    monkeypatch.delattr(tricolo_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tricolo_tpu_torch.tracing", None)
    run = SimpleNamespace(m={"voxel": True})
    assert all(cell.metric_reader(n).read(run) is None for n in READERS)


def test_readers_on_a_tiny_cpu_run(capsys, monkeypatch):
    from benchmark import harness
    from benchmark.harness import Run

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)  # the pass's least steps: 3

    cell = load_cell("tri_iv.chair_table.train_spread")
    run = Run(cell, 2**31 + 43, "cpu", tiny("float32"))
    run.setup()
    padding = []  # each batch's padding share, as the pass's steps take them
    step = run._one_step

    def one_step(host, keep=False):
        ids = host["voxel_row_ids"]
        padding.append(100.0 * (1.0 - int((ids < (32 // 8) ** 3).sum()) / ids.size))
        return step(host, keep)

    try:
        run.window(0.2)
        run._one_step = one_step
        values = {name: cell.metric_reader(name).read(run) for name in READERS}
    finally:
        run.close()
    # The CPU has no device events: the device readings are None.
    assert values["voxel_tile_blocks_step_ms"] is None
    assert values["voxel_dense_blocks_step_ms"] is None
    assert values["voxel_dense_blocks_mfu"] is None
    assert values["voxel_tile_wgrad_roofline"] is None
    # Every batch has B·k rows, so the share is a mean of the batches'.
    assert len(padding) == _voxel_stages.FLUSH + 3
    assert min(padding) <= values["voxel_tile_padding_share"] <= max(padding)
    assert not tracing.enabled() and tracing.spans() == []
    assert "benchmark: voxel stages {" in capsys.readouterr().err

"""The benchmark's readers of the program's spans (``benchmark/metrics/
_spans.py`` and its eight metrics) on a tiny CPU run of the Tri(I+V) cell
(``benchmark/tests``' sizes): the host-clock metrics come back as numbers
and the device metrics as None, since a CPU run has no device events; a
program without ``tracing`` gives None everywhere; and the device pass's
arithmetic holds on a hand-written merged trace."""

import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from benchmark.metrics import _spans  # noqa: E402
from benchmark.spec import load_benchmark, load_cell  # noqa: E402
from benchmark.tests.sizes import tiny  # noqa: E402

HOST = ("step_dispatch_ms", "loader_produce_ms")
DEVICE = ("voxel_encoder_step_ms", "image_encoder_step_ms", "text_encoder_step_ms",
          "loss_step_ms", "optimizer_step_ms", "launches_per_step")
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


def test_every_span_metric_is_listed_after_the_others():
    # Only the voxel encoder's stage readers, whose level-2 pass follows
    # these passes (``_voxel_stages``), come after them.
    bench = load_benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-13:-5] == ["voxel_encoder_step_ms", "image_encoder_step_ms",
                             "text_encoder_step_ms", "loss_step_ms", "optimizer_step_ms",
                             "step_dispatch_ms", "loader_produce_ms", "launches_per_step"]
    assert names[-5:] == ["voxel_tile_blocks_step_ms", "voxel_dense_blocks_step_ms",
                          "voxel_dense_blocks_mfu", "voxel_tile_padding_share",
                          "voxel_tile_wgrad_roofline"]
    for metric in bench["per_layer"][-13:-5]:
        assert metric["source"] == "program_span" and metric["workloads"] == CELLS
        assert metric["moves"] == "train_pairs_per_s" and metric["better"] == "lower"


def test_readers_on_a_tiny_cpu_run(capsys):
    from benchmark.harness import Run
    from tricolo_tpu_torch import tracing

    cell = load_cell("tri_iv.chair_table.train_spread")
    run = Run(cell, 2**31 + 29, "cpu", tiny("float32"))
    run.setup()
    try:
        run.window(0.2)
        values = {name: cell.metric_reader(name).read(run) for name in HOST + DEVICE}
    finally:
        run.close()
    assert all(isinstance(values[n], float) and values[n] > 0 for n in HOST), values
    assert all(values[n] is None for n in DEVICE), values
    host = run.span_passes["host"]
    assert run.span_passes["device"] is None and host["steps"] >= _spans.HOST_STEPS
    assert host["loader_batches"] >= 3
    # The dispatch time leaves out step.prepare, where the host may wait.
    spent = host["span_host_ms"]
    assert values["step_dispatch_ms"] == pytest.approx(spent["step"] - spent["step.prepare"],
                                                       rel=1e-3)
    assert not tracing.enabled() and tracing.spans() == []
    assert "benchmark: spans {" in capsys.readouterr().err


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    import tricolo_tpu_torch

    monkeypatch.delattr(tricolo_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tricolo_tpu_torch.tracing", None)
    run = SimpleNamespace()
    cell = load_cell("tri_iv.chair_table.train_narrow")
    assert all(cell.metric_reader(n).read(run) is None for n in HOST + DEVICE)
    assert run.span_passes is None


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_the_device_pass_reads_a_merged_trace():
    """Two steps in a 1000 µs annotation. Step 1 (0-450) launches the voxel
    forward at 20 (100-200) and, from the engine's thread (tid 2), its
    backward at 310 (300-400); step 2 (500-950) the optimizer at 520
    (600-650). A copy launched by ``to_device`` (460) runs at 460-480, a
    kernel launched at 970 under no span at 960-990 and a kernel with no
    launch in the trace at 700-720. The host waits in a stream sync at
    200-260; the prefetch thread (tid 3) collates at 700-960."""
    trace = {"traceEvents": [
        _x("user_annotation", _spans.ANNOTATION, 0.0, 1000.0),
        _x("program_span", "step", 0.0, 450.0, span=1, parent=None),
        _x("program_span", "forward.voxel", 10.0, 40.0, span=2, parent=1),
        _x("program_span", "backward", 300.0, 100.0, span=3, parent=1),
        _x("program_span", "backward.voxel", 305.0, 50.0, tid=2, span=4, parent=3),
        _x("program_span", "to_device", 455.0, 10.0, span=5, parent=None),
        _x("program_span", "step", 500.0, 450.0, span=6, parent=None),
        _x("program_span", "optimizer", 510.0, 30.0, span=7, parent=6),
        _x("program_span", "loader.collate", 700.0, 260.0, tid=3, span=8, parent=None),
        _x("cuda_runtime", "cudaStreamSynchronize", 200.0, 60.0),
        _x("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 310.0, 2.0, tid=2, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 460.0, 2.0, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 520.0, 2.0, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 970.0, 2.0, correlation=5),
        _x("kernel", "fprop", 100.0, 100.0, tid=7, correlation=1),
        _x("kernel", "dgrad", 300.0, 100.0, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 460.0, 20.0, tid=7, correlation=3),
        _x("kernel", "adam", 600.0, 50.0, tid=7, correlation=4),
        _x("kernel", "orphan", 700.0, 20.0, tid=7, correlation=99),
        _x("kernel", "late", 960.0, 30.0, tid=7, correlation=5),
    ]}
    r = _spans.analyse(trace)
    assert r["steps"] == 2
    assert r["busy_ms_per_step"] == pytest.approx(0.16)
    assert r["span_ms"] == pytest.approx({"forward.voxel": 0.05, "backward.voxel": 0.05,
                                          "optimizer": 0.025, "(none)": 0.025,
                                          "to_device": 0.01})
    assert r["parts_ms"] == pytest.approx({"voxel": 0.1, "image": 0.0, "text": 0.0,
                                           "loss": 0.0, "optimizer": 0.025})
    assert r["parts_and_copy_ms"] == pytest.approx(0.135)
    assert r["in_step_ms_per_step"] == pytest.approx(0.125)
    assert r["unclaimed_share"] == pytest.approx(50.0 / 320.0)
    assert r["kernels_per_step"] == 1.5  # three kernels under a step, not the copy
    assert [g[0] for g in r["gaps"]] == pytest.approx([0.24, 0.12, 0.1, 0.1, 0.06, 0.05, 0.01])
    # 720-960: the second step's host, the prefetch thread's collate beside it
    assert r["gaps"][0][1:] == ["step", "loader.collate", None]
    assert r["gaps"][1][1:] == ["optimizer", None, None]  # 480-600: mid-gap at Adam's end
    assert r["gaps"][3][1:] == ["step", None, "cudaStreamSynchronize"]  # 200-300
    assert r["waits_ms"] == pytest.approx({"step": 0.03})
    assert r["loader_ms"] == {"loader.collate": [1, pytest.approx(0.26)]}
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert _spans.analyse(trace) is None

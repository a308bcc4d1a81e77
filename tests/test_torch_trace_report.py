"""``tricolo_tpu_torch.trace_report`` on a hand-written Chrome trace in
``torch.profiler``'s format, where every number is known: device ms per
step, the idle share of the window, the K-labels, the forward/backward
split by the launching thread's ``autograd::engine::evaluate_function:``
spans, and the longest idle gaps with the host operation under each. And
``chip_smoke.profile_summary`` (the profiled phases' arithmetic) gives the
module's numbers over the same events.
"""

import json
from types import SimpleNamespace

import pytest

STEPS = 2
MAIN, BACKWARD_THREAD, PREFETCH_THREAD = (1, 1), (1, 2), (1, 3)


def _host(cat, name, ts, dur, thread=MAIN, correlation=None):
    args = {"External id": ts}
    if correlation is not None:
        args["correlation"] = correlation
    return {"ph": "X", "cat": cat, "name": name, "pid": thread[0], "tid": thread[1],
            "ts": ts, "dur": dur, "args": args}


def _device(cat, name, ts, dur, correlation):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": 7, "correlation": correlation}}


K1 = "void (anonymous namespace)::bn_relu_pool_kernel<true, 8>(Params)"
K3 = "void (anonymous namespace)::bn_relu_pool_bwd_kernel<__nv_bfloat16, 8>(Params)"
K56 = "void (anonymous namespace)::nt_xent_bwd_cluster_kernel<64>(const float*, float*)"
DGRAD = "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
MEMCPY = "Memcpy HtoD (Pinned -> Device)"
BWD_SPAN = "autograd::engine::evaluate_function: ConvolutionBackward0"


def trace() -> dict:
    """A 1000 µs window of two steps: device busy 100-200 (K1, launched in
    the forward), 400-600 (K3 and a cuDNN dgrad, launched in a backward
    span of the autograd thread), 700-720 (a copy), 850-860 (K5-K6, the
    backward), 900-950 (a kernel whose launch is not in the trace)."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 0.0, "dur": 1000.0, "args": {}},
        _host("cpu_op", "aten::conv3d", 10.0, 50.0),
        _host("cuda_runtime", "cudaLaunchKernel", 20.0, 5.0, correlation=1),
        _device("kernel", K1, 100.0, 100.0, 1),
        _host("cuda_runtime", "cudaDeviceSynchronize", 250.0, 100.0),
        _host("cpu_op", BWD_SPAN, 300.0, 200.0, BACKWARD_THREAD),
        _host("cuda_runtime", "cudaLaunchKernel", 310.0, 5.0, BACKWARD_THREAD, correlation=2),
        _host("cuda_runtime", "cudaLaunchKernel", 320.0, 5.0, BACKWARD_THREAD, correlation=3),
        _host("cuda_runtime", "cudaLaunchKernel", 330.0, 5.0, BACKWARD_THREAD, correlation=5),
        _device("kernel", K3, 400.0, 150.0, 2),
        _device("kernel", DGRAD, 550.0, 50.0, 3),
        # A launch on the main thread while the autograd thread is in a
        # backward span: forward (the span is another thread's).
        _host("cuda_runtime", "cudaMemcpyAsync", 650.0, 5.0, correlation=4),
        _device("gpu_memcpy", MEMCPY, 700.0, 20.0, 4),
        _device("kernel", K56, 850.0, 10.0, 5),
        _device("kernel", ELEMENTWISE, 900.0, 50.0, 99),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 1, "ts": 20.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0, "tid": 7, "ts": 100.0,
         "bp": "e"},
    ]}


def test_report_numbers():
    from tricolo_tpu_torch.trace_report import analyse

    r = analyse(trace(), STEPS)
    assert r["window_ms"] == pytest.approx(1.0)
    assert r["device_busy_ms"] == pytest.approx(0.38)
    assert r["device_ms_per_step"] == pytest.approx(0.19)
    assert r["device_idle_share"] == pytest.approx(0.62)
    assert r["port_kernels_ms_per_step"] == pytest.approx(
        {"K1": 0.05, "K2": 0.0, "K3": 0.075, "K4": 0.0, "K5-K6": 0.005, "K7": 0.0})
    assert r["phase_ms_per_step"] == pytest.approx({"fwd": 0.06, "bwd": 0.105, "unlinked": 0.025})
    rows = {(row["phase"], row["name"]): row for row in r["top"]}
    assert set(rows) == {("fwd", K1), ("fwd", MEMCPY), ("bwd", K3), ("bwd", DGRAD),
                         ("bwd", K56), ("unlinked", ELEMENTWISE)}
    assert [row["name"] for row in r["top"]][:2] == [K3, K1]
    assert {name: row["label"] for (_, name), row in rows.items()} == {
        K1: "K1", K3: "K3", K56: "K5-K6", DGRAD: None, MEMCPY: None, ELEMENTWISE: None}
    assert rows[("bwd", K3)]["ms_per_step"] == pytest.approx(0.075)
    assert all(row["count"] == 1 for row in r["top"])
    assert [g["at_ms"] for g in r["gaps"]] == pytest.approx([0.2, 0.72, 0.0, 0.6, 0.95])
    assert [g["ms"] for g in r["gaps"]] == pytest.approx([0.2, 0.13, 0.1, 0.1, 0.05])
    assert [g["host_op"] for g in r["gaps"]] == ["cudaDeviceSynchronize", None, "aten::conv3d",
                                                 "cudaMemcpyAsync", None]


def test_top_and_gap_counts_are_limited():
    from tricolo_tpu_torch.trace_report import analyse

    r = analyse(trace(), STEPS, top=2, gaps=6)
    assert [row["name"] for row in r["top"]] == [K3, K1]
    assert len(r["gaps"]) == 6 and r["gaps"][-1]["ms"] == pytest.approx(0.04)


def test_port_kernel_labels():
    from tricolo_tpu_torch.trace_report import port_kernel

    assert port_kernel("void (anonymous namespace)::scatter_pass_kernel<8>") == "K2"
    assert port_kernel("void (anonymous namespace)::inverse_global_kernel") == "K2"
    assert port_kernel("void (anonymous namespace)::nt_xent_fwd_combine_kernel") == "K4"
    assert port_kernel("void tile_gather_kernel<8, 1>") is None  # not in a namespace
    assert port_kernel("void (anonymous namespace)::tile_gather_kernel<8, 1>") == "K7"
    assert port_kernel(K3) == "K3" and port_kernel(DGRAD) is None


def test_profile_summary_shares_the_arithmetic():
    """``chip_smoke.profile_summary`` over ``key_averages``-like rows of the
    trace's device events (and a host row it must skip) gives the
    module's busy ms, idle share and port-kernel ms."""
    import chip_smoke
    from tricolo_tpu_torch.trace_report import analyse

    events = [e for e in trace()["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    rows = [SimpleNamespace(key=e["name"], self_device_time_total=e["dur"],
                            device_type="DeviceType.CUDA", count=1) for e in events]
    rows.append(SimpleNamespace(key="aten::conv3d", self_device_time_total=0.0,
                                device_type="DeviceType.CPU", count=1))
    summary = chip_smoke.profile_summary(rows, [], wall_us=1000.0)
    ref = analyse(trace(), STEPS)
    assert summary["device_busy_ms"] == pytest.approx(ref["device_busy_ms"])
    assert summary["device_idle_share"] == pytest.approx(ref["device_idle_share"])
    assert summary["port_kernels_ms"] == pytest.approx(
        {k: v * STEPS for k, v in ref["port_kernels_ms_per_step"].items()})
    assert summary["top"][0]["name"] == K3 and summary["wall_ms"] == 1.0
    assert chip_smoke.profile_summary(rows[-1:], [], 1000.0)["device_busy_ms"] is None


def test_cli_reads_the_newest_trace(tmp_path, capsys):
    from tricolo_tpu_torch import trace_report

    old = trace()
    old["traceEvents"] = old["traceEvents"][:5]
    (tmp_path / "bench.100.pt.trace.json").write_text(json.dumps(old))
    (tmp_path / "bench.200.pt.trace.json").write_text(json.dumps(trace()))
    assert trace_report.main([str(tmp_path), "--steps", str(STEPS), "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report["trace"].endswith("bench.200.pt.trace.json")
    assert report["device_ms_per_step"] == pytest.approx(0.19)
    assert trace_report.main([str(tmp_path / "bench.200.pt.trace.json"), "--steps", "2",
                              "--top", "3"]) == 0
    text = capsys.readouterr().out
    assert "total device time: 0.190 ms/step (2 steps traced)" in text
    assert "device idle share 0.6200" in text and "host: cudaDeviceSynchronize" in text
    assert "K3" in text and "bwd" in text
    with pytest.raises(SystemExit):
        trace_report.main([str(tmp_path / "empty"), "--steps", "1"])


def _span(name, ts, dur, thread=MAIN, parent=None):
    return {"ph": "X", "cat": "program_span", "name": name, "pid": thread[0], "tid": thread[1],
            "ts": ts, "dur": dur, "args": {"span": ts, "parent": parent}}


def test_program_spans_place_device_time_and_gaps():
    """With the port's spans merged in (``tracing.merge_into``): each device
    event goes to the innermost span of its launching thread, each idle gap
    to the innermost span over its midpoint of the threads that launch
    device work, beside its host operation and the innermost span of the
    other threads (a prefetch thread's ``loader.collate``, shorter than the
    ``step`` it overlaps, does not take the gap); the rest of the report is
    unchanged."""
    from tricolo_tpu_torch.trace_report import analyse, format_report

    merged = trace()
    merged["traceEvents"] += [
        _span("step", 0.0, 1000.0), _span("forward.voxel", 10.0, 50.0),
        _span("to_device", 640.0, 20.0),
        _span("backward.voxel", 300.0, 25.0, BACKWARD_THREAD),
        _span("backward.loss", 325.0, 15.0, BACKWARD_THREAD),
        _span("loader.collate", 700.0, 200.0, PREFETCH_THREAD)]
    r = analyse(merged, STEPS)
    plain = analyse(trace(), STEPS)
    assert "span_ms_per_step" not in plain and all("span" not in g for g in plain["gaps"])
    assert r["span_ms_per_step"] == pytest.approx({
        "backward.voxel": 0.1, "forward.voxel": 0.05, "(none)": 0.025, "to_device": 0.01,
        "backward.loss": 0.005})
    assert [g["span"] for g in r["gaps"]] == ["backward.voxel", "step", "forward.voxel",
                                              "to_device", "step"]
    assert [g["other_span"] for g in r["gaps"]] == [None, "loader.collate", None, None, None]
    assert [g["host_op"] for g in r["gaps"]] == [g["host_op"] for g in plain["gaps"]]
    assert r["device_ms_per_step"] == plain["device_ms_per_step"]
    text = format_report(r)
    assert "device time by program span: backward.voxel 0.100" in text
    assert "host: cudaDeviceSynchronize  span: backward.voxel" in text
    assert "host: None  span: step (beside loader.collate)" in text

"""``tricolo_tpu_torch.roofline_report`` on a hand-written Chrome trace and
work record of 2 steps, its arithmetic checked exactly.

Each step holds ``work#`` ranges for a bf16 convolution (two kernels, one
launched from the autograd thread's range in step 2), a ``K1`` call and an
elementwise add; an unlinked memcpy (no launch in the trace) is device
time outside any range; a ``zeros`` and a ``view`` launched nothing. With
the H100 peaks: the convolution's floor is its FLOPs' (10 µs a call of 50
µs), K1's its bytes' (10 of 20 µs), the add's its bytes' (1 µs of 0.5:
above 105%, so ``impossible``).
"""

import pytest

from tricolo_tpu_torch.roofline_report import DEFAULT_PEAKS, analyse, format_report, owners

BW = 3.35e12
CONV_FLOPS = 9.89e9  # 10 µs at 989 TFLOP/s
CONV_BYTES = 3.35e6  # 1 µs
K1_BYTES = 33.5e6  # 10 µs
ADD_BYTES = 3.35e6  # 1 µs
ZEROS_BYTES = 6.7e6  # 2 µs, no device work


def _record():
    ops = {}
    for step in range(2):
        base = 10 * step
        ops[base + 0] = ("aten::convolution", "bf16", CONV_FLOPS, CONV_BYTES)
        ops[base + 1] = ("K1", "memory", 0, K1_BYTES)
        ops[base + 2] = ("aten::add", "memory", 0, ADD_BYTES)
    ops[20] = ("aten::view", "memory", 0, 0)
    ops[21] = ("aten::zeros", "memory", 0, ZEROS_BYTES)
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "ops": ops, "kernel_args": {}}


def _trace():
    events = []
    corr = iter(range(1, 100))

    def span(cat, name, ts, dur, tid=1, **args):
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
                       "dur": dur, "args": args})

    def launch(ts, tid, kernel_ts, dur, name):
        c = next(corr)
        span("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid, correlation=c)
        span("kernel", name, kernel_ts, dur, tid=7, correlation=c)

    for step in range(2):
        base, t0 = 10 * step, 1000 * step
        tid = 2 if step else 1  # step 2's convolution runs on the autograd thread
        span("user_annotation", f"work#{base}", t0, 100, tid=tid)
        launch(t0 + 10, tid, t0 + 20, 40, "conv_fprop_a")
        launch(t0 + 50, tid, t0 + 60, 10, "conv_fprop_b")
        span("user_annotation", f"work#{base + 1}:K1", t0 + 100, 20)
        launch(t0 + 105, 1, t0 + 110, 20, "tricolo::bn_relu_pool_kernel")
        span("user_annotation", f"work#{base + 2}", t0 + 120, 10)
        launch(t0 + 122, 1, t0 + 140, 0.5, "elementwise_add")
    span("user_annotation", "work#20", 1500, 5)
    span("user_annotation", "work#21", 1510, 5)
    span("gpu_memcpy", "Memcpy HtoD", 1600, 5, tid=7, correlation=500)  # unlinked
    return {"traceEvents": events}


def test_rows_totals_and_impossible_exactly():
    report = analyse(_trace(), _record(), steps=2)
    rows = {r["op"]: r for r in report["rows"]}
    assert set(rows) == {"aten::convolution", "K1", "aten::add", "unattributed"}
    conv, k1, add = rows["aten::convolution"], rows["K1"], rows["aten::add"]
    assert conv["device_ms"] == pytest.approx(0.050, rel=1e-12)
    assert conv["floor_ms"] == pytest.approx(0.010, rel=1e-12)
    assert conv["pct_of_floor"] == pytest.approx(0.2, rel=1e-12)
    assert (conv["bound"], conv["launches"], conv["kernels"]) == ("FLOP", 1.0, 2.0)
    assert k1["device_ms"] == pytest.approx(0.020, rel=1e-12)
    assert k1["floor_ms"] == pytest.approx(0.010, rel=1e-12)
    assert k1["pct_of_floor"] == pytest.approx(0.5, rel=1e-12)
    assert (k1["bound"], k1["launches"], k1["kernels"]) == ("BW", 1.0, 1.0)
    assert add["device_ms"] == pytest.approx(0.0005, rel=1e-12)
    assert add["floor_ms"] == pytest.approx(0.001, rel=1e-12)
    assert add["pct_of_floor"] == pytest.approx(2.0, rel=1e-12)
    assert report["impossible"] == ["aten::add"]
    un = rows["unattributed"]
    assert un["device_ms"] == pytest.approx(0.0025, rel=1e-12) and un["kernels"] == 0.5
    total_us = 2 * (50 + 20 + 0.5) + 5
    assert report["device_ms_per_step"] == pytest.approx(total_us / 2e3, rel=1e-12)
    assert report["floor_ms_per_step"] == pytest.approx(0.021, rel=1e-12)
    assert report["floor_share"] == pytest.approx(0.021 / (total_us / 2e3), rel=1e-12)
    assert report["attributed_share"] == pytest.approx(1 - 5 / total_us, rel=1e-12)
    assert report["no_device_work_floor_ms"] == pytest.approx(ZEROS_BYTES / BW * 1e3 / 2,
                                                              rel=1e-12)
    assert set(report["kernel_rows"]) == {"K1"}
    by_class = report["per_step_by_class"]
    assert by_class["bf16"] == {"flops": CONV_FLOPS, "bytes": CONV_BYTES}
    assert by_class["memory"]["bytes"] == pytest.approx(K1_BYTES + ADD_BYTES + ZEROS_BYTES / 2)
    kernels = {k["kernel"]: k for k in report["by_kernel"]}
    assert kernels["conv_fprop_a"]["ops"] == ["aten::convolution"]
    assert kernels["conv_fprop_a"]["device_ms"] == pytest.approx(0.040, rel=1e-12)
    assert kernels["conv_fprop_a"]["ops_floor_ms"] == pytest.approx(0.010, rel=1e-12)
    assert report["peaks"] == {"bf16_tflops": 989.0, "tf32_tflops": 494.0, "f32_tflops": 67.0,
                               "gbps": 3350.0}
    text = format_report(report)
    assert "aten::add" in text and "impossible" in text and "unattributed" in text


def test_innermost_range_on_the_launching_thread():
    host = [
        {"name": "work#1", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {"name": "work#2:K1", "pid": 1, "tid": 1, "ts": 10, "dur": 20},
        {"name": "work#3", "pid": 1, "tid": 2, "ts": 0, "dur": 100},
        {"name": "other", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
    ]
    launches = {7: {"pid": 1, "tid": 1, "ts": 15}, 8: {"pid": 1, "tid": 1, "ts": 50},
                9: {"pid": 1, "tid": 2, "ts": 15}, 10: {"pid": 1, "tid": 3, "ts": 15},
                11: {"pid": 1, "tid": 1, "ts": 150}}
    assert owners(host, launches) == {7: 2, 8: 1, 9: 3}


def test_peaks_change_the_floor():
    from tricolo_tpu_torch.roofline_report import peaks

    half = peaks(989 / 2, 494, 67, 3350)
    report = analyse(_trace(), _record(), steps=2, peak=half)
    conv = next(r for r in report["rows"] if r["op"] == "aten::convolution")
    assert conv["floor_ms"] == pytest.approx(0.020, rel=1e-12)
    assert DEFAULT_PEAKS["bytes_per_s"] == BW

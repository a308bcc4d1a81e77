"""``tricolo_tpu_torch.tracing`` on the CPU, on a tiny Tri(I+V) model with
the windowed_compact transfer: off it records nothing and leaves the
step's graph alone; on, each step gives the span tree of the train step,
the backward phases hold their encoders' operations, the prefetch thread's
spans carry the batch ids of the spans that consume the batch, merged spans
sit on the profiler trace's clock, and the counters the port reads
(``ops.launches``, ``native.call_counts``, the copy counts) read as before.
"""

import collections
import json
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

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
BACKWARD_PHASES = ["backward.loss", "backward.voxel", "backward.image", "backward.text"]


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _setup(pin=False):
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
    return model, optimizer, make_train_step(model, optimizer, cfg), dm.train_loader(pin)


def _steps(step, loader, n):
    """``n`` steps as the trainer takes them, each tagged with its step."""
    from tricolo_tpu_torch.inference import to_device_batch

    for i, batch in enumerate(loader):
        tracing.set_step(i)
        step(to_device_batch(batch, CPU), 1e-3)
        if i + 1 == n:
            break


def _graph(outputs) -> collections.Counter:
    """Node types of the autograd graph behind ``outputs``."""
    seen, todo = set(), [t.grad_fn for t in outputs.values()]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return collections.Counter(type(node).__name__ for node in seen)


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start) if s.parent is parent]


def test_off_records_nothing_and_leaves_the_graph_alone():
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch

    model, _, step, loader = _setup()
    batch = to_device_batch(loader.peek(), CPU)
    model.train()
    off = _graph(model(prepare_inputs(model, batch)))
    tracing.enable()
    on = _graph(model(prepare_inputs(model, batch)))
    tracing.disable()
    assert on - off == collections.Counter({"_MarkBackward": 3}) and not off - on
    assert "_MarkBackward" not in off
    tracing.clear()
    losses = step(batch, 1e-3)
    assert all(torch.isfinite(v) for v in losses.values())
    assert tracing.spans() == [] and tracing._anchors == []


def test_on_equals_off_bit_for_bit():
    from tricolo_tpu_torch.inference import to_device_batch

    results = []
    for on in (False, True):
        model, _, step, loader = _setup()
        batch = to_device_batch(loader.peek(), CPU)
        (tracing.enable if on else tracing.disable)()
        losses = step(batch, 1e-3)
        tracing.disable()
        results.append((losses, model.state_dict()))
    (l0, s0), (l1, s1) = results
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert {s.name for s in tracing.spans()} >= {"step", *STEP_CHILDREN, *BACKWARD_PHASES}


def test_each_step_gives_the_span_tree():
    _, _, step, loader = _setup()
    tracing.enable()
    _steps(step, loader, 2)
    tracing.disable()
    spans = tracing.spans()
    steps = sorted((s for s in spans if s.name == "step"), key=lambda s: s.start)
    assert [s.step for s in steps] == [0, 1]
    assert [s.batch for s in steps] == [(0, 0), (0, 1)]
    for root in steps:
        assert root.parent is None and root.thread == threading.get_native_id()
        assert _children(spans, root) == STEP_CHILDREN
        (back,) = [s for s in spans if s.name == "backward" and s.parent is root]
        assert _children(spans, back) == BACKWARD_PHASES
        tree = [s for s in spans if s.parent is root or s.parent is back]
        assert all(s.step == root.step and s.batch == root.batch for s in tree)
        assert all(root.start <= s.start <= s.end <= root.end for s in tree)
        phases = sorted((s for s in spans if s.parent is back), key=lambda s: s.start)
        assert all(a.end == b.start for a, b in zip(phases, phases[1:]))
        assert back.start <= phases[0].start and phases[-1].end <= back.end
        assert root.args == {}  # no port kernel launches on the CPU


def _merged_trace(record_shapes=False):
    """A profiled two-step run with tracing on, its spans merged."""
    from torch.profiler import ProfilerActivity, profile

    _, _, step, loader = _setup()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        _steps(step, loader, 2)
    tracing.disable()
    return _export(prof)


def _export(prof):
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    assert tracing.merge_into(trace) > 0
    return trace


def test_backward_phases_hold_their_encoders_ops():
    trace = _merged_trace(record_shapes=True)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    phases = [e for e in events if e.get("cat") == tracing.CATEGORY
              and e["name"] in ("backward.voxel", "backward.text")]
    assert len(phases) == 4

    def ops_in(phase):
        return [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == phase["tid"]
                and phase["ts"] <= e["ts"] <= phase["ts"] + phase["dur"]]

    for phase in phases:
        ops = ops_in(phase)
        conv3d = [e for e in ops if e["name"] == "aten::convolution_backward"
                  and len(e["args"]["Input Dims"][0]) == 5]
        conv = [e for e in ops if e["name"] == "aten::convolution_backward"]
        gru = [e for e in ops if e["name"] in ("aten::sigmoid_backward", "aten::tanh_backward")]
        if phase["name"] == "backward.voxel":
            assert len(conv3d) == 5 and not gru, phase
        else:
            assert gru and not conv, phase


def test_prefetch_spans_carry_the_batch_ids(monkeypatch):
    from tricolo_tpu_torch.data.loader import ARRAY_DTYPES, host_tensor

    # A CPU build of torch has no page-locked memory: the pin is an identity.
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    _, _, step, loader = _setup(pin=True)
    first = loader.peek()
    first_bytes = sum(host_tensor(k, v).nbytes for k, v in first.items() if k in ARRAY_DTYPES)
    tracing.enable()
    _steps(step, loader, 2)
    tracing.disable()
    spans = tracing.spans()
    main = threading.get_native_id()
    by_name = collections.defaultdict(dict)
    for s in spans:
        if s.name in ("loader.collate", "loader.pin", "loader.wait", "to_device", "step"):
            by_name[s.name][s.batch] = s
    taken = [(0, 0), (0, 1)]
    for name in ("loader.wait", "to_device", "step"):
        assert sorted(by_name[name]) == taken, name
        assert all(s.thread == main for s in by_name[name].values())
    for name in ("loader.collate", "loader.pin"):
        assert set(taken) <= set(by_name[name]), name
        assert all(s.thread != main for s in by_name[name].values())
    for batch in taken:
        collate, pin = by_name["loader.collate"][batch], by_name["loader.pin"][batch]
        assert collate.end <= pin.start <= pin.end <= by_name["loader.wait"][batch].end
        assert by_name["loader.wait"][batch].end <= by_name["to_device"][batch].start
        # Each pin span records the bytes it pinned (``loader.pinned_bytes``).
        assert pin.args == {"loader.pinned_bytes": first_bytes} and first_bytes > 0


def test_merged_spans_sit_on_the_trace_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            # An annotation around a span, and a span around an annotation:
            # a clock off by more than 50 µs either way puts one outside.
            with record_function(f"outer{i}"), tracing.span(f"inner{i}"):
                time.sleep(0.001)
            with tracing.span(f"outer{i}"), record_function(f"inner{i}"):
                time.sleep(0.001)
    tracing.disable()
    trace = _export(prof)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ours = {e["name"]: e for e in events if e.get("cat") == tracing.CATEGORY}
    notes = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert len(ours) == 10
    for i in range(5):
        for outer, inner in ((notes[f"outer{i}"], ours[f"inner{i}"]),
                             (ours[f"outer{i}"], notes[f"inner{i}"])):
            assert inner["ts"] >= outer["ts"] - 50.0
            assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 50.0
    assert all(e["tid"] == threading.get_native_id() for e in ours.values())


def test_the_prefetch_thread_reaches_the_merged_trace():
    trace = _merged_trace()
    events = trace["traceEvents"]
    collates = [e for e in events if e.get("cat") == tracing.CATEGORY
                and e["name"] == "loader.collate"]
    assert collates and {e["tid"] for e in collates} != {threading.get_native_id()}
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {names[e["tid"]] for e in collates} == {"tricolo-prefetch"}
    steps = [e for e in events if e.get("cat") == tracing.CATEGORY and e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    assert [e["args"]["batch"] for e in steps] == [[0, 0], [0, 1]]


def test_counters_read_as_before():
    from tricolo_tpu_torch import native, ops
    from tricolo_tpu_torch.inference import to_device_batch

    ops.reset_launches()
    native.reset_calls()
    assert ops.launches() == dict.fromkeys((k.__name__ for k in ops.KERNELS), 0)
    assert len(ops.launches()) == 14
    assert native.call_counts() == dict.fromkeys((f.__name__ for f in native.SWEEPS), 0)
    _, _, _, loader = _setup()
    copies = tracing.counts("to_device.")
    n = 0
    for batch in loader:  # counters count whether tracing is on or not
        to_device_batch(batch, CPU)
        n += 1
    assert n > 0 and native.call_counts()["packed_to_windowed_compact"] == n
    assert tracing.counts("to_device.") == copies  # copies to a CUDA device only
    assert set(ops.launches().values()) == {0}  # no kernel runs on the CPU
    tracing.count("launches.bn_relu_pool", 3)
    assert ops.launches()["bn_relu_pool"] == 3
    ops.reset_launches()
    assert ops.launches()["bn_relu_pool"] == 0 and native.call_counts()[
        "packed_to_windowed_compact"] == n


def test_count_loses_no_update_across_threads():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("test.stress")
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counter("test.stress") == 16 * 2000
    tracing.reset_counts("test.")
    assert tracing.counts("test.") == {}


def test_timed_spans_time_with_tracing_off_or_on():
    totals = collections.defaultdict(float)
    assert tracing.span("x") is tracing.span("y")  # one shared no-op
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        with tracing.span("fit.train", totals=totals):
            time.sleep(0.01)
    tracing.disable()
    assert totals["fit.train"] >= 0.02
    assert [s.name for s in tracing.spans()] == ["fit.train"]

"""A run with its timed path broken underneath comes out not correct, and
the control (the reference in fp8, put in the program's place) fails the
cell's limits.

The fault runs drive ``run.execute`` (everything but the look for a GPU)
at the CPU size in f32, against limits that a sound run at that size
meets; each fault is planted in the step the harness builds:

* a step that returns its state unchanged (the weights and statistics put
  back after it);
* half of the batch left out, the mean taken over the rest;
* the answer altered where it is produced (the step's total loss × 1.1).

A training cell has no exchange between chips (one GPU) and no tokens to
serve, so those faults do not apply."""

from __future__ import annotations

import pytest

from benchmark import compare, harness
from benchmark.harness import TOTAL, Run
from benchmark.run import execute

from .sizes import tiny

# What a sound f32 run at the CPU size reads (test_reference's bounds).
CPU_F32_LIMITS = {"numbers": {
    "loss_gap": {"limit": 5e-3}, "emb_gap.text": {"limit": 1e-4},
    "emb_gap.image": {"limit": 1e-4}, "emb_gap.voxel": {"limit": 1e-4},
    "grad_gap": {"limit": 3e-3}, "change_gap": {"limit": 1e-2},
    "batch_mismatch": {"limit": 0}}}
REAL_STEP = harness.make_train_step


def unchanged(model, optimizer, cfg):
    step = REAL_STEP(model, optimizer, cfg)

    def fault(batch, lr, generator=None):
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        out = step(batch, lr, generator)
        model.load_state_dict(saved)
        return out

    return fault


def half_batch(model, optimizer, cfg):
    step = REAL_STEP(model, optimizer, cfg)

    def fault(batch, lr, generator=None):
        return step({k: v[:v.shape[0] // 2] for k, v in batch.items()}, lr, generator)

    return fault


def altered(model, optimizer, cfg):
    step = REAL_STEP(model, optimizer, cfg)

    def fault(batch, lr, generator=None):
        out = dict(step(batch, lr, generator))
        out[TOTAL] = out[TOTAL] * 1.1
        return out

    return fault


def run_cell(cell, monkeypatch, fault=None, trace=False) -> dict:
    cell.limits = CPU_F32_LIMITS
    if fault is not None:
        monkeypatch.setattr(harness, "make_train_step", fault)
    return execute(cell, 2**31 + 19, 0.3, trace, "cpu", tiny("float32"), start=0.0)


def test_a_sound_run_is_correct(tri_cell, monkeypatch):
    result = run_cell(tri_cell, monkeypatch)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("order", ["listed", "reversed"])
def test_the_traced_steps_come_before_every_reader(tri_cell, order, monkeypatch):
    # The encoder and loss timings move BatchNorm statistics, leave
    # gradients and reshape the allocator's cache: none of that may come
    # before the traced steps, whichever metric BENCHMARK.json lists first.
    calls = []
    real_trace = Run.trace

    def trace(run):
        if run.trace_report is None:
            calls.append("trace")
        return real_trace(run)

    def timed(call, device, n=harness.TIMED_CALLS):  # no CUDA events on the CPU
        calls.append("timed")
        call()
        return 1.0

    monkeypatch.setattr(Run, "trace", trace)
    monkeypatch.setattr(harness, "timed_ms", timed)
    if order == "reversed":
        tri_cell.per_layer = tri_cell.per_layer[::-1]
    result = run_cell(tri_cell, monkeypatch, trace=True)
    assert calls[0] == "trace" and calls.count("trace") == 1, calls
    assert "timed" in calls
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered], ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(tri_cell, fault, monkeypatch):
    result = run_cell(tri_cell, monkeypatch, fault)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_cells_limits(tri_cell):
    run = Run(tri_cell, 2**31 + 23, "cpu", tiny("bfloat16"))
    run.setup()
    run.close()
    control = compare.numbers(run.reference(control=True), run.reference())
    correct, checks = compare.judge(control, tri_cell.limits)
    assert not correct, checks

"""The plain reference against the program's plain path (CPU, f32).

On the CPU the program runs its kernels' plain versions; with
``precision.compute_dtype=float32`` both sides compute in f32 from the same
seeded weights and raw items, so the first step agrees to f32 rounding. The
later steps and the gradients read the BatchNorms' conditioning at this
size (ResNet18's last stages normalise over few values), hence their looser
bounds."""

from __future__ import annotations

import torch

from benchmark import compare
from benchmark.harness import Run

from .sizes import tiny


def test_reference_matches_program_f32(tri_cell):
    run = Run(tri_cell, 2**31 + 7, "cpu", tiny("float32"))
    run.setup()
    run.close()
    ref = run.reference()
    prog = run.readings
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-6 * abs(ref["loss"][0])
    for key, want in ref["emb"].items():
        assert torch.allclose(prog["emb"][key], want, atol=2e-5), key
    found = compare.numbers(prog, ref)
    assert found["loss_gap"] < 5e-3
    assert found["grad_gap"] < 3e-3
    assert found["change_gap"] < 1e-2
    assert run.batch_mismatch() == 0
    assert set(prog["change"]) == set(ref["change"])


def test_batch_check_sees_a_changed_word(tri_cell):
    run = Run(tri_cell, 5, "cpu", tiny("float32"))
    run.setup()
    run.close()
    rows = run.first_batch["voxel_rows"]
    b, j = torch.nonzero(rows.reshape(rows.shape[0], rows.shape[1], -1).any(-1))[0].tolist()
    rows[b, j, rows[b, j].nonzero()[0]] ^= 1  # one site's red channel, lowest bit
    assert run.batch_mismatch() == 1

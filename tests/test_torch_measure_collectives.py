"""``tricolo_tpu_torch.measure_collectives`` against the JAX package's
``scripts/measure_collectives.py`` and ``tricolo_tpu.parallel``.

* At 2 gloo ranks (CPU processes), for the same seeded (256, 512) inputs:
  the global-negative loss (the gathered form and the
  ``explicit_collectives`` form) and its gradients equal
  ``make_global_nt_xent`` over a 2-device JAX mesh, within rel 1e-5 for
  the loss and 3e-4 of max for the gradients; the local loss and its
  gradients equal ``make_local_nt_xent``'s.
* The gathered bytes a rank are the JAX script's formula, 2·2·B·(n−1)·D·4.
* The CLI prints a line a (world, loss) and the summary line.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
GRAD_TOL = 3e-4


@pytest.fixture(scope="module")
def two_ranks():
    from tricolo_tpu_torch.measure_collectives import run_world

    return run_world(2, "gloo", repeats=1, keep=True)


def _jax_value_and_grads(kind, zis, zjs, temperature, alpha):
    from tricolo_tpu.parallel import batch_sharding, make_mesh
    from tricolo_tpu.parallel.collectives import make_global_nt_xent, make_local_nt_xent

    mesh = make_mesh(2)
    make = make_local_nt_xent if kind == "local" else make_global_nt_xent
    loss_fn = make(mesh, temperature, alpha)
    a, b = (jax.device_put(z, batch_sharding(mesh)) for z in (zis, zjs))
    loss, grads = jax.jit(jax.value_and_grad(lambda x, y: loss_fn(x, y), argnums=(0, 1)))(a, b)
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["global", "global_explicit", "local"])
def test_two_ranks_match_jax_mesh(two_ranks, kind):
    from tricolo_tpu_torch.bench_data import flagship_cfg
    from tricolo_tpu_torch.measure_collectives import global_batch

    params = flagship_cfg().loss.NTXentLoss
    zis, zjs = global_batch(2)
    ref_loss, ref_grads = _jax_value_and_grads(kind, zis, zjs, params.temperature,
                                               params.alpha_weight)
    got = two_ranks[kind]
    np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
    for g, r in zip(got["grads"], ref_grads):
        assert g.shape == r.shape == (256, 512)
        err = float(np.abs(g - r).max())
        assert err <= GRAD_TOL * float(np.abs(r).max()), (kind, err)
    assert got["ms"] > 0


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_gathered_bytes_are_the_jax_formula(world):
    from tricolo_tpu_torch.measure_collectives import gathered_bytes

    per_device, dim = 128, 512
    assert gathered_bytes("global", per_device, world, dim) == \
        2 * 2 * per_device * (world - 1) * dim * 4
    assert gathered_bytes("global_explicit", per_device, world, dim) == \
        2 * 2 * per_device * (world - 1) * dim * 4
    assert gathered_bytes("local", per_device, world, dim) == 0


def test_cli_prints_a_line_a_world_and_loss():
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "tricolo_tpu_torch.measure_collectives",
                           "--worlds", "1", "2", "--repeats", "2"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [(r["world"], r["loss"]) for r in rows] == [
        (n, k) for n in (1, 2) for k in ("global", "global_explicit", "local")]
    assert all(r["ms_per_step"] > 0 and r["backend"] == "gloo" for r in rows)
    assert rows[0]["value"] == pytest.approx(rows[1]["value"], rel=1e-5)  # one rank: same loss
    assert sorted(summary["gap_ms"]) == ["1", "2"] and summary["card"] == "cpu"


def test_nccl_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from tricolo_tpu_torch.measure_collectives import main

    with pytest.raises(RuntimeError, match="GPU"):
        main(["--backend", "nccl"])

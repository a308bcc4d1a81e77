"""``tricolo_tpu_torch.profile_step`` against the JAX package's
``scripts/profile_step.py``.

* The CLI on the CPU at the tiny bench sizes (32³, 2 views of 32², batch
  8, f32): one JSON line with every row, each > 0.
* The encoder rows' backward (``surrogate_backward``), from the JAX
  fixture's weights carried across with ``convert.py``: each encoder's
  parameter gradient equals JAX's ``jax.grad`` of the JAX script's
  surrogate form ``sum(out * cotangent)`` (its l.144-150) within 3e-4 of
  each tensor's max. The JAX script's cotangent is ``stop_gradient(out)``;
  the encoders' outputs are unit vectors, so that gradient is 0 up to
  rounding on both sides (the projection of ``out`` onto its own tangent
  space), and the test holds the two packages to a seeded cotangent
  instead, then checks that both surrogate gradients vanish against it.
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

from test_torch_data import jax_cfg, jax_device_batch, jax_variables, torch_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ROWS = ["full_step", "prepare_device_batch", "forward_loss", "text_fwd", "text_fwd_bwd",
        "image_fwd", "image_fwd_bwd", "voxel_fwd", "voxel_fwd_bwd", "nt_xent_fwd_bwd",
        "adam_update"]
GRAD_TOL = 3e-4
ENCODERS = {"text_features": "text_encoder", "image_features": "image_encoder",
            "voxel_features": "voxel_encoder"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_cli_on_cpu():
    args = ["--device", "cpu", "--iters", "1", "--batch-size", "8", "--voxel-size", "32"]
    for o in ["data.image_size=32", "data.num_views=2", "precision.compute_dtype=float32"]:
        args += ["--override", o]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "tricolo_tpu_torch.profile_step", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert list(out["rows"]) == ROWS
    assert all(v > 0 for v in out["rows"].values()), out["rows"]
    assert out["launches"] == {row: {} for row in ROWS}  # CPU: the plain versions
    assert (out["card"], out["batch_size"], out["iters"]) == ("cpu", 8, 1)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def fixture():
    from tricolo_tpu.data import DataModule

    cfg = jax_cfg()
    model, params, stats = jax_variables(cfg, seed=3)
    dm = DataModule(cfg)
    dm.setup("fit")
    batch = dm.train_loader().peek()
    return cfg, model, params, stats, batch


def _port_grads(params, stats, batch, key, cotangent):
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.profile_step import surrogate_backward

    model = TriCoLoNet.from_config(torch_cfg())
    model.load_state_dict(jax_to_torch(params, stats))
    inputs = prepare_inputs(model, to_device_batch(batch, torch.device("cpu")))
    encoder = getattr(model, ENCODERS[key])
    c = None if cotangent is None else torch.from_numpy(cotangent)
    surrogate_backward(model, encoder, inputs, c)
    state = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if p.grad is not None:
            state[name] = p.grad.detach().clone()
    return _flat(torch_to_jax(state)[0])


def _jax_grads(cfg, model, params, stats, batch, cotangents):
    """JAX's gradient of Σ over the encoders of the JAX script's surrogate
    form ``sum(out * cotangent)`` (l.144-150), one jit for all three: each
    encoder's parameters reach its own output only, so each subtree is
    that encoder's surrogate gradient. ``cotangents`` None: the script's
    own ``stop_gradient(out)``."""
    import jax.numpy as jnp

    dbatch = jax_device_batch(batch, cfg)

    def sloss(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, dbatch, train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        total = 0.0
        for key in ENCODERS:
            z = out[key]
            c = jax.lax.stop_gradient(z) if cotangents is None else jnp.asarray(cotangents[key])
            total = total + jnp.sum(z * c)
        return total

    return _flat(jax.jit(jax.grad(sloss))(jax.tree.map(jnp.asarray, params)))


@pytest.fixture(scope="module")
def jax_grads(fixture):
    cfg, model, params, stats, batch = fixture
    rng = np.random.default_rng(7)
    cotangents = {key: rng.standard_normal((cfg.data.batch_size, cfg.model.out_dim))
                  .astype(np.float32) for key in ENCODERS}
    return (cotangents, _jax_grads(cfg, model, params, stats, batch, cotangents),
            _jax_grads(cfg, model, params, stats, batch, None))


@pytest.mark.parametrize("key", list(ENCODERS))
def test_surrogate_grads_match_jax(fixture, jax_grads, key):
    cfg, model, params, stats, batch = fixture
    cotangents, seeded, own = jax_grads
    prefix = ENCODERS[key] + "/"
    ref = {n: r for n, r in seeded.items() if n.startswith(prefix)}
    got = _port_grads(params, stats, batch, key, cotangents[key])
    assert sorted(got) == sorted(seeded)
    assert ref and all(float(np.abs(r).max()) > 0 for r in ref.values())
    for name, g in got.items():
        if not name.startswith(prefix):
            assert float(np.abs(g).max()) == 0.0, name  # other encoders: no gradient
            continue
        err = float(np.abs(g - ref[name]).max())
        assert err <= GRAD_TOL * float(np.abs(ref[name]).max()), (name, err)
    # The JAX script's own surrogate, sum(out * stop_gradient(out)): 0 up to
    # rounding on both sides, against the seeded cotangent's gradient scale.
    scale = max(float(np.abs(r).max()) for r in ref.values())
    port_own = _port_grads(params, stats, batch, key, None)
    for grads in (own, port_own):
        worst = max(float(np.abs(g).max()) for n, g in grads.items() if n.startswith(prefix))
        assert worst <= 1e-4 * scale, worst

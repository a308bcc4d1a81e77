"""Three train steps of the port against three of the JAX package's
``make_train_step`` on the tiny Tri(I+V) fixture, each step started from
one shared state (the port's params, batch_stats and Adam moments and
count), so every step is a one-step comparison and the moments' carry-over
is held too. Split from ``test_torch_train.py`` (its fixture, helpers and
the reasons for the tolerances) so the two files run on separate workers.

Tolerances: per-pair losses rtol 1e-5; updated parameters within 2·lr (a
gradient that rounding pushes across zero flips Adam's ±lr step) and all
but 0.1% of them within 1e-6 (the updates use each package's own moment
updates from the shared moments); batch statistics atol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import torch_cfg  # noqa: E402
from test_torch_train import PORT, _flat, _port_model, _port_tree, setup  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _adam_trees(model, optimizer):
    """(mu, nu, count) of the port's Adam as JAX-layout numpy trees."""
    from tricolo_tpu_torch.convert import torch_to_jax

    buffers = {k: v for k, v in model.state_dict().items() if "running_" in k}
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        state = dict(buffers)
        for name, p in model.named_parameters():
            entry = optimizer.state.get(p)
            state[name] = entry[key] if entry else torch.zeros_like(p)
        moments.append(torch_to_jax(state)[0])
    steps = [int(e["step"]) for e in optimizer.state.values()] or [0]
    return moments[0], moments[1], steps[0]


def test_three_steps_match_jax_make_train_step(setup):
    import jax.numpy as jnp

    from tricolo_tpu.training.optim import lr_for_epoch, make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import make_optimizer as port_optimizer
    from tricolo_tpu_torch.training import make_train_step as port_train_step

    cfg, model, params, stats, batches = setup
    lr = lr_for_epoch(cfg, 0)
    tx = make_optimizer(cfg)
    jax_step = make_train_step(model, tx, cfg)
    port = _port_model(params, stats)
    pcfg = torch_cfg(PORT)
    optimizer = port_optimizer(pcfg, port)
    step = port_train_step(port, optimizer, pcfg)
    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    for i, batch in enumerate(batches):
        # Both packages start this step from the port's state.
        p_tree, s_tree = _port_tree(port)
        mu, nu, count = _adam_trees(port, optimizer)
        state = TrainState.create({"params": as_jax(p_tree), "batch_stats": as_jax(s_tree)}, tx)
        adam = state.opt_state[-1]._replace(
            count=jnp.asarray(count, jnp.int32), mu=as_jax(mu), nu=as_jax(nu))
        state = state.replace(opt_state=(*state.opt_state[:-1], adam))
        before = _flat(p_tree)

        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        state, ref = jax_step(state, arrays, lr, jax.random.PRNGKey(0))
        got = step(to_device_batch(batch, torch.device("cpu")), lr)
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_allclose(got[name].item(), float(ref[name]), rtol=1e-5,
                                       err_msg=f"step {i} {name}")

        got_params, got_stats = (_flat(t) for t in _port_tree(port))
        ref_params = _flat(state.params)
        diffs = np.concatenate([np.abs(got_params[n] - r).ravel() for n, r in ref_params.items()])
        assert diffs.max() <= 2 * lr * 1.01, f"step {i}: {diffs.max()}"
        assert (diffs > 1e-6).mean() <= 1e-3, f"step {i}: {(diffs > 1e-6).mean()}"
        moved = np.concatenate([(np.abs(r - before[n]) > 0).ravel() for n, r in ref_params.items()])
        assert moved.mean() > 0.99
        for name, ref in _flat(state.batch_stats).items():
            np.testing.assert_allclose(got_stats[name], ref, rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {name}")
        # A wrong moment update would move the updated parameters apart
        # (checked above); the step count must agree.
        assert _adam_trees(port, optimizer)[2] == int(state.opt_state[-1].count) == i + 1

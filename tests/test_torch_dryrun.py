"""``tricolo_tpu_torch.dryrun`` against ``__graft_entry__.dryrun_multichip``.

``dryrun(2)`` on the CPU (two gloo ranks) runs all five modes and passes
every check of the JAX function at its tolerances; at f32 compute its
``dp_replicated`` loss equals the JAX replicated step's from the same
weights (the port's seeded init carried across with ``convert.py``) on the
same batch within rel 1e-5 (the train gate of PERF.md). ``entry`` runs the flagship
forward and returns its output shapes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

F32 = ["precision.compute_dtype=float32"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_two_ranks_pass_every_check_and_match_jax():
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_cfg, _host_batch
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu.training import TrainState, make_optimizer, make_train_step
    from tricolo_tpu_torch.convert import torch_to_jax
    from tricolo_tpu_torch.dryrun import MODES, dryrun, dryrun_cfg
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    torch.manual_seed(0)  # the dry run's own init
    params, stats = torch_to_jax(TriCoLoNet.from_config(dryrun_cfg(2, F32)).state_dict())
    cfg = _flagship_cfg(tiny=True, extra=["data.batch_size=8", *F32])
    model = JaxNet.from_config(cfg)
    tx = make_optimizer(cfg)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    _, losses = make_train_step(model, tx, cfg)(
        TrainState.create(variables, tx), _host_batch(cfg, n_points=256), cfg.optimizer.lr,
        jax.random.PRNGKey(1))

    results = dryrun(2, "cpu", extra=F32)
    assert sorted(results) == sorted(MODES)
    assert all(np.isfinite(loss) and fp > 0 for loss, fp in results.values())
    np.testing.assert_allclose(results["dp_replicated"][0],
                               float(losses["train_loss/total_loss"]), rtol=1e-5)


def test_check_refuses_a_disagreeing_mode():
    from tricolo_tpu_torch.dryrun import check

    good = {"dp_replicated": (5.0, 1000.0), "dp_fsdp": (5.0, 1000.0),
            "dp_explicit_collectives": (5.0, 1000.0), "dp_windowed_compact": (5.05, 1000.5),
            "windowed_compact_1dev": (5.05, 1000.5)}
    check(good)
    with pytest.raises(AssertionError, match="dp_fsdp param fingerprint"):
        check(dict(good, dp_fsdp=(5.0, 1000.2)))
    with pytest.raises(AssertionError, match="dp_windowed_compact loss"):
        check(dict(good, dp_windowed_compact=(5.2, 1000.5), windowed_compact_1dev=(5.2, 1000.5)))


def test_entry_runs_the_flagship_forward():
    from tricolo_tpu_torch.dryrun import entry

    assert entry("cpu") == {"text_features": (8, 512), "image_features": (8, 512),
                            "voxel_features": (8, 512)}

"""FSDP in the port against the JAX package's FSDP step: one train step
of the port on two gloo ranks under ``parallel.param_sharding=fsdp``
against ``shard_state(TrainState.create(...), Mesh(jax.devices()[:2],
("data",)), "fsdp", min_size=2**10)`` and ``make_train_step``, from the
tiny Tri(I+V) fixture's JAX weights (``test_torch_train.py``), at global
batch 4 (2 a rank), f32.

The JAX step runs in a subprocess of its own (``python
tests/test_torch_fsdp_jax.py jax <dir>``): ``tests/test_parallel.py``
records that this program (an FSDP-resharded train step on the CPU's
virtual devices) can abort a process that ran interpret-mode Pallas first.
It returns its weights before the step, its losses, its updated
parameters and batch statistics, and Adam's moments. JAX's step does not
return its gradients: they are read from its first moment,
g = μ/(1 − b1) − wd·p (optax's ``add_decayed_weights`` then
``scale_by_adam`` from zero moments), in float64.

Tolerances, those of ``test_torch_parallel_train.py``, stated before the
first run: per-pair losses rtol 1e-5; gradients and Adam's first moment
within 3e-4 of each tensor's max, the second moment within 6e-4; running
statistics atol 1e-5; updated parameters within 2·lr and all but 0.1% of
them within 1e-6; the two ranks bit-equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp import first_batch, fsdp_cfg, sharded_step  # noqa: E402
from test_torch_parallel import REPO, deviations, digest, init_rank, spawn_ranks  # noqa: E402

if __name__ != "__main__" or sys.argv[1:2] == ["jax"]:
    jax = pytest.importorskip("jax")

MIN_SIZE = 2**10
RANKS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_main(workdir: Path) -> None:
    """The JAX package's FSDP step over two CPU devices (module
    docstring): ``init.pkl`` (the weights) and ``ref.pkl`` (the step)."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from test_torch_data import jax_cfg, jax_variables
    from tricolo_tpu.data import DataModule
    from tricolo_tpu.models.tricolo_net import TriCoLoNet
    from tricolo_tpu.parallel import shard_batch
    from tricolo_tpu.parallel.sharding_rules import shard_state
    from tricolo_tpu.training.optim import lr_for_epoch, make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu.utils.compcache import compilation_cache_dir

    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    _, params, stats = jax_variables(jax_cfg(), seed=2)  # test_torch_train's fixture
    with open(workdir / "init.pkl", "wb") as f:
        pickle.dump((params, stats), f)
    cfg = jax_cfg(["data.batch_size=4"])
    dm = DataModule(cfg)
    dm.setup("fit")
    batch = next(iter(dm.train_loader()))
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    tx = make_optimizer(cfg)
    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    state = shard_state(TrainState.create({"params": as_jax(params),
                                           "batch_stats": as_jax(stats)}, tx),
                        mesh, "fsdp", min_size=MIN_SIZE)
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    state, losses = make_train_step(TriCoLoNet.from_config(cfg), tx, cfg)(
        state, shard_batch(arrays, mesh), lr_for_epoch(cfg, 0), jax.random.PRNGKey(0))
    adam = state.opt_state[-1]
    as_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    with open(workdir / "ref.pkl", "wb") as f:
        pickle.dump({"losses": {k: float(v) for k, v in losses.items()},
                     "model_ids": batch["model_id"], "params": as_np(state.params),
                     "batch_stats": as_np(state.batch_stats), "mu": as_np(adam.mu),
                     "nu": as_np(adam.nu)}, f)


def _jax_snapshot(ref: dict, init: dict, cfg) -> dict:
    """The JAX step as a ``test_torch_parallel.snapshot`` in the port's
    names and layouts; the gradients from the first moment (module
    docstring)."""
    from tricolo_tpu_torch.convert import jax_to_torch

    params = jax_to_torch(ref["params"], ref["batch_stats"])
    mu = jax_to_torch(ref["mu"], ref["batch_stats"])
    nu = jax_to_torch(ref["nu"], ref["batch_stats"])
    b1, wd = 0.9, cfg.optimizer.weight_decay or 0.0
    names = [n for n in init if n in mu and "running_" not in n and "num_batches" not in n]
    return {"losses": ref["losses"],
            "grads": {n: (mu[n].double() / (1 - b1) - wd * init[n].double()).float()
                      for n in names},
            "buffers": {n: v for n, v in params.items() if n not in names},
            "moments": {n: {"exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in names},
            "params": {n: params[n] for n in names}}


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    world = init_rank(rank, port)
    cfg = fsdp_cfg(["parallel.param_sharding=fsdp"])
    batch = first_batch(cfg)
    mine, _, _ = sharded_step(cfg, batch, torch.load(workdir / "state.pt"), world, "fsdp",
                              MIN_SIZE)
    out = {"digest": digest(mine), "model_ids": batch["model_id"]}
    if rank == 0:
        with open(workdir / "ref.pkl", "rb") as f:
            ref = pickle.load(f)
        jax_step = _jax_snapshot(ref, torch.load(workdir / "state.pt"), cfg)
        out.update(deviations=deviations(mine, jax_step), jax_model_ids=ref["model_ids"],
                   names=(sorted(mine["grads"]), sorted(jax_step["grads"])))
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tricolo_tpu_torch.convert import jax_to_torch

    workdir = tmp_path_factory.mktemp("fsdp_jax")
    result = subprocess.run([sys.executable, __file__, "jax", str(workdir)], cwd=REPO,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]
    with open(workdir / "init.pkl", "rb") as f:
        torch.save(jax_to_torch(*pickle.load(f)), workdir / "state.pt")
    (workdir / "init.pkl").unlink()
    try:
        return spawn_ranks(__file__, workdir)
    finally:
        for name in ("ref.pkl", "state.pt"):
            (workdir / name).unlink()


def test_fsdp_step_matches_the_jax_fsdp_step(ranks):
    from test_torch_parallel_train import assert_ranks_equal, assert_step_close

    mine = ranks[0]
    assert ranks[0]["model_ids"] + ranks[1]["model_ids"] == mine["jax_model_ids"]
    assert mine["names"][0] == mine["names"][1]
    assert_ranks_equal(ranks[0]["digest"], ranks[1]["digest"])
    assert_step_close(mine["deviations"], fsdp_cfg().optimizer.lr)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1] == "jax":
        _jax_main(Path(sys.argv[2]))
    else:
        _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

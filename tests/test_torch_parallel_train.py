"""Data parallel in the port, the train step: one step on two gloo ranks
on the CPU against one process at the same global batch
(``test_torch_parallel.spawn_ranks``; the fit: ``test_torch_parallel_fit.py``).

* One train step at global batch 4 (2 a rank) on the tiny Tri(I+V) fixture
  of ``test_torch_train.py`` (the JAX package's weights, whose
  single-process port step that file holds against JAX ``make_train_step``)
  under the three loss forms (the pjit form; ``explicit_collectives``;
  ``global_negatives=false``, whose single-process twin averages the two
  halves' losses), and one Tri(CLIP-I+V) step at dropout 0.1 (the masks
  drawn for the global batch, each rank keeping its rows): the losses,
  every gradient, the BN running statistics, Adam's moments and the updated
  parameters, and the ranks bit-equal to each other.

Tolerances, f32, stated before the first run. The step: per-pair losses
rtol 1e-5, BN running statistics atol 1e-5, gradients and Adam's first
moment within ``GRAD_TOL`` = 3e-4 of each tensor's max, the second moment
within 2·``GRAD_TOL`` (the fixture's ResNet layer 4 normalises over B·V = 8
samples a channel, which amplifies f32 rounding about a thousandfold:
``test_torch_train.py``), updated parameters within 2·lr (a gradient that
rounding pushes across zero flips Adam's ±lr step) and all but 0.1% of them
within 1e-6.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    REPO,
    deviations,
    digest,
    init_rank,
    one_step,
    spawn_ranks,
    torch_cfg,
)

if __name__ != "__main__":  # a spawned rank needs torch alone
    jax = pytest.importorskip("jax")
    from test_torch_train import GRAD_TOL, setup  # noqa: E402,F401

PORT = ["loss.NTXentLoss.use_pallas=true"]
STEP = ["data.batch_size=4"]
CLIP = ["model.text_encoder=CLIPTextEncoder", "model.image_encoder=CLIPImageEncoder",
        "model.modules.CLIPTextEncoder.dropout=0.1",
        "model.modules.CLIPImageEncoder.dropout=0.1"]
# name → (overrides, weights): the fixture's JAX weights or the port's seeded init.
STEP_CASES = {"tri": ([], "tri"), "tri_explicit": (["parallel.explicit_collectives=true"], "tri"),
              "tri_local": (["parallel.global_negatives=false"], "tri"), "clip": (CLIP, "clip")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _step_cfg(name, multiprocess=False):
    extra, weights = STEP_CASES[name]
    base = CLIP if weights == "clip" else []
    return torch_cfg([*PORT, *STEP, *base, *extra,
                      *(["parallel.multiprocess=true"] if multiprocess else [])])


def _first_batch(cfg):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(cfg)
    dm.setup("fit")
    return dm.train_loader().peek()


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    world = init_rank(rank, port)
    out: dict = {}
    states = torch.load(workdir / "states.pt")
    for name, (_, weights) in STEP_CASES.items():
        cfg = _step_cfg(name, multiprocess=True)
        snap = one_step(cfg, _first_batch(cfg), states[weights], world=world)
        out[f"step/{name}"] = snap if rank == 0 else digest(snap)
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):  # noqa: F811 (the shared fixture)
    """(rank 0's results, rank 1's)."""
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    workdir = tmp_path_factory.mktemp("train")
    _, _, params, stats, _ = setup
    clip_cfg = _step_cfg("clip")
    torch.manual_seed(clip_cfg.train_seed)
    clip_state = TriCoLoNet.from_config(clip_cfg).state_dict()
    torch.save({"tri": jax_to_torch(params, stats), "clip": clip_state},
               workdir / "states.pt")
    return spawn_ranks(__file__, workdir)


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_rank_step_equals_one_process(ranks, setup, monkeypatch, name):  # noqa: F811
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.losses import make_loss_fn
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import steps

    cfg = _step_cfg(name)
    if STEP_CASES[name][1] == "clip":
        torch.manual_seed(cfg.train_seed)
        state = TriCoLoNet.from_config(cfg).state_dict()
    else:
        state = jax_to_torch(*setup[2:4])
    if name == "tri_local":  # the local form's definition: each half's loss, averaged
        loss = make_loss_fn(cfg)
        monkeypatch.setattr(steps, "make_loss_fn", lambda *args, **kwargs: lambda a, b: (
            loss(a[:2], b[:2]) + loss(a[2:], b[2:])) / 2)
    ref = one_step(cfg, _first_batch(cfg), state)

    mine, theirs = ranks[0][f"step/{name}"], ranks[1][f"step/{name}"]
    assert_ranks_equal(digest(mine), theirs)
    assert_step_close(deviations(mine, ref), cfg.optimizer.lr)


def assert_ranks_equal(a: dict, b: dict) -> None:
    """Two ranks' ``digest``s of one step: every tensor bit-equal."""
    assert a == b, sorted(n for n in a if a[n] != b.get(n))


def assert_step_close(dev: dict, lr: float, where: str = "") -> None:
    """A rank's ``deviations`` from one process's step, from the same
    state, within the module docstring's tolerances."""
    for key, (got, want) in dev["losses"].items():
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=where + key)
    for kind, tol in (("grads", GRAD_TOL), ("exp_avg", GRAD_TOL), ("exp_avg_sq", 2 * GRAD_TOL)):
        assert all(d <= tol for d in dev[kind].values()), \
            (where + kind, {n: d for n, d in dev[kind].items() if d > tol})
    assert all(d <= 1e-5 for d in dev["buffers"].values()), (where, dev["buffers"])
    assert dev["params_max"] <= 2 * lr, (where, dev["params_max"])
    assert dev["params_over_1e6"] <= 1e-3, (where, dev["params_over_1e6"])

if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

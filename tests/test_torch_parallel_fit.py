"""Data parallel in the port, the fit: a 2-epoch ``Trainer.fit`` under
``parallel.multiprocess=true`` on two gloo ranks on the CPU (6 steps of a
global batch of 4), Tri(I+V) and Bi(V), against one process
(``test_torch_parallel.spawn_ranks``): the stripes' union is the
single-process batch stream, rank 1 writes no file, and every step of the
2-rank fit equals the single-process step from the same state.

Each step is checked where it starts. Before each of its steps, rank 0
keeps the fit's state (parameters, buffers, Adam's state); after the step
it runs the single-process step from that state on the single-process
fit's batch of that step, twice (``one_step``):

* with the port's own single-process BatchNorm, the non-parallel step:
  the step's losses rtol 1e-5 and running statistics atol 1e-5, and every
  logged loss rtol 1e-5;
* with every BatchNorm's sums through a one-rank process group, the ranks'
  BN algorithm in one process: everything at the one-step bounds of
  ``test_torch_parallel_train.py`` (``assert_step_close``: losses rtol
  1e-5, gradients and Adam's first moment within 3e-4 of each tensor's
  max, the second within 6e-4, running statistics atol 1e-5, the updated
  parameters within 2·lr and all but 0.1% of them within 1e-6), the last
  step's updated parameters being the fit's final ones.

The gradients are held against the ranks' algorithm because the two BN
forms, both right, round differently, and on this fixture (ResNet layer 4
at 1×1 over B·V = 8 images) that rounding can move a step's gradients far
more than the data parallelism does: at one state of a single-process fit
the global-batch form in one process moved layer 1.1's weight gradient by
1.5e-2 of its max against the port's own BN, while the one-step test holds
the 2-rank step to the non-parallel one within 3e-4 at its state.
``test_torch_parallel.py`` holds the BN forms to each other at 1e-5 on a
well-conditioned batch. The ranks are bit-equal at every step (``digest``).
A fit compared with a free-running single-process fit would drift apart
by that rounding, amplified, and could only be held to bounds loose enough
to pass a wrong fit.
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    RANKS,
    REPO,
    deviations,
    digest,
    init_rank,
    one_step,
    snapshot,
    spawn_ranks,
    torch_cfg,
)

if __name__ != "__main__":  # a spawned rank needs torch alone
    jax = pytest.importorskip("jax")
    from test_torch_parallel_train import assert_ranks_equal, assert_step_close  # noqa: E402

PORT = ["loss.NTXentLoss.use_pallas=true"]
FIT = [*PORT, "data.batch_size=4", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=2",
       "trainer.log_every_n_steps=1", "checkpoint_monitor.save_top_k=1",
       "logger.backend=jsonl", "experiment_name=fit"]
FIT_CASES = {"tri": [], "bi_v": ["model.image_encoder=null"]}
FIT_STEPS = 6  # 15 captions, global batch 4, drop_last: 3 steps an epoch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _batches(cfg, epochs=2) -> list:
    """The train loader's host batches of each epoch."""
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(cfg)
    dm.setup("fit")
    loader = dm.train_loader()
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def _stream(cfg) -> list:
    return [[batch["model_id"] for batch in epoch] for epoch in _batches(cfg)]


def _checked_fit(cfg, single_cfg, solo, rank: int):
    """The 2-rank fit; rank 0 holds each step against the single-process
    steps from the state it started at (module docstring): (each step's
    ``digest`` and, on rank 0, its ``deviations`` from the ranks'
    algorithm and from the non-parallel step; the steps taken; the best
    checkpoint's path)."""
    import copy

    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    batches = [b for epoch in _batches(single_cfg) for b in epoch] if rank == 0 else None
    trainer = Trainer(cfg, device="cpu")
    inner, steps = trainer.train_step, []

    def step(batch, lr, generator):
        k = len(steps)
        before = ({n: v.clone() for n, v in trainer.model.state_dict().items()},
                  copy.deepcopy(trainer.optimizer.state_dict()))
        losses = inner(batch, lr, generator)
        mine = snapshot(trainer.model, trainer.optimizer, losses)
        row = {"digest": digest(mine)}
        if rank == 0:
            row["same_bn"] = deviations(mine, one_step(single_cfg, batches[k], *before,
                                                       bn_group=solo, lr=lr, step=k))
            row["non_parallel"] = deviations(mine, one_step(single_cfg, batches[k], *before,
                                                            lr=lr, step=k))
        steps.append(row)
        return losses

    trainer.train_step = step
    manager = trainer.fit(DataModule(cfg))
    return steps, trainer.step, manager.best_path


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    init_rank(rank, port)
    solo = torch.distributed.new_group([0])  # every rank joins the group's creation
    out: dict = {}
    for name, extra in FIT_CASES.items():
        cfg = torch_cfg([*FIT, *extra, "parallel.multiprocess=true",
                         f"project_root_path={workdir / f'{name}{rank}'}"])
        out[f"fit/{name}/stream"] = _stream(cfg)
        out[f"fit/{name}"] = _checked_fit(cfg, torch_cfg([*FIT, *extra]), solo, rank)
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank 0's results, rank 1's, the work directory)."""
    workdir = tmp_path_factory.mktemp("fit")
    return (*spawn_ranks(__file__, workdir), workdir)


# -------------------------------------------------------------- the fit


def _training_dir(root: Path) -> Path:
    return root / "output" / "Synthetic" / "fit" / "training"


def test_stripes_union_is_the_single_process_stream(ranks):
    single = _stream(torch_cfg(FIT))
    for epoch, batches in enumerate(single):
        assert len(batches) == FIT_STEPS // 2
        for i, batch in enumerate(batches):
            stripes = [ranks[r]["fit/tri/stream"][epoch][i] for r in range(RANKS)]
            assert all(len(s) == 2 for s in stripes)
            assert stripes[0] + stripes[1] == batch


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_rank_one_writes_no_artifact(ranks, name):
    workdir = ranks[2]
    assert [p for p in (workdir / f"{name}1").rglob("*") if p.is_file()] == []
    training = _training_dir(workdir / f"{name}0")
    assert (training / "metrics.jsonl").is_file() and (training / "epoch=1.ckpt").is_file()
    assert ranks[0][f"fit/{name}"][2] == str(training / "epoch=1.ckpt")
    assert ranks[1][f"fit/{name}"][2] is None


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_two_rank_fit_equals_one_process(ranks, name):
    lr = torch_cfg(FIT).optimizer.lr
    (steps0, count0, _), (steps1, count1, _) = ranks[0][f"fit/{name}"], ranks[1][f"fit/{name}"]
    assert count0 == count1 == len(steps0) == len(steps1) == FIT_STEPS
    for k, (mine, theirs) in enumerate(zip(steps0, steps1)):
        where = f"step {k}: "
        assert_ranks_equal(mine["digest"], theirs["digest"])
        assert_step_close(mine["same_bn"], lr, where=where)
        single = mine["non_parallel"]
        for key, (got, want) in single["losses"].items():
            assert got == pytest.approx(want, rel=1e-5), where + key
        assert all(d <= 1e-5 for d in single["buffers"].values()), (where, single["buffers"])

    rows = [json.loads(line) for line in
            (_training_dir(ranks[2] / f"{name}0") / "metrics.jsonl").read_text().splitlines()]
    logged = [r["train_loss/total_loss"] for r in rows if "train_loss/total_loss" in r]
    assert len(logged) == FIT_STEPS
    for k, got in enumerate(logged):
        want = steps0[k]["non_parallel"]["losses"]["train_loss/total_loss"][1]
        assert got == pytest.approx(want, rel=1e-5), k


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

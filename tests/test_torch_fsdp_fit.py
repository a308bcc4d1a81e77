"""FSDP in the port, the fit: ``Trainer.fit`` under
``parallel.multiprocess=true`` on two gloo ranks on the CPU, one epoch of
the tiny Tri(I+V) fixture (3 steps of a global batch of 4), under
``parallel.param_sharding=fsdp`` and under ``replicated``, from the same
seed (``test_torch_parallel.spawn_ranks``). The trainer shards at
``min_size`` 2**10 here, so that the fixture's leaves shard.

* The FSDP fit's checkpoint is the replicated fit's, key for key, dtype
  for dtype and bit for bit (weights, BN statistics, Adam's moments and
  step): ``Trainer.state`` gathers the shards whole.
* Resuming from the FSDP checkpoint for a second epoch under FSDP and
  under replicated writes the same checkpoint bit for bit (``load_state``
  keeps each rank's shard of the file's full tensors).
* ``Trainer.test`` on the FSDP checkpoint under FSDP equals it under
  replicated: the same metrics, exactly.

Every comparison is exact, for the reason ``test_torch_fsdp.py`` gives:
at two ranks a sharded step is bit-equal to the replicated one. Rank 0
digests each checkpoint and deletes it (a Tri(I+V) checkpoint with Adam's
moments is ~140 MB).
"""

import functools
import hashlib
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp import bits  # noqa: E402
from test_torch_parallel import REPO, init_rank, spawn_ranks, torch_cfg  # noqa: E402

if __name__ != "__main__":  # a spawned rank needs torch alone
    pytest.importorskip("jax")

MIN_SIZE = 2**10
FIT = ["loss.NTXentLoss.use_pallas=true", "data.batch_size=4", "trainer.max_epochs=1",
       "trainer.check_val_every_n_epoch=1", "checkpoint_monitor.save_top_k=1",
       "logger.backend=jsonl", "experiment_name=fit", "parallel.multiprocess=true"]
MODES = ("replicated", "fsdp")


def _fit_cfg(mode: str, root: Path, extra=()):
    return torch_cfg([*FIT, f"parallel.param_sharding={mode}", f"project_root_path={root}",
                      f"inference.output_dir={root / 'inference'}", *extra])


def _file_digest(path) -> dict:
    """A checkpoint's every tensor by (dtype, shape, SHA-256 of its bytes),
    beside its step and epoch; the file is deleted."""
    payload = torch.load(path, weights_only=False)
    os.unlink(path)
    out = {"step": payload["step"], "epoch": payload["epoch"]}

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            data = bits(node.detach()).contiguous().numpy().tobytes()
            out[prefix] = (node.dtype, tuple(node.shape), hashlib.sha256(data).hexdigest())
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, f"{prefix}/{key}")

    walk(payload["model"], "model")
    walk(payload["optimizer"]["state"], "optimizer")
    return out


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.parallel import shard_model
    from tricolo_tpu_torch.training import Trainer, trainer

    init_rank(rank, port)
    os.chdir(workdir)  # Trainer.test writes nearest.jsonl in the CWD
    trainer.shard_model = functools.partial(shard_model, min_size=MIN_SIZE)
    out: dict = {}

    def fit(name, mode, extra=(), resume=None):
        cfg = _fit_cfg(mode, workdir / f"{name}{rank}", extra)
        fitted = Trainer(cfg, device="cpu")
        best = fitted.fit(DataModule(cfg), resume_ckpt=resume).best_path
        out[f"steps/{name}"] = fitted.step
        return best

    for mode in MODES:
        fit(mode, mode)
    torch.distributed.barrier()
    ckpt = workdir / "fsdp0" / "output" / "Synthetic" / "fit" / "training" / "epoch=0.ckpt"
    for mode in MODES:
        fit(f"resumed_{mode}", mode, ["trainer.max_epochs=2"], resume=str(ckpt))
    for mode in MODES:
        cfg = _fit_cfg(mode, workdir / f"test_{mode}{rank}")
        metrics = Trainer(cfg, device="cpu").test(DataModule(cfg), str(ckpt))
        out[f"test/{mode}"] = metrics.summary("")
    torch.distributed.barrier()
    if rank == 0:
        for name in (*MODES, "resumed_replicated", "resumed_fsdp"):
            training = workdir / f"{name}0" / "output" / "Synthetic" / "fit" / "training"
            out[f"ckpt/{name}"] = {path.name: _file_digest(path)
                                   for path in sorted(training.glob("*.ckpt"))}
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, tmp_path_factory.mktemp("fsdp_fit"))


def test_fsdp_fit_writes_the_replicated_checkpoint(ranks):
    results = ranks[0]
    assert all(ranks[r][f"steps/{m}"] == 3 for r in range(2) for m in MODES)
    replicated, fsdp = results["ckpt/replicated"], results["ckpt/fsdp"]
    assert list(fsdp) == ["epoch=0.ckpt"]
    assert fsdp == replicated
    params = [k for k in fsdp["epoch=0.ckpt"] if k.startswith("model/")]
    assert len(params) > 100 and fsdp["epoch=0.ckpt"]["step"] == 3


def test_fsdp_checkpoint_resumes_under_either_mode(ranks):
    results = ranks[0]
    assert all(ranks[r][f"steps/resumed_{m}"] == 6 for r in range(2) for m in MODES)
    fsdp, replicated = results["ckpt/resumed_fsdp"], results["ckpt/resumed_replicated"]
    assert list(fsdp) == ["epoch=1.ckpt"]
    assert fsdp == replicated
    assert fsdp["epoch=1.ckpt"]["step"] == 6


def test_fsdp_checkpoint_tests_as_replicated(ranks):
    for rank in range(2):
        assert ranks[rank]["test/fsdp"] == ranks[rank]["test/replicated"]
    assert ranks[0]["test/fsdp"] == ranks[1]["test/fsdp"]


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

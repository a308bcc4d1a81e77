"""The port's checkpoint lifecycle against the JAX package's.

* Retention: both ``CheckpointManager``\\ s fed the same score sequences
  keep the same files and write the same ``checkpoints.json`` entries
  (``save_top_k`` 3 / 1 / 0 / −1, ``save_last``, ``mode`` max and min);
  a missing monitor raises KeyError in both; the async writer leaves the
  directory the synchronous path leaves, and a failed write raises again.
* ``latest_checkpoint`` skips a name that is not ``epoch=<int>.ckpt``.
* Resume is lossless: 2 epochs straight equal 1 epoch + resume for 1 more
  — weights, BN statistics, Adam state and step exactly, f32 on the CPU
  (the twin of the JAX ``test_interrupted_plus_resume_equals_straight_run``).
* ``checkpoint_monitor.every_n_epochs`` gates saving apart from the
  validation cadence (the twin of ``test_every_n_epochs_decoupled_from_val_cadence``).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import TINY  # noqa: E402

# Bi(V) at the tiny widths: 15 train captions, B=5 → 3 steps an epoch.
BI_V = [o for o in TINY if o != "model.image_encoder=MVCNNEncoder"] + [
    "data.batch_size=5", "trainer.profiler=none", "logger.backend=jsonl",
    "loss.NTXentLoss.use_pallas=true"]

SEQUENCES = [
    # (save_top_k, mode, save_last, [(epoch, score), ...])
    (3, "max", False, [(0, 1.0), (1, 3.0), (2, 2.0), (3, 0.5), (4, 5.0), (5, 2.5)]),
    (1, "max", True, [(0, 5.0), (1, 1.0), (2, 7.0)]),
    (2, "min", True, [(1, 0.9), (3, 0.4), (5, 0.6), (7, 0.1), (9, 0.5)]),
    (0, "max", True, [(0, 9.0), (1, 1.0)]),
    (0, "max", False, [(0, 1.0)]),
    (-1, "max", False, [(0, 1.0), (1, 5.0), (2, 3.0)]),
    (-1, "min", True, [(0, 2.0), (2, 1.0), (4, 3.0)]),
]


def _jax_state():
    from tricolo_tpu.training.state import TrainState

    return TrainState(step=np.asarray(3, np.int32), params={"w": np.arange(4, dtype=np.float32)},
                      batch_stats={}, opt_state={})


def _port_state():
    return {"model": {"w": torch.arange(4, dtype=torch.float32)},
            "optimizer": {"state": {0: {"step": torch.tensor(3.0),
                                        "exp_avg": torch.ones(4)}}, "param_groups": []},
            "step": 3}


def _entries(directory):
    with open(os.path.join(directory, "checkpoints.json")) as f:
        index = json.load(f)
    return index["monitor"], [(os.path.basename(e["path"]), e["score"], e["epoch"])
                              for e in index["entries"]]


def _ckpts(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".ckpt"))


def _run(manager, state, sequence):
    saved = [manager.save(state, epoch, {"m": score, "other": 0.0}) for epoch, score in sequence]
    manager.wait()
    return [os.path.basename(p) if p else None for p in saved]


@pytest.mark.parametrize("case", SEQUENCES, ids=lambda c: f"top{c[0]}-{c[1]}-last{int(c[2])}")
def test_retention_equals_jax(case, tmp_path):
    from tricolo_tpu.training.checkpoint import CheckpointManager as JaxManager
    from tricolo_tpu_torch.training.checkpoint import CheckpointManager

    top_k, mode, save_last, sequence = case
    kw = dict(monitor="m", mode=mode, save_top_k=top_k, save_last=save_last)
    ref = JaxManager(str(tmp_path / "jax"), **kw)
    ours = CheckpointManager(str(tmp_path / "port"), **kw)
    os.makedirs(tmp_path / "jax"), os.makedirs(tmp_path / "port")
    assert _run(ours, _port_state(), sequence) == _run(ref, _jax_state(), sequence)
    assert _ckpts(tmp_path / "port") == _ckpts(tmp_path / "jax")
    if top_k != 0:
        assert _entries(tmp_path / "port") == _entries(tmp_path / "jax")
        assert os.path.basename(ours.best_path) == os.path.basename(ref.best_path)
    else:
        assert ours.best_path is ref.best_path is None


def test_missing_monitor_raises_keyerror(tmp_path):
    from tricolo_tpu.training.checkpoint import CheckpointManager as JaxManager
    from tricolo_tpu_torch.training.checkpoint import CheckpointManager

    for manager, state in ((JaxManager(str(tmp_path / "jax"), monitor="val_eval/RR@5"),
                            _jax_state()),
                           (CheckpointManager(str(tmp_path / "port"), monitor="val_eval/RR@5"),
                            _port_state())):
        with pytest.raises(KeyError, match="val_eval/RR@5"):
            manager.save(state, 0, {"val_eval/RR@1": 1.0})


def test_async_directory_equals_sync(tmp_path):
    from tricolo_tpu_torch.training.checkpoint import (
        AsyncCheckpointWriter,
        CheckpointManager,
        load_checkpoint,
    )

    top_k, mode, save_last, sequence = SEQUENCES[2]
    kw = dict(monitor="m", mode=mode, save_top_k=top_k, save_last=save_last)
    os.makedirs(tmp_path / "sync"), os.makedirs(tmp_path / "async")
    state = _port_state()
    sync = _run(CheckpointManager(str(tmp_path / "sync"), **kw), state, sequence)
    writer = AsyncCheckpointWriter()
    try:
        manager = CheckpointManager(str(tmp_path / "async"), writer=writer, **kw)
        saved = []
        for epoch, score in sequence:
            saved.append(manager.save(state, epoch, {"m": score}))
            state["model"]["w"].add_(1.0)  # the next steps update the live tensors
        manager.wait()
    finally:
        writer.close()
    assert [os.path.basename(p) if p else None for p in saved] == sync
    assert _ckpts(tmp_path / "async") == _ckpts(tmp_path / "sync")
    assert _entries(tmp_path / "async")[1] == _entries(tmp_path / "sync")[1]
    # Each file holds the state as it was when save() returned.
    for name in _ckpts(tmp_path / "async"):
        payload = load_checkpoint(str(tmp_path / "async" / name))
        epoch = payload["epoch"]
        position = [e for e, _ in sequence].index(epoch)
        np.testing.assert_array_equal(payload["model"]["w"].numpy(),
                                      np.arange(4, dtype=np.float32) + position)


def test_failed_async_write_raises_again(tmp_path):
    from tricolo_tpu_torch.training.checkpoint import AsyncCheckpointWriter, CheckpointManager

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    writer = AsyncCheckpointWriter()
    try:
        manager = CheckpointManager(str(blocker / "ckpts"), monitor="m", writer=writer)
        manager.save(_port_state(), 0, {"m": 1.0})
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            manager.wait()
        writer.submit(lambda: 1 / 0)
        writer._queue.join()  # the worker has run it
        with pytest.raises(RuntimeError) as err:
            writer.submit(lambda: None)  # raised again on the next submit
        assert isinstance(err.value.__cause__, ZeroDivisionError)
    finally:
        writer.close()


def test_latest_checkpoint_skips_bogus_name(tmp_path):
    from tricolo_tpu.training.checkpoint import latest_checkpoint as jax_latest
    from tricolo_tpu_torch.training.checkpoint import latest_checkpoint

    assert latest_checkpoint(str(tmp_path)) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("epoch=0.ckpt", "epoch=2.ckpt", "epoch=10.ckpt", "epoch=bogus.ckpt",
                 "epoch=99.ckpt.tmp", "last.ckpt"):
        (tmp_path / name).write_text("x")
    assert latest_checkpoint(str(tmp_path)) == jax_latest(str(tmp_path))
    assert latest_checkpoint(str(tmp_path)).endswith("epoch=10.ckpt")


def _fit(tmp_path, name, epochs, resume=None, extra=()):
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    cfg = load_config([*BI_V, f"trainer.max_epochs={epochs}", "trainer.check_val_every_n_epoch=2",
                       "trainer.log_every_n_steps=1", "checkpoint_monitor.save_top_k=-1",
                       "checkpoint_monitor.every_n_epochs=1", f"project_root_path={tmp_path}",
                       f"experiment_name={name}", *extra])
    trainer = Trainer(cfg, device="cpu")
    manager = trainer.fit(DataModule(cfg), resume_ckpt=resume)
    return trainer, manager


def test_interrupted_plus_resume_equals_straight_run(tmp_path):
    straight, _ = _fit(tmp_path, "straight", 2)
    _, first = _fit(tmp_path, "resumed", 1)
    ckpt = first.best_path
    assert ckpt.endswith("epoch=0.ckpt")
    resumed, _ = _fit(tmp_path, "resumed", 2, resume=ckpt)

    assert straight.step == resumed.step == 6
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    opt_a, opt_b = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert opt_a["state"].keys() == opt_b["state"].keys()
    for index, entry in opt_a["state"].items():
        for key, value in entry.items():
            assert torch.equal(value, opt_b["state"][index][key]), (index, key)
    assert int(opt_a["state"][0]["step"]) == 6


def test_every_n_epochs_decoupled_from_val_cadence(tmp_path):
    _, manager = _fit(tmp_path, "cadence", 4, extra=["trainer.check_val_every_n_epoch=1",
                                                     "checkpoint_monitor.every_n_epochs=4"])
    # Validation ran at epochs 0-3; only epoch 3 meets (epoch + 1) % 4 == 0.
    assert _ckpts(manager.dirpath) == ["epoch=3.ckpt"]


def test_auto_resume_cli_continues_the_run(tmp_path, capsys):
    from tricolo_tpu_torch import train
    from tricolo_tpu_torch.training.checkpoint import load_checkpoint

    args = [*BI_V, "trainer.check_val_every_n_epoch=1", "checkpoint_monitor.save_last=true",
            "experiment_name=auto", f"project_root_path={tmp_path}", "+device=cpu"]
    train.main([*args, "trainer.max_epochs=1", "+auto_resume=true"])
    assert "resuming from" not in capsys.readouterr().out  # nothing to resume yet
    path = train.main([*args, "trainer.max_epochs=2", "+auto_resume=true"])
    out = capsys.readouterr().out
    assert "auto_resume: resuming from " in out and out.count("epoch 1: RR@1=") == 1
    assert "epoch 0:" not in out
    last = load_checkpoint(os.path.join(os.path.dirname(path), "last.ckpt"))
    assert last["epoch"] == 1 and last["step"] == 6
    assert int(last["optimizer"]["state"][0]["step"]) == 6
    with pytest.raises(AssertionError, match="Checkpoint path does not exists"):
        train.main([*args, "ckpt_name=missing.ckpt"])

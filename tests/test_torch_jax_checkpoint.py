"""The JAX package's msgpack checkpoints in the port, read without flax.

* The pure-Python reader (``training/jax_checkpoint.py``) returns what
  ``flax.serialization.msgpack_restore`` returns, leaf for leaf in type,
  dtype, shape and bytes: npscalars, empty ``EmptyState`` dicts, strings,
  None, ints of every width, floats, complex, lists, bytes, chunked arrays,
  and real train-state checkpoints of both optimizer layouts. A bfloat16
  leaf decodes to a uint16 array of its bits, bit-exact, which
  ``convert.jax_to_torch`` views as ``torch.bfloat16``.
* A JAX checkpoint serves in the port: its index equals the JAX eval
  forward's within 1e-4 (f32 on the CPU; convolution sums run in another
  order), a legacy 3-channel block-0 voxel kernel included.
* One port train step from a JAX checkpoint (after one JAX step, so the
  Adam moments are live) matches one JAX step from the same state, for
  the per-leaf optax layout and the flat ``optimizer.flat_update`` one;
  the restored weights, statistics, moments and count are exact first.
  Tolerances of ``test_torch_train_steps.py``: losses rtol 1e-5, updated
  parameters within 2·lr with all but 0.1% within 1e-6, statistics 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import TINY, jax_device_batch, jax_variables  # noqa: E402
from test_torch_train import _flat  # noqa: E402

BI_V = [o for o in TINY if o != "model.image_encoder=MVCNNEncoder"]
PORT = [*BI_V, "loss.NTXentLoss.use_pallas=true"]


def _same(ours, ref, path="/"):
    """Leaf-for-leaf equality: containers, types, dtypes, shapes, bytes."""
    assert type(ours) is type(ref), (path, type(ours), type(ref))
    if isinstance(ref, dict):
        assert list(ours) == list(ref), path
        for key in ref:
            _same(ours[key], ref[key], f"{path}{key}/")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{path}{i}/")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path
    else:
        assert ours == ref, path


def _write(tmp_path, tree, name="ck.ckpt"):
    from flax import serialization

    path = tmp_path / name
    path.write_bytes(serialization.msgpack_serialize(tree))
    return str(path)


def _assert_reads_as_flax(path):
    from flax import serialization

    from tricolo_tpu_torch.training.jax_checkpoint import load_jax_checkpoint

    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    _same(load_jax_checkpoint(path), ref)


def test_reader_equals_msgpack_restore(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "step": np.asarray(7, np.int32),
        "epoch": np.int64(3),  # an npscalar
        "scale": np.float32(1.5),
        "params": {
            "dense": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                      "bias": np.zeros(4, np.float32)},
            "emb": {"table": rng.integers(-128, 127, (5, 2), dtype=np.int8),
                    "mask": rng.random(6) > 0.5, "ids": np.arange(3, dtype=np.uint32),
                    "f64": np.asarray(2.25), "i16": np.asarray([-3, 40000 // 2], np.int16)},
        },
        "batch_stats": {},
        "opt_state": {"0": {}, "1": {"count": np.asarray(2, np.int32),
                                     "mu": {"w": np.ones((2, 2), np.float32)}}},
        "extra": {"metrics": {"val_eval/RR@5": 12.5, "val_loss/total_loss": 3.25},
                  "name": "héllo", "none": None, "flag": True, "off": False,
                  "small": -1, "neg16": -40000, "neg64": -(2**40), "big": 2**63 + 5,
                  "u8": 200, "list": [1, 2.5, "s", [3]], "blob": b"\x00\x01\xff",
                  "cplx": complex(1, -2), "long": "x" * 300},
    }
    _assert_reads_as_flax(_write(tmp_path, tree))


def test_chunked_arrays(tmp_path, monkeypatch):
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
                       "small": np.arange(3, dtype=np.float32)},
            "top": np.arange(50, dtype=np.int64)}
    path = _write(tmp_path, tree)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    _assert_reads_as_flax(path)


def test_bfloat16_leaf_decodes_bit_exact(tmp_path):
    import jax.numpy as jnp

    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.training.jax_checkpoint import load_jax_checkpoint

    rng = np.random.default_rng(3)
    w = np.array(jnp.asarray(rng.normal(size=(2, 5)), jnp.bfloat16))
    w[0, :3] = [np.inf, -0.0, 1e-40]  # inf, signed zero, a bf16 subnormal
    path = _write(tmp_path, {"params": {"enc": {"w": w}}, "step": np.asarray(1, np.int32)})
    leaf = load_jax_checkpoint(path)["params"]["enc"]["w"]
    assert leaf.dtype == np.uint16 and leaf.shape == w.shape
    assert leaf.tobytes() == w.tobytes()
    tensor = jax_to_torch({"enc": {"embedding": leaf}}, {})["enc.weight"]
    assert tensor.dtype == torch.bfloat16
    assert tensor.view(torch.int16).numpy().tobytes() == w.tobytes()


def _jax_cfg(extra=()):
    from tricolo_tpu.config import load_config

    return load_config([*BI_V, *extra])


def _port_cfg():
    from tricolo_tpu_torch.config import load_config

    return load_config(PORT)


def _train_state(cfg, seed):
    import jax.numpy as jnp

    from tricolo_tpu.training.optim import make_optimizer
    from tricolo_tpu.training.state import TrainState

    model, params, stats = jax_variables(cfg, seed=seed)
    tx = make_optimizer(cfg)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    return model, tx, TrainState.create(variables, tx)


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy_voxel_kernel"])
def test_jax_checkpoint_serves_equal_features(tmp_path, legacy):
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.training.checkpoint import save_checkpoint
    from tricolo_tpu.training.steps import shape_embedding_sum
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    cfg = _jax_cfg()
    model, _, state = _train_state(cfg, seed=4)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    dm = JaxDataModule(cfg)
    dm.setup("test")
    ref, seen = [], set()
    for batch in dm.test_loader():
        out = model.apply(variables, jax_device_batch(batch, cfg), train=False)
        shape = np.asarray(shape_embedding_sum(out))
        for i in range(batch["num_valid"]):
            if batch["model_id"][i] not in seen:
                seen.add(batch["model_id"][i])
                ref.append(shape[i])
    if legacy:  # saved before the RGB 3 → 4 channel pad (its weights are zero)
        conv = state.params["voxel_encoder"]["ConvBlock_0"]["Conv_0"]
        assert not np.asarray(conv["kernel"])[..., 3, :].any()
        conv = dict(conv, kernel=conv["kernel"][..., :3, :])
        params = dict(state.params, voxel_encoder=dict(
            state.params["voxel_encoder"],
            ConvBlock_0=dict(state.params["voxel_encoder"]["ConvBlock_0"], Conv_0=conv)))
        state = state.replace(params=params, opt_state=state.opt_state)
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)
    server = RetrievalServer.from_checkpoint(_port_cfg(), path, device="cpu")
    index = server.build_index(DataModule(_port_cfg()))
    np.testing.assert_allclose(index.matrix, np.stack(ref), rtol=0, atol=1e-4)


def _port_moments(model, optimizer):
    """(mu, nu, count) of the port's Adam as JAX-layout numpy trees."""
    from tricolo_tpu_torch.convert import torch_to_jax

    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        state = {k: v for k, v in model.state_dict().items() if "running_" in k}
        for name, p in model.named_parameters():
            state[name] = optimizer.state[p][key]
        moments.append(_flat(torch_to_jax(state)[0]))
    return moments[0], moments[1], {int(e["step"]) for e in optimizer.state.values()}


@pytest.mark.parametrize("flat_update", [False, True], ids=["optax_chain", "flat_update"])
def test_one_step_from_jax_checkpoint_matches_jax(tmp_path, flat_update):
    from jax.flatten_util import ravel_pytree

    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.training.checkpoint import _find_adam_moments, save_checkpoint
    from tricolo_tpu.training.optim import lr_for_epoch
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.convert import torch_to_jax
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    cfg = _jax_cfg([f"optimizer.flat_update={str(flat_update).lower()}"])
    model, tx, state = _train_state(cfg, seed=5)
    dm = JaxDataModule(cfg)
    dm.setup("fit")
    batches = list(dm.train_loader())[:2]
    arrays = [{k: v for k, v in b.items() if isinstance(v, np.ndarray)} for b in batches]
    lr = lr_for_epoch(cfg, 0)
    step = make_train_step(model, tx, cfg)
    state, _ = step(state, arrays[0], lr, jax.random.PRNGKey(0))
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)

    trainer = Trainer(_port_cfg(), device="cpu")
    assert trainer.load_state(path) == 0 and trainer.step == 1
    got_params, got_stats = (_flat(t) for t in torch_to_jax(trainer.model.state_dict()))
    ref_params = _flat(state.params)
    assert got_params.keys() == ref_params.keys()
    for name, ref in ref_params.items():
        np.testing.assert_array_equal(got_params[name], ref, err_msg=name)
    for name, ref in _flat(state.batch_stats).items():
        np.testing.assert_array_equal(got_stats[name], ref, err_msg=name)
    adam = _find_adam_moments(jax.tree.map(np.asarray, _as_state_dict(state.opt_state)))
    if flat_update:
        unravel = ravel_pytree(state.params)[1]
        adam = {**adam, "mu": unravel(adam["mu"]), "nu": unravel(adam["nu"])}
    mu, nu, count = _port_moments(trainer.model, trainer.optimizer)
    assert count == {int(adam["count"])} == {1}
    for got, ref in ((mu, _flat(adam["mu"])), (nu, _flat(adam["nu"]))):
        for name, value in ref.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)

    before = _flat(state.params)
    state, ref_losses = step(state, arrays[1], lr, jax.random.PRNGKey(0))
    got_losses = trainer.train_step(to_device_batch(batches[1], torch.device("cpu")), lr)
    assert sorted(got_losses) == sorted(ref_losses)
    for name, value in ref_losses.items():
        np.testing.assert_allclose(got_losses[name].item(), float(value), rtol=1e-5)
    got_params, got_stats = (_flat(t) for t in torch_to_jax(trainer.model.state_dict()))
    ref_params = _flat(state.params)
    diffs = np.concatenate([np.abs(got_params[n] - r).ravel() for n, r in ref_params.items()])
    assert diffs.max() <= 2 * lr * 1.01, diffs.max()
    assert (diffs > 1e-6).mean() <= 1e-3, (diffs > 1e-6).mean()
    moved = np.concatenate([(np.abs(r - before[n]) > 0).ravel() for n, r in ref_params.items()])
    assert moved.mean() > 0.99
    for name, ref in _flat(state.batch_stats).items():
        np.testing.assert_allclose(got_stats[name], ref, rtol=0, atol=1e-5, err_msg=name)
    assert _port_moments(trainer.model, trainer.optimizer)[2] == {2}


def _as_state_dict(opt_state):
    from flax import serialization

    return serialization.to_state_dict(opt_state)

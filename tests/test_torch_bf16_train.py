"""Training at bf16 parameters (``precision.param_dtype=bfloat16``): one
Tri(I+V) train step of the port against the JAX package's
``make_train_step``, JAX bf16 checkpoints in, the port's own resume, the
weight bridge and data parallel, on the tiny fixture of
``test_torch_bf16_params.py`` (voxel 32, image 32, 2 views, ef_dim 8,
B=2, windowed_compact, masked BN; the JAX variables from ``eval_shape``
filled with seeded bf16 parameters and f32 statistics).

The JAX side runs the plain loss, the port the blocked loss on its kernels'
plain versions (``test_torch_train.py``). Tolerances:

* one step at ``compute_dtype=float32`` from the same state: per-pair
  losses rtol 1e-5; each gradient (bf16 on both sides, JAX's cotangent of
  a bf16 leaf and the port's ``.grad``) within 8e-3 of its tensor's max
  |JAX| (two bf16 ulps: each side rounds its f32 gradient once, and the
  fixture's ResNet layer 4, which normalises over B·V = 4 samples, amplifies
  the f32 rounding of the two packages' sums to ~3e-4 of max,
  ``test_torch_train.py``); running statistics within 1e-6 absolute plus
  1e-6 relative. Updated parameters (``assert_updates_close``): each element
  within one bf16 ulp, or within 2·lr and one ulp, where Adam's first step
  lr·g/(|g| + eps) turns a gradient that f32 rounding moves across zero,
  or one of the size of eps, into a different step; no more than 0.1% of
  the elements beyond one ulp and 2% differing at all. Measured: 0.0047%
  beyond one ulp, 0.038% differing. The same step, at the same bounds, on
  the other voxel paths: ``explicit_dgrad``, ``remat_voxel`` and the full
  windowed transfer;
* one step at ``compute_dtype=bfloat16`` (``BF16_LOSS_RTOL``): finite
  losses; the text-voxel loss within 2e-2 of JAX's, the two losses through
  the ResNet within 1.5e-1 and the total within 5e-2. Both packages round
  activations to bf16 in other places (8 bits of mantissa) and the ResNet
  layer 4's BatchNorm over 4 samples amplifies that: measured 0.27%
  (text-voxel), 9.5% (text-image), 1.6% (image-voxel), 2.7% (total).
  The fixture at f32 parameters, bf16 compute, lies 4.1% from JAX on
  text-image, and JAX's own bf16-compute step 1.7% from its f32 step;
* a JAX bf16 train-state checkpoint loads into the port's model and Adam
  bit-exact (parameters and both moments bf16, statistics f32) with its
  step; a port bf16 checkpoint resumes to the bits of an uninterrupted
  run's next step; ``torch_to_jax(jax_to_torch(·))`` keeps every bf16 bit.

Data parallel at bf16 parameters: ``test_torch_bf16_parallel.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_bf16_params import arrays, fill, jax_inputs, rel  # noqa: E402
from test_torch_data import jax_cfg, torch_cfg  # noqa: E402
from test_torch_train import _flat, _train_batches  # noqa: E402

BF16 = ["precision.param_dtype=bfloat16"]
PORT = ["loss.NTXentLoss.use_pallas=true"]
CPU = torch.device("cpu")
GRAD_TOL = 8e-3
# One step at bf16 compute (module docstring): the loss without the ResNet,
# then the two through it and the total.
BF16_LOSS_RTOL = {"train_loss/text_voxel_loss": 2e-2, "train_loss/text_image_loss": 1.5e-1,
                  "train_loss/image_voxel_loss": 1.5e-1, "train_loss/total_loss": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def teardown_module(module):
    jax.clear_caches()


def _keys(compute):
    return [*BF16, f"precision.compute_dtype={compute}"]


@pytest.fixture(scope="module")
def batches():
    from tricolo_tpu.data import DataModule as JaxDataModule

    return _train_batches(JaxDataModule, jax_cfg(_keys("float32")), 0)[:2]


def _variables(cfg, batch, seed=2):
    """(JAX model, bf16 params, f32 batch_stats) numpy trees."""
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet

    model = JaxNet.from_config(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax_inputs(arrays(batch), cfg))
    rng = np.random.default_rng(seed)
    return model, fill(shapes["params"], rng), fill(shapes["batch_stats"], rng)


def _jax_state(cfg, params, stats):
    import jax.numpy as jnp

    from tricolo_tpu.training.optim import make_optimizer
    from tricolo_tpu.training.state import TrainState

    tx = make_optimizer(cfg)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    return tx, TrainState.create(variables, tx)


def _jax_grads(model, cfg, params, stats, batch):
    """JAX's gradient tree of the step's loss (``steps.py``'s ``loss_fn``)."""
    from tricolo_tpu.losses import make_loss_fn, pairwise_losses

    loss_pair = make_loss_fn(cfg)

    def loss_fn(params, batch):
        output, _ = model.apply({"params": params, "batch_stats": stats},
                                jax_inputs(batch, cfg), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return pairwise_losses(loss_pair, output, "train_loss")["train_loss/total_loss"]

    return jax.jit(jax.grad(loss_fn))(params, arrays(batch))


def _port(compute, params, stats, extra=()):
    """The port's model and Adam at bf16 parameters carrying JAX's trees."""
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer

    cfg = torch_cfg([*_keys(compute), *PORT, *extra])
    model = TriCoLoNet.from_config(cfg)
    model.load_state_dict(jax_to_torch(params, stats))
    return cfg, model, make_optimizer(cfg, model)


def _as_float(tree) -> dict:
    """A flat numpy tree with bf16 leaves (JAX's, or the port's uint16
    bits) as float32."""
    import jax.numpy as jnp

    out = {}
    for name, value in _flat(tree).items():
        if value.dtype == np.uint16:
            value = value.view(jnp.bfloat16)
        out[name] = np.asarray(value, np.float32)
    return out


def _bits(tree) -> dict:
    """A flat numpy tree's bf16 leaves as their uint16 bits."""
    return {name: np.asarray(v).view(np.uint16) if np.asarray(v).dtype.itemsize == 2
            else np.asarray(v) for name, v in _flat(tree).items()}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 steps (±0 equal)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def assert_updates_close(got: dict, ref: dict, lr: float) -> dict:
    """Updated bf16 parameters against a reference step's: every element
    within one bf16 ulp, or within 2·lr and one ulp (Adam's first step
    moves a parameter by lr·g/(|g| + eps): a gradient that rounding moves
    across zero, or one of the size of eps, moves the step by up to 2·lr).
    Returns the shares of elements that differ at all and beyond one ulp."""
    differ = beyond = total = 0
    for name, want in ref.items():
        have = got[name]
        ulps = bf16_ulps(have, want)
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
        far = ulps > 1
        gap = (have.float() - want.float()).abs()
        assert bool((gap[far] <= 2 * lr + ulp[far]).all()), (name, float(gap[far].max()))
        differ, beyond = differ + int((ulps > 0).sum()), beyond + int(far.sum())
        total += ulps.numel()
    return {"differ": differ / total, "beyond_one_ulp": beyond / total}


def _f32_step_matches_jax(batch, extra=()) -> None:
    """One f32-compute step of the port against ``make_train_step`` from
    the same bf16 state, at the module docstring's bounds."""
    from tricolo_tpu.training.optim import lr_for_epoch
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.convert import _tensor, torch_to_jax
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import make_train_step as port_train_step

    cfg = jax_cfg([*_keys("float32"), *extra])
    model, params, stats = _variables(cfg, batch)
    lr = lr_for_epoch(cfg, 0)
    ref_grads = _as_float(_jax_grads(model, cfg, params, stats, batch))
    tx, state = _jax_state(cfg, params, stats)
    state, ref_losses = make_train_step(model, tx, cfg)(state, arrays(batch), lr,
                                                        jax.random.PRNGKey(0))

    pcfg, port, optimizer = _port("float32", params, stats, extra)
    losses = port_train_step(port, optimizer, pcfg)(to_device_batch(batch, CPU), lr)
    assert sorted(losses) == sorted(ref_losses)
    for name, value in losses.items():
        np.testing.assert_allclose(value.item(), float(ref_losses[name]), rtol=1e-5,
                                   err_msg=name)

    grads = {n: p.grad for n, p in port.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.bfloat16}
    got = _as_float(torch_to_jax({**port.state_dict(), **grads})[0])
    assert sorted(got) == sorted(ref_grads)
    errors = {n: rel(got[n], r) for n, r in ref_grads.items()}
    assert max(errors.values()) <= GRAD_TOL, max(errors.items(), key=lambda kv: kv[1])

    new_params, new_stats = torch_to_jax(port.state_dict())
    got_new = {n: _tensor(v) for n, v in _flat(new_params).items()}
    share = assert_updates_close(got_new, {n: _tensor(v) for n, v in _flat(state.params).items()},
                                 lr)
    assert share["beyond_one_ulp"] <= 1e-3 and share["differ"] <= 0.02, share
    for name, ref in _flat(state.batch_stats).items():
        assert _flat(new_stats)[name].dtype == np.float32
        np.testing.assert_allclose(_flat(new_stats)[name], ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_f32_compute_step_matches_jax_make_train_step(batches):
    _f32_step_matches_jax(batches[0])


# The other voxel paths, each on the Tri(I+V) step of the test above: the
# explicit input-gradient conv, the rematerialised encoder and the full
# windowed transfer.
VOXEL_PATHS = {
    "explicit_dgrad": ["model.modules.VoxelCNNEncoder.explicit_dgrad=true"],
    "remat_voxel": ["precision.remat_voxel=true"],
    "windowed": ["data.voxel_transfer=windowed"],
}


@pytest.mark.parametrize("path", sorted(VOXEL_PATHS))
def test_f32_compute_step_on_each_voxel_path_matches_jax(path):
    from tricolo_tpu.data import DataModule as JaxDataModule

    extra = VOXEL_PATHS[path]
    batch = _train_batches(JaxDataModule, jax_cfg([*_keys("float32"), *extra]), 0)[0]
    _f32_step_matches_jax(batch, extra)


def test_bf16_compute_step_losses_match_jax(batches):
    from tricolo_tpu.training.optim import lr_for_epoch
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import make_train_step as port_train_step

    cfg = jax_cfg(_keys("bfloat16"))
    model, params, stats = _variables(cfg, batches[0])
    lr = lr_for_epoch(cfg, 0)
    tx, state = _jax_state(cfg, params, stats)
    _, ref = make_train_step(model, tx, cfg)(state, arrays(batches[0]), lr,
                                             jax.random.PRNGKey(0))
    pcfg, port, optimizer = _port("bfloat16", params, stats)
    losses = port_train_step(port, optimizer, pcfg)(to_device_batch(batches[0], CPU), lr)
    assert sorted(losses) == sorted(ref) == sorted(BF16_LOSS_RTOL)
    for name, value in losses.items():
        assert np.isfinite(value.item()), name
        np.testing.assert_allclose(value.item(), float(ref[name]), rtol=BF16_LOSS_RTOL[name],
                                   err_msg=name)
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}


def test_jax_bf16_checkpoint_loads_bit_exact(batches, tmp_path):
    from tricolo_tpu.training.checkpoint import save_checkpoint
    from tricolo_tpu.training.optim import lr_for_epoch
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.convert import torch_to_jax
    from tricolo_tpu_torch.training import Trainer

    cfg = jax_cfg(_keys("float32"))
    model, params, stats = _variables(cfg, batches[0], seed=3)
    tx, state = _jax_state(cfg, params, stats)
    state, _ = make_train_step(model, tx, cfg)(state, arrays(batches[0]), lr_for_epoch(cfg, 0),
                                               jax.random.PRNGKey(0))
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)

    trainer = Trainer(torch_cfg([*_keys("float32"), *PORT]), device="cpu")
    assert trainer.load_state(path) == 0 and trainer.step == 1
    model_t, optimizer = trainer.model, trainer.optimizer
    assert {p.dtype for p in model_t.parameters()} == {torch.bfloat16}
    got_params, got_stats = torch_to_jax(model_t.state_dict())
    assert _bits(got_params).keys() == _bits(state.params).keys()
    for name, ref in _bits(state.params).items():
        np.testing.assert_array_equal(_bits(got_params)[name], ref, err_msg=name)
    for name, ref in _flat(state.batch_stats).items():
        assert _flat(got_stats)[name].dtype == np.float32
        np.testing.assert_array_equal(_flat(got_stats)[name], ref, err_msg=name)
    adam = state.opt_state[-1]
    for key, ref_tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = {n: optimizer.state[p][key] for n, p in model_t.named_parameters()}
        assert {m.dtype for m in moments.values()} == {torch.bfloat16}
        running = {k: v for k, v in model_t.state_dict().items() if "running_" in k}
        got = _bits(torch_to_jax({**running, **moments})[0])
        for name, ref in _bits(ref_tree).items():
            np.testing.assert_array_equal(got[name], ref, err_msg=f"{key} {name}")
    assert {int(s["step"]) for s in optimizer.state.values()} == {int(adam.count)} == {1}


def test_port_bf16_checkpoint_resumes_the_next_step(batches, tmp_path):
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer
    from tricolo_tpu_torch.training.checkpoint import save_checkpoint

    cfg = torch_cfg([*_keys("float32"), *PORT])
    device_batches = [to_device_batch(b, CPU) for b in batches]
    lr = cfg.optimizer.lr
    run = Trainer(cfg, device="cpu")
    run.train_step(device_batches[0], lr)
    run.step = 1
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, run.state(), epoch=0)
    run.train_step(device_batches[1], lr)

    resumed = Trainer(cfg, device="cpu")
    assert resumed.load_state(path) == 0 and resumed.step == 1
    resumed.train_step(device_batches[1], lr)
    for (name, p), q in zip(run.model.named_parameters(), resumed.model.parameters()):
        assert p.dtype == q.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name
        for key in ("exp_avg", "exp_avg_sq"):
            a, b = run.optimizer.state[p][key], resumed.optimizer.state[q][key]
            assert a.dtype == b.dtype == torch.bfloat16
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), (name, key)
        assert int(run.optimizer.state[p]["step"]) == int(resumed.optimizer.state[q]["step"]) == 2
    for (name, a), b in zip(run.model.named_buffers(), resumed.model.buffers()):
        assert torch.equal(a, b), name


def test_weight_bridge_round_trips_bf16_bits(batches):
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax

    cfg = jax_cfg(_keys("float32"))
    _, params, stats = _variables(cfg, batches[0], seed=5)
    state = jax_to_torch(params, stats)
    assert {t.dtype for k, t in state.items() if "running_" not in k and
            "num_batches" not in k} == {torch.bfloat16}
    got_params, got_stats = torch_to_jax(state)
    ref, got = _bits(params), _bits(got_params)
    assert got.keys() == ref.keys()
    for name, value in ref.items():
        assert value.dtype == got[name].dtype == np.uint16, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    for name, value in _flat(stats).items():
        np.testing.assert_array_equal(_flat(got_stats)[name], value, err_msg=name)




def test_server_indexes_a_jax_bf16_checkpoint(batches, tmp_path):
    """``RetrievalServer`` serves a JAX bf16 checkpoint: bf16 parameters,
    an index equal to the JAX eval forward's shape embeddings (f32 compute:
    1e-4, as ``test_torch_jax_checkpoint.py``) and token queries answered."""
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.training.checkpoint import save_checkpoint
    from tricolo_tpu.training.steps import shape_embedding_sum
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    cfg = jax_cfg(_keys("float32"))
    model, params, stats = _variables(cfg, batches[0], seed=6)
    _, state = _jax_state(cfg, params, stats)
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)
    dm = JaxDataModule(cfg)
    dm.setup("test")
    forward = jax.jit(lambda b: model.apply({"params": params, "batch_stats": stats},
                                            jax_inputs(b, cfg), train=False))
    ref, seen = [], set()
    for batch in dm.test_loader():
        shape = np.asarray(shape_embedding_sum(forward(arrays(batch))))
        for i in range(batch["num_valid"]):
            if batch["model_id"][i] not in seen:
                seen.add(batch["model_id"][i])
                ref.append(shape[i])

    pcfg = torch_cfg([*_keys("float32"), *PORT])
    server = RetrievalServer.from_checkpoint(pcfg, path, device="cpu")
    assert {p.dtype for p in server.model.parameters()} == {torch.bfloat16}
    index = server.build_index(DataModule(pcfg))
    assert index.matrix.dtype == np.float32
    np.testing.assert_allclose(index.matrix, np.stack(ref), rtol=0, atol=1e-4)
    hits = server.query(tokens=[5, 12, 9], k=3)
    assert len(hits) == 3 and {m for m, _ in hits} <= seen

"""Training the CLIP-head configurations in the port: the train step
against the JAX package, the heads' dropout, a JAX CLIP-variant checkpoint
continued in the port, the fit → resume → test lifecycle, and the train,
test and serve CLIs.

On the CPU at the tiny widths of ``test_torch_clip.py``, f32. Tolerances
(PERF.md §2): one step's per-pair losses rtol 1e-5, gradients within 3e-4
of each tensor's largest JAX magnitude, updated parameters within 2·lr
with all but 0.1% of them within 1e-6 (a gradient that rounding pushes
across zero flips Adam's ±lr step). The JAX comparisons run with
``CLIP*Encoder.dropout=0``: the port draws its dropout masks from its own
generator stream (``training.steps.dropout_generator``), which cannot equal
the JAX package's threefry bits. The port's own dropout is held on its
own terms: the drop rate, the survivors' scale, eval mode, the same masks
for the same (train_seed, step), and a resumed fit equal to an
uninterrupted one (losses within 1e-6).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_clip import (  # noqa: E402
    CLIP_BI,
    CLIP_TRI,
    StubBackend,
    jax_cfg,
    jax_clip_variables,
    port_model,
    torch_cfg,
)
from test_torch_data import host_batch, jax_device_batch  # noqa: E402
from test_torch_train import _flat, _max_normalised_errors, _port_tree  # noqa: E402

NO_DROPOUT = ["model.modules.CLIPTextEncoder.dropout=0",
              "model.modules.CLIPImageEncoder.dropout=0"]
PORT = ["loss.NTXentLoss.use_pallas=true"]
GRAD_TOL = 3e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def teardown_module(module):
    jax.clear_caches()


# --------------------------------------------------------------- the step


def _first_train_batch(cfg):
    """The JAX package's first shuffled train batch: two captions of two
    models (an eval batch holds two captions of one model, whose equal
    features give the pair losses no gradient)."""
    from tricolo_tpu.data import DataModule as JaxDataModule

    dm = JaxDataModule(cfg)
    dm.setup("fit")
    batch = dm.train_loader().peek()
    assert len(set(batch["model_id"])) == 2
    return batch


@pytest.mark.parametrize("base", [CLIP_TRI, CLIP_BI], ids=["tri", "bi_no_batch_stats"])
def test_first_step_grads_match_jax(base):
    """One train-mode forward/backward at dropout 0 from the same weights:
    the pair losses and every gradient, and the BN statistics it updates."""
    import jax.numpy as jnp

    from tricolo_tpu.losses import make_loss_fn, pairwise_losses
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.losses import make_loss_fn as port_loss_fn
    from tricolo_tpu_torch.losses import pairwise_losses as port_pairwise

    overrides = [*base, *NO_DROPOUT]
    cfg = jax_cfg(overrides)
    model, params, stats = jax_clip_variables(overrides, seed=6)
    batch = _first_train_batch(cfg)
    device_batch = jax_device_batch(batch, cfg)
    loss_pair = make_loss_fn(cfg)

    def loss_fn(params, batch_stats):  # tricolo_tpu/training/steps.py loss_fn
        output, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, device_batch, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        loss_dict = pairwise_losses(loss_pair, output, "train_loss")
        return loss_dict["train_loss/total_loss"], (loss_dict, mutated.get("batch_stats", {}))

    grads, (ref_losses, ref_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats))

    port = port_model(params, stats, [*overrides, *PORT]).train()
    losses = port_pairwise(port_loss_fn(torch_cfg([*overrides, *PORT])),
                           port(prepare_inputs(port, to_device_batch(batch, CPU))), "train_loss")
    losses["train_loss/total_loss"].backward()
    assert sorted(losses) == sorted(ref_losses)
    for name, value in losses.items():
        np.testing.assert_allclose(value.item(), float(ref_losses[name]), rtol=1e-5, err_msg=name)
    got_grads, got_stats = (_flat(t) for t in _port_tree(port, grads=True))
    ref_flat = _flat(grads)
    assert sorted(got_grads) == sorted(ref_flat)
    assert any(name.startswith("text_encoder/MLPHead_0") for name in ref_flat)
    errors = _max_normalised_errors(got_grads, ref_flat)
    assert max(errors.values()) <= GRAD_TOL, max(errors.items(), key=lambda kv: kv[1])
    for name, ref in _flat(ref_stats).items():
        np.testing.assert_allclose(got_stats[name], ref, rtol=0, atol=2e-6, err_msg=name)


# ------------------------------------------------------------------ dropout


def test_dropout_rate_scale_and_eval():
    """Over 10⁶ draws the dropped share lies within 3σ of p = 0.1, every
    survivor is x / (1 − p), and in eval mode the head is the identity."""
    from tricolo_tpu_torch.models.common import MLPHead, dropout
    from tricolo_tpu_torch.training import dropout_generator

    p, n = 0.1, 1_000_000
    x = torch.full((1000, 1000), 3.0)
    y = dropout(x, p, dropout_generator(123, 0, CPU))
    dropped = float((y == 0).float().mean())
    assert abs(dropped - p) <= 3 * np.sqrt(p * (1 - p) / n), dropped
    assert torch.equal(y[y != 0], (x / (1 - p))[y != 0])
    with pytest.raises(ValueError, match="torch.Generator"):
        dropout(x, p, None)

    head = MLPHead(16, 32, 8, dropout=p)
    features = torch.randn(64, 16)
    plain = head.fc2(torch.relu(head.fc1(features)))
    head.eval()
    assert torch.equal(head(features), plain)
    assert torch.equal(head(features, dropout_generator(1, 2, CPU)), plain)
    head.train()
    assert not torch.equal(head(features, dropout_generator(1, 2, CPU)), plain)
    zero = MLPHead(16, 32, 8).train()  # dropout 0: no generator needed
    assert torch.equal(zero(features), zero.fc2(torch.relu(zero.fc1(features))))


def test_dropout_masks_follow_seed_and_step():
    """The same (train_seed, step) draws the same masks; another step or
    seed draws others; a model with dropout refuses a train forward without
    a generator."""
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.training import dropout_generator

    model = port_model(*jax_clip_variables(CLIP_BI, seed=1)[1:], CLIP_BI).train()
    inputs = prepare_inputs(model, to_device_batch(host_batch(jax_cfg(CLIP_BI)), CPU))

    def features(seed, step):
        with torch.no_grad():
            out = model(inputs, dropout_generator(seed, step, CPU))
        return torch.cat([out["text_features"], out["image_features"]], dim=-1)

    same = features(123, 7)
    assert torch.equal(same, features(123, 7))
    assert not torch.equal(same, features(123, 8))
    assert not torch.equal(same, features(231, 7))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(inputs)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(inputs)["text_features"], model(inputs)["text_features"])


def _fit_cfg(tmp_path, *extra):
    from tricolo_tpu_torch.config import load_config

    return load_config([*CLIP_TRI, *PORT, "trainer.check_val_every_n_epoch=1",
                        "trainer.log_every_n_steps=1", "trainer.profiler=none",
                        "logger.backend=jsonl", f"project_root_path={tmp_path}",
                        "experiment_name=t", *extra])


def _train_losses(cfg):
    with open(os.path.join(cfg.logger.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["train_loss/total_loss"] for r in rows if "train_loss/total_loss" in r}


def test_resumed_fit_draws_the_masks_of_an_uninterrupted_one(tmp_path):
    """2 epochs at dropout 0.1 in one fit, against 1 epoch then a resumed
    run for 1 more: the same losses at every step (within 1e-6)."""
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    whole = _fit_cfg(tmp_path / "whole", "trainer.max_epochs=2")
    assert whole.model.modules.CLIPTextEncoder.dropout == 0.1
    Trainer(whole, device="cpu").fit(DataModule(whole))
    first = _fit_cfg(tmp_path / "split", "trainer.max_epochs=1")
    manager = Trainer(first, device="cpu").fit(DataModule(first))
    second = _fit_cfg(tmp_path / "split", "trainer.max_epochs=2")
    resumed = Trainer(second, device="cpu")
    resumed.fit(DataModule(second), resume_ckpt=manager.best_path)
    ref, got = _train_losses(whole), _train_losses(second)
    assert sorted(ref) == sorted(got) == list(range(1, 15))
    for step, loss in ref.items():
        assert abs(got[step] - loss) <= 1e-6, (step, got[step], loss)
    # Dropout is live: at dropout 0 the same fit gives other losses.
    off = _fit_cfg(tmp_path / "off", "trainer.max_epochs=1", *NO_DROPOUT)
    Trainer(off, device="cpu").fit(DataModule(off))
    assert _train_losses(off)[3] != ref[3]


# ------------------------------------------------------------ JAX checkpoint


@pytest.mark.parametrize("flat_update", [False, True], ids=["optax_chain", "flat_update"])
@pytest.mark.parametrize("base", [CLIP_TRI, CLIP_BI], ids=["tri", "bi_no_batch_stats"])
def test_jax_clip_checkpoint_continues_one_step(tmp_path, base, flat_update):
    """A JAX CLIP-variant checkpoint after one JAX step (live Adam moments
    over the heads, either optimizer layout), read by the port's trainer:
    the weights, the Adam moments and count exact, then one port step
    against one JAX step."""
    import jax.numpy as jnp

    from jax.flatten_util import ravel_pytree

    from test_torch_jax_checkpoint import _as_state_dict, _port_moments
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.training.checkpoint import _find_adam_moments, save_checkpoint
    from tricolo_tpu.training.optim import lr_for_epoch, make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu.training.steps import make_train_step
    from tricolo_tpu_torch.convert import torch_to_jax
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    overrides = [*base, *NO_DROPOUT, f"optimizer.flat_update={str(flat_update).lower()}"]
    cfg = jax_cfg(overrides)
    model, params, stats = jax_clip_variables(overrides, seed=5)
    tx = make_optimizer(cfg)
    variables = {"params": jax.tree.map(jnp.asarray, params)}
    if stats:
        variables["batch_stats"] = jax.tree.map(jnp.asarray, stats)
    state = TrainState.create(variables, tx)
    dm = JaxDataModule(cfg)
    dm.setup("fit")
    batches = list(dm.train_loader())[:2]
    arrays = [{k: v for k, v in b.items() if isinstance(v, np.ndarray)} for b in batches]
    lr = lr_for_epoch(cfg, 0)
    step = make_train_step(model, tx, cfg)
    state, _ = step(state, arrays[0], lr, jax.random.PRNGKey(0))
    path = str(tmp_path / "epoch=0.ckpt")
    save_checkpoint(path, state, epoch=0)

    trainer = Trainer(torch_cfg([*overrides, *PORT]), device="cpu")
    assert trainer.load_state(path) == 0 and trainer.step == 1
    got_params, got_stats = (_flat(t) for t in torch_to_jax(trainer.model.state_dict()))
    for name, ref in _flat(state.params).items():
        np.testing.assert_array_equal(got_params[name], ref, err_msg=name)
    assert sorted(got_stats) == sorted(_flat(state.batch_stats))
    adam = _find_adam_moments(jax.tree.map(np.asarray, _as_state_dict(state.opt_state)))
    if flat_update:
        unravel = ravel_pytree(state.params)[1]
        adam = {**adam, "mu": unravel(adam["mu"]), "nu": unravel(adam["nu"])}
    mu, nu, count = _port_moments(trainer.model, trainer.optimizer)
    assert count == {int(adam["count"])} == {1}
    for got, ref in ((mu, _flat(adam["mu"])), (nu, _flat(adam["nu"]))):
        assert any(name.startswith("image_encoder/MLPHead_0") for name in ref)
        for name, value in ref.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)

    state, ref_losses = step(state, arrays[1], lr, jax.random.PRNGKey(0))
    got_losses = trainer.train_step(to_device_batch(batches[1], CPU), lr)
    assert sorted(got_losses) == sorted(ref_losses)
    for name, value in ref_losses.items():
        np.testing.assert_allclose(got_losses[name].item(), float(value), rtol=1e-5)
    got_params = _flat(torch_to_jax(trainer.model.state_dict())[0])
    diffs = np.concatenate([np.abs(got_params[n] - r).ravel()
                            for n, r in _flat(state.params).items()])
    assert diffs.max() <= 2 * lr * 1.01, diffs.max()
    assert (diffs > 1e-6).mean() <= 1e-3, (diffs > 1e-6).mean()


# ------------------------------------------------------------ the lifecycle


def test_clip_fit_resume_and_test(tmp_path, monkeypatch, capsys):
    """Twin of the JAX package's ``test_clip_variant_fit_resume_and_test``:
    fit 2 epochs with the async writer, resume for a third from the best
    checkpoint, test it (metrics printed, ``output.p`` saved)."""
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    cfg = _fit_cfg(tmp_path, "trainer.max_epochs=2", "checkpoint_monitor.async_save=true")
    trainer = Trainer(cfg, device="cpu")
    manager = trainer.fit(DataModule(cfg))
    assert manager.best_path and os.path.exists(manager.best_path)
    assert os.path.getsize(os.path.join(cfg.logger.save_dir, "metrics.jsonl")) > 0
    cfg2 = _fit_cfg(tmp_path, "trainer.max_epochs=3")
    trainer2 = Trainer(cfg2, device="cpu")
    trainer2.fit(DataModule(cfg2), resume_ckpt=manager.best_path)
    assert trainer2.step > trainer.step
    monkeypatch.chdir(tmp_path)  # nearest.jsonl lands in the CWD
    result = trainer2.test(DataModule(cfg2), manager.best_path)
    assert result is not None and all(np.isfinite(v) for v in result.summary().values())
    assert os.path.exists(os.path.join(cfg2.inference.output_dir, "output.p"))
    assert "RR@1 RR@5 NDCG@5 MRR" in capsys.readouterr().out


def test_train_test_and_serve_clis_run_clip(tmp_path, capsys, monkeypatch):
    """The train CLI (one epoch), the test CLI and the serving CLI with
    ``+query_tokens`` through the CLIP branch (the stub backend in place of
    the local checkpoint directory); the train CLI's image-size guard."""
    import tricolo_tpu_torch.clip.extract as port_extract
    from tricolo_tpu_torch import serve, train
    from tricolo_tpu_torch import test as test_cli

    args = [*CLIP_TRI, *PORT, "data.image_size=224", "trainer.max_epochs=1",
            "experiment_name=clip", f"project_root_path={tmp_path}", "+device=cpu"]
    best = train.main(args)
    assert os.path.basename(best) == "epoch=0.ckpt"
    assert "epoch 0: RR@1=" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    metrics = test_cli.main([*args, f"+ckpt_path={best}"])
    assert all(np.isfinite(v) for v in metrics.summary().values())
    capsys.readouterr()
    monkeypatch.setattr(port_extract, "TransformersClipBackend", lambda path: StubBackend())
    serve.main([*args, f"+ckpt_path={best}", "+query_tokens=49406,320,1901,49407"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "index built: 5 models"
    assert len(lines) == 6 and all(len(line.split("\t")) == 2 for line in lines[1:])
    with pytest.raises(SystemExit) as info:
        train.main([a for a in args if a != "data.image_size=224"])
    assert info.value.code == 0
    assert "data.image_size to 224" in capsys.readouterr().out

"""The training slice as a whole: the port's train loader, train step and
Trainer against the JAX package's loader, ``loss_fn`` / ``make_train_step``
on the tiny Tri(I+V) fixture (voxel 32, image 32, 2 views, ef_dim 8, B=2,
f32, windowed_compact at halo 3, masked BN).

The JAX side runs the plain loss (``use_pallas=false``): with ``true`` its
``make_loss_fn`` calls the Pallas kernel compiled, which the CPU cannot
run; ``test_torch_nt_xent.py`` ties the blocked loss to both. The port runs
``use_pallas=true`` (the blocked loss on its kernels' plain versions).

Tolerances (f32 on the CPU). This fixture is ill-conditioned: ResNet
layer 4 normalises over B·V = 4 samples per channel, which amplifies the
convolutions' f32 rounding (XLA and PyTorch sum in other orders) about a
thousandfold. Measured: the image features of both f32 forwards lie ~2e-6
from a float64 run; the max-normalised first-step gradients of JAX's own
f32 run lie 1.5e-4 from the port's float64 run, the port's f32 run 1.0e-4.
Adam's first steps move every parameter by about ±lr, so a gradient that
rounding pushes across zero moves its parameter 2·lr apart, and free-running
runs of the same code in f32 and f64 drift apart by 1.9e-2 in the loss by
step 3. Hence:

* per-pair losses of a step: rtol 1e-5;
* gradients of the first step: each tensor within ``GRAD_TOL`` = 3e-4 of
  its largest JAX magnitude, and JAX's f32 gradients within the same of the
  port's float64 gradients (the gap is JAX's own rounding);
* three steps (``test_torch_train_steps.py``): each starts both packages
  from the port's state (params,
  batch_stats and the Adam moments and count), so every step is a one-step
  comparison and the moments' carry-over is held too. Updated parameters
  within 2·lr (a sign flip) and all but 0.1% of them within 1e-6; batch
  statistics atol 1e-5. Gradients are compared at the first step only: at
  a later state a forward near-tie (the max over 2 views, a pooling
  window) can route a gradient differently under rounding-size changes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import (  # noqa: E402
    TINY,
    jax_cfg,
    jax_device_batch,
    jax_variables,
    torch_cfg,
)

PORT = ["loss.NTXentLoss.use_pallas=true"]
STEPS = 3
GRAD_TOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _train_batches(dm_cls, cfg, epoch):
    dm = dm_cls(cfg)
    dm.setup("fit")
    loader = dm.train_loader()
    loader.set_epoch(epoch)
    return list(loader)


def _port_model(params, stats):
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(torch_cfg(PORT))
    model.load_state_dict(jax_to_torch(params, stats))
    return model


def _port_tree(model, grads=False):
    """(params, batch_stats) numpy trees of the port model — or of its
    gradients with ``grads`` — in the JAX layout."""
    from tricolo_tpu_torch.convert import torch_to_jax

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if grads:
        for name, p in model.named_parameters():
            state[name] = p.grad.detach().clone()
    return torch_to_jax(state)


@pytest.fixture(scope="module")
def setup():
    from tricolo_tpu.data import DataModule as JaxDataModule

    cfg = jax_cfg()
    model, params, stats = jax_variables(cfg, seed=2)
    batches = _train_batches(JaxDataModule, cfg, 0)[:STEPS]
    return cfg, model, params, stats, batches


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batches_match_jax(epoch):
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule

    ref = _train_batches(JaxDataModule, jax_cfg(), epoch)
    ours = _train_batches(DataModule, torch_cfg(), epoch)
    assert len(ours) == len(ref) == 7  # 15 captions, B=2, drop_last
    for a, b in zip(ours, ref):
        assert a["model_id"] == b["model_id"] and a["num_valid"] == b["num_valid"] == 2
        for key in ("tokens", "images", "voxel_rows", "voxel_row_ids"):
            np.testing.assert_array_equal(a[key], b[key])
    other = _train_batches(DataModule, torch_cfg(), 1 - epoch)
    assert [b["model_id"] for b in other] != [b["model_id"] for b in ours]


def _port_grads(params, stats, batch, dtype):
    """Loss dict and gradient tree of one port forward/backward in ``dtype``
    (float64: the model, the inputs and the loss in float64)."""
    from tricolo_tpu_torch.data.device_prep import normalize_images
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.losses import make_loss_fn, pairwise_losses

    port = _port_model(params, stats).train().to(dtype)
    port.set_compute_dtype(dtype)
    inputs = to_device_batch(batch, torch.device("cpu"))
    inputs["images"] = normalize_images(inputs["images"], dtype)
    loss_fn = make_loss_fn(torch_cfg(PORT)) if dtype == torch.float32 else _nt_xent64
    losses = pairwise_losses(loss_fn, port(inputs), "train_loss")
    losses["train_loss/total_loss"].backward()
    return losses, port


def _nt_xent64(a, b, tau=0.1, alpha=0.25):
    a, b = (torch.nn.functional.normalize(x.double(), dim=-1) for x in (a, b))
    loss_a = -torch.log_softmax(a @ b.T / tau, dim=1).diagonal().mean()
    loss_b = -torch.log_softmax(b @ a.T / tau, dim=1).diagonal().mean()
    return alpha * loss_a + (1 - alpha) * loss_b


def _max_normalised_errors(got, ref):
    return {name: float(np.abs(got[name] - r).max()) / max(float(np.abs(r).max()), 1e-30)
            for name, r in ref.items()}


def test_first_step_grads_match_jax(setup):
    import jax.numpy as jnp

    from tricolo_tpu.losses import make_loss_fn, pairwise_losses

    cfg, model, params, stats, batches = setup
    device_batch = jax_device_batch(batches[0], cfg)
    loss_pair = make_loss_fn(cfg)

    def loss_fn(params, batch_stats):  # tricolo_tpu/training/steps.py loss_fn
        output, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, device_batch, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)},
        )
        loss_dict = pairwise_losses(loss_pair, output, "train_loss")
        return loss_dict["train_loss/total_loss"], (loss_dict, mutated["batch_stats"])

    grads, (ref_losses, ref_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    )
    losses, port = _port_grads(params, stats, batches[0], torch.float32)
    assert sorted(losses) == sorted(ref_losses)
    for name, value in losses.items():
        np.testing.assert_allclose(value.item(), float(ref_losses[name]), rtol=1e-5)

    ref_flat = _flat(grads)
    got_grads, got_stats = _port_tree(port, grads=True)
    assert sorted(_flat(got_grads)) == sorted(ref_flat)
    errors = _max_normalised_errors(_flat(got_grads), ref_flat)
    assert max(errors.values()) <= GRAD_TOL, max(errors.items(), key=lambda kv: kv[1])
    # The gap is f32 rounding: JAX's own f32 gradients are as far from the
    # port's float64 gradients.
    _, port64 = _port_grads(params, stats, batches[0], torch.float64)
    exact = _flat(_port_tree(port64, grads=True)[0])
    errors64 = _max_normalised_errors(ref_flat, exact)
    assert max(errors64.values()) <= GRAD_TOL, max(errors64.items(), key=lambda kv: kv[1])
    # Running statistics after the step: the biased batch variance.
    for name, ref in _flat(ref_stats).items():
        np.testing.assert_allclose(_flat(got_stats)[name], ref, rtol=0, atol=2e-6,
                                   err_msg=name)


def test_fit_one_epoch_checkpoint_serves(tmp_path, capsys):
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer
    from tricolo_tpu_torch.training import Trainer

    cfg = load_config([*TINY, *PORT, "trainer.max_epochs=1", "experiment_name=fit",
                       f"project_root_path={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    path = trainer.fit(DataModule(cfg)).best_path
    assert path == str(tmp_path / "output" / "Synthetic" / "fit" / "training" / "epoch=0.ckpt")
    out = capsys.readouterr().out
    assert "epoch 0: RR@1=" in out and "MRR=" in out
    assert trainer.metrics is not None
    server = RetrievalServer.from_checkpoint(cfg, path, device="cpu")
    after = server.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    server.build_index(DataModule(cfg))
    assert len(server.index.model_ids) == 5
    answer = server.query(tokens=[5, 12, 9], k=3)
    assert len(answer) == 3 and all(np.isfinite(s) for _, s in answer)


def test_train_cli_on_cpu(tmp_path, capsys):
    from tricolo_tpu_torch import train

    path = train.main([*TINY, *PORT, "trainer.max_epochs=1", "experiment_name=cli",
                       f"project_root_path={tmp_path}", "+device=cpu"])
    assert path.endswith("epoch=0.ckpt")
    assert f"checkpoint: {path}" in capsys.readouterr().out


def test_trainer_raises_without_cuda_or_cpu_request(monkeypatch):
    from tricolo_tpu_torch.training import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(torch_cfg(PORT))

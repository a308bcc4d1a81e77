"""The port honours or refuses every opt-in the JAX package acts on:
``precision.remat_voxel`` (honoured: ``torch.utils.checkpoint``, as JAX's
``nn.remat``), ``model.modules.MVCNNEncoder.hybrid_stem`` and ``s2d_stem``
(refused: not ported), and ``trainer.profiler=xplane`` (honoured: a
``torch.profiler`` trace under ``{logger.save_dir}/xplane``, as the JAX
package's ``profile_trace``).

The remat tests run one train step on the tiny Tri(I+V) fixture (the
masked windowed_compact encoder) and on its unmasked (all-site BN, packed)
encoder, from one seeded state with ``remat_voxel`` off and on, f32 on the
CPU. Tolerances, stated before the first run: the recompute repeats the
forward's arithmetic, so losses, gradients and running statistics within
1e-6 of each tensor's largest magnitude; and the bytes the autograd graph
saves in the voxel encoder's forward (``saved_tensors_hooks``) at most a
tenth of the non-remat forward's (it keeps its inputs alone).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import TINY  # noqa: E402

PORT = ["loss.NTXentLoss.use_pallas=true"]
ENCODERS = {"masked": [],
            "unmasked": ["model.modules.VoxelCNNEncoder.masked_bn=false",
                         "data.voxel_transfer=packed"]}
CPU = torch.device("cpu")
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cfg(extra):
    from tricolo_tpu_torch.config import load_config

    return load_config([*TINY, *PORT, *extra])


@pytest.mark.parametrize("stem", ["hybrid_stem", "s2d_stem"])
def test_stem_opt_ins_are_refused(stem):
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    with pytest.raises(NotImplementedError, match=stem):
        TriCoLoNet.from_config(_cfg([f"model.modules.MVCNNEncoder.{stem}=true"]))
    TriCoLoNet.from_config(_cfg([f"model.modules.MVCNNEncoder.{stem}=false"]))


def _batch(cfg):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(cfg)
    dm.setup("fit")
    return dm.train_loader().peek()


def _step(extra, remat):
    """One train step from the seeded state: losses, gradients, buffers."""
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer, make_train_step

    cfg = _cfg([*extra, f"precision.remat_voxel={str(remat).lower()}"])
    torch.manual_seed(cfg.train_seed)
    model = TriCoLoNet.from_config(cfg)
    assert model.voxel_encoder.remat is remat
    step = make_train_step(model, make_optimizer(cfg, model), cfg)
    losses = step(to_device_batch(_batch(cfg), CPU), cfg.optimizer.lr)
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_remat_voxel_step_equals_the_plain_step(encoder):
    losses, grads, buffers = _step(ENCODERS[encoder], remat=True)
    ref_losses, ref_grads, ref_buffers = _step(ENCODERS[encoder], remat=False)
    for key, value in ref_losses.items():
        np.testing.assert_allclose(losses[key], value, rtol=TOL, err_msg=key)
    for name, g in ref_grads.items():
        assert _rel(grads[name], g) <= TOL, name
    # Running statistics updated once a step: a second update would move
    # them 0.9× further from their start.
    for name, b in ref_buffers.items():
        if b.is_floating_point():
            assert _rel(buffers[name], b) <= TOL, name


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_remat_voxel_saves_fewer_bytes(encoder):
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    saved = {}
    for remat in (False, True):
        cfg = _cfg([*ENCODERS[encoder], f"precision.remat_voxel={str(remat).lower()}"])
        torch.manual_seed(cfg.train_seed)
        model = TriCoLoNet.from_config(cfg).train()
        inputs = prepare_inputs(model, to_device_batch(_batch(cfg), CPU))
        enc = model.voxel_encoder
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if "voxels" in inputs:
                out = enc(voxels=inputs["voxels"])
            else:
                out = enc(inputs["voxel_rows"], inputs["voxel_row_ids"])
        out.sum().backward()
        saved[remat] = total[0]
    assert saved[False] > 0 and saved[True] <= saved[False] / 10, saved


def test_xplane_profiler_writes_a_trace(tmp_path):
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.training import Trainer

    cfg = _cfg(["trainer.max_epochs=1", "trainer.profiler=xplane", "experiment_name=trace",
                f"project_root_path={tmp_path}", "logger.backend=jsonl"])
    Trainer(cfg, device="cpu").fit(DataModule(cfg))
    traces = list((tmp_path / "output" / "Synthetic" / "trace" / "training" / "xplane")
                  .glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("train_step" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)

"""Two config keys the JAX package honours, held on both packages.

* ``model.modules.MVCNNEncoder.pretrained_path``: an npz written by the JAX
  ``models/resnet.py::save_pretrained`` (flat ``params/…`` and
  ``batch_stats/…`` keys, flax layouts) is grafted over the image backbone's
  random init. The JAX ``Trainer._graft_pretrained_backbone`` and the
  port's ``Trainer`` (on the CPU) graft the same file; after
  ``convert.jax_to_torch`` every backbone parameter and BN buffer is equal,
  exactly in f32, and the rest of the model keeps its seeded init. A key
  the backbone lacks raises KeyError and a shape mismatch ValueError on
  both sides.
* ``precision.param_dtype``: the port builds f32 parameters only, so any
  other value raises NotImplementedError instead of being ignored.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import jax_cfg, jax_variables, torch_cfg  # noqa: E402

BACKBONE = "image_encoder.backbone."


def _random_like(tree, rng):
    return {k: _random_like(v, rng) if isinstance(v, dict)
            else rng.normal(size=v.shape).astype(np.float32) for k, v in tree.items()}


@pytest.fixture(scope="module")
def backbone():
    """(params, batch_stats) of the tiny fixture's backbone, random values
    in the JAX model's shapes."""
    _, params, stats = jax_variables(jax_cfg())
    rng = np.random.default_rng(7)
    return (_random_like(params["image_encoder"]["backbone"], rng),
            _random_like(stats["image_encoder"]["backbone"], rng))


def _save(tmp_path, params, stats):
    from tricolo_tpu.models.resnet import save_pretrained

    path = str(tmp_path / "backbone.npz")
    save_pretrained(path, params, stats)
    return path


def _overrides(path, tmp_path):
    return [f"model.modules.MVCNNEncoder.pretrained_path={path}",
            f"project_root_path={tmp_path}", "experiment_name=t"]


def _jax_graft(path, tmp_path):
    """The JAX trainer's graft over the JAX init, as numpy trees."""
    from tricolo_tpu.training.trainer import Trainer as JaxTrainer

    cfg = jax_cfg(_overrides(path, tmp_path))
    _, params, stats = jax_variables(cfg)
    grafted = JaxTrainer._graft_pretrained_backbone(
        SimpleNamespace(cfg=cfg), {"params": params, "batch_stats": stats})
    return grafted["params"], grafted["batch_stats"]


def _port_trainer(overrides):
    from tricolo_tpu_torch.training import Trainer

    return Trainer(torch_cfg(overrides), device="cpu")


def test_pretrained_backbone_equals_the_jax_graft(backbone, tmp_path):
    from tricolo_tpu_torch.convert import jax_to_torch

    path = _save(tmp_path, *backbone)
    params, stats = _jax_graft(path, tmp_path)
    want = {k: v for k, v in jax_to_torch(params, stats).items()
            if k.startswith(BACKBONE) and not k.endswith("num_batches_tracked")}
    got = _port_trainer(_overrides(path, tmp_path)).model.state_dict()
    assert len(want) == 100  # ResNet18: 20 convs, 20 BNs of 4 entries each
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], value.float()), key
    # Everything else keeps the seeded init of a trainer without the key.
    base = _port_trainer([]).model.state_dict()
    for key, value in base.items():
        if key not in want:
            assert torch.equal(got[key], value), key


@pytest.mark.parametrize("fault,error", [
    ("unknown_param", KeyError), ("unknown_stat", KeyError), ("wrong_shape", ValueError)])
def test_pretrained_faults_raise_on_both_sides(backbone, tmp_path, fault, error):
    params, stats = (dict(tree) for tree in backbone)
    if fault == "unknown_param":
        params["layer9_0"] = {"conv1": {"kernel": np.zeros((3, 3, 8, 8), np.float32)}}
    elif fault == "unknown_stat":
        stats["bn9"] = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    else:
        params["conv1"] = {"kernel": np.zeros((7, 7, 3, 32), np.float32)}
    path = _save(tmp_path, params, stats)
    with pytest.raises(error):
        _jax_graft(path, tmp_path)
    with pytest.raises(error):
        _port_trainer(_overrides(path, tmp_path))


def test_pretrained_path_needs_the_mvcnn_encoder(tmp_path):
    """As in the JAX trainer, the key is read only with the MVCNN image
    encoder: without one a path (here a missing file) is never opened."""
    missing = str(tmp_path / "missing.npz")
    _port_trainer(_overrides(missing, tmp_path) + ["model.image_encoder=null"])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_param_dtype_is_honoured_or_refused(param_dtype):
    """The JAX package builds its parameters in ``precision.param_dtype``;
    the port builds f32 only and refuses any other value."""
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    key = [f"precision.param_dtype={param_dtype}"]
    JaxNet.from_config(jax_cfg(key))
    if param_dtype == "float32":
        model = TriCoLoNet.from_config(torch_cfg(key))
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    else:
        with pytest.raises(NotImplementedError, match="param_dtype"):
            TriCoLoNet.from_config(torch_cfg(key))

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


# ------------------------------------------- the other backbones' converters

CONVERTED = ["resnet18", "resnet34", "resnet50", "efficientnet_b0", "efficientnet_b3"]


def _published_state_dict(cnn_name):
    """A seeded state_dict with the published key names and shapes of
    torchvision's ResNets (``downsample.0/1``, an ``fc``) or
    efficientnet_pytorch's EfficientNets (``_conv_stem``, ``_blocks.{i}``,
    ``_conv_head``, an ``_fc``), built from the port's backbone by renaming."""
    import re

    from tricolo_tpu_torch.models.efficientnet import EfficientNet
    from tricolo_tpu_torch.models.resnet import ResNet

    rng = np.random.default_rng(sum(map(ord, cnn_name)))
    if cnn_name.startswith("efficientnet"):
        model = EfficientNet(cnn_name)
        index = {name: i for i, name in enumerate(model.block_names)}
        names = {"expand": "_expand_conv", "bn_expand": "_bn0", "depthwise": "_depthwise_conv",
                 "bn_depthwise": "_bn1", "se_reduce": "_se_reduce", "se_expand": "_se_expand",
                 "project": "_project_conv", "bn_project": "_bn2", "stem_conv": "_conv_stem",
                 "stem_bn": "_bn0", "head_conv": "_conv_head", "head_bn": "_bn1"}

        def rename(key):
            parts = key.split(".")
            if parts[0] in index:
                return ".".join(["_blocks", str(index[parts[0]]), names[parts[1]], parts[2]])
            return ".".join([names[parts[0]], parts[1]])

        extra = {"_fc.weight": (1000, model.feature_dim), "_fc.bias": (1000,)}
    else:
        model = ResNet(cnn_name)

        def rename(key):
            key = re.sub(r"downsample_conv", "downsample.0", key)
            return re.sub(r"downsample_bn", "downsample.1", key)

        extra = {"fc.weight": (1000, model.feature_dim), "fc.bias": (1000,)}
    state = {rename(k): rng.normal(size=tuple(v.shape)).astype(np.float32)
             for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    state.update({k: rng.normal(size=shape).astype(np.float32) for k, shape in extra.items()})
    return state


@pytest.mark.parametrize("cnn_name", CONVERTED)
def test_converters_equal_the_jax_converters_and_graft(cnn_name, tmp_path):
    from tricolo_tpu.models.efficientnet import convert_efficientnet_state_dict as jax_eff
    from tricolo_tpu.models.resnet import convert_torchvision_state_dict as jax_resnet
    from tricolo_tpu.models.resnet import save_pretrained as jax_save
    from tricolo_tpu.training.trainer import Trainer as JaxTrainer
    from test_torch_backbone_slice import _jax_model

    from tricolo_tpu_torch import convert_torchvision_weights as conv
    from tricolo_tpu_torch.convert import jax_to_torch

    state = _published_state_dict(cnn_name)
    efficient = cnn_name.startswith("efficientnet")
    ours = (conv.convert_efficientnet_state_dict if efficient
            else conv.convert_torchvision_state_dict)(state, cnn_name)
    theirs = (jax_eff if efficient else jax_resnet)(state, cnn_name)
    for got, want in zip(ours, theirs):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
    path, jax_path = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    conv.save_pretrained(path, *ours)
    jax_save(jax_path, *theirs)
    with np.load(path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
    # The port's file grafts over the port's model as the JAX trainer grafts
    # it over the JAX model.
    overrides = [f"model.modules.MVCNNEncoder.cnn_name={cnn_name}",
                 *_overrides(path, tmp_path)]
    cfg = jax_cfg(overrides)
    _, params, stats = _jax_model(cfg, seed=0)
    grafted = JaxTrainer._graft_pretrained_backbone(
        SimpleNamespace(cfg=cfg), {"params": jax.tree.map(np.asarray, params),
                                   "batch_stats": jax.tree.map(np.asarray, stats)})
    want = {k: v for k, v in jax_to_torch(grafted["params"], grafted["batch_stats"]).items()
            if k.startswith(BACKBONE) and not k.endswith("num_batches_tracked")}
    got = _port_trainer(overrides).model.state_dict()
    assert len(want) == sum(1 for k in got if k.startswith(BACKBONE)
                            and not k.endswith("num_batches_tracked"))
    for key, value in want.items():
        assert torch.equal(got[key], value.float()), key


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def test_convert_cli_needs_a_source_file(tmp_path):
    from tricolo_tpu_torch import convert_torchvision_weights as conv
    from tricolo_tpu_torch.models.resnet import load_pretrained

    with pytest.raises(ValueError, match="supplied as a file"):
        conv.main(["+cnn_name=resnet50", f"+out={tmp_path / 'x.npz'}"])
    src = tmp_path / "effnet.pth"
    state = _published_state_dict("efficientnet_b0")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, src)
    out = conv.main([f"+src={src}", "+cnn_name=efficientnet_b0",
                     f"+out={tmp_path / 'pretrained' / 'b0.npz'}"])
    params, stats = load_pretrained(out)
    want = conv.convert_efficientnet_state_dict(state, "efficientnet_b0")
    assert _flat(params).keys() == _flat(want[0]).keys()
    assert all(np.array_equal(v, _flat(want[0])[k]) for k, v in _flat(params).items())
    assert _flat(stats).keys() == _flat(want[1]).keys()

"""Weight bridge: JAX {params, batch_stats} ↔ the port's state_dict."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_data import jax_cfg, jax_variables, torch_cfg  # noqa: E402


@pytest.fixture(scope="module")
def tri_tree():
    _, params, stats = jax_variables(jax_cfg())
    return params, stats


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def test_round_trip_is_bit_exact(tri_tree):
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax

    params, stats = tri_tree
    back_params, back_stats = torch_to_jax(jax_to_torch(params, stats))
    for original, back in ((params, back_params), (stats, back_stats)):
        a, b = dict(_leaves(original)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for path in a:
            assert a[path].dtype == b[path].dtype, path
            np.testing.assert_array_equal(a[path], b[path], err_msg="/".join(path))


def test_state_dict_loads_strictly_and_back(tri_tree):
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    params, stats = tri_tree
    model = TriCoLoNet.from_config(torch_cfg())
    model.load_state_dict(jax_to_torch(params, stats), strict=True)
    back_params, _ = torch_to_jax(model.state_dict())
    np.testing.assert_array_equal(
        back_params["voxel_encoder"]["ConvBlock_0"]["Conv_0"]["kernel"],
        params["voxel_encoder"]["ConvBlock_0"]["Conv_0"]["kernel"],
    )


def test_layouts(tri_tree):
    from tricolo_tpu_torch.convert import jax_to_torch

    params, stats = tri_tree
    sd = jax_to_torch(params, stats)
    text = params["text_encoder"]
    np.testing.assert_array_equal(
        sd["text_encoder.gru.weight_ih_l0_reverse"].numpy(), text["gru_bwd"]["w_ih"].T
    )
    np.testing.assert_array_equal(
        sd["text_encoder.fc.weight"].numpy(), text["fc"]["Dense_0"]["kernel"].T
    )
    conv = params["voxel_encoder"]["ConvBlock_1"]["Conv_0"]["kernel"]  # (3,3,3,I,O)
    np.testing.assert_array_equal(
        sd["voxel_encoder.blocks.1.conv.weight"].numpy()[:, :, 0, 1, 2], conv[0, 1, 2].T
    )
    stem = params["image_encoder"]["backbone"]["conv1"]["kernel"]  # (7,7,3,64)
    np.testing.assert_array_equal(
        sd["image_encoder.backbone.conv1.weight"].numpy()[:, :, 4, 1], stem[4, 1].T
    )
    np.testing.assert_array_equal(
        sd["image_encoder.backbone.layer2.0.downsample_bn.running_var"].numpy(),
        stats["image_encoder"]["backbone"]["layer2_0"]["downsample_bn"]["var"],
    )

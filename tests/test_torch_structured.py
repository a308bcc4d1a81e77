"""The port's structured dataset against the JAX package's
(``tricolo_tpu.data.structured``): item for item and exactly — tokens,
captions, model ids, packed voxels, images, the split's voxel budgets — for
all three splits of the shipped ``data=structured`` preset at voxel size
32; the same bad configs raise; and the port's loader batches it as the
JAX loader does."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

STRUCTURED = ["data=structured", "data.voxel_size=32", "model.voxel_encoder=VoxelCNNEncoder",
              "data.batch_size=16"]


def _cfgs(extra=()):
    from tricolo_tpu.config import load_config as jax_load
    from tricolo_tpu_torch.config import load_config as torch_load

    return jax_load([*STRUCTURED, *extra]), torch_load([*STRUCTURED, *extra])


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_items_equal_jax(split):
    from tricolo_tpu.data.structured import StructuredSyntheticDataset as JaxStructured
    from tricolo_tpu_torch.data.datasets import build_dataset

    jax_cfg, torch_cfg = _cfgs()
    ref, ours = JaxStructured(jax_cfg, split), build_dataset(torch_cfg, split)
    assert len(ours) == len(ref) == 900
    assert ours.max_voxel_points == ref.max_voxel_points
    assert ours.max_voxel_tiles == ref.max_voxel_tiles
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        assert a["model_id"] == b["model_id"] and a["category"] == b["category"]
        assert ours.language_data[i]["text"] == ref.language_data[i]["text"]
        for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{split} {i} {key}")


@pytest.mark.parametrize("bad", ["data.vocab_size=36", "data.num_models=1081"])
def test_bad_configs_raise_as_jax(bad):
    from tricolo_tpu.data.structured import StructuredSyntheticDataset as JaxStructured
    from tricolo_tpu_torch.data.structured import StructuredSyntheticDataset

    jax_cfg, torch_cfg = _cfgs([bad])
    with pytest.raises(ValueError) as ref:
        JaxStructured(jax_cfg, "train")
    with pytest.raises(ValueError) as ours:
        StructuredSyntheticDataset(torch_cfg, "train")
    assert str(ours.value) == str(ref.value)


def test_eval_batches_equal_jax():
    """The preset through both DataModules (windowed_compact): every val
    batch, the padded tail included."""
    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu_torch.data import DataModule

    jax_cfg, torch_cfg = _cfgs(["data.num_models=40"])
    ref, ours = JaxDataModule(jax_cfg), DataModule(torch_cfg)
    ref.setup("test"), ours.setup("test")
    ref_batches, our_batches = list(ref.test_loader()), list(ours.test_loader())
    assert len(our_batches) == len(ref_batches) == 8  # 120 captions, B=16
    for a, b in zip(our_batches, ref_batches):
        assert a["num_valid"] == b["num_valid"] and a["model_id"] == b["model_id"]
        for key in ("tokens", "voxel_rows", "voxel_row_ids"):
            np.testing.assert_array_equal(a[key], b[key])

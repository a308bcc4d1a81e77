"""The port's loader-included benchmark (``tricolo_tpu_torch.bench_loader``)
against ``scripts/bench_loader.py``: the dataset's items bit-equal to
``_EllipsoidDataset``'s (imported by path; the script is not edited), the
same global budget fit, a per-sample budget that no item overflows, and
both modes end to end on the CPU at 32³, 2 views of 32², batch 8.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
TINY = ["data.voxel_size=32", "data.image_size=32", "data.num_views=2"]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_bench_loader",
                                                  ROOT / "scripts" / "bench_loader.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfgs(batch_size=8):
    from __graft_entry__ import _flagship_cfg
    from tricolo_tpu_torch.bench_data import flagship_cfg

    extra = [f"data.batch_size={batch_size}", "data.voxel_transfer=windowed_compact", *TINY]
    return flagship_cfg(extra=extra), _flagship_cfg(extra=extra)


def test_dataset_items_match_jax_script():
    from tricolo_tpu_torch.bench_data import EllipsoidDataset

    ours_cfg, ref_cfg = _cfgs()
    ours = EllipsoidDataset(ours_cfg, n_items=24, length=40, n_points=1024)
    ref = _jax_script()._EllipsoidDataset(ref_cfg, n_items=24, length=40, n_points=1024)
    assert len(ours) == len(ref) == 40 and ours.max_voxel_points == ref.max_voxel_points
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        assert a["model_id"] == b["model_id"] and a["category"] == b["category"]
        for key in ("tokens", "images", "voxel_flat", "voxel_rgb"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")


def test_budget_fits():
    """The global fraction is the JAX script's (its first-batch rule); the
    per-sample rows cover every item, at least the first batch's fit."""
    from tricolo_tpu.ops.tile_sparse import host_tile_count
    from tricolo_tpu_torch.bench_data import EllipsoidDataset
    from tricolo_tpu_torch.bench_loader import fit_budgets
    from tricolo_tpu_torch.data.loader import BatchIterator
    from tricolo_tpu_torch.ops.tile_sparse import host_sample_tile_counts

    cfg, _ = _cfgs()
    dataset = EllipsoidDataset(cfg, n_items=64, length=64, n_points=1024)
    rows = fit_budgets(cfg, dataset, 8)
    probe = BatchIterator(dataset, 8, drop_last=True, prefetch=False, voxel_transfer="packed",
                          voxel_size=32).peek()
    budget = -(-int(host_tile_count(probe["voxel_flat"], 32) * 1.25) // 256) * 256
    assert cfg.model.modules.VoxelCNNEncoder.tile_budget_frac == min(1.0, budget / (8 * 64))
    counts = host_sample_tile_counts([item["voxel_flat"] for item in dataset.items], 32)
    assert rows == max(counts) >= max(host_sample_tile_counts(probe["voxel_flat"], 32))


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    overrides = [a for o in TINY for a in ("--override", o)]
    proc = subprocess.run(
        [sys.executable, "-m", "tricolo_tpu_torch.bench_loader", "--device", "cpu",
         "--steps", "3", "--batch-size", "8", *overrides, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_host_mode_on_cpu():
    result = _run(["--mode", "host"])
    assert result["metric"] == "loader_host_ms_per_batch_median"
    assert result["batches"] == 3 and result["voxel_transfer"] == "windowed_compact"
    assert result["value"] > 0 and result["p90"] >= result["value"] > 0
    assert result["pairs_per_sec_host_only"] == pytest.approx(8e3 / result["value"])
    assert result["h2d_mb_per_batch"] > 0


@pytest.mark.parametrize("transfer", ["windowed_compact", "packed"])
def test_e2e_mode_on_cpu(transfer):
    result = _run(["--mode", "e2e", "--voxel-transfer", transfer,
                   "--override", "precision.compute_dtype=float32"])
    assert result["metric"] == "loader_included_pairs_per_sec"
    assert result["batches"] == 3 and result["voxel_transfer"] == transfer
    assert result["value"] == pytest.approx(8e3 / result["ms_per_step"])
    assert result["card"] == "cpu"


def test_raises_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from tricolo_tpu_torch import bench_loader

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_loader.main(["--mode", "host"])

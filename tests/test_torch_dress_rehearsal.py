"""``tricolo_tpu_torch.dress_rehearsal`` against ``scripts/dress_rehearsal.py``.

* ``generate`` at a tiny scale writes the JAX script's split bit for bit:
  the same npz files with equal arrays, and equal ``*_map.json`` (the JAX
  script imported by path, its ``SPLITS`` set to the same counts, run into
  a temp dir).
* ``run`` at that scale with ``+device=cpu`` and shrinking overrides exits
  0, and ``report`` returns every key.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SCALE = 0.001  # 7 train and 1 val models


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_dress_rehearsal", ROOT / "scripts" / "dress_rehearsal.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_matches_jax_script_bit_for_bit(tmp_path):
    from tricolo_tpu_torch import dress_rehearsal as port

    ref = _jax_script()
    ref.SPLITS = port.splits(SCALE)
    ref.generate(tmp_path / "jax")
    port.generate(tmp_path / "port", scale=SCALE)
    a, b = port.exp_dir(tmp_path / "jax"), port.exp_dir(tmp_path / "port")
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert sum(f.suffix == ".npz" for f in files) == 8
    for f in files:
        if f.suffix == ".json":
            assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
            continue
        with np.load(a / f) as x, np.load(b / f) as y:
            assert sorted(x.files) == sorted(y.files) == ["images", "voxel64"]
            for key in x.files:
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{f}:{key}")


def test_run_and_report_on_cpu(tmp_path):
    from tricolo_tpu_torch import dress_rehearsal as port

    port.generate(tmp_path, scale=SCALE)
    rc = port.run(tmp_path, 1, "cpu", ["data.image_size=32", "data.num_views=2",
                                       "data.batch_size=4", "trainer.log_every_n_steps=1"])
    assert rc == 0, (tmp_path / "train_log.txt").read_text()[-3000:]
    out = port.report(tmp_path)
    assert tuple(out) == port.REPORT_KEYS
    assert out["steps"] == 35 // 4 and out["train_s"] > 0 and out["total_wall_s"] > 0
    assert out["peak_rss_gb"] > 0 and out["s_per_step"]["median"] > 0
    assert out["tile_budget_fit"] is True and list(out["val_epochs"]) == [0]
    assert out["ckpt_mb"] and out["train_idle_share"] is None  # no samples on the CPU

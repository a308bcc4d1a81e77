"""The harness finds its parts by name; the traffic keeps the work; the
FLOP count matches a hand count."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.metrics import _flops, _kernel_work
from benchmark.spec import HERE, ROOT, load_benchmark, load_cell


def test_every_part_is_found_by_name():
    bench = load_benchmark()
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).exists()
        assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    for workload in bench["workloads"]:
        cell = load_cell(workload["name"])
        assert cell.generator().generate
        assert cell.limits.get("numbers"), f"no limits for {cell.name}"
        assert {m["name"] for m in cell.end_to_end} >= {"train_pairs_per_s", "setup_s"}
        assert cell.per_layer
        for metric in cell.per_layer:
            reader = cell.metric_reader(metric["name"])
            assert reader.UNIT == metric["unit"] and reader.LAYER == metric["layer"]
            assert reader.MOVES == metric["moves"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no_such.cell")


@pytest.mark.parametrize("traffic", ["train_spread", "train_narrow"])
def test_traffic_work_is_the_seeds_order(traffic):
    spec = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    sizes = {"voxel_size": 32, "image_size": 16, "num_views": 2, "vocab_size": 50,
             "max_tokens": 96, "voxel": True, "image": True}
    gen = load_cell("tri_iv.chair_table.train_spread").generator()
    a, b = (gen.generate(spec, sizes, seed, 64, 128) for seed in (1, 2**31 + 3))
    assert a.max_voxel_tiles == b.max_voxel_tiles
    assert a.max_voxel_points == b.max_voxel_points
    assert np.array_equal(a.active_sites, b.active_sites)
    lengths = [sorted(int((d.items[i]["tokens"] != 0).sum()) for i in range(64)) for d in (a, b)]
    assert lengths[0] == lengths[1]
    assert not np.array_equal(a.items[0]["images"], b.items[0]["images"])
    assert all((d.items[i]["tokens"] < 50).all() for d in (a, b) for i in range(64))
    shares = a.active_sites[:, 0] / 32**3
    lo, hi = spec["site_share"]["low"], spec["site_share"]["high"]
    assert shares.min() > 0.8 * lo and shares.max() < 1.2 * hi


def test_flops_match_a_hand_count():
    # BiGRU, B 2, T 3, I 4, H 5, out 6: 2 directions · 2·6·15·9, fc 2·2·10·6.
    assert _flops.text(2, 3, 4, 5, 6) == 3.0 * (2 * 2 * 6 * 3 * 5 * 9 + 2 * 2 * 10 * 6)
    # Voxel, B 1: block 1 (3 → 2) at 10 sites ×2, block 2 (2 → 4) at 3 sites ×3.
    assert _flops.voxel([10, 3], (2, 4), 1, 8, 2) == (
        2 * 2 * 27 * 3 * 2 * 10 + 3 * 2 * 27 * 2 * 4 * 3 + 3 * (2 * 8 * 2 + 2 * 2 * 2))
    # ResNet18 on one 32² image: stem 16², pool 8², stages at 8², 4², 2², 1².
    hand = 2 * (2 * 16 * 16 * 64 * 3 * 49)
    cin = 64
    for f, s in ((64, 8), (128, 4), (256, 2), (512, 1)):
        first = 2 * s * s * f * cin * 9 + 2 * s * s * f * f * 9 + (2 * s * s * f * cin if f != cin else 0)
        hand += 3 * (first + 2 * (2 * s * s * f * f * 9))
        cin = f
    assert _flops.resnet18(1, 32) == hand
    assert _flops.loss(3, 4, 8) == 3 * 6 * 16 * 8


def test_kernel_bytes_match_a_hand_count():
    # K1 on (1, 2, 2, 2, 4) with one mask and the argmax, bf16.
    assert _kernel_work.k1_bytes((1, 2, 2, 2, 4), 2, 1) == (8 * 4 + 8 + 4 + 1) * 2 + 4
    assert _kernel_work.k3_bytes((1, 2, 2, 2, 4), 2, 1) == (2 * 32 + 4 + 8) * 2 + 4
    assert _kernel_work.k2_bytes(3, 2, 4, 2, 5, 1, 4) == (3 * 8 + 64) * 4 * 2 + 20
    assert _kernel_work.label("void (anonymous namespace)::bn_relu_pool_bwd_kernel<1>") == "K3"
    assert _kernel_work.label("void (anonymous namespace)::bn_relu_pool_kernel<2>") == "K1"
    assert _kernel_work.label("volta_sgemm") is None

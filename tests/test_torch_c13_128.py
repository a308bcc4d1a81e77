"""The benchmark's 128³ cell, ``tri_iv.c13_128.train_spread``, on the CPU.

The cell runs through ``benchmark.harness.Run`` at 128³ with tiny widths
(ef_dim 4, voxel z 16, 2 views of 64², B 4, 8 distinct items, float32
compute, the benchmark's seeded weights): windowed_compact rows of the
worst item's ~717 tiles, the dense tail from 32³ and the 32·4³-wide head,
as on the card. Its readings of the compared steps are held, by
``compare.numbers``, against the plain reference twice: the whole-batch
voxel encoder and the blocked one (``train.reference_voxel_block``, 2
samples a block, as the card's cell runs it at 8). The fp8 control and a
planted half-batch fault must fail the same tolerances. The configuration
file must hold what the port builds from its overrides.
"""

from __future__ import annotations

import copy

import pytest

torch = pytest.importorskip("torch")

from benchmark import compare  # noqa: E402
from benchmark.harness import WIDTH_KEYS, Run, cfg_get  # noqa: E402
from benchmark.spec import load_benchmark, load_cell  # noqa: E402

CELL = "tri_iv.c13_128.train_spread"
SEED = 2**31 + 37
TINY = {"model": {"ef_dim": 4, "voxel_z_dim": 16, "image_size": 64, "num_views": 2},
        "train": {"batch_size": 4},
        "port": ["model.modules.VoxelCNNEncoder.ef_dim=4",
                 "model.modules.VoxelCNNEncoder.z_dim=16", "data.image_size=64",
                 "data.num_views=2", "precision.compute_dtype=float32"],
        "items": (8, 16)}
# What a sound f32 run at these sizes reads against the f32 reference, and
# why each bound is where it is: the bounds of ``benchmark/tests``' CPU
# runs (``test_faults.CPU_F32_LIMITS``). The two sides differ in the order
# of their sums only (windowed tiles against the dense grid, the blocked
# statistics against the whole batch's), so every gap is float32 rounding
# carried through the steps. Over three seeds the program read at most a
# twentieth of each bound (loss 2.8e-4, embeddings 3.9e-6, gradient
# 3.9e-5, change 1.9e-3); the control and the half batch read 10-2000
# times their bound on the embeddings, the loss or both.
TOLERANCES = {"numbers": {
    # Steps 2-3 follow Adam's first moves, which turn gradients near
    # rounding into whole steps of lr: the losses part by up to ~3e-4.
    "loss_gap": {"limit": 5e-3},
    # Unit embeddings after one forward: rounding of the encoders' sums.
    "emb_gap.text": {"limit": 1e-4}, "emb_gap.image": {"limit": 1e-4},
    "emb_gap.voxel": {"limit": 1e-4},
    # The first gradient, worst leaf: BatchNorm over 4 samples cancels to a
    # few % of its terms, which multiplies rounding (PERF.md §2).
    "grad_gap": {"limit": 3e-3},
    # Three Adam steps, worst leaf: m / √v of a gradient near rounding is
    # a whole step of lr either way.
    "change_gap": {"limit": 1e-2},
    "batch_mismatch": {"limit": 0}}}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    """The cell's compared steps at the tiny widths, made once for the
    module; the references are made by the tests."""
    cell = copy.deepcopy(load_cell(CELL))
    run = Run(cell, SEED, "cpu", TINY)
    run.setup()
    run.close()
    return run


@pytest.fixture(scope="module")
def blocked(run):
    """The f32 reference with the blocked voxel encoder, made once."""
    return reference(run, 2)


def reference(run, block: int | None, **fault) -> dict:
    saved = run.hyper
    run.hyper = {**saved, "reference_voxel_block": block}
    try:
        return run.reference(**fault)
    finally:
        run.hyper = saved


def test_the_configuration_holds_the_ports_widths():
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    bench = load_benchmark()
    cell = load_cell(CELL)
    (entry,) = [c for c in bench["configs"] if c["name"] == "tri_iv.c13_128"]
    assert entry["reduced"] == [] and cell.config["reduced"] == []
    (workload,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert workload["chips"] == 1 and workload["traffic"] == "train_spread"
    cfg = load_config(cell.config["port_overrides"])
    m = cell.config["model"]
    for key, dotted in WIDTH_KEYS.items():
        assert cfg_get(cfg, dotted) == m[key], key
    assert m["vocab_size"] == 3968 and m["voxel_size"] == 128
    assert cfg.precision.remat_voxel is False and cfg.data.voxel_transfer == "windowed_compact"
    assert cell.config["train"]["reference_voxel_block"] == 8
    with torch.device("meta"):
        model = TriCoLoNet.from_config(cfg)
    head = model.voxel_encoder.head.fc1
    assert head.in_features == 32_768 == 512 * 4**3
    assert set(cell.config["assumed"]) >= {"weights", "max_tokens", "head", "traffic"}


def test_the_cell_runs_at_128():
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.limits.get("numbers")
    # Every per-layer metric of the 64³ cells is read here too.
    bench = load_benchmark()
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in bench["per_layer"]]
    assert [m["name"] for m in cell.per_layer][-5:] == [
        "voxel_tile_blocks_step_ms", "voxel_dense_blocks_step_ms", "voxel_dense_blocks_mfu",
        "voxel_tile_padding_share", "voxel_tile_wgrad_roofline"]


@pytest.mark.parametrize("block", [None, 2], ids=["whole", "blocked"])
def test_the_run_holds_to_the_reference(run, blocked, block):
    assert run.first_batch["voxel_rows"].shape[-1] == 14**3
    k = run.first_batch["voxel_row_ids"].shape[1]
    assert 600 < k < 800  # the worst item's tiles at 128³ (717 at 1,024 items)
    found = compare.numbers(run.readings, blocked if block else reference(run, None))
    found["batch_mismatch"] = run.batch_mismatch()
    correct, checks = compare.judge(found, TOLERANCES)
    assert correct, checks


@pytest.mark.parametrize("fault", [{"control": True}, {"rows": 2}],
                         ids=["fp8_control", "half_batch"])
def test_a_fault_fails_the_tolerances(run, blocked, fault):
    found = compare.numbers(reference(run, 2, **fault), blocked)
    correct, checks = compare.judge(found, TOLERANCES)
    assert not correct, checks

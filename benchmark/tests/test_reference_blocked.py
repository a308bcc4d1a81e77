"""The reference's voxel encoder over blocks of samples
(``train.reference_voxel_block``) against the whole-batch one.

The two are the same mathematics and differ only in the order of sums, so
they are compared in float64 (every ``.float()`` of the reference made a
``.double()``), where that order moves nothing the comparison can see: in
float32 the whole-batch path at this size lies up to 2.4e-3 from its own
float64 values (the first voxel BatchNorm's bias gradient, a sum that
cancels) and its changes after three Adam steps up to 2.3e-2, which would
hide a real fault under a loose bound. The voxel widths are cut to
ef_dim 8 and z 64 to keep the float64 runs short; the blocking does not
depend on them. A saved-tensor count shows what the blocked path keeps
between the forward and the backward and how much one block's
recomputation adds, against bounds worked out from the shapes.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import weights as seeded
from benchmark.reference import batch as ref_batch
from benchmark.reference.batch import dense_voxels, packed_grid
from benchmark.reference.model import Model, param_specs, running, trainable, voxel_channels
from benchmark.reference.precision import fp8
from benchmark.reference.train import follow
from benchmark.spec import load_cell

from .sizes import TINY

SEED = 2**31 + 29
EXACT = 1e-10  # relative, in float64
VARIANTS = {"reference": {}, "control": {"q": fp8}, "half_batch": {"rows": 8},
            "unchanged_state": {"frozen": True}}


@pytest.fixture(scope="module")
def cell():
    return load_cell("tri_iv.chair_table.train_spread")


@pytest.fixture(scope="module")
def traffic(cell):
    m = {**cell.config["model"], **TINY["model"]}
    return cell.generator().generate(cell.traffic, m, SEED, *TINY["items"])


@pytest.fixture(scope="module")
def whole_runs():
    """The whole-batch readings of each variant, made once for the module."""
    return {}


@pytest.fixture
def float64():
    """The reference in float64 while the test runs."""
    saved = torch.get_default_dtype()
    patch = pytest.MonkeyPatch()
    patch.setattr(torch.Tensor, "float", torch.Tensor.double)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)
        patch.undo()


def compared_batches(traffic, B: int) -> list:
    n, length = len(traffic.items), len(traffic)
    return [[traffic.items[i] for i in ref_batch.batch_items(SEED, 0, length, n, B, j)]
            for j in range(3)]


def assert_close(got: float, want: float, what: str, tol: float = EXACT):
    assert abs(got - want) <= tol * abs(want), (what, got, want)


# Blocks of 1 and 16 (the whole batch) for the reference; 3, which does not
# divide the batch of 16 (nor the half batch's 8), for the control and the
# planted faults, whose unchanged state also follows the reference's
# arithmetic at 3 over three batches.
CASES = [("reference", 1), ("reference", 16)] + [(v, 3) for v in VARIANTS if v != "reference"]


@pytest.mark.parametrize("variant, block", CASES)
def test_blocked_follow_is_the_whole_one(cell, traffic, whole_runs, float64, variant, block):
    m = {**cell.config["model"], **TINY["model"], "ef_dim": 8, "voxel_z_dim": 64}
    hyper = {**cell.config["train"], **TINY["train"]}
    specs = param_specs(m)
    w0 = seeded.make(specs, SEED, "cpu")
    batches = compared_batches(traffic, hyper["batch_size"])
    kw = VARIANTS[variant]
    if variant not in whole_runs:
        whole_runs[variant] = follow(m, hyper, specs, w0, batches, "cpu", **kw)
    want = whole_runs[variant]
    got = follow(m, {**hyper, "reference_voxel_block": block}, specs, w0, batches, "cpu", **kw)
    assert len(got["loss"]) == 3
    for t, (a, b) in enumerate(zip(got["loss"], want["loss"])):
        assert_close(a, b, f"loss of step {t + 1}")
    assert got["emb"].keys() == want["emb"].keys() == {"text", "image", "voxel"}
    for key, emb in want["emb"].items():
        assert float((got["emb"][key] - emb).abs().max()) <= EXACT, key
    for reading in ("grad", "grad_abs", "change"):
        assert got[reading].keys() == want[reading].keys(), reading
        for name, value in want[reading].items():
            assert_close(got[reading][name], value, f"{reading} of {name}")
    # The voxel running statistics move, except where the state is left unchanged.
    moved = [v > 0 for n, v in want["change"].items()
             if n.startswith("voxel_encoder") and "running" in n]
    assert moved and all(moved) == (variant != "unchanged_state")


class SavedBytes:
    """Bytes of the distinct storages that autograd holds for the backward,
    now and at their peak, from ``saved_tensors_hooks``: each packed tensor
    counts until autograd lets go of it."""

    def __init__(self):
        self.refs: dict = {}
        self.now = self.peak = 0

    def pack(self, t):
        key = t.untyped_storage().data_ptr()
        if key not in self.refs:
            self.refs[key] = [0, t.untyped_storage().nbytes()]
            self.now += self.refs[key][1]
            self.peak = max(self.peak, self.now)
        self.refs[key][0] += 1
        return _Held(self, key, t)

    @staticmethod
    def unpack(held):
        return held.t

    def release(self, key):
        self.refs[key][0] -= 1
        if self.refs[key][0] == 0:
            self.now -= self.refs.pop(key)[1]


class _Held:
    def __init__(self, owner, key, t):
        self.owner, self.key, self.t = owner, key, t

    def __del__(self):
        self.owner.release(self.key)


def voxel_saved_bytes(m, items, block):
    """(kept after the forward, peak through the backward) of the voxel
    encoder alone, in float32."""
    specs = param_specs(m)
    w0 = seeded.make(specs, SEED, "cpu")
    w = {n: w0[n].clone().requires_grad_(True) for n in trainable(specs)}
    model = Model(m, w, {n: w0[n].clone() for n in running(specs)})
    rgb, occupied = dense_voxels(packed_grid(items, m["voxel_size"], "cpu"))
    count = SavedBytes()
    with torch.autograd.graph.saved_tensors_hooks(count.pack, count.unpack):
        out = model.voxel_blocked(rgb, occupied, block) if block else model.voxel(rgb, occupied)
        kept = count.now
        torch.autograd.grad((out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum(),
                            [w[n] for n in w if n.startswith("voxel_encoder")])
    return kept, count.peak


@pytest.mark.parametrize("block", [1, 4])
def test_blocked_path_keeps_pooled_outputs_and_one_blocks_activations(cell, traffic, block):
    m = {**cell.config["model"], **TINY["model"]}
    B, D, f32 = TINY["train"]["batch_size"], m["voxel_size"], 4
    items = traffic.items[:B]
    chans = voxel_channels(m)
    # Kept: each block's input (RGB and its mask) and every pooled output with
    # its mask, the weights, and a few (C,) statistics.
    inputs = B * 4 * D**3 * f32
    pooled = sum(B * (c + 1) * (D >> (i + 1)) ** 3 * f32 for i, c in enumerate(chans))
    weights = sum(n * f32 for n in (27 * cin * cout for cin, cout in zip((3,) + chans, chans)))
    head = (chans[-1] * (D // 32) ** 3 + 2 * m["out_dim"]) * m["out_dim"] * f32 + pooled
    kept_bound = inputs + pooled + weights + head + 1e5
    # One block's recomputation: its conv output at full resolution, saved as
    # the centred value, its scaled value, the ReLU's output and the pool's
    # input, and the pool's int64 indices (a quarter of it): 4.25 such tensors.
    full = block * chans[0] * D**3 * f32
    kept, peak = voxel_saved_bytes(m, items, block)
    assert kept <= kept_bound, (kept, kept_bound)
    assert peak <= kept_bound + 4.25 * full, (peak, kept_bound, full)
    whole_kept, _ = voxel_saved_bytes(m, items, None)
    assert whole_kept > kept_bound + 4.25 * B * chans[0] * D**3 * f32, whole_kept


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def gaps(got: dict, want: dict) -> dict:
    """The largest relative gap of each reading of ``follow``."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
           "emb": max(float((got["emb"][k] - e).abs().max()) for k, e in want["emb"].items())}
    for reading in ("grad", "grad_abs", "change"):
        out[reading] = max(abs(got[reading][n] - v) / max(abs(v), 1e-30)
                           for n, v in want[reading].items() if v or got[reading][n])
    return out


@pytest.mark.cuda
def test_card_blocked_follow_is_the_whole_one_at_128(cell):
    """At 128³ and a batch of 8, where the whole-batch graph still fits the
    card (cuDNN picks its algorithms per shape): blocks of 3 against the
    whole batch, in float64 to the same bound as on the CPU, and in float32
    each against the float64 whole batch."""
    need_cuda()
    m = {**cell.config["model"], "voxel_size": 128}
    hyper = {**cell.config["train"], "batch_size": 8}
    data = cell.generator().generate(cell.traffic, m, SEED, 32, 64)
    specs = param_specs(m)
    w0 = seeded.make(specs, SEED, "cuda")
    batches = compared_batches(data, hyper["batch_size"])
    blocked = {**hyper, "reference_voxel_block": 3}
    f32 = {"whole": follow(m, hyper, specs, w0, batches, "cuda"),
           "blocked": follow(m, blocked, specs, w0, batches, "cuda")}
    torch.cuda.empty_cache()
    patch = pytest.MonkeyPatch()
    patch.setattr(torch.Tensor, "float", torch.Tensor.double)
    try:
        whole64 = follow(m, hyper, specs, w0, batches, "cuda")
        torch.cuda.empty_cache()
        blocked64 = follow(m, blocked, specs, w0, batches, "cuda")
    finally:
        patch.undo()
    found = {"float64 blocked / whole": gaps(blocked64, whole64),
             "float32 blocked / whole": gaps(f32["blocked"], f32["whole"]),
             "float32 whole / float64 whole": gaps(f32["whole"], whole64),
             "float32 blocked / float64 whole": gaps(f32["blocked"], whole64)}
    print(found)
    assert all(v <= EXACT for v in found["float64 blocked / whole"].values()), found
    # In float32 the whole batch is itself up to 3.5e-4 (losses), 1.5e-3
    # (gradients) and 3e-2 (changes after three steps) from its float64 values
    # on the card; the blocks may differ from it by their order of sums, and
    # stay as near the float64 values as it is.
    for reading, gap in found["float32 whole / float64 whole"].items():
        assert found["float32 blocked / float64 whole"][reading] <= 2 * gap, (reading, found)

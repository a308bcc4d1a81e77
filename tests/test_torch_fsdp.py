"""FSDP in the port (``parallel.param_sharding=fsdp``): the sharding rule
against the JAX package's, one train step on two gloo ranks on the CPU
under FSDP against the port's replicated two-rank step from the same
weights (``test_torch_parallel.spawn_ranks``), the bf16 reduce-scatter
against JAX at three ranks, and the config. The step runs on the tiny
Tri(I+V) fixture of ``test_torch_train.py`` at global batch 4 (2 a rank)
with ``min_size`` 2**10, so that its leaves shard (the JAX package's own
FSDP test uses 2**10). The step against the JAX package's FSDP step:
``test_torch_fsdp_jax.py``; the fit: ``test_torch_fsdp_fit.py``.

Tolerances, stated before the first run:

* the rule: ``fsdp_axis`` decides on shapes alone, so it must equal the
  JAX package's ``_fsdp_spec`` exactly, on JAX's own three cases and on
  every leaf shape of the JAX and the port parameter trees of the flagship
  and of the tiny fixture, at world sizes 1, 2, 3, 4 and 8 and min sizes
  2**16 and 2**10;
* FSDP against replicated at two ranks: bit-equal. Each element of a
  gradient is the sum of the two ranks' terms, which commutes, whether an
  all-reduce or a reduce-scatter adds them, and Adam is elementwise. So the
  losses, the full gradients, both Adam moments, the updated parameters
  and the BN running statistics must be equal bit for bit, under the pjit,
  explicit and local NT-Xent forms, the triplet loss, remat and bf16
  parameters (where parameters and moments stay bf16 and the running
  statistics f32);
* each rank holds, of every leaf the rule shards, its size over the world
  size, and no other leaf is sharded; the two ranks' shards differ;
* the bf16 reduce-scatter at three ranks: bit for bit against the JAX
  gradient of a bf16 leaf sharded by JAX's rule over three CPU devices.
  JAX's compiled CPU program reduces that gradient in f32 (an f32
  all-reduce, then the device's slice rounded to bf16 once), and the port
  reduce-scatters in f32 (``MixedPrecisionPolicy(reduce_dtype=float32)``),
  a SUM, rounded once. The seeded parts are chosen so that a sum rounded
  to bf16 at each addition differs.
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import REPO, digest, init_rank, spawn_ranks, torch_cfg  # noqa: E402

if __name__ != "__main__":  # a spawned rank needs torch alone
    jax = pytest.importorskip("jax")

PORT = ["loss.NTXentLoss.use_pallas=true", "data.batch_size=4"]
MIN_SIZE = 2**10
RANKS = 2
CASES = {"pjit": [], "explicit": ["parallel.explicit_collectives=true"],
         "local": ["parallel.global_negatives=false"], "triplet": ["loss.name=TripletLoss"],
         "remat": ["precision.remat_voxel=true"], "bf16": ["precision.param_dtype=bfloat16"]}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ both sides


def fsdp_cfg(extra=(), multiprocess=True):
    return torch_cfg([*PORT, *extra, *(["parallel.multiprocess=true"] if multiprocess else [])])


def first_batch(cfg):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(cfg)
    dm.setup("fit")
    return dm.train_loader().peek()


def seeded_state(cfg) -> dict:
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    torch.manual_seed(cfg.train_seed)
    return TriCoLoNet.from_config(cfg).state_dict()


def full_snapshot(model, optimizer, losses: dict) -> dict:
    """``test_torch_parallel.snapshot`` of a sharded or replicated model:
    every tensor whole (sharded ones gathered, on every rank)."""
    from tricolo_tpu_torch.parallel.sharding_rules import gathered

    named = list(model.named_parameters())
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: gathered(p.grad).clone() for n, p in named},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "moments": {n: {k: gathered(optimizer.state[p][k]).clone()
                            for k in ("exp_avg", "exp_avg_sq")} for n, p in named},
            "params": {n: gathered(p.detach()).clone() for n, p in named}}


def bits(node):
    """``node`` with every bf16 tensor as its int16 bits (numpy, which
    ``digest`` hashes, has no bf16)."""
    if isinstance(node, dict):
        return {k: bits(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16:
        return node.view(torch.int16)
    return node


def sharded_step(cfg, batch, state, world, mode, min_size=MIN_SIZE):
    """One train step of the port from ``state`` on the rank's stripe
    ``batch``, the model placed by ``mode``: (its ``full_snapshot``, the
    model, the optimizer)."""
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.parallel import attach, shard_model
    from tricolo_tpu_torch.training import dropout_generator, make_optimizer, make_train_step

    model = TriCoLoNet.from_config(cfg)
    model.load_state_dict(state)
    attach(model, world)
    shard_model(model, world, mode, min_size)
    optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, optimizer, cfg, world=world)
    losses = step(to_device_batch(batch, CPU), cfg.optimizer.lr,
                  dropout_generator(cfg.train_seed, 0, CPU))
    return full_snapshot(model, optimizer, losses), model, optimizer


def local_digests(model) -> dict:
    """Each sharded parameter's local shard by its bytes' SHA-256."""
    from torch.distributed.tensor import DTensor

    return {n: hashlib.sha256(bits(p.to_local().detach()).contiguous().numpy().tobytes())
            .hexdigest() for n, p in model.named_parameters() if isinstance(p, DTensor)}


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    from tricolo_tpu_torch.parallel import sharded_leaves

    world = init_rank(rank, port)
    out: dict = {}
    for name, extra in CASES.items():
        cfg = fsdp_cfg(extra)
        batch, state = first_batch(cfg), seeded_state(cfg)
        rep, _, _ = sharded_step(cfg, batch, state, world, "replicated")
        mine, model, optimizer = sharded_step(cfg, batch, state, world, "fsdp")
        out[name] = {
            "losses": (rep["losses"], mine["losses"]),
            "replicated": digest(bits(rep)), "fsdp": digest(bits(mine)),
            "leaves": sharded_leaves(model), "local": local_digests(model),
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "dtypes": {"params": {p.dtype for p in model.parameters()},
                       "moments": {m.dtype for s in optimizer.state.values()
                                   for k, m in s.items() if k != "step"},
                       "stats": {b.dtype for n, b in model.named_buffers() if "running_" in n}}}
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, tmp_path_factory.mktemp("fsdp"))


# -------------------------------------------------------------- the rule


def _jax_axis(shape, world_size, min_size):
    from tricolo_tpu.parallel.sharding_rules import _fsdp_spec

    spec = _fsdp_spec((), jax.ShapeDtypeStruct(tuple(shape), np.float32), world_size, min_size)
    axes = [i for i, name in enumerate(spec) if name is not None]
    return axes[0] if axes else None


def test_rule_on_the_jax_cases():
    """``tests/test_parallel.py``'s three leaves on its 8-device mesh."""
    from tricolo_tpu_torch.parallel import fsdp_axis

    for shape, want in (((1024, 256), 0), ((16, 16), None), ((1025, 129), None)):
        assert fsdp_axis(shape, 8, 2**12) == want == _jax_axis(shape, 8, 2**12), shape


FLAGSHIP = ["data.voxel_size=64", "data.image_size=128", "data.num_views=6",
            "data.vocab_size=3588", "model.modules.VoxelCNNEncoder.ef_dim=32",
            "precision.compute_dtype=bfloat16"]


def _leaf_shapes(extra) -> set:
    """Every parameter shape of the port's and the JAX package's model of
    the tiny fixture with ``extra``, unevaluated (meta tensors;
    ``jax.eval_shape``)."""
    from test_torch_data import host_batch, jax_cfg, jax_device_batch

    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    with torch.device("meta"):
        shapes = {tuple(p.shape) for p in TriCoLoNet.from_config(torch_cfg(extra)).parameters()}
    cfg = jax_cfg(extra)
    tree = jax.eval_shape(JaxNet.from_config(cfg).init, jax.random.PRNGKey(0),
                          jax_device_batch(host_batch(cfg), cfg))
    shapes |= {tuple(leaf.shape) for leaf in jax.tree.leaves(tree["params"])}
    return shapes


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_rule_equals_jax_on_every_leaf_shape(name):
    from tricolo_tpu_torch.parallel import fsdp_axis

    shapes = _leaf_shapes(FLAGSHIP if name == "flagship" else [])
    sharded = 0
    for shape in sorted(shapes):
        for world_size in (1, 2, 3, 4, 8):
            for min_size in (2**16, 2**10):
                got = fsdp_axis(shape, world_size, min_size)
                assert got == _jax_axis(shape, world_size, min_size), (shape, world_size,
                                                                       min_size)
                sharded += got is not None
    assert sharded > 0


# -------------------------------------------------------------- the step


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_is_bit_equal_to_replicated(ranks, name):
    for rank in range(RANKS):
        result = ranks[rank][name]
        replicated, fsdp = result["losses"]
        assert fsdp == replicated, (rank, fsdp, replicated)
        differ = sorted(n for n, h in result["fsdp"].items() if result["replicated"][n] != h)
        assert not differ, (rank, differ)
    assert ranks[0][name]["fsdp"] == ranks[1][name]["fsdp"]


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_shards(ranks, name):
    from tricolo_tpu_torch.parallel import fsdp_axis

    shapes = ranks[0][name]["shapes"]
    want = {n: int(np.prod(s)) // RANKS for n, s in shapes.items()
            if fsdp_axis(s, RANKS, MIN_SIZE) is not None}
    assert want and len(want) < len(shapes)
    for rank in range(RANKS):
        assert ranks[rank][name]["leaves"] == want, rank
    mine, theirs = ranks[0][name]["local"], ranks[1][name]["local"]
    assert sorted(mine) == sorted(want)
    assert all(mine[n] != theirs[n] for n in want)


def test_bf16_parameters_and_moments_stay_bf16(ranks):
    for rank in range(RANKS):
        dtypes = ranks[rank]["bf16"]["dtypes"]
        assert dtypes == {"params": {torch.bfloat16}, "moments": {torch.bfloat16},
                          "stats": {torch.float32}}, rank
    assert ranks[0]["pjit"]["dtypes"]["moments"] == {torch.float32}


# ------------------------------------------------- the bf16 reduce-scatter

REDUCE_RANKS = 3
REDUCE_SHAPES = [(3072,), (64, 48)]  # sharded along axis 0, and along axis 1


class _Leaf(torch.nn.Module):
    """One bf16 leaf ``w``; the forward Σ w·x, whose gradient is x."""

    def __init__(self, shape):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(shape, dtype=torch.bfloat16))

    def forward(self, x):
        return (self.w * x).sum()


def _reduce_main(rank: int, port: str, workdir: Path) -> None:
    """One rank of three: its part of each seeded gradient through a
    sharded leaf's backward; the reduce-scattered gradient, gathered."""
    from tricolo_tpu_torch.parallel import shard_model
    from tricolo_tpu_torch.parallel.sharding_rules import gathered

    world = init_rank(rank, port, REDUCE_RANKS)
    out = []
    for parts in torch.load(workdir / "parts.pt"):
        leaf = shard_model(_Leaf(parts.shape[1:]), world, "fsdp", MIN_SIZE)
        leaf(parts[rank]).backward()
        out.append((gathered(leaf.w.grad), leaf.w.grad.to_local().shape))
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def test_three_gloo_ranks_reduce_scatter_bf16_gradients_as_jax(tmp_path):
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from test_torch_bf16_params import _bits
    from tricolo_tpu.parallel import batch_sharding
    from tricolo_tpu.parallel.sharding_rules import param_shardings

    rng = np.random.default_rng(7)
    parts = [np.asarray(jnp.asarray(rng.normal(size=(REDUCE_RANKS, *shape))
                                    * rng.choice([1e-3, 1.0, 30.0], size=(1, *shape)),
                                    jnp.bfloat16))
             for shape in REDUCE_SHAPES]
    torch.save([_bits(a) for a in parts], tmp_path / "parts.pt")
    ranks = spawn_ranks(__file__, tmp_path, ranks=REDUCE_RANKS, args=["reduce"])

    mesh = Mesh(np.asarray(jax.devices()[:REDUCE_RANKS]), ("data",))
    for i, a in enumerate(parts):
        w = jnp.zeros(a.shape[1:], jnp.bfloat16)
        w_sharding = param_shardings({"w": w}, mesh, "fsdp", min_size=MIN_SIZE)["w"]
        assert w_sharding.spec != jax.sharding.PartitionSpec()
        grad = jax.jit(jax.grad(lambda w, x: jnp.sum(w[None] * x)),  # bf16 compute
                       in_shardings=(w_sharding, batch_sharding(mesh)), out_shardings=w_sharding)
        want = _bits(np.asarray(grad(w, jax.device_put(a, batch_sharding(mesh)))))
        for rank, result in enumerate(ranks):
            got, local = result[i]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (i, rank)
            assert int(np.prod(local)) * REDUCE_RANKS == a[0].size
        each = _bits(a)  # a sum rounded to bf16 at each addition
        rounded = (each[0] + each[1]) + each[2]
        assert int((rounded.view(torch.int16) != want.view(torch.int16)).sum()) > 0, i


# ------------------------------------------------------------ the config


def test_fsdp_without_a_world_is_the_replicated_model():
    from torch.distributed.tensor import DTensor

    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.training import Trainer

    results = []
    for mode in ("replicated", "fsdp"):
        cfg = fsdp_cfg([f"parallel.param_sharding={mode}"], multiprocess=False)
        trainer = Trainer(cfg, device="cpu")
        assert trainer.world is None
        assert not any(isinstance(p, DTensor) for p in trainer.model.parameters())
        losses = trainer.train_step(to_device_batch(first_batch(cfg), CPU), cfg.optimizer.lr)
        results.append(({k: float(v) for k, v in losses.items()}, trainer.state()))
    (losses_r, state_r), (losses_f, state_f) = results
    assert losses_r == losses_f
    assert state_r["model"].keys() == state_f["model"].keys()
    assert all(torch.equal(v, state_f["model"][k]) for k, v in state_r["model"].items())


def test_unknown_param_sharding_raises():
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.parallel import World, shard_model
    from tricolo_tpu_torch.training import Trainer

    with pytest.raises(ValueError, match="unknown param sharding mode: zero3"):
        Trainer(fsdp_cfg(["parallel.param_sharding=zero3"], multiprocess=False), device="cpu")
    with pytest.raises(ValueError, match="unknown param sharding mode"):
        shard_model(TriCoLoNet.from_config(fsdp_cfg(multiprocess=False)), World(0, 1, None),
                    "sharded")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main = _reduce_main if sys.argv[4:] == ["reduce"] else _rank_main
    main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

"""Data parallel in the port, the collectives: the three contrastive loss
forms against the JAX package's ``make_global_nt_xent`` /
``make_local_nt_xent`` on a 2-device mesh, and BatchNorm over the global
batch, on two gloo ranks on the CPU; the config guards.

``spawn_ranks`` starts two processes running a test file as a script
(``python tests/<file> <rank> <port> <dir>``, one gloo world over
``tcp://127.0.0.1``); each rank runs its cases and saves what it computed,
which the tests hold against one process (``test_torch_parallel_train.py``
uses it for the train step and the fit). Here:

* the three loss forms on (16, 32) embeddings, 8 rows a rank: the loss and
  each rank's gradient slice against JAX on a 2-device mesh (the pjit form
  and the explicit form against ``make_global_nt_xent``, the local form
  against ``make_local_nt_xent``), and the pjit form against the port's
  single-process ``blocked_nt_xent_loss`` (plain versions) at B = 16;
* ``masked_bn_relu_pool_train`` (two masks), ``bn_relu_pool_train`` and
  the ResNet's ``BatchNorm2d``, each rank on half of a batch of 4, against
  one process on the whole batch: outputs, statistics, input gradients,
  and the ranks' summed dγ, dβ (each rank's own is its local sum).

Tolerances, f32, stated before the first run: the values differ only in
the order of f32 sums, so losses rtol 1e-5, everything else within 1e-5
of each tensor's largest magnitude.
"""

import copy
import hashlib
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if __name__ != "__main__":  # a spawned rank needs torch alone
    jax = pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
# test_torch_data.TINY, the tiny Tri(I+V) fixture's config, repeated here so
# that a rank imports no JAX.
TINY = [
    "data=synthetic",
    "model.image_encoder=MVCNNEncoder",
    "model.voxel_encoder=VoxelCNNEncoder",
    "data.batch_size=2",
    "data.num_models=5",
    "model.modules.VoxelCNNEncoder.ef_dim=8",
    "precision.compute_dtype=float32",
]
PORT = ["loss.NTXentLoss.use_pallas=true"]
FORMS = {"pjit": [], "explicit": ["parallel.explicit_collectives=true"],
         "local": ["parallel.global_negatives=false"]}
RANKS = 2
TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ two ranks


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def spawn_ranks(script: str, workdir: Path, timeout: float = 240.0, ranks: int = RANKS,
                args=()) -> list:
    """Run ``script`` as ``ranks`` gloo ranks (``script <rank> <port>
    <workdir> *args``); each saves ``rank<r>.pt`` in ``workdir``, which this
    returns loaded, rank order."""
    port = _free_port()
    logs = [open(workdir / f"rank{rank}.log", "w") for rank in range(ranks)]
    procs = [subprocess.Popen([sys.executable, script, str(rank), port, str(workdir), *args],
                              stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
             for rank, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            p.wait()
            log.close()
    for rank, p in enumerate(procs):
        text = (workdir / f"rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return [torch.load(workdir / f"rank{rank}.pt", weights_only=False)
            for rank in range(ranks)]


def init_rank(rank: int, port: str, ranks: int = RANKS):
    """This process's gloo rank of the ``ranks``-rank world: its ``World``."""
    import torch.distributed as dist

    from tricolo_tpu_torch.parallel import World

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ranks, rank=rank)
    return World(rank, ranks, dist.group.WORLD)


def torch_cfg(extra=()):
    """The port's config of the tiny fixture with ``extra``."""
    from tricolo_tpu_torch.config import load_config

    return load_config([*TINY, *extra])


def one_step(cfg, batch, model_state, optimizer_state=None, world=None, bn_group=None,
             lr=None, step=0) -> dict:
    """One train step of the port on a host batch from the given state (a
    fresh Adam without ``optimizer_state``): its ``snapshot``. ``world``:
    the rank's data-parallel world, the model ``attach``-ed to it;
    ``bn_group``: a process group every BatchNorm sums over (a one-rank
    group runs the ranks' BN algorithm in one process); ``step``: the
    global step the dropout masks are drawn for."""
    from tricolo_tpu_torch.inference import to_device_batch
    from tricolo_tpu_torch.models.resnet import BatchNorm2d
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.models.voxel_cnn import ConvBlock
    from tricolo_tpu_torch.parallel import attach
    from tricolo_tpu_torch.training import dropout_generator, make_optimizer, make_train_step

    model = TriCoLoNet.from_config(cfg)
    model.load_state_dict(model_state)
    if world is not None:
        attach(model, world)
    for module in model.modules():
        if bn_group is not None and isinstance(module, (BatchNorm2d, ConvBlock)):
            module.bn_group = bn_group
    optimizer = make_optimizer(cfg, model)
    if optimizer_state is not None:
        optimizer.load_state_dict(copy.deepcopy(optimizer_state))
    train_step = make_train_step(model, optimizer, cfg, world=world)
    losses = train_step(to_device_batch(batch, CPU), cfg.optimizer.lr if lr is None else lr,
                        dropout_generator(cfg.train_seed, step, CPU))
    return snapshot(model, optimizer, losses)


def snapshot(model, optimizer, losses: dict) -> dict:
    """Copies of what a train step left: its losses, every gradient, the
    buffers, Adam's moments and the updated parameters."""
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "moments": {n: {k: optimizer.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
                        for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def rel(got, ref) -> float:
    """max |got − ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _tensors(snap: dict) -> dict:
    """A ``snapshot``'s tensors by one flat name each."""
    out = {f"{kind}/{n}": t for kind in ("grads", "buffers", "params")
           for n, t in snap[kind].items()}
    out.update({f"{k}/{n}": m[k] for n, m in snap["moments"].items()
                for k in ("exp_avg", "exp_avg_sq")})
    return out


def digest(snap: dict) -> dict:
    """Each tensor of a ``snapshot`` by its bytes' SHA-256: equal digests
    are bit-equal tensors, at a fraction of the tensors' size."""
    return {name: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
            for name, t in _tensors(snap).items()}


def deviations(mine: dict, ref: dict) -> dict:
    """How far one ``snapshot`` of a step is from another: each loss as
    (mine, ref); each gradient's and Adam moment's max |Δ| of the
    reference's max (``rel``); each buffer's max |Δ|; the updated
    parameters' max |Δ| and the share of their elements more than 1e-6
    apart."""
    params = np.concatenate([(mine["params"][n] - p).abs().reshape(-1).numpy()
                             for n, p in ref["params"].items()])
    return {"losses": {k: (mine["losses"].get(k), v) for k, v in ref["losses"].items()},
            "grads": {n: rel(mine["grads"][n], g) for n, g in ref["grads"].items()},
            **{k: {n: rel(mine["moments"][n][k], m[k]) for n, m in ref["moments"].items()}
               for k in ("exp_avg", "exp_avg_sq")},
            "buffers": {n: float((mine["buffers"][n] - b).abs().max())
                        for n, b in ref["buffers"].items()},
            "params_max": float(params.max()), "params_over_1e6": float((params > 1e-6).mean())}


# ------------------------------------------------------------ both sides


def _embeddings():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(16, 32)).astype(np.float32),
            rng.normal(size=(16, 32)).astype(np.float32))


def _bn_inputs():
    rng = np.random.default_rng(5)
    y = rng.normal(0.3, 1.0, (4, 8, 8, 8, 8)).astype(np.float32)
    stats = (rng.random((4, 8, 8, 8, 1)) < 0.6).astype(np.float32)
    zero = np.maximum(stats, rng.random((4, 8, 8, 8, 1)) < 0.3).astype(np.float32)
    x2d = rng.normal(0.2, 1.5, (4, 8, 5, 5)).astype(np.float32)
    return {"y": y, "stats": stats, "zero": zero, "scale": rng.uniform(0.5, 1.5, 8),
            "bias": rng.normal(0.0, 0.2, 8), "g": rng.normal(size=(4, 4, 4, 4, 8)),
            "x2d": x2d, "g2d": rng.normal(size=x2d.shape)}


def _bn_ops(rows, group):
    """Each BN op on ``rows`` of the batch: its outputs and gradients."""
    from tricolo_tpu_torch.models.resnet import BatchNorm2d
    from tricolo_tpu_torch.ops import bn_relu_pool_train, masked_bn_relu_pool_train

    t = {k: torch.tensor(v[rows] if v.ndim > 1 else v, dtype=torch.float32)
         for k, v in _bn_inputs().items()}
    out = {}
    for name in ("masked", "unmasked"):
        y = t["y"].clone().requires_grad_(True)
        scale = t["scale"].clone().requires_grad_(True)
        bias = t["bias"].clone().requires_grad_(True)
        if name == "masked":
            pooled, mean, var, _ = masked_bn_relu_pool_train(
                y, scale, bias, t["stats"], t["zero"], use_kernels=False, group=group)
        else:
            pooled, mean, var = bn_relu_pool_train(y, scale, bias, use_kernels=False,
                                                   group=group)
        (pooled * t["g"]).sum().backward()
        out[name] = {"pooled": pooled, "mean": mean, "var": var, "dy": y.grad,
                     "dgamma": scale.grad, "dbeta": bias.grad}
    bn = BatchNorm2d(8).train()
    bn.bn_group = group
    with torch.no_grad():
        bn.weight.copy_(t["scale"])
        bn.bias.copy_(t["bias"])
    x = t["x2d"].clone().requires_grad_(True)
    y = bn(x)
    (y * t["g2d"]).sum().backward()
    out["resnet"] = {"pooled": y, "mean": bn.running_mean, "var": bn.running_var,
                     "dy": x.grad, "dgamma": bn.weight.grad, "dbeta": bn.bias.grad}
    return {op: {k: v.detach().clone() for k, v in vals.items()} for op, vals in out.items()}


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    from tricolo_tpu_torch.parallel import make_parallel_loss_fn

    world = init_rank(rank, port)
    out: dict = {}
    zis, zjs = _embeddings()
    local = slice(rank * 8, (rank + 1) * 8)
    for form, extra in FORMS.items():
        loss_fn = make_parallel_loss_fn(torch_cfg([*PORT, *extra]), world)
        a = torch.tensor(zis[local], requires_grad=True)
        b = torch.tensor(zjs[local], requires_grad=True)
        loss = loss_fn(a, b)
        loss.backward()
        out[f"nt/{form}"] = (loss.item(), a.grad.numpy(), b.grad.numpy())
    out["bn"] = _bn_ops(slice(rank * 2, (rank + 1) * 2), world.group)
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, tmp_path_factory.mktemp("collectives"))


def _cat(results, *path):
    parts = []
    for result in results:
        node = result
        for key in path:
            node = node[key]
        parts.append(np.asarray(node))
    return np.concatenate(parts)


# ------------------------------------------------------------- loss forms


def _jax_loss_and_grads(form):
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tricolo_tpu.parallel import make_global_nt_xent, make_local_nt_xent

    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    make = make_local_nt_xent if form == "local" else make_global_nt_xent
    loss_fn = jax.jit(jax.value_and_grad(make(mesh, 0.1, 0.25), argnums=(0, 1)))
    loss, grads = loss_fn(*(jnp.asarray(z) for z in _embeddings()))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", list(FORMS))
def test_loss_forms_match_jax_mesh(ranks, form):
    ref_loss, (ref_a, ref_b) = _jax_loss_and_grads(form)
    for rank in range(RANKS):
        loss, ga, gb = ranks[rank][f"nt/{form}"]
        np.testing.assert_allclose(loss, ref_loss, rtol=TOL)
        rows = slice(rank * 8, (rank + 1) * 8)
        assert rel(ga, ref_a[rows]) <= TOL and rel(gb, ref_b[rows]) <= TOL


def test_pjit_form_equals_single_process_blocked_loss(ranks):
    from tricolo_tpu_torch.ops import blocked_nt_xent_loss

    zis, zjs = (torch.tensor(z, requires_grad=True) for z in _embeddings())
    loss = blocked_nt_xent_loss(zis, zjs, 0.1, 0.25, use_kernels=False)
    loss.backward()
    for rank in range(RANKS):
        np.testing.assert_allclose(ranks[rank]["nt/pjit"][0], loss.item(), rtol=TOL)
    assert rel(_cat(ranks, "nt/pjit", 1), zis.grad) <= TOL
    assert rel(_cat(ranks, "nt/pjit", 2), zjs.grad) <= TOL


def test_all_gather_rows_takes_two_backwards():
    from tricolo_tpu_torch.parallel import World, all_gather_rows

    with pytest.raises(ValueError, match="slice"):
        all_gather_rows(torch.zeros(2), World(0, 1, None), "mean")


# ------------------------------------------------------------ global BN


@pytest.mark.parametrize("op", ["masked", "unmasked", "resnet"])
def test_global_batch_norm_matches_one_process(ranks, op):
    ref = _bn_ops(slice(None), None)[op]
    for key in ("pooled", "dy"):
        assert rel(_cat(ranks, "bn", op, key), ref[key]) <= TOL, key
    for rank in range(RANKS):
        for key in ("mean", "var"):
            assert rel(ranks[rank]["bn"][op][key], ref[key]) <= TOL, key
    for key in ("dgamma", "dbeta"):  # each rank's own sum; the ranks' sum is the total
        total = sum(np.asarray(ranks[r]["bn"][op][key], np.float64) for r in range(RANKS))
        assert rel(total, ref[key]) <= TOL, key
        assert rel(ranks[0]["bn"][op][key], ref[key]) > 1e-3, f"{key} is not rank 0's own"


def test_clip_dropout_masks_are_the_global_batch_rows():
    from tricolo_tpu_torch.models.common import dropout
    from tricolo_tpu_torch.training import dropout_generator

    x = torch.ones(6, 5)
    whole = dropout(x, 0.5, dropout_generator(3, 7, CPU))
    parts = [dropout(x[:3], 0.5, dropout_generator(3, 7, CPU), (rank, 2)) for rank in (0, 1)]
    assert torch.equal(torch.cat(parts), whole)


# -------------------------------------------------------- config guards


def test_data_parallel_without_multiprocess_raises():
    from tricolo_tpu_torch.training import Trainer

    with pytest.raises(NotImplementedError, match="parallel.multiprocess"):
        Trainer(torch_cfg([*PORT, "parallel.data_parallel=2"]), device="cpu")


def test_fsdp_raises():
    """A sharding mode other than replicated or fsdp raises ValueError, as
    the JAX ``param_shardings`` does; fsdp runs (``test_torch_fsdp.py``)."""
    from tricolo_tpu_torch.training import Trainer

    with pytest.raises(ValueError, match="unknown param sharding mode: fsdp2"):
        Trainer(torch_cfg([*PORT, "parallel.param_sharding=fsdp2"]), device="cpu")


def test_indivisible_global_batch_raises():
    from tricolo_tpu_torch.data.loader import BatchIterator
    from tricolo_tpu_torch.parallel import World, check_parallel_config

    with pytest.raises(ValueError, match="not divisible"):
        check_parallel_config(torch_cfg([*PORT, "data.batch_size=5"]), World(0, 2, None))
    with pytest.raises(ValueError, match="not divisible"):
        BatchIterator([], 5, drop_last=True, process_index=0, process_count=2)


def test_rank_triple_from_keys_then_torchrun(monkeypatch):
    from tricolo_tpu_torch.parallel import maybe_initialize
    from tricolo_tpu_torch.parallel.multiprocess import rank_triple

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    cfg = torch_cfg([*PORT, "parallel.multiprocess=true"])
    assert rank_triple(cfg) == (None, None, None)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert rank_triple(cfg) == ("127.0.0.1:29511", 2, 1)
    cfg.parallel.process_id = 0  # a key wins over the environment
    assert rank_triple(cfg) == ("127.0.0.1:29511", 2, 0)
    monkeypatch.delenv("RANK")
    cfg.parallel.process_id = None
    with pytest.raises(ValueError, match="rank triple"):
        maybe_initialize(cfg, CPU)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

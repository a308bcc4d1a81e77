"""Data parallel at bf16 parameters (``precision.param_dtype=bfloat16``):
one train step on two gloo ranks on the CPU against one process at the
same global batch (4, 2 a rank), the port on both sides at f32 compute,
from the port's seeded init of the tiny Tri(I+V) fixture
(``test_torch_parallel.spawn_ranks``, ``one_step``).

The gradient all-reduce (``parallel.all_reduce_gradients``) sums each
rank's bf16 gradient in f32 and rounds the total once, as the JAX package's
step does: XLA all-reduces the gradient of a bf16 leaf over the mesh in
f32. A bf16 sum would round again at each addition; at two ranks the two
coincide (one addition, one rounding), so a second test holds three ranks'
sum bit for bit against the JAX gradient of a bf16 leaf whose batch is
sharded over three CPU devices, on seeded bf16 parts for which a sum
rounded at each addition differs. What is left between the ranks and one
process is the rounding of each rank's part to bf16 before the sum, half a
bf16 ulp of that part each, which the parts' cancellation can make large
against the total. Tolerances, stated from that:

* each gradient element within 3e-4 of its tensor's max (the f32 tolerance
  of ``test_torch_parallel_train.py``) plus one bf16 ulp (2⁻⁷ relative) of
  the larger rank part's max |g| (each rank records its parts before the
  sum);
* updated parameters as ``test_torch_bf16_train.assert_updates_close``:
  each within one bf16 ulp, or within 2·lr and one ulp (Adam's first step
  moves by lr·g/(|g| + eps)); Adam's moments follow from the gradients
  bit for bit (``test_torch_bf16_adam.py``);
* per-pair losses rtol 1e-5, BN running statistics atol 1e-5; the two
  ranks bit-equal to each other; parameters and moments bf16.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    REPO,
    deviations,
    digest,
    init_rank,
    one_step,
    spawn_ranks,
)
from test_torch_parallel import torch_cfg as parallel_cfg  # noqa: E402

if __name__ != "__main__":  # a spawned rank needs torch alone
    pytest.importorskip("jax")
    from test_torch_bf16_train import assert_updates_close  # noqa: E402

DP = ["precision.param_dtype=bfloat16", "loss.NTXentLoss.use_pallas=true",
      "data.batch_size=4"]
DP_F32_TOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _dp_cfg(multiprocess=False):
    return parallel_cfg([*DP, *(["parallel.multiprocess=true"] if multiprocess else [])])


def _first_batch(cfg):
    from tricolo_tpu_torch.data import DataModule

    dm = DataModule(cfg)
    dm.setup("fit")
    return dm.train_loader().peek()


def _dp_state(cfg):
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    torch.manual_seed(cfg.train_seed)
    return TriCoLoNet.from_config(cfg).state_dict()


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    from tricolo_tpu_torch.training import steps

    world = init_rank(rank, port)
    cfg = _dp_cfg(multiprocess=True)
    reduce, parts = steps.all_reduce_gradients, []

    def recorded(params, world):  # each local gradient's max |g| before the sum
        parts.extend(float(p.grad.float().abs().max()) for p in params)
        reduce(params, world)

    steps.all_reduce_gradients = recorded
    snap = one_step(cfg, _first_batch(cfg), _dp_state(cfg), world=world)
    out = {"snap": snap if rank == 0 else digest(_with_bits(snap)),
           "parts": dict(zip(snap["grads"], parts))}
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _map_bf16(node, fn):
    if isinstance(node, dict):
        return {k: _map_bf16(v, fn) for k, v in node.items()}
    if isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16:
        return fn(node)
    return node


def _with_bits(snap: dict) -> dict:
    """A ``snapshot`` whose bf16 tensors are their int16 bits (``digest``
    hashes numpy bytes, which bf16 tensors cannot give)."""
    return _map_bf16(snap, lambda t: t.view(torch.int16))


def _as_f32(snap: dict) -> dict:
    """A ``snapshot`` whose bf16 tensors are widened to f32 (exactly)."""
    return _map_bf16(snap, lambda t: t.float())


def test_two_gloo_ranks_equal_one_process(tmp_path):
    ranks = spawn_ranks(__file__, tmp_path)
    cfg = _dp_cfg()
    ref = one_step(cfg, _first_batch(cfg), _dp_state(cfg))
    mine = ranks[0]["snap"]
    assert digest(_with_bits(mine)) == ranks[1]["snap"]
    assert {p.dtype for p in mine["params"].values()} == {torch.bfloat16}
    assert {m["exp_avg_sq"].dtype for m in mine["moments"].values()} == {torch.bfloat16}
    dev = deviations(_as_f32(mine), _as_f32(ref))
    for key, (got, want) in dev["losses"].items():
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    eps = torch.finfo(torch.bfloat16).eps
    for name, want in ref["grads"].items():
        part = max(ranks[0]["parts"][name], ranks[1]["parts"][name])
        bound = DP_F32_TOL * float(want.float().abs().max()) + eps * part
        gap = float((mine["grads"][name].float() - want.float()).abs().max())
        assert gap <= bound, (name, gap, bound)
    assert all(d <= 1e-5 for d in dev["buffers"].values()), dev["buffers"]
    assert_updates_close(mine["params"], ref["params"], cfg.optimizer.lr)


REDUCE_RANKS = 3


def _reduce_main(rank: int, port: str, workdir: Path) -> None:
    """One rank of three: its part of each seeded gradient through
    ``all_reduce_gradients``."""
    from tricolo_tpu_torch.parallel.collectives import all_reduce_gradients

    world = init_rank(rank, port, REDUCE_RANKS)
    params = []
    for parts in torch.load(workdir / "parts.pt"):
        p = torch.zeros(parts.shape[1:], dtype=torch.bfloat16, requires_grad=True)
        p.grad = parts[rank].clone()
        params.append(p)
    all_reduce_gradients(params, world)
    torch.save([p.grad for p in params], workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def test_three_gloo_ranks_reduce_bf16_gradients_as_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from test_torch_bf16_params import _bits
    from tricolo_tpu.parallel import batch_sharding, make_mesh, replicated_sharding

    rng = np.random.default_rng(7)
    parts = [np.asarray(jnp.asarray(rng.normal(size=(REDUCE_RANKS, *shape))
                                    * rng.choice([1e-3, 1.0, 30.0], size=(1, *shape)),
                                    jnp.bfloat16))
             for shape in [(4096,), (64, 48)]]
    torch.save([_bits(a) for a in parts], tmp_path / "parts.pt")
    ranks = spawn_ranks(__file__, tmp_path, ranks=REDUCE_RANKS, args=["reduce"])

    mesh = make_mesh(REDUCE_RANKS)
    grad = jax.jit(jax.grad(lambda w, x: jnp.sum(w[None] * x)),  # bf16 compute
                   in_shardings=(replicated_sharding(mesh), batch_sharding(mesh)))
    for i, a in enumerate(parts):
        want = _bits(np.asarray(grad(jnp.zeros(a.shape[1:], jnp.bfloat16),
                                     jax.device_put(a, batch_sharding(mesh)))))
        for rank, got in enumerate(ranks):
            assert got[i].dtype == torch.bfloat16
            assert torch.equal(got[i].view(torch.int16), want.view(torch.int16)), (i, rank)
        each = _bits(a)  # a sum rounded to bf16 at each addition
        rounded = (each[0] + each[1]) + each[2]
        assert int((rounded.view(torch.int16) != want.view(torch.int16)).sum()) > 0, i


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main = _reduce_main if sys.argv[4:] == ["reduce"] else _rank_main
    main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

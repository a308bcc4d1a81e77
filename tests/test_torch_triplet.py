"""The semi-hard triplet loss of the port (``losses/triplet.py``) against
the JAX package's ``triplet_loss`` and the reference's double loop, and its
data-parallel form on two gloo ranks against one process.

* Loss and gradient on seeded (10, 8) unit embeddings at margins 0.025 and
  0.2, on an all-hard batch (zls = −zis: every d_ij < d_ii = 2) and an
  all-empty one (zis = zls = one-hot rows: d_ii = 0, the masked square root
  at 0, d_ij = √2): against JAX ``triplet_loss`` (value and ``jax.grad``),
  the reference's loop (``tests/test_losses.py::_loop_triplet``, numpy) and
  a literal double loop in torch for the gradient. The selection is
  discontinuous where d_ij = d_ii or d_ij = d_ii + margin, so each case
  first asserts that its inputs keep every off-diagonal d_ij at least 1e-4
  from both: a precondition of the comparison, checked, not a seed picked.
* ``loss.name=TripletLoss`` under the three ``parallel.*`` settings: the
  ranks' loss and their gradient stripes equal the single-process loss on
  the whole (16, 32) batch of raw (not normalised) rows.

Tolerances, f32, stated before the first run: losses rtol 1e-5 or 1e-6
absolute (the loss is a mean of differences of distances up to 2, which
f32 resolves to ~2.4e-7); gradients within 1e-5 of their largest
magnitude.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import FORMS, RANKS, init_rank, rel, spawn_ranks  # noqa: E402

if __name__ != "__main__":  # a spawned rank needs torch alone
    jax = pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
TRIPLET = ["loss.name=TripletLoss"]
SEPARATION = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5


def _unit(rng, shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _case(name):
    if name == "all_hard":
        zis = _unit(np.random.default_rng(3), (10, 8))
        return zis, -zis
    if name == "all_empty":
        eye = np.eye(8, dtype=np.float32)
        return eye, eye.copy()
    rng = np.random.default_rng(2)
    return _unit(rng, (10, 8)), _unit(rng, (10, 8))


CASES = [("random", 0.025), ("random", 0.2), ("all_hard", 0.025), ("all_empty", 0.025)]


def assert_separated(zis, zls, margin) -> None:
    """Every off-diagonal d_ij at least ``SEPARATION`` from d_ii and from
    d_ii + margin (the reference's distances, float64)."""
    from tricolo_tpu_torch.losses import pairwise_distances

    d = pairwise_distances(torch.tensor(zis, dtype=torch.float64),
                           torch.tensor(zls, dtype=torch.float64)).numpy()
    d_pos = np.diag(d)[:, None]
    off = ~np.eye(len(d), dtype=bool)
    gap = np.minimum(np.abs(d - d_pos), np.abs(d - d_pos - margin))[off]
    assert gap.min() >= SEPARATION, f"inputs within {gap.min()} of a selection boundary"


def _torch_loop(zis, zls, margin):
    """The reference's double loop (triplet.py:103-125) on torch tensors,
    differentiable: the gradient's oracle."""
    from tricolo_tpu_torch.losses import pairwise_distances

    d = pairwise_distances(zis, zls)
    batch = d.shape[0]
    terms = [d[i, i] - d[i, j] + margin for i in range(batch) for j in range(batch)
             if i != j and d[i, i] < d[i, j] < d[i, i] + margin]
    if not terms:
        terms = [d[i, i] - d[i, j] + margin for i in range(batch) for j in range(batch)
                 if i != j and d[i, j] < d[i, i]]
    return sum(terms) / len(terms) if terms else (zis * 0).sum() + (zls * 0).sum()


@pytest.mark.parametrize("name,margin", CASES)
def test_triplet_matches_jax_and_the_loop(name, margin):
    import jax.numpy as jnp
    from test_losses import _loop_triplet

    from tricolo_tpu.losses import triplet_loss as jax_triplet
    from tricolo_tpu_torch.losses import triplet_loss

    zis, zls = _case(name)
    assert_separated(zis, zls, margin)
    ref, (ref_a, ref_b) = jax.value_and_grad(jax_triplet, argnums=(0, 1))(
        jnp.asarray(zis), jnp.asarray(zls), margin)
    a, b = (torch.tensor(z, requires_grad=True) for z in (zis, zls))
    loss = triplet_loss(a, b, margin)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(loss.item(), _loop_triplet(zis, zls, margin), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    loop_a, loop_b = (torch.tensor(z, requires_grad=True) for z in (zis, zls))
    _torch_loop(loop_a, loop_b, margin).backward()
    for got, jax_grad, loop_grad in ((a.grad, ref_a, loop_a.grad), (b.grad, ref_b, loop_b.grad)):
        assert rel(got, jax_grad) <= GRAD_TOL and rel(got, loop_grad) <= GRAD_TOL
    if name == "all_empty":
        assert loss.item() == 0.0 and not a.grad.any() and not b.grad.any()
    if name == "all_hard":
        assert loss.item() > margin  # hard terms: d_ii − d_ij + margin > margin


def test_make_loss_fn_dispatches_the_triplet_loss():
    from test_torch_data import torch_cfg

    from tricolo_tpu_torch.losses import make_loss_fn, triplet_loss

    zis, zls = (torch.tensor(z) for z in _case("random"))
    cfg = torch_cfg([*TRIPLET, "loss.TripletLoss.margin=0.2"])
    want = triplet_loss(zis, zls, 0.2)
    # use_kernels and norm do not apply to the triplet loss.
    for kwargs in ({}, {"use_kernels": False}, {"norm": False}):
        assert torch.equal(make_loss_fn(cfg, **kwargs)(zis, zls), want)
    with pytest.raises(ValueError, match="unknown loss"):
        make_loss_fn(torch_cfg(["loss.name=CosineLoss"]))
    from tricolo_tpu_torch.parallel import World, make_parallel_loss_fn

    for extra in ([], ["parallel.explicit_collectives=true"],
                  ["parallel.global_negatives=false"]):
        with pytest.raises(ValueError, match="unknown loss"):
            make_parallel_loss_fn(torch_cfg(["loss.name=CosineLoss", *extra]), World(0, 1, None))


# ------------------------------------------------------------ two ranks


def _raw_rows():
    rng = np.random.default_rng(13)
    return (rng.normal(size=(16, 32)).astype(np.float32),
            rng.normal(1.0, 2.0, size=(16, 32)).astype(np.float32))


def _rank_main(rank: int, port: str, workdir: Path) -> None:
    from test_torch_parallel import torch_cfg

    from tricolo_tpu_torch.parallel import make_parallel_loss_fn

    world = init_rank(rank, port)
    out = {}
    zis, zjs = _raw_rows()
    rows = slice(rank * 8, (rank + 1) * 8)
    for form, extra in FORMS.items():
        loss_fn = make_parallel_loss_fn(torch_cfg([*TRIPLET, *extra]), world)
        a = torch.tensor(zis[rows], requires_grad=True)
        b = torch.tensor(zjs[rows], requires_grad=True)
        loss = loss_fn(a, b)
        loss.backward()
        out[form] = (loss.item(), a.grad.numpy(), b.grad.numpy())
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, tmp_path_factory.mktemp("triplet"))


@pytest.mark.parametrize("form", list(FORMS))
def test_parallel_triplet_equals_one_process(ranks, form):
    """Every ``parallel.*`` form is the triplet loss of the global batch on
    the raw rows, as the JAX package computes it under pjit."""
    from tricolo_tpu_torch.losses import triplet_loss

    zis, zjs = _raw_rows()
    assert_separated(zis, zjs, 0.025)
    a, b = (torch.tensor(z, requires_grad=True) for z in (zis, zjs))
    loss = triplet_loss(a, b, 0.025)
    loss.backward()
    for rank in range(RANKS):
        np.testing.assert_allclose(ranks[rank][form][0], loss.item(), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    got_a = np.concatenate([ranks[r][form][1] for r in range(RANKS)])
    got_b = np.concatenate([ranks[r][form][2] for r in range(RANKS)])
    assert rel(got_a, a.grad) <= GRAD_TOL and rel(got_b, b.grad) <= GRAD_TOL


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

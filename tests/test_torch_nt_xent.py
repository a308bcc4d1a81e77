"""The blocked NT-Xent (K4-K6) against the JAX package: the kernels' plain
versions against the Pallas ``_direction_fwd`` / ``_direction_bwd`` /
``_direction_bwd_cols`` in interpret mode (the pair forward against the
JAX ``_fwd``'s two directions, the two-term backward against the sum of the
last two, as the JAX ``_bwd`` forms it), and the autograd
loss against ``pallas_nt_xent_loss(..., interpret=True)`` with
``jax.grad`` and against the plain ``nt_xent_loss``. On the CPU the
wrappers run the plain versions; the CUDA kernels are held against those
in ``test_torch_kernels.py`` and by ``chip_smoke.py``.

Tolerance: rtol 1e-5 (f32; the logits' dot products and the logsumexp sums
run in another order in the Pallas kernels, XLA and PyTorch).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tricolo_tpu_torch.ops import nt_xent as ours  # noqa: E402

TAU, ALPHA = 0.1, 0.25
RTOL = 1e-5


def teardown_module(module):
    # Interpret-mode pallas_call state: clear it as the repo's Pallas test
    # modules do.
    jax.clear_caches()


def _embeddings(B, D, seed, normed=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, B, D)).astype(np.float32)
    if normed:
        z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return z[0], z[1]


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()) * 1e-2)


def test_plain_fwd_matches_pallas_direction_fwd():
    from tricolo_tpu.ops.nt_xent_pallas import _direction_fwd

    zi, zj = _embeddings(16, 128, 0)
    loss_ref, lse_ref = _direction_fwd(zi, zj, 1 / TAU, 8, True)
    out = ours.nt_xent_fwd(torch.from_numpy(zi), torch.from_numpy(zj), 1 / TAU)
    assert out.shape == (16, 2)
    _close(out[:, 1].numpy(), np.asarray(lse_ref)[:, 0])
    _close((out[:, 1] - out[:, 0]).mean().item(), float(loss_ref))
    logits = zi @ zj.T / TAU
    _close(out[:, 0].numpy(), np.diagonal(logits))


@pytest.mark.parametrize("D", [128, 512])
@pytest.mark.parametrize("B", [16, 64])
def test_plain_fwd_pair_matches_pallas_fwd(B, D):
    """The pair forward's plain version (and the CPU wrapper) against the
    JAX ``_fwd``: column 1 is direction a's logsumexps, column 2 direction
    b's (the column logsumexps of a's logits), and the loss built from them
    as ``_BlockedNTXent`` builds it."""
    from tricolo_tpu.ops.nt_xent_pallas import _fwd

    zi, zj = _embeddings(B, D, 10 + B + D)
    loss_ref, (_, _, lse_a, lse_b) = _fwd(zi, zj, TAU, ALPHA, 8, True)
    zi_t, zj_t = torch.from_numpy(zi), torch.from_numpy(zj)
    out = ours.nt_xent_fwd_pair_plain(zi_t, zj_t, 1 / TAU)
    assert out.shape == (B, 3)
    assert torch.equal(ours.nt_xent_fwd_pair(zi_t, zj_t, 1 / TAU), out)
    _close(out[:, 1].numpy(), np.asarray(lse_a)[:, 0])
    _close(out[:, 2].numpy(), np.asarray(lse_b)[:, 0])
    _close(out[:, 0].numpy(), np.diagonal(zi @ zj.T / TAU))
    loss = (ALPHA * (out[:, 1] - out[:, 0]).mean()
            + (1 - ALPHA) * (out[:, 2] - out[:, 0]).mean())
    _close(loss.item(), float(loss_ref))
    assert torch.equal(ours.blocked_nt_xent_loss(zi_t, zj_t, TAU, ALPHA, norm=False), loss)


@pytest.mark.parametrize("ct", [1.0, -0.7])
def test_plain_bwd_rows_and_cols_match_pallas(ct):
    from tricolo_tpu.ops.nt_xent_pallas import (
        _direction_bwd,
        _direction_bwd_cols,
        _direction_fwd,
    )

    zi, zj = _embeddings(16, 128, 1)
    B = zi.shape[0]
    _, lse = _direction_fwd(zi, zj, 1 / TAU, 8, True)
    rows_ref = _direction_bwd(zi, zj, lse, ct, 1 / TAU, 8, True)
    cols_ref = _direction_bwd_cols(zj, zi, lse, ct, 1 / TAU, 8, True)
    lse_t = torch.from_numpy(np.asarray(lse)[:, 0].copy())
    scale = torch.tensor([ct / TAU / B], dtype=torch.float32)
    zi_t, zj_t = torch.from_numpy(zi), torch.from_numpy(zj)
    _close(ours.nt_xent_bwd_rows(zi_t, zj_t, lse_t, scale, 1 / TAU).numpy(), rows_ref)
    _close(ours.nt_xent_bwd_cols(zj_t, zi_t, lse_t, scale, 1 / TAU).numpy(), cols_ref)


@pytest.mark.parametrize("ct", [1.0, -0.7])
@pytest.mark.parametrize("operand", ["zis", "zjs"])
def test_plain_two_term_bwd_matches_pallas_composition(operand, ct):
    """``nt_xent_bwd_plain`` (and the CPU wrapper) equal the JAX ``_bwd``'s
    two terms of one operand: ``_direction_bwd`` of its own direction plus
    ``_direction_bwd_cols`` of the other, for d_zis and for d_zjs."""
    from tricolo_tpu.ops.nt_xent_pallas import (
        _direction_bwd,
        _direction_bwd_cols,
        _direction_fwd,
    )

    zis, zjs = _embeddings(16, 128, 5)
    B = zis.shape[0]
    _, lse_a = _direction_fwd(zis, zjs, 1 / TAU, 8, True)
    _, lse_b = _direction_fwd(zjs, zis, 1 / TAU, 8, True)
    ct_a, ct_b = ct * ALPHA, ct * (1 - ALPHA)
    if operand == "zis":
        own, oth, lse_row, lse_col, ct_row, ct_col = zis, zjs, lse_a, lse_b, ct_a, ct_b
    else:
        own, oth, lse_row, lse_col, ct_row, ct_col = zjs, zis, lse_b, lse_a, ct_b, ct_a
    ref = (_direction_bwd(own, oth, lse_row, ct_row, 1 / TAU, 8, True)
           + _direction_bwd_cols(own, oth, lse_col, ct_col, 1 / TAU, 8, True))
    args = (torch.from_numpy(own), torch.from_numpy(oth),
            torch.from_numpy(np.asarray(lse_row)[:, 0].copy()),
            torch.from_numpy(np.asarray(lse_col)[:, 0].copy()),
            torch.tensor([ct_row / TAU / B, ct_col / TAU / B], dtype=torch.float32), 1 / TAU)
    _close(ours.nt_xent_bwd_plain(*args).numpy(), ref)
    assert torch.equal(ours.nt_xent_bwd(*args), ours.nt_xent_bwd_plain(*args))


@pytest.mark.parametrize("term", ["rows", "cols"])
def test_zero_scale_reduces_two_term_bwd_to_one(term):
    """A zero scale switches a term off: the two-term backward is then K5's
    or K6's plain version alone, exactly."""
    zi, zj = (torch.from_numpy(z) for z in _embeddings(12, 64, 6))
    lse_row = ours.nt_xent_fwd_plain(zi, zj, 1 / TAU)[:, 1].contiguous()
    lse_col = ours.nt_xent_fwd_plain(zj, zi, 1 / TAU)[:, 1].contiguous()
    s = torch.tensor([0.3], dtype=torch.float32)
    zero = torch.zeros(1)
    if term == "rows":
        got = ours.nt_xent_bwd_plain(zi, zj, lse_row, lse_col, torch.cat([s, zero]), 1 / TAU)
        want = ours.nt_xent_bwd_rows_plain(zi, zj, lse_row, s, 1 / TAU)
    else:
        got = ours.nt_xent_bwd_plain(zi, zj, lse_row, lse_col, torch.cat([zero, s]), 1 / TAU)
        want = ours.nt_xent_bwd_cols_plain(zi, zj, lse_col, s, 1 / TAU)
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_cpu_backward_is_the_four_term_composition(use_kernels):
    """On the CPU the loss's backward (two two-term calls) gives bit for bit
    the four single-term plain calls it replaced: d_zis = rows(zis, zjs,
    lse_a) + cols(zis, zjs, lse_b), d_zjs = cols(zjs, zis, lse_a) +
    rows(zjs, zis, lse_b), with the logsumexps the forward saved (the pair
    forward's row and column logsumexps)."""
    zis, zjs = (torch.from_numpy(z) for z in _embeddings(20, 64, 7))
    a, b = zis.clone().requires_grad_(), zjs.clone().requires_grad_()
    ours.blocked_nt_xent_loss(a, b, TAU, ALPHA, norm=False, use_kernels=use_kernels).backward()
    out = ours.nt_xent_fwd_pair_plain(zis, zjs, 1 / TAU)
    lse_a, lse_b = out[:, 1].contiguous(), out[:, 2].contiguous()
    ct = torch.ones(1)
    s_a, s_b = ct * ALPHA * (1 / TAU) / 20, ct * (1.0 - ALPHA) * (1 / TAU) / 20
    d_zis = (ours.nt_xent_bwd_rows_plain(zis, zjs, lse_a, s_a, 1 / TAU)
             + ours.nt_xent_bwd_cols_plain(zis, zjs, lse_b, s_b, 1 / TAU))
    d_zjs = (ours.nt_xent_bwd_cols_plain(zjs, zis, lse_a, s_a, 1 / TAU)
             + ours.nt_xent_bwd_rows_plain(zjs, zis, lse_b, s_b, 1 / TAU))
    assert torch.equal(a.grad, d_zis) and torch.equal(b.grad, d_zjs)


@pytest.mark.parametrize("B,D", [(16, 128), (32, 64)])
def test_loss_and_grads_match_pallas_and_plain(B, D):
    import jax.numpy as jnp

    from tricolo_tpu.losses import nt_xent_loss as jax_plain
    from tricolo_tpu.ops.nt_xent_pallas import pallas_nt_xent_loss
    from tricolo_tpu_torch.losses import nt_xent_loss as torch_plain

    a, b = _embeddings(B, D, 2, normed=False)  # the loss normalises
    pallas = jax.value_and_grad(
        lambda x, y: pallas_nt_xent_loss(x, y, TAU, ALPHA, interpret=True), argnums=(0, 1)
    )
    loss_ref, grads_ref = pallas(jnp.asarray(a), jnp.asarray(b))
    plain_ref = jax_plain(jnp.asarray(a), jnp.asarray(b), TAU, ALPHA)
    _close(float(plain_ref), float(loss_ref))

    at, bt = (torch.tensor(x, requires_grad=True) for x in (a, b))
    loss = ours.blocked_nt_xent_loss(at, bt, TAU, ALPHA)
    loss.backward()
    _close(loss.item(), float(loss_ref))
    _close(at.grad.numpy(), grads_ref[0])
    _close(bt.grad.numpy(), grads_ref[1])

    a2, b2 = (torch.tensor(x, requires_grad=True) for x in (a, b))
    plain = torch_plain(a2, b2, TAU, ALPHA)
    plain.backward()
    _close(plain.item(), float(loss_ref))
    _close(a2.grad.numpy(), grads_ref[0])
    _close(b2.grad.numpy(), grads_ref[1])


def test_ragged_batch_plain_matches_plain_loss():
    """Any B (the kernels mask their ragged edge; the plain versions have
    none): the blocked loss equals the plain loss at B = 20."""
    from tricolo_tpu_torch.losses import nt_xent_loss as torch_plain

    a, b = _embeddings(20, 64, 3, normed=False)
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    ours.blocked_nt_xent_loss(ta, tb, TAU, ALPHA).backward()
    pa, pb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    ref = torch_plain(pa, pb, TAU, ALPHA)
    ref.backward()
    loss = ours.blocked_nt_xent_loss(torch.from_numpy(a), torch.from_numpy(b), TAU, ALPHA)
    _close(loss.item(), ref.item())
    _close(ta.grad.numpy(), pa.grad.numpy())
    _close(tb.grad.numpy(), pb.grad.numpy())


def test_make_loss_fn_honours_use_pallas(monkeypatch):
    import jax.numpy as jnp

    from test_torch_data import jax_cfg, torch_cfg
    from tricolo_tpu.losses import make_loss_fn as jax_make
    from tricolo_tpu_torch.losses import make_loss_fn

    calls = []
    blocked_loss = ours.blocked_nt_xent_loss
    monkeypatch.setattr(ours, "blocked_nt_xent_loss",
                        lambda *a, **k: calls.append(k) or blocked_loss(*a, **k))
    a, b = _embeddings(8, 64, 4, normed=False)
    ref = float(jax_make(jax_cfg())(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(make_loss_fn(torch_cfg())(ta, tb).item(), ref)
    assert calls == []
    blocked = make_loss_fn(torch_cfg(["loss.NTXentLoss.use_pallas=true"]))
    _close(blocked(ta, tb).item(), ref)
    assert calls == [{"use_kernels": True}]

"""The port's Adam (``training/optim.py``) against the JAX package's step:
``tricolo_tpu.training.optim.make_optimizer`` (optax
``add_decayed_weights(wd) → scale_by_adam(0.9, 0.999, 1e-8)``) and the
update line of ``tricolo_tpu/training/steps.py``,
``(p − lr·u).astype(p.dtype)``, jitted with ``lr`` a traced argument as the
JAX train step takes it.

A seeded tree of leaves of several shapes takes five steps of seeded
gradients whose magnitudes span four decades:

* bf16 leaves: the parameters and both moments **bit-exact** after every
  step, with and without weight decay (JAX rounds every weakly typed scalar
  and every operation to bf16; the port repeats that order);
* f32 leaves: ``torch.optim.Adam``'s step bit for bit (the port's f32
  path, unchanged), which lies within today's f32 tolerance of the
  train-step tests (``test_torch_train_steps.py``: 1e-6 on the updated
  parameters) of the JAX step, moments within 1e-6 of their largest
  magnitude (the two round in other places: a few f32 ulps).

Also: in bf16, b2 = 0.999 rounds to 1.0, so the second moment does not
decay (a zero gradient leaves ν as it was), in both packages; and the
state keeps ``torch.optim.Adam``'s names, so checkpoints and resume see
the state they saw.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

SHAPES = {"conv": (3, 3, 3, 4, 8), "dense": (64, 33), "bias": (33,), "gru": (2, 96)}
LR = 3.5e-4
STEPS = 5


def _jax_cfg(weight_decay):
    from tricolo_tpu.config import load_config

    return load_config(["data=synthetic", f"optimizer.weight_decay={weight_decay}"])


def _to_torch(array) -> torch.Tensor:
    from tricolo_tpu_torch.convert import _tensor

    return _tensor(np.asarray(array))


def _tree(rng, dtype, scale=1.0):
    import jax.numpy as jnp

    return {name: jnp.asarray(rng.normal(size=shape) * scale * 10 ** rng.uniform(-4, 0),
                              dtype)
            for name, shape in SHAPES.items()}


def _run(dtype_name, weight_decay, seed=0):
    """(JAX params, mu, nu, count) and the port's parameters and optimizer
    after each of ``STEPS`` steps from one seeded tree."""
    import jax.numpy as jnp

    from tricolo_tpu.training.optim import make_optimizer
    from tricolo_tpu_torch.training.optim import Adam

    dtype = getattr(jnp, dtype_name)
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype)
    tx = make_optimizer(_jax_cfg(weight_decay))
    state = tx.init(params)

    @jax.jit
    def step(params, state, grads, lr):  # tricolo_tpu/training/steps.py's update
        updates, state = tx.update(grads, state, params)
        return jax.tree.map(lambda p, u: (p - lr * u).astype(p.dtype), params, updates), state

    port = {name: torch.nn.Parameter(_to_torch(value)) for name, value in params.items()}
    optimizer = Adam(list(port.values()), lr=LR, weight_decay=weight_decay)
    for _ in range(STEPS):
        grads = _tree(rng, dtype)
        params, state = step(params, state, grads, LR)
        for name, p in port.items():
            p.grad = _to_torch(grads[name])
        optimizer.step()
        adam = state[-1]
        yield params, adam.mu, adam.nu, int(adam.count), port, optimizer


def _same_bits(got: torch.Tensor, ref) -> bool:
    return got.view(torch.int16).numpy().tobytes() == np.asarray(ref).view(np.int16).tobytes()


@pytest.mark.parametrize("weight_decay", [1e-6, 0.0])
def test_bf16_steps_are_bit_exact(weight_decay):
    for i, (params, mu, nu, count, port, optimizer) in enumerate(_run("bfloat16", weight_decay)):
        for name, p in port.items():
            state = optimizer.state[p]
            assert p.dtype == state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.bfloat16
            assert _same_bits(p.detach(), params[name]), (i, name)
            assert _same_bits(state["exp_avg"], mu[name]), (i, name)
            assert _same_bits(state["exp_avg_sq"], nu[name]), (i, name)
            assert int(state["step"]) == count == i + 1


def test_f32_steps_within_the_f32_tolerance():
    for i, (params, mu, nu, count, port, optimizer) in enumerate(_run("float32", 1e-6)):
        for name, p in port.items():
            state = optimizer.state[p]
            np.testing.assert_allclose(p.detach().numpy(), params[name], rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")
            for key, ref in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
                ref = np.asarray(ref)
                np.testing.assert_allclose(state[key].numpy(), ref, rtol=0,
                                           atol=1e-6 * np.abs(ref).max(),
                                           err_msg=f"step {i} {name} {key}")
            assert int(state["step"]) == count == i + 1


def test_f32_steps_are_torch_adams_bit_for_bit():
    """A tree of f32 and bf16 leaves: the f32 leaves take exactly the
    steps ``torch.optim.Adam`` takes."""
    from tricolo_tpu_torch.training.optim import Adam

    rng = np.random.default_rng(1)
    values = {name: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for name, shape in SHAPES.items()}
    ours = {name: torch.nn.Parameter(v.clone()) for name, v in values.items()}
    ours["bf16"] = torch.nn.Parameter(torch.ones(7, dtype=torch.bfloat16))
    ref = {name: torch.nn.Parameter(v.clone()) for name, v in values.items()}
    optimizer = Adam(list(ours.values()), lr=LR, weight_decay=1e-6)
    torch_adam = torch.optim.Adam(list(ref.values()), lr=LR, weight_decay=1e-6)
    for _ in range(STEPS):
        for name in SHAPES:
            grad = torch.from_numpy(rng.normal(size=SHAPES[name]).astype(np.float32))
            ours[name].grad, ref[name].grad = grad.clone(), grad.clone()
        ours["bf16"].grad = torch.ones(7, dtype=torch.bfloat16)
        optimizer.step()
        torch_adam.step()
        for name in SHAPES:
            assert torch.equal(ours[name], ref[name]), name
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(optimizer.state[ours[name]][key],
                                   torch_adam.state[ref[name]][key]), (name, key)


def test_bf16_second_moment_does_not_decay():
    """b2 = 0.999 is 1.0 in bf16: after a step with a zero gradient ν is
    unchanged, in the JAX package and in the port (and μ decays)."""
    import jax.numpy as jnp
    import optax

    from tricolo_tpu_torch.training.optim import Adam

    tx = optax.scale_by_adam(0.9, 0.999, 1e-8)
    p = jnp.ones(4, jnp.bfloat16)
    g = jnp.asarray([0.5, -2.0, 3e-3, 7.0], jnp.bfloat16)
    state = tx.init(p)
    _, state = tx.update(g, state, p)
    nu1, mu1 = np.asarray(state.nu), np.asarray(state.mu)
    _, state = tx.update(jnp.zeros_like(g), state, p)
    assert np.asarray(state.nu).tobytes() == nu1.tobytes()
    assert not np.array_equal(np.asarray(state.mu), mu1)

    leaf = torch.nn.Parameter(_to_torch(p))
    optimizer = Adam([leaf], lr=LR)
    for grad in (g, jnp.zeros_like(g)):
        leaf.grad = _to_torch(grad)
        optimizer.step()
    assert _same_bits(optimizer.state[leaf]["exp_avg_sq"], nu1)
    assert _same_bits(optimizer.state[leaf]["exp_avg"], state.mu)


def test_state_dict_has_torch_adams_layout():
    from tricolo_tpu_torch.training.optim import Adam

    leaves = [torch.nn.Parameter(torch.ones(3, dtype=dtype))
              for dtype in (torch.float32, torch.bfloat16)]
    ours = Adam(leaves, lr=LR, weight_decay=1e-6)
    ref = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=LR, weight_decay=1e-6)
    for optimizer in (ours, ref):
        for leaf in optimizer.param_groups[0]["params"]:
            leaf.grad = torch.ones_like(leaf)
        optimizer.step()
    state = ours.state_dict()
    assert set(state["state"][0]) == set(ref.state_dict()["state"][0])
    assert set(ref.state_dict()["param_groups"][0]) >= set(state["param_groups"][0])
    assert state["state"][1]["exp_avg"].dtype == torch.bfloat16
    # A reload keeps each moment in its leaf's dtype and the step count.
    again = Adam(leaves, lr=LR, weight_decay=1e-6)
    again.load_state_dict(state)
    assert again.state[leaves[1]]["exp_avg_sq"].dtype == torch.bfloat16
    assert int(again.state[leaves[0]]["step"]) == 1

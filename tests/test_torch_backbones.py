"""The image backbones of the port against the JAX package's: ResNet18/34/50
(``models/resnet.py``) and EfficientNet-B0/B3 (``models/efficientnet.py``),
and the EfficientNet's padding and stochastic depth; the JAX ResNet18's
stem opt-ins against the port's ResNet18, which runs the plain stem for
either.

The JAX trees come from ``jax.eval_shape`` of ``init`` filled with seeded
numpy values (``fill_tree``: conv and dense kernels N(0, 1/fan_in), BN
scale U(0.5, 1.5), biases N(0, 0.2), running means N(0, 0.2) and variances
U(0.5, 2)), carried to the port with ``convert.jax_to_torch``; inputs are
seeded numpy, 4 images of 32² (33² for the odd size).

Tolerances, stated before the first run:

* eval features (f32): within 1e-4 of the largest JAX feature;
* train mode (B0 at stochastic-depth rate 0, ResNet50): features, every
  gradient within 3e-4 of its tensor's largest JAX magnitude, running
  statistics within 1e-6. These run in float64 on both sides (JAX under
  ``jax.enable_x64``): at 32² a train-mode BN normalises ResNet50's layer
  4 over a value a sample, and f32 cannot resolve the gradients there —
  measured with 8 images, JAX's f32 gradients lie 0.25 of max from the
  float64 ones (layer4_2.conv3), the port's f32 ones 0.20. A gradient whose
  exact value is 0 (EfficientNet's ``bn_project`` biases feed only other
  BNs' mean subtraction) is held absolutely: below 1e-10 of the largest
  gradient on both sides;
* the SAME padding: a stride-2 conv at 32² and 33² equal to flax's
  ``padding="SAME"`` within 1e-5 of max; at 32² symmetric padding misses
  it by more than 1e-2 of max (the fault the test is there to catch), at
  33², where SAME is symmetric, it does not;
* stochastic depth: exact (masks are compared as values).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

BACKBONES = ["resnet18", "resnet34", "resnet50", "efficientnet_b0", "efficientnet_b3"]
FEATURE_TOL = 1e-4
GRAD_TOL = 3e-4
STATS_TOL = 1e-6
ZERO_GRAD = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def fill_tree(tree, rng):
    """Seeded numpy values in the shapes of an ``eval_shape`` tree (module
    docstring); GRU weights as kernels, embeddings N(0, 1)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = fill_tree(value, rng)
            continue
        shape = value.shape
        if key in ("kernel", "w_ih", "w_hh"):
            fan_in = int(np.prod(shape[:-1]))
            out[key] = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif key == "embedding":
            out[key] = rng.normal(0.0, 1.0, shape)
        elif key == "scale":
            out[key] = rng.uniform(0.5, 1.5, shape)
        elif key in ("bias", "b_ih", "b_hh", "mean"):
            out[key] = rng.normal(0.0, 0.2, shape)
        elif key == "var":
            out[key] = rng.uniform(0.5, 2.0, shape)
        else:
            raise KeyError(f"no fill for leaf {key!r}")
        out[key] = out[key].astype(np.float32)
    return out


def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _jax_backbone(name, drop_connect_rate=0.2, **stems):
    from tricolo_tpu.models.efficientnet import EfficientNet
    from tricolo_tpu.models.resnet import ResNet

    if name.startswith("efficientnet"):
        return EfficientNet(cnn_name=name, drop_connect_rate=drop_connect_rate)
    return ResNet(cnn_name=name, **stems)


def _port_backbone(name, drop_connect_rate=0.2):
    """The port's backbone; an EfficientNet's blocks at stochastic-depth
    rate 0 when ``drop_connect_rate`` is 0 (its own rate is fixed, as the
    JAX package's default)."""
    from tricolo_tpu_torch.models.efficientnet import DROP_CONNECT_RATE, EfficientNet, MBConv
    from tricolo_tpu_torch.models.resnet import ResNet

    if not name.startswith("efficientnet"):
        return ResNet(name)
    model = EfficientNet(name)
    assert drop_connect_rate in (0.0, DROP_CONNECT_RATE)
    for block in model.modules():
        if isinstance(block, MBConv) and drop_connect_rate == 0.0:
            block.drop_rate = 0.0
    return model


def backbone_pair(name, size=32, seed=0, drop_connect_rate=0.2, **stems):
    """(JAX module, params, batch_stats, port module carrying them, images)."""
    import jax.numpy as jnp

    from tricolo_tpu_torch.convert import jax_to_torch

    images = np.random.default_rng(seed + 1).normal(size=(4, size, size, 3)).astype(np.float32)
    module = _jax_backbone(name, drop_connect_rate, **stems)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(images))
    rng = np.random.default_rng(seed)
    params, stats = fill_tree(shapes["params"], rng), fill_tree(shapes["batch_stats"], rng)
    port = _port_backbone(name, drop_connect_rate)
    port.load_state_dict(jax_to_torch(params, stats))
    return module, params, stats, port, images


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------- (a) eval, train


@pytest.mark.parametrize("name,size", [(n, 32) for n in BACKBONES] + [("efficientnet_b0", 33)])
def test_eval_features_match_jax(name, size):
    module, params, stats, port, images = backbone_pair(name, size)
    apply = jax.jit(lambda p, s, x: module.apply({"params": p, "batch_stats": s}, x))
    ref = np.asarray(apply(params, stats, images))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images)).numpy()
    assert got.shape == ref.shape == (4, port.feature_dim)
    assert rel(got, ref) <= FEATURE_TOL


def _jax_train64(module, params, stats, images, weights):
    """Features, gradients of Σ features·weights and updated batch_stats of
    the JAX backbone's train-mode forward, all in float64."""
    import jax.numpy as jnp

    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731

        def loss(p, s):
            out, mutated = module.apply({"params": p, "batch_stats": s},
                                        jnp.asarray(images, jnp.float64), train=True,
                                        mutable=["batch_stats"])
            return (out * weights).sum(), (out, mutated["batch_stats"])

        grads, (out, new_stats) = jax.jit(jax.grad(loss, has_aux=True))(f64(params), f64(stats))
        return np.asarray(out), flat(grads), flat(new_stats)


def _port_train(port, images, weights, dtype):
    """The same through the port: features, gradients and buffers in the JAX
    layout (``convert.torch_to_jax``)."""
    from tricolo_tpu_torch.convert import torch_to_jax

    port = port.train().to(dtype)
    out = port(torch.from_numpy(images).to(dtype))
    (out * torch.from_numpy(weights).to(dtype)).sum().backward()
    state = {k: v.detach().clone() for k, v in port.state_dict().items()}
    state.update({n: p.grad.detach().clone() for n, p in port.named_parameters()})
    grads, stats = torch_to_jax(state)
    return out.detach().numpy(), flat(grads), flat(stats)


def assert_grads_close(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for name, g in ref.items():
        if np.abs(g).max() < ZERO_GRAD * top:  # an exact 0 (module docstring)
            assert np.abs(got[name]).max() < ZERO_GRAD * top, name
        else:
            assert rel(got[name], g) <= GRAD_TOL, (name, rel(got[name], g))


@pytest.mark.parametrize("name", ["efficientnet_b0", "resnet50"])
def test_train_mode_matches_jax_float64(name):
    module, params, stats, port, images = backbone_pair(name, drop_connect_rate=0.0)
    weights = np.random.default_rng(9).normal(size=(4, port.feature_dim))
    ref_out, ref_grads, ref_stats = _jax_train64(module, params, stats, images, weights)
    out, grads, new_stats = _port_train(port, images, weights, torch.float64)
    assert rel(out, ref_out) <= FEATURE_TOL
    assert_grads_close(grads, ref_grads)
    assert sorted(new_stats) == sorted(ref_stats)
    for key, value in ref_stats.items():
        np.testing.assert_allclose(new_stats[key], value, rtol=0, atol=STATS_TOL, err_msg=key)
    # The step moved them (so the comparison above is not of the inputs).
    moved = {k: np.abs(v - flat(stats)[k]).max() for k, v in ref_stats.items()}
    assert max(moved.values()) > 100 * STATS_TOL


@pytest.mark.parametrize("stem", ["hybrid_stem", "s2d_stem"])
def test_resnet_stems_match_jax(stem):
    """The JAX ResNet18 with a stem opt-in against the port's ResNet18 (the
    plain stem, which the opt-in rewrites exactly) from the same variables:
    eval features in f32; train-mode features, gradients and running
    statistics in float64 on both sides, at the tolerances of
    ``test_train_mode_matches_jax_float64`` (in f32 the rewrite's own
    rounding, carried through layer 4's four-value BatchNorms, moves a
    running variance 2e-6)."""
    module, params, stats, port, images = backbone_pair("resnet18", **{stem: True})
    apply = jax.jit(lambda p, s, x: module.apply({"params": p, "batch_stats": s}, x))
    with torch.no_grad():
        assert rel(port.eval()(torch.from_numpy(images)).numpy(),
                   apply(params, stats, images)) <= FEATURE_TOL
    weights = np.random.default_rng(9).normal(size=(4, port.feature_dim))
    ref_out, ref_grads, ref_stats = _jax_train64(module, params, stats, images, weights)
    out, grads, new_stats = _port_train(port, images, weights, torch.float64)
    assert rel(out, ref_out) <= FEATURE_TOL
    assert_grads_close(grads, ref_grads)
    assert sorted(new_stats) == sorted(ref_stats)
    for key, value in ref_stats.items():
        np.testing.assert_allclose(new_stats[key], value, rtol=0, atol=STATS_TOL, err_msg=key)


# -------------------------------------------------------- (b) SAME padding


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("k,groups", [(3, 1), (5, 8)])
def test_stride2_same_conv_matches_flax(size, k, groups, monkeypatch):
    import flax.linen as nn
    import jax.numpy as jnp

    from tricolo_tpu_torch.models import efficientnet
    from tricolo_tpu_torch.models.efficientnet import SameConv2d

    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 8 // groups, 8)).astype(np.float32)
    conv = nn.Conv(8, (k, k), strides=(2, 2), padding="SAME", use_bias=False,
                   feature_group_count=groups)
    ref = np.asarray(conv.apply({"params": {"kernel": jnp.asarray(kernel)}}, x))
    port = SameConv2d(8, 8, k, stride=2, groups=groups)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))

    def run():
        with torch.no_grad():
            return port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    assert run().shape == ref.shape == (2, (size + 1) // 2, (size + 1) // 2, 8)
    assert rel(run(), ref) <= 1e-5
    # Symmetric padding (nn.Conv2d(padding=k // 2)) shifts every output at
    # an even size; at an odd one SAME is symmetric.
    monkeypatch.setattr(efficientnet, "same_padding", lambda n, k, s: (k // 2, k // 2))
    if size % 2:
        assert rel(run(), ref) <= 1e-5
    else:
        assert rel(run(), ref) > 1e-2


def test_same_padding_is_lax_same():
    from tricolo_tpu_torch.models.efficientnet import same_padding

    # lax: total = max((ceil(in/s) − 1)·s + k − in, 0), total // 2 before.
    assert same_padding(128, 3, 2) == (0, 1)
    assert same_padding(64, 5, 2) == (1, 2)
    assert same_padding(33, 3, 2) == (1, 1)
    assert same_padding(33, 5, 2) == (2, 2)
    assert same_padding(32, 3, 1) == (1, 1)


# ------------------------------------------------- (c) stochastic depth


def test_stochastic_depth_masks_are_per_sample_seeded_and_scaled():
    from tricolo_tpu_torch.models.common import stochastic_depth
    from tricolo_tpu_torch.training import dropout_generator

    cpu = torch.device("cpu")
    x = torch.ones(64, 3, 2, 2)
    a = stochastic_depth(x, 0.25, dropout_generator(5, 1, cpu))
    per_sample = a.reshape(64, -1)
    assert torch.all(per_sample == per_sample[:, :1])  # one draw a sample
    scaled = torch.tensor(1.0 / 0.75).item()  # 1/keep in f32
    assert set(per_sample[:, 0].tolist()) == {0.0, scaled}  # scaled by 1/keep
    assert torch.equal(a, stochastic_depth(x, 0.25, dropout_generator(5, 1, cpu)))
    assert not torch.equal(a, stochastic_depth(x, 0.25, dropout_generator(5, 2, cpu)))
    with pytest.raises(ValueError, match="Generator"):
        stochastic_depth(x, 0.25, None)
    # Two ranks' stripes draw the masks of one process on the global batch.
    parts = [stochastic_depth(x[:32], 0.25, dropout_generator(5, 1, cpu), (rank, 2))
             for rank in (0, 1)]
    assert torch.equal(torch.cat(parts), a)


def _recorded_masks(monkeypatch, port, images, generator_seed, rows=None):
    """Run ``port`` in train mode, recording (block, mask) of every
    stochastic-depth draw; ``rows`` sets every MBConv's (rank, ranks)."""
    from tricolo_tpu_torch.models import efficientnet
    from tricolo_tpu_torch.models.common import stochastic_depth
    from tricolo_tpu_torch.training import dropout_generator

    calls = []

    def record(x, rate, generator, block_rows=(0, 1)):
        calls.append((rate, stochastic_depth(torch.ones_like(x), rate, generator,
                                             block_rows)[:, 0, 0, 0].clone()))
        return x

    monkeypatch.setattr(efficientnet, "stochastic_depth", record)
    for block in port.modules():
        if isinstance(block, efficientnet.MBConv) and rows is not None:
            block.rows = rows
    port.train()(torch.from_numpy(images), dropout_generator(generator_seed, 0, "cpu"))
    return calls


def test_stochastic_depth_blocks_rates_and_eval(monkeypatch):
    from tricolo_tpu_torch.models.efficientnet import MBConv

    *_, port, images = backbone_pair("efficientnet_b0")
    blocks = [m for m in port.modules() if isinstance(m, MBConv)]
    total = len(blocks)
    assert total == 16
    want = [0.2 * i / total for i, b in enumerate(blocks) if b.has_residual and i > 0]
    assert not blocks[0].has_residual and blocks[0].drop_rate == 0.0
    calls = _recorded_masks(monkeypatch, port, images, 3)
    # Only the residual blocks draw (none of the shape-changing ones, not
    # block 0), at their ramped rates, one value a sample.
    assert [rate for rate, _ in calls] == pytest.approx(want)
    assert all(mask.shape == (4,) for _, mask in calls)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="Generator"):
        port.train()(torch.from_numpy(images))
    with torch.no_grad():  # eval mode draws nothing and needs no generator
        port.eval()(torch.from_numpy(images))


def test_stochastic_depth_under_two_ranks_is_one_process(monkeypatch):
    *_, port, images = backbone_pair("efficientnet_b0")
    images = np.concatenate([images, images[::-1]])  # 8 rows: two stripes of 4
    whole = _recorded_masks(monkeypatch, port, images, 3)
    stripes = [_recorded_masks(monkeypatch, port, images[rank * 4:(rank + 1) * 4], 3,
                               rows=(rank, 2)) for rank in (0, 1)]
    assert len(whole) == len(stripes[0]) == len(stripes[1]) > 0
    for (rate, mask), (r0, m0), (r1, m1) in zip(whole, *stripes):
        assert rate == r0 == r1
        assert torch.equal(torch.cat([m0, m1]), mask)


def test_attach_finds_every_batchnorm_and_block():
    from tricolo_tpu_torch.models.common import BatchNorm2d
    from tricolo_tpu_torch.models.efficientnet import MBConv
    from tricolo_tpu_torch.parallel import World, attach

    group = object()  # stands in for a process group
    for name in ("efficientnet_b3", "resnet50"):
        model = _port_backbone(name)
        attach(model, World(1, 2, group))
        bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
        assert bns and all(bn.bn_group is group for bn in bns)
        blocks = [m for m in model.modules() if isinstance(m, MBConv)]
        assert all(b.rows == (1, 2) for b in blocks)
        assert (len(blocks) > 0) == name.startswith("efficientnet")


# ------------------------------------------- the weight bridge (convert.py)


def test_torch_to_jax_keeps_a_conv_bias_beside_its_kernel():
    """A biased conv (EfficientNet's ``se_reduce``) maps its bias to
    ``se_reduce/bias``; a Linear's bias stays under ``Dense_0``."""
    from tricolo_tpu_torch.convert import torch_to_jax

    state = {"block.se_reduce.weight": torch.randn(4, 8, 1, 1),
             "block.se_reduce.bias": torch.randn(4),
             "fc.weight": torch.randn(3, 5), "fc.bias": torch.randn(3)}
    params, stats = torch_to_jax(state)
    assert stats == {}
    assert sorted(params["block"]["se_reduce"]) == ["bias", "kernel"]
    assert params["block"]["se_reduce"]["kernel"].shape == (1, 1, 8, 4)
    assert np.array_equal(params["block"]["se_reduce"]["bias"], state["block.se_reduce.bias"])
    assert sorted(params["fc"]) == ["Dense_0"]
    assert np.array_equal(params["fc"]["Dense_0"]["bias"], state["fc.bias"])


@pytest.mark.parametrize("name,stems", [(n, {}) for n in BACKBONES]
                         + [("resnet18", {"hybrid_stem": True, "s2d_stem": True})])
def test_weight_bridge_round_trip_is_exact(name, stems):
    """jax_to_torch then torch_to_jax gives back every leaf of the JAX tree
    bit for bit (depthwise kernels (k, k, 1, mid) ↔ (mid, 1, k, k))."""
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax

    _, params, stats, port, _ = backbone_pair(name, **stems)
    got_params, got_stats = torch_to_jax(port.state_dict())
    for got, want in ((flat(got_params), flat(params)), (flat(got_stats), flat(stats))):
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
    again = jax_to_torch(got_params, got_stats)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())

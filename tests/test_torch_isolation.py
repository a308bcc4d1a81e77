"""The PyTorch port stands alone: no file of ``tricolo_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax, msgpack or the JAX package, or
names the JAX package's native library (the port builds its own host
loader); and the kernel wrappers launch nothing on CPU tensors, eval or
train.

The scan reads the sources' import statements (AST) rather than
``sys.modules``: the test process itself may have JAX loaded.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tricolo_tpu")
SOURCES = sorted((ROOT / "tricolo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def test_sources_found():
    assert len(SOURCES) > 15 and all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [
        m for m in _imported_modules(path)
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_counters_stay_zero_on_cpu():
    """An eval step and a train step with the blocked loss on CPU tensors
    take every kernel's plain version: every counter stays 0."""
    from tricolo_tpu_torch import ops
    from tricolo_tpu_torch.config import load_config
    from tricolo_tpu_torch.inference import eval_step, to_device_batch
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet
    from tricolo_tpu_torch.training import make_optimizer, make_train_step

    cfg = load_config([
        "data=synthetic", "model.image_encoder=MVCNNEncoder",
        "model.voxel_encoder=VoxelCNNEncoder", "data.batch_size=2",
        "model.modules.VoxelCNNEncoder.ef_dim=8", "precision.compute_dtype=float32",
        "loss.NTXentLoss.use_pallas=true",
    ])
    ops.reset_launches()
    dm = DataModule(cfg)
    dm.setup("test")
    model = TriCoLoNet.from_config(cfg).eval()
    batch = to_device_batch(dm.test_loader().peek(), torch.device("cpu"))
    out = eval_step(model, batch)
    assert out["voxel_features"].shape == (2, 512)
    step = make_train_step(model, make_optimizer(cfg, model), cfg)
    losses = step(batch, cfg.optimizer.lr)
    assert all(torch.isfinite(v) for v in losses.values())
    assert ops.launches() == {name: 0 for name in (
        "bn_relu_pool", "scatter_tiles_ps", "bn_relu_pool_bwd", "nt_xent_fwd",
        "nt_xent_fwd_pair", "nt_xent_bwd_rows", "nt_xent_bwd_cols", "nt_xent_bwd", "gather_tiles",
        "scatter_tiles_global", "bn_relu_pool_unmasked", "bn_relu_pool_bwd_unmasked")}


def test_host_library_is_the_ports_own():
    """The port builds its host loader from its own C++ source and never
    names, builds or loads the JAX package's library."""
    for path in SOURCES:
        text = path.read_text()
        for name in ("libtricolo_native", "tricolo_native.cpp", "ensure_built"):
            assert name not in text, f"{path.relative_to(ROOT)} names {name}"
    from tricolo_tpu_torch import native

    assert native.SOURCE == ROOT / "tricolo_tpu_torch" / "csrc" / "host_loader.cpp"
    library = native.build()
    assert library.name.startswith("libhost_loader-") and library.suffix == ".so"
    assert Path(native.library()._name) == library

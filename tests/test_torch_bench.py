"""The port's benchmark (``tricolo_tpu_torch.bench``, ``bench_data``)
against the JAX package's ``bench.py`` and ``__graft_entry__``.

On the CPU at the tiny sizes (32³ voxels, 2 views of 32², batch 8):

* the benchmark's data: ``host_batch`` bit-equal to ``_host_batch``;
* its configuration: ``bench_config`` equal, on every key both configs
  have, to ``_flagship_cfg`` with ``bench.py``'s rules (bi_i / bi_v,
  windowed_compact unless overridden, remat at 128³) and the port's one
  rule more, the NT-Xent kernels (``loss.NTXentLoss.use_pallas=true``);
* its budgets and staged arrays: exact against the JAX package's
  ``ops/tile_sparse.py`` and ``data/device_prep.py`` host functions (numpy
  on both sides);
* one bench train step from the JAX init's weights: losses within rel
  1e-5 of the JAX ``make_train_step``'s (the train gate of PERF.md; the JAX
  side runs its plain loss, as ``test_torch_train.py`` explains);
* the CLI end to end with ``--device cpu``, and ``measure``'s watchdog
  driven with fake timed loops: one line at most, ever.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
TINY = ["data.image_size=32", "data.num_views=2", "precision.compute_dtype=float32"]
N_POINTS = 1024  # 8192·(32/64)³, the bench's default at 32³


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def jax_bench_cfg(config, voxel_size, batch_size, overrides, kernels=True):
    """``bench.py``'s configuration (its l.137-173), with the port's NT-Xent
    rule when ``kernels``."""
    from __graft_entry__ import _flagship_cfg

    extra = [f"data.voxel_size={voxel_size}", f"data.batch_size={batch_size}"]
    if kernels:
        extra.append("loss.NTXentLoss.use_pallas=true")
    cfg = _flagship_cfg(extra=[*extra, *overrides])
    if config == "bi_i":
        cfg.model.voxel_encoder = None
    elif config == "bi_v":
        cfg.model.image_encoder = None
    if not any(o.startswith("data.voxel_transfer") for o in overrides):
        cfg.data.voxel_transfer = "windowed_compact"
    if voxel_size >= 128 and not any(o.startswith("precision.remat_voxel") for o in overrides):
        cfg.precision.remat_voxel = True
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_host_batch_matches_graft_entry(seed):
    from __graft_entry__ import _flagship_cfg, _host_batch
    from tricolo_tpu_torch.bench_data import flagship_cfg, host_batch

    extra = ["data.voxel_size=32", "data.batch_size=8"]
    ref = _host_batch(_flagship_cfg(extra=extra), n_points=256, seed=seed)
    ours = host_batch(flagship_cfg(extra=extra), n_points=256, seed=seed)
    assert sorted(ours) == sorted(ref) == ["images", "tokens", "voxel_flat", "voxel_rgb"]
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype and ours[key].shape == value.shape, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_flagship_cfg_matches_graft_entry():
    from __graft_entry__ import _flagship_cfg
    from tricolo_tpu_torch.bench_data import flagship_cfg

    for tiny in (False, True):
        a, b = _flagship_cfg(tiny).to_dict(), flagship_cfg(tiny).to_dict()
        a.pop("project_root_path"), b.pop("project_root_path")
        assert a == b


@pytest.mark.parametrize("config,voxel_size,overrides", [
    ("tri", 64, []),
    ("bi_i", 64, []),
    ("bi_v", 64, []),
    ("tri", 128, []),
    ("bi_v", 128, ["precision.remat_voxel=false"]),
    ("tri", 64, ["data.voxel_transfer=packed",
                 "model.modules.VoxelCNNEncoder.tile_sparse=true"]),
])
def test_bench_config_matches_bench_py(config, voxel_size, overrides):
    from tricolo_tpu_torch.bench import bench_config

    batch = 32 if voxel_size == 128 else 128
    ours = _flat(bench_config(config, voxel_size, batch, overrides).to_dict())
    ref = _flat(jax_bench_cfg(config, voxel_size, batch, overrides).to_dict())
    common = sorted(set(ours) & set(ref) - {"project_root_path"})
    assert len(common) > 0.9 * len(ref)
    assert {k: ours[k] for k in common} == {k: ref[k] for k in common}
    assert ours["loss.NTXentLoss.use_pallas"] is True
    assert ours["precision.remat_voxel"] is (voxel_size >= 128 and not overrides)
    transfer = "packed" if overrides and "packed" in overrides[0] else "windowed_compact"
    assert ours["data.voxel_transfer"] == transfer


def _jax_budgets(cfg, hosts, overrides):
    """``bench.py``'s budget fit (its l.178-221) through the JAX package."""
    from tricolo_tpu.ops.tile_sparse import (
        host_sample_tile_counts,
        host_tile_count,
        sample_tile_budget,
    )

    D, transfer = cfg.data.voxel_size, cfg.data.voxel_transfer
    tg3 = (D // 8) ** 3
    if transfer == "windowed_compact":
        budget = cfg.model.modules.VoxelCNNEncoder.get("tile_budget", "auto")
        explicit = isinstance(budget, (int, float)) and not isinstance(budget, bool)
        worst = max(max(host_sample_tile_counts(b["voxel_flat"], D)) for b in hosts)
        return sample_tile_budget(budget, tg3, None if explicit else worst)
    if transfer == "windowed" and not any("tile_budget" in o for o in overrides):
        worst = max(host_tile_count(b["voxel_flat"], D) for b in hosts)
        rows = -(-int(worst * 1.25) // 256) * 256
        cfg.model.modules.VoxelCNNEncoder.tile_budget_frac = min(
            1.0, rows / (cfg.data.batch_size * tg3))
    return 0


def _jax_transfer(cfg, host, tile_rows):
    """``bench.py``'s ``to_transfer`` through the JAX package."""
    from tricolo_tpu.data import device_prep
    from tricolo_tpu.ops.tile_sparse import windowed_halo

    host = dict(host)
    D, transfer = cfg.data.voxel_size, cfg.data.voxel_transfer
    halo = windowed_halo(cfg.model.modules.VoxelCNNEncoder.get("tile_sparse_blocks", 2))
    if transfer == "dense":
        host["voxel_grid"] = device_prep.densify_on_host(
            host.pop("voxel_flat"), host.pop("voxel_rgb"), D)
    elif transfer == "windowed":
        host["voxel_windows"], host["voxel_tile_occ"] = device_prep.windowed_on_host(
            host.pop("voxel_flat"), host.pop("voxel_rgb"), D, halo=halo)
    elif transfer == "windowed_compact":
        host["voxel_rows"], host["voxel_row_ids"], _ = device_prep.windowed_compact_on_host(
            host.pop("voxel_flat"), host.pop("voxel_rgb"), D, tile_rows, halo=halo)
    return host


@pytest.mark.parametrize("transfer", ["windowed_compact", "windowed", "dense", "packed"])
def test_budgets_and_transfers_match_jax(transfer):
    from __graft_entry__ import _host_batch
    from tricolo_tpu_torch.bench import bench_config, fit_budgets, to_transfer
    from tricolo_tpu_torch.bench_data import host_batch

    overrides = [*TINY, f"data.voxel_transfer={transfer}"]
    ours_cfg = bench_config("tri", 32, 8, overrides)
    ref_cfg = jax_bench_cfg("tri", 32, 8, overrides)
    ours_hosts = [host_batch(ours_cfg, N_POINTS, seed=s) for s in range(2)]
    ref_hosts = [_host_batch(ref_cfg, n_points=N_POINTS, seed=s) for s in range(2)]
    rows = fit_budgets(ours_cfg, ours_hosts, overrides)
    assert rows == _jax_budgets(ref_cfg, ref_hosts, overrides)
    assert (rows > 0) == (transfer == "windowed_compact")
    frac = ours_cfg.model.modules.VoxelCNNEncoder.tile_budget_frac
    assert frac == ref_cfg.model.modules.VoxelCNNEncoder.tile_budget_frac
    for ours_host, ref_host in zip(ours_hosts, ref_hosts):
        ours, ref = to_transfer(ours_cfg, ours_host, rows), _jax_transfer(ref_cfg, ref_host, rows)
        assert sorted(ours) == sorted(ref)
        for key, value in ref.items():
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)


@pytest.mark.parametrize("config,dropped", [("bi_i", {"voxel_flat", "voxel_rgb"}),
                                            ("bi_v", {"images"})])
def test_bimodal_transfer_drops_the_disabled_encoders_arrays(config, dropped):
    from tricolo_tpu_torch.bench import bench_config, fit_budgets, to_transfer
    from tricolo_tpu_torch.bench_data import host_batch

    cfg = bench_config(config, 32, 8, TINY)
    host = host_batch(cfg, N_POINTS)
    rows = fit_budgets(cfg, [host])
    assert (rows > 0) == (config == "bi_v")
    staged = to_transfer(cfg, host, rows)
    assert not dropped & set(staged) and "tokens" in staged


def test_one_bench_step_matches_jax_train_step():
    import jax.numpy as jnp

    from __graft_entry__ import _host_batch
    from tricolo_tpu.data.device_prep import prepare_device_batch
    from tricolo_tpu.models.tricolo_net import TriCoLoNet as JaxNet
    from tricolo_tpu.training import TrainState, make_optimizer, make_train_step
    from tricolo_tpu_torch.bench import bench_config, build_step, fit_budgets, stage, to_transfer
    from tricolo_tpu_torch.bench_data import host_batch
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.training import dropout_generator

    # The JAX side: bench.py's init and step on its plain loss.
    ref_cfg = jax_bench_cfg("tri", 32, 8, TINY, kernels=False)
    hosts = [_host_batch(ref_cfg, n_points=N_POINTS, seed=s) for s in range(2)]
    rows = _jax_budgets(ref_cfg, hosts, TINY)
    model = JaxNet.from_config(ref_cfg)
    init_batch = prepare_device_batch(
        {k: jnp.asarray(v) for k, v in _host_batch(ref_cfg, n_points=N_POINTS).items()},
        ref_cfg.data.voxel_size)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), init_batch)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    tx = make_optimizer(ref_cfg)
    lr = ref_cfg.optimizer.lr
    _, ref = make_train_step(model, tx, ref_cfg)(
        TrainState.create(variables, tx), _jax_transfer(ref_cfg, hosts[0], rows), lr,
        jax.random.PRNGKey(0))

    cfg = bench_config("tri", 32, 8, TINY)
    ours_hosts = [host_batch(cfg, N_POINTS, seed=s) for s in range(2)]
    assert fit_budgets(cfg, ours_hosts) == rows
    batch = stage(to_transfer(cfg, ours_hosts[0], rows), torch.device("cpu"))
    net, _, step = build_step(cfg, torch.device("cpu"))
    net.load_state_dict(jax_to_torch(params, stats))
    losses = step(batch, cfg.optimizer.lr, dropout_generator(cfg.train_seed, 0, "cpu"))
    assert sorted(losses) == sorted(ref) and len(ref) == 4
    for name, value in ref.items():
        np.testing.assert_allclose(losses[name].item(), float(value), rtol=1e-5, err_msg=name)


def _cli(args, **kwargs):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", "tricolo_tpu_torch.bench", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=240, **kwargs)


def test_cli_on_cpu(tmp_path):
    args = ["--device", "cpu", "--voxel-size", "32", "--batch-size", "8", "--pairs", "2",
            "--idle-wait", "0", "--trace", str(tmp_path)]
    for o in [*TINY, "bench.steps=1", "bench.warmup_steps=1"]:
        args += ["--override", o]
    proc = _cli(args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    assert sorted(result) == sorted(["metric", "value", "unit", "step_ms", "pairs", "salvaged",
                                     "config", "voxel_size", "batch_size", "card"])
    assert result["metric"] == "train_pairs_per_sec_per_chip"
    assert result["unit"] == "caption-shape pairs/sec/chip"
    assert result["pairs"] == 2 and result["salvaged"] is False and result["value"] > 0
    assert result["step_ms"] > 0 and result["card"] == "cpu"
    assert (result["config"], result["voxel_size"], result["batch_size"]) == ("tri", 32, 8)
    counted = json.loads(proc.stderr.strip().splitlines()[-1][len("bench: "):])
    assert counted["steps"] == 6  # 2 pairs × (1 + 2) steps
    assert set(counted["launches_per_step"].values()) == {0}  # CPU: the plain versions
    assert len(list(tmp_path.glob("bench.*.pt.trace.json"))) == 1
    # The trace report reads it: host events only on the CPU.
    from tricolo_tpu_torch.trace_report import analyse, find_trace

    merged = json.loads(Path(find_trace(str(tmp_path))).read_text())
    report = analyse(merged, steps=1)
    assert report["device_busy_ms"] == 0.0 and report["window_ms"] > 0
    # The port's spans are merged in: one step span for each traced step.
    assert sum(e.get("cat") == "program_span" and e["name"] == "step"
               for e in merged["traceEvents"]) == 1
    assert report["device_idle_share"] == 1.0 and report["gaps"][0]["host_op"]


def test_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from tricolo_tpu_torch import bench

    monkeypatch.setattr(bench, "host_batch", lambda *a, **k: pytest.fail("ran without a GPU"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--idle-wait", "0"])


# ------------------------------------------------------------ the watchdog


class Recorder:
    """``emit`` and ``exit`` of one ``measure`` run; ``exited`` releases a
    fake loop that stalls."""

    def __init__(self):
        self.lines = []
        self.codes = []
        self.exited = threading.Event()

    def emit(self, estimates, salvaged):
        self.lines.append({"pairs": len(estimates), "salvaged": salvaged,
                           "median": float(np.median(estimates))})

    def exit(self, code):
        self.codes.append(code)
        self.exited.set()


def _loop(durations, stall_at=None, rec=None):
    """A fake ``timed_loop``: leg i reports ``durations[i]`` seconds; leg
    ``stall_at`` blocks until the watchdog exits."""
    calls = []

    def timed_loop(n):
        calls.append(n)
        if len(calls) - 1 == stall_at:
            assert rec.exited.wait(10)
        return durations[(len(calls) - 1) % len(durations)]

    return timed_loop, calls


def test_measure_prints_the_median_once():
    from tricolo_tpu_torch.bench import measure

    rec = Recorder()
    loop, calls = _loop([1.0, 3.0, 1.0, 4.0, 1.0, 2.5])
    assert measure(loop, 5, 3, 60.0, rec.emit, rec.exit) == 0
    assert calls == [5, 10] * 3
    assert rec.lines == [{"pairs": 3, "salvaged": False, "median": 2.0}] and rec.codes == []


def test_measure_salvages_after_one_pair():
    from tricolo_tpu_torch.bench import measure

    rec = Recorder()
    loop, _ = _loop([1.0, 3.0], stall_at=2, rec=rec)
    assert measure(loop, 4, 3, 0.2, rec.emit, rec.exit) == 0
    assert rec.lines == [{"pairs": 1, "salvaged": True, "median": 2.0}] and rec.codes == [0]


def test_measure_stall_before_any_pair_exits_3_silently():
    from tricolo_tpu_torch.bench import measure

    rec = Recorder()
    loop, _ = _loop([1.0], stall_at=1, rec=rec)
    assert measure(loop, 4, 2, 0.2, rec.emit, rec.exit) == 3
    assert rec.lines == [] and rec.codes == [3]


def test_measure_never_prints_twice_when_a_pair_ends_at_the_threshold():
    """The last leg ends as the stall threshold passes: the watchdog's
    salvage and the main thread's line race for the once-flag."""
    from tricolo_tpu_torch.bench import measure

    stall = 0.05
    outcomes = set()
    for i in range(50):
        rec = Recorder()
        legs = [0]

        def loop(n):
            legs[0] += 1
            if legs[0] == 4:  # the second pair's 2N leg
                time.sleep(stall * (0.9 + 0.2 * (i % 5) / 4))
            return float(n)

        code = measure(loop, 1, 2, stall, rec.emit, rec.exit)
        assert len(rec.lines) == 1, (i, rec.lines)
        assert code == 0 and rec.codes in ([], [0])
        assert rec.lines[0]["salvaged"] == bool(rec.codes)
        outcomes.add(rec.lines[0]["salvaged"])
    assert outcomes  # at least one outcome seen; both are allowed


def test_default_stall_threshold():
    from tricolo_tpu_torch.bench import default_stall_s

    assert default_stall_s(0.5) == 300.0
    assert default_stall_s(30.0) == 300.0
    assert default_stall_s(45.0) == 450.0


def test_per_step_counts():
    from tricolo_tpu_torch.bench import per_step

    assert per_step({"a": 30, "b": 0, "c": 7}, 6) == {"a": 5, "b": 0, "c": 7 / 6}
    assert isinstance(per_step({"a": 30}, 6)["a"], int)


def test_chip_smoke_ellipsoid_batch_is_graft_entry_host_batch():
    """``chip_smoke.ellipsoid_batch`` draws its packed arrays from
    ``bench_data.host_batch``: the JAX ``_host_batch`` of seed 0."""
    import chip_smoke
    from __graft_entry__ import _flagship_cfg, _host_batch
    from tricolo_tpu_torch.config import load_config

    cfg = load_config([*chip_smoke.FLAGSHIP[:4], "data.voxel_size=32", "data.image_size=32",
                       "data.num_views=2", "data.batch_size=8", "data.vocab_size=3588"])
    batch, k = chip_smoke.ellipsoid_batch(cfg, n_points=512, packed=True)
    ref = _host_batch(_flagship_cfg(tiny=True, extra=["data.batch_size=8",
                                                      "data.vocab_size=3588"]),
                      n_points=512, seed=0)
    for key, value in ref.items():
        np.testing.assert_array_equal(batch[key], value, err_msg=key)
    rows, _ = chip_smoke.ellipsoid_batch(cfg, n_points=512)
    assert rows["voxel_rows"].shape[:2] == (8, k) and "voxel_flat" not in rows

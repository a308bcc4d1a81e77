"""One full train step in each data-parallel mode over N ranks, cross-
checked; and the flagship forward.

    python -m tricolo_tpu_torch.dryrun [N] [--device cuda|cpu]
    python -m tricolo_tpu_torch.dryrun entry [--device cuda|cpu]

The port's twin of ``__graft_entry__.dryrun_multichip`` and ``entry``. N
ranks (default 8), spawned processes joined over gloo, each run one full
train step — forward, the global-negative NT-Xent over every pair,
backward, the gradient reduction, Adam, the BN statistics — on the tiny
flagship (``bench_data.flagship_cfg(tiny=True)``: 32³, 2 views of 32²)
at a global batch of max(8, N) solid ellipsoids of 256 sites, from the
same weights (``torch.manual_seed(0)``), in five modes:

* ``dp_replicated``: the packed batch, replicated parameters;
* ``dp_fsdp``: the same under ``parallel.param_sharding=fsdp``;
* ``dp_explicit_collectives``: the same under
  ``parallel.explicit_collectives=true``;
* ``dp_windowed_compact``: the batch in the flagship's windowed_compact
  transfer (per-sample rows, k fitted to the batch as the loader does);
* ``windowed_compact_1dev``: that batch whole in each process, no world,
  its BatchNorms summing through a one-rank process group: the ranks' BN
  algorithm on one device, as the JAX function's 1-device mesh runs the
  mesh's program (the single-process BN rounds otherwise: 1.7e-3 of the
  loss apart at bf16 on this fixture).

Each mode gives its loss and the post-step fingerprint Σ|p| over every
parameter in f64 (FSDP's shards gathered with ``sharding_rules.gathered``).
The checks are the JAX function's, at its tolerances (relative to
max(1, |reference|)): the packed modes against ``dp_replicated`` at 1e-3
(loss) and 1e-4 (fingerprint); ``dp_windowed_compact`` against
``windowed_compact_1dev`` at 1e-3 and 1e-4, and against ``dp_replicated``
at 2e-2 and 1e-3 (the tile-sparse and dense masked blocks round apart in
bf16). A failed check raises AssertionError.

``--device cuda`` (the default) puts every rank on cuda:0 over gloo (one
card); ``--device cpu`` runs them on the CPU. ``entry`` runs the flagship
Tri(I+V) forward (64³, 6 views of 128², batch 8, bf16, eval mode) once and
prints its output shapes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MODES = {
    "dp_replicated": ("packed", []),
    "dp_fsdp": ("packed", ["parallel.param_sharding=fsdp"]),
    "dp_explicit_collectives": ("packed", ["parallel.explicit_collectives=true"]),
    "dp_windowed_compact": ("windowed_compact", []),
    "windowed_compact_1dev": ("windowed_compact", []),
}
N_POINTS = 256


def dryrun_cfg(n_ranks: int, extra=()):
    from .bench_data import flagship_cfg

    return flagship_cfg(tiny=True, extra=[f"data.batch_size={max(8, n_ranks)}", *extra])


def batches(cfg) -> dict:
    """The packed host batch (``bench_data.host_batch``, seed 0) and its
    windowed_compact transfer, k the batch's worst sample's tiles."""
    from .bench import to_transfer
    from .bench_data import host_batch
    from .ops.tile_sparse import host_sample_tile_counts, sample_tile_budget

    host = host_batch(cfg, n_points=N_POINTS)
    D = cfg.data.voxel_size
    k = sample_tile_budget("auto", (D // 8) ** 3,
                           max(host_sample_tile_counts(host["voxel_flat"], D)))
    cfg.data.voxel_transfer = "windowed_compact"
    return {"packed": host, "windowed_compact": to_transfer(cfg, host, k)}


def stripe(batch: dict, rank: int, n_ranks: int) -> dict:
    """The rank's contiguous rows of every array."""
    b = len(batch["tokens"]) // n_ranks
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def fingerprint(model) -> float:
    """Σ|p| over every parameter, in f64 (a collective under FSDP)."""
    from .parallel.sharding_rules import gathered

    params = gathered(dict(model.named_parameters()))
    return float(sum(np.abs(p.detach().double().cpu().numpy()).sum() for p in params.values()))


def solo_bn(model, group) -> None:
    """Every BatchNorm of ``model`` sums its statistics through ``group``
    (``parallel.attach``'s BN half)."""
    from .models.common import BatchNorm2d
    from .models.voxel_cnn import ConvBlock

    for module in model.modules():
        if isinstance(module, (ConvBlock, BatchNorm2d)):
            module.bn_group = group


def run_mode(name: str, n_ranks: int, world, solo, device, extra, init: dict, host: dict):
    """(loss, fingerprint) of one step of mode ``name`` from ``init``;
    ``solo``: this rank's one-rank group."""
    import torch

    from .inference import to_device_batch
    from .models.tricolo_net import TriCoLoNet
    from .parallel import attach, shard_model
    from .training import dropout_generator, make_optimizer, make_train_step

    transfer, overrides = MODES[name]
    cfg = dryrun_cfg(n_ranks, [*extra, *overrides])
    model = TriCoLoNet.from_config(cfg).to(device)
    model.load_state_dict(init)
    if name == "windowed_compact_1dev":
        world = None
        solo_bn(model, solo)
    if world is not None:
        attach(model, world)
    shard_model(model, world, cfg.parallel.get("param_sharding", "replicated"))
    optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, optimizer, cfg, world=world)
    batch = host[transfer]
    if world is not None:
        batch = stripe(batch, world.rank, world.size)
    losses = step(to_device_batch(batch, device), cfg.optimizer.lr,
                  dropout_generator(cfg.train_seed, 0, device))
    loss = losses["train_loss/total_loss"].item()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return loss, fingerprint(model)


def rank_main(rank: int, n_ranks: int, port: int, device_name: str, extra, threads: int,
              queue) -> None:
    """One rank of the dry run: every mode in turn; rank 0 puts {mode:
    (loss, fingerprint)} on ``queue``."""
    import torch
    import torch.distributed as dist

    from .models.tricolo_net import TriCoLoNet
    from .parallel import World

    torch.set_num_threads(threads)
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_ranks, rank=rank)
    try:
        world = World(rank, n_ranks, dist.group.WORLD)
        solos = [dist.new_group([r]) for r in range(n_ranks)]  # every rank makes each
        cfg = dryrun_cfg(n_ranks, extra)
        host = batches(cfg)
        torch.manual_seed(0)
        init = TriCoLoNet.from_config(cfg).state_dict()
        results = {name: run_mode(name, n_ranks, world, solos[rank], device, extra, init, host)
                   for name in MODES}
        if rank == 0:
            queue.put(results)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def check(results: dict) -> None:
    """The JAX dry run's checks (module docstring); AssertionError names
    the first that fails."""
    def close(name, ref_name, loss_tol, fp_tol):
        (loss, fp), (ref_loss, ref_fp) = results[name], results[ref_name]
        if abs(loss - ref_loss) > loss_tol * max(1.0, abs(ref_loss)):
            raise AssertionError(f"{name} loss {loss} disagrees with {ref_name} {ref_loss}")
        if abs(fp - ref_fp) > fp_tol * max(1.0, abs(ref_fp)):
            raise AssertionError(f"{name} param fingerprint {fp} disagrees with "
                                 f"{ref_name} {ref_fp}")

    for name, (transfer, _) in MODES.items():
        if transfer == "packed":
            close(name, "dp_replicated", 1e-3, 1e-4)
    close("dp_windowed_compact", "windowed_compact_1dev", 1e-3, 1e-4)
    close("dp_windowed_compact", "dp_replicated", 2e-2, 1e-3)


def dryrun(n_ranks: int, device: str = "cuda", extra=(), timeout: float = 1200.0) -> dict:
    """Run the five modes in ``n_ranks`` gloo ranks on ``device`` (every
    rank on cuda:0, or the CPU), print a line a mode, check them; returns
    {mode: (loss, fingerprint)}. ``extra``: config overrides."""
    from .inference import resolve_device
    from .measure_collectives import free_port, spawn_ranks

    target = resolve_device(device)
    device_name = "cuda:0" if target.type == "cuda" else "cpu"
    threads = max(1, (os.cpu_count() or 1) // n_ranks)
    results = spawn_ranks(rank_main, n_ranks, (n_ranks, free_port(), device_name, list(extra),
                                               threads), timeout)
    for name, (loss, fp) in results.items():
        print(f"dryrun({n_ranks}) {name} ran: loss={loss:.6f} param_fp={fp:.6f}", flush=True)
    check(results)
    print(f"dryrun({n_ranks}) OK: all modes agree", flush=True)
    return results


def entry(device: str = "cuda") -> dict:
    """The flagship Tri(I+V) forward once (eval mode, batch 8, 2048-site
    ellipsoids): {output name: shape}."""
    import torch

    from .bench_data import flagship_cfg, host_batch
    from .inference import eval_step, resolve_device, to_device_batch
    from .models.tricolo_net import TriCoLoNet

    target = resolve_device(device)
    cfg = flagship_cfg()
    torch.manual_seed(0)
    model = TriCoLoNet.from_config(cfg).to(target).eval()
    out = eval_step(model, to_device_batch(host_batch(cfg), target))
    return {k: tuple(v.shape) for k, v in out.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="8",
                    help="the number of ranks (default 8), or 'entry'")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every rank on cuda:0; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.what == "entry":
        print(entry(args.device), flush=True)
        return 0
    dryrun(int(args.what), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-component timing of the flagship train step on the GPU.

    python -m tricolo_tpu_torch.profile_step [--iters 20] [--batch-size 128]
        [--override key=value ...] [--device cuda|cpu]

The port's twin of ``scripts/profile_step.py``: the bench's Tri(I+V) step
(``bench.bench_config``, ``fit_budgets``, ``to_transfer`` and ``stage``:
batch 128, 6 views of 128², 64³ voxels on windowed_compact, bf16 compute,
the loss through the NT-Xent kernels; ``--override
data.voxel_transfer=packed`` gives the JAX script's dense-input path)
broken into rows:

* ``full_step``: the full train step, its state threaded through (the
  bench's two staged batches in turn);
* ``prepare_device_batch`` alone;
* ``forward_loss``: forward + loss in train mode;
* ``{text,image,voxel}_fwd`` and ``_fwd_bwd``: each encoder's forward, and
  its forward + backward under the JAX script's surrogate loss ``sum(out *
  out.detach())`` (a dense cotangent on the output: the encoder's share of
  the step's backward; the gradient itself is 0 up to rounding, the
  outputs being unit vectors);
* ``nt_xent_fwd_bwd``: the NT-Xent loss over the 3 pairs, forward +
  backward, on seeded unit-norm (B, 512) f32 embeddings (through the pair
  and two-term kernels);
* ``adam_update``: the Adam update (``training.optim.Adam``) alone, on zero
  gradients.

Each row is the median of 3 loops of ``--iters`` calls, each loop ending in
a CUDA synchronize, per call; the first call is a warm-up that also counts
the row's kernel launches. Prints one JSON line: ``{"rows": {name: ms},
"launches": {name: {wrapper: n}}, "iters", "batch_size", "card", ...}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable

import numpy as np
import torch

SEED = 0


def loop_ms(fn: Callable, iters: int, device, loops: int = 3) -> float:
    """The median over ``loops`` of a host clock around ``iters`` calls that
    ends in a synchronize, per call, in ms."""
    times = []
    for _ in range(loops):
        tic = time.perf_counter()
        for _ in range(iters):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - tic) / iters * 1e3)
    return statistics.median(times)


def counted(fn: Callable, device) -> dict:
    """One call of ``fn`` (the warm-up) and the kernel launches it made."""
    from . import ops

    ops.reset_launches()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {k: v for k, v in ops.launches().items() if v}


def encode(encoder, inputs: dict, generator=None):
    """The encoder's features from the prepared inputs, as
    ``TriCoLoNet.forward`` feeds it."""
    from .models.bigru import BiGRUEncoder
    from .models.clip_heads import CLIPImageEncoder, CLIPTextEncoder
    from .models.voxel_cnn import VoxelCNNEncoder

    if isinstance(encoder, BiGRUEncoder):
        return encoder(inputs["tokens"])
    if isinstance(encoder, VoxelCNNEncoder):
        if "voxel_windows" in inputs:
            return encoder(windows=inputs["voxel_windows"], tile_occ=inputs["voxel_tile_occ"])
        if "voxel_rows" in inputs:
            return encoder(inputs["voxel_rows"], inputs["voxel_row_ids"])
        return encoder(voxels=inputs["voxels"])
    if isinstance(encoder, CLIPTextEncoder):
        return encoder(inputs["clip_embeddings_text"], generator)
    if isinstance(encoder, CLIPImageEncoder):
        return encoder(inputs["clip_embeddings_img"], generator)
    return encoder(inputs["images"], generator)


def surrogate_backward(model, encoder, inputs: dict, cotangent=None) -> torch.Tensor:
    """The encoder's forward in train mode under the model's autocast, then
    the backward of ``sum(out · cotangent)`` into its parameters' ``.grad``
    (set to None first); ``cotangent`` defaults to ``out.detach()``, the
    JAX script's surrogate ``sum(out * stop_gradient(out))``. Returns the
    loss."""
    from .inference import autocast

    encoder.train()
    encoder.zero_grad(set_to_none=True)
    with autocast(model, next(iter(inputs.values())).device.type):
        out = encode(encoder, inputs).float()
    loss = (out * (out.detach() if cotangent is None else cotangent)).sum()
    loss.backward()
    return loss


def unit_embeddings(batch: int, dim: int = 512, device="cpu") -> dict:
    """Seeded unit-norm (batch, dim) f32 text, image and voxel features."""
    rng = np.random.default_rng(SEED)
    out = {}
    for key in ("text_features", "image_features", "voxel_features"):
        z = rng.standard_normal((batch, dim)).astype(np.float32)
        out[key] = torch.from_numpy(z / np.linalg.norm(z, axis=1, keepdims=True)).to(device)
    return out


def profile(cfg, device, iters: int, hosts: list) -> dict:
    """Every row's ms and launches on ``device`` (module docstring)."""
    from .bench import build_step, fit_budgets, stage, to_transfer
    from .inference import autocast, prepare_inputs
    from .losses import make_loss_fn, pairwise_losses
    from .training import dropout_generator

    tile_rows = fit_budgets(cfg, hosts)
    batches = [stage(to_transfer(cfg, h, tile_rows), device) for h in hosts]
    model, optimizer, step = build_step(cfg, device)
    lr = cfg.optimizer.lr
    rows: dict = {}
    launches: dict = {}

    def row(name: str, fn: Callable) -> None:
        launches[name] = counted(fn, device)
        rows[name] = loop_ms(fn, iters, device)

    taken = [0]

    def train_step():
        step(batches[taken[0] % 2], lr, dropout_generator(cfg.train_seed, taken[0], device))
        taken[0] += 1

    row("full_step", train_step)
    batch = batches[0]
    row("prepare_device_batch", lambda: prepare_inputs(model, batch))
    loss_pair = make_loss_fn(cfg)

    @torch.no_grad()
    def forward_loss():
        model.train()
        inputs = prepare_inputs(model, batch)
        with autocast(model, device.type):
            output = model(inputs)
        return pairwise_losses(loss_pair, {k: v.float() for k, v in output.items()},
                               "t")["t/total_loss"]

    row("forward_loss", forward_loss)
    inputs = prepare_inputs(model, batch)
    encoders = [("text", model.text_encoder), ("image", model.image_encoder),
                ("voxel", model.voxel_encoder)]
    for label, encoder in encoders:
        if encoder is None:
            continue

        @torch.no_grad()
        def forward(encoder=encoder):
            encoder.train()
            with autocast(model, device.type):
                return encode(encoder, inputs)

        row(f"{label}_fwd", forward)
        row(f"{label}_fwd_bwd", lambda encoder=encoder: surrogate_backward(model, encoder, inputs))

    emb = unit_embeddings(cfg.data.batch_size, cfg.model.out_dim, device)

    def loss_fwd_bwd():
        leaves = {k: v.clone().requires_grad_(True) for k, v in emb.items()}
        pairwise_losses(loss_pair, leaves, "t")["t/total_loss"].backward()

    row("nt_xent_fwd_bwd", loss_fwd_bwd)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    row("adam_update", optimizer.step)
    return {"rows": rows, "launches": launches}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m tricolo_tpu_torch.profile_step",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="calls a timed loop")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--voxel-size", type=int, default=64)
    ap.add_argument("--override", action="append", default=[],
                    help="a config override key=value (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from .bench import bench_config, card_name
    from .bench_data import host_batch
    from .inference import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.iters < 1:
        raise ValueError("--iters must be at least 1")
    cfg = bench_config("tri", args.voxel_size, args.batch_size, args.override)
    n_points = 8192 * args.voxel_size**3 // 64**3  # the bench's default
    hosts = [host_batch(cfg, n_points=n_points, seed=s) for s in range(2)]
    out = profile(cfg, device, args.iters, hosts)
    out.update(iters=args.iters, batch_size=cfg.data.batch_size,
               voxel_size=cfg.data.voxel_size, voxel_transfer=cfg.data.voxel_transfer,
               card=card_name(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

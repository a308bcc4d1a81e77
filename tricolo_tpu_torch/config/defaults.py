"""Default configuration tree.

Key surface mirrors the reference so CLI invocations carry over
(reference config/config.yaml + config/data/*.yaml): same knob names and
defaults for seeds, trainer schedule, optimizer, loss, model modules, data
group and inference block. TPU-specific additions live under ``parallel``
and ``precision``; neither changes reference-default behavior.

This is the PyTorch port's own copy of ``tricolo_tpu.config.defaults``
(the port imports nothing of the JAX package), kept key-for-key identical
so one command line configures both packages. ``parallel.*`` is read by
``tricolo_tpu_torch.parallel``: one process per GPU, ``data_parallel`` the
world size, the rank triple from the keys or torchrun's environment,
``param_sharding`` replicated or ``fsdp`` (``parallel.sharding_rules``).
Keys that only the JAX package reads (``precision.scoped_vmem_kib``, the
Pallas toggles) are accepted and ignored here.
"""

from __future__ import annotations

import json
import os

from .node import ConfigNode

_HERE = os.path.dirname(os.path.abspath(__file__))


def _ignored_models_chair_table() -> list[str]:
    with open(os.path.join(_HERE, "ignored_models_chair_table.json")) as f:
        return json.load(f)["ignored_models"]


def default_config() -> ConfigNode:
    """The root defaults (reference config/config.yaml:15-108)."""
    return ConfigNode(
        {
            "project_root_path": os.getcwd(),
            "experiment_output_path": "${project_root_path}/output/${data.dataset}/${experiment_name}",
            # Seeds (reference config.yaml:18-19).
            "train_seed": 123,
            "test_seed": 321,
            "ckpt_name": None,
            "experiment_name": None,
            # Metric logging. WandB is used when available + enabled; a JSONL
            # metrics file is always written (reference config.yaml:24-28).
            "logger": {
                "backend": "auto",  # auto | wandb | jsonl | none
                "project": "TriCoLo",
                "name": "${experiment_name}",
                "save_dir": "${experiment_output_path}/training",
            },
            # Trainer schedule (reference config.yaml:30-36).
            "trainer": {
                "accelerator": "auto",  # auto → TPU if present, else CPU
                "max_epochs": 20,
                "profiler": "simple",
                "num_sanity_val_steps": 0,
                "check_val_every_n_epoch": 2,
                "log_every_n_steps": 10,
            },
            # Checkpoint retention (reference config.yaml:39-47).
            "checkpoint_monitor": {
                "monitor": "val_eval/RR@5",
                "mode": "max",
                "save_last": False,
                "save_top_k": 3,
                # Beyond the reference: true = save on a background writer
                # thread (device-side snapshot, ordered filesystem effects)
                # so the epoch loop never blocks on the ~8 s/save D2H.
                # Identical on-disk results; fit() flushes before returning.
                "async_save": False,
                "every_n_epochs": "${trainer.check_val_every_n_epoch}",
                "dirpath": "${experiment_output_path}/training",
            },
            # Adam (reference config.yaml:50-53). weight_decay is additive L2
            # on the gradient, matching torch.optim.Adam's decoupling-free
            # formulation (not AdamW).
            "optimizer": {
                "name": "adam",
                "lr": 0.00035,
                "weight_decay": 1.0e-6,
                # torch-Adam over one flattened buffer — same numbers,
                # O(1) kernels instead of ~5 stages per leaf. MEASURED
                # NEGATIVE on v5e (PERF.md round 3): 86.9 vs 84.7 ms/step
                # (the ravel/unravel copies cost more than the per-leaf
                # dispatch they remove) and 10× the compile time (688 s vs
                # 69 s). Kept as an option; checkpoints convert between
                # layouts on load either way.
                "flat_update": False,
            },
            # Cosine decay from start_epoch to max_epochs; inert at the
            # defaults since start_epoch == max_epochs (reference
            # config.yaml:56, callback/lr_decay_callback.py:5-16).
            "lr_decay": {"start_epoch": 20},
            "model": {
                "out_dim": 512,
                "voxel_encoder": None,
                "image_encoder": None,
                "text_encoder": None,
                "modules": {
                    "BiGRUEncoder": {
                        "vocab_size": "${data.vocab_size}",
                        "embed_dim": 256,
                        "hidden_dim": 128,
                        "out_dim": "${model.out_dim}",
                    },
                    "MVCNNEncoder": {
                        "z_dim": 512,
                        "cnn_name": "resnet18",
                        "num_views": "${data.num_views}",
                        "out_dim": "${model.out_dim}",
                        # Path to converted torchvision weights (msgpack /
                        # npz produced by tricolo_tpu.models.resnet
                        # conversion); None → random init.
                        "pretrained_path": None,
                        # The JAX package's ResNet stem opt-ins: bn1→relu→
                        # maxpool with a hand-derived backward, and the stem
                        # conv over a 2×2 space-to-depth input. Both are
                        # exact rewrites of the plain stem with the same
                        # variables; the port accepts them and runs the
                        # plain stem.
                        "hybrid_stem": False,
                        "s2d_stem": False,
                    },
                    "VoxelCNNEncoder": {
                        "voxel_size": "${data.voxel_size}",
                        "ef_dim": 32,
                        "z_dim": 512,
                        "out_dim": "${model.out_dim}",
                        # "auto": the default hybrid XLA path (pure XLA
                        # forward; hand-derived backward with BN param
                        # grads reduced at pooled resolution — measurably
                        # the fastest end-to-end, PERF.md). false: the
                        # plain composed XLA chain. true: opt-in fused
                        # Pallas forward/backward kernels (exact, but
                        # slower end-to-end since they break XLA's
                        # conv-epilogue fusions); under masked_bn no
                        # Pallas masked kernel exists, so true falls back
                        # to the composed masked path. The port computes
                        # every value with its one kernel path (K1/K3);
                        # TriCoLoNet.from_config refuses any other value.
                        "fused_bn_pool": "auto",
                        # Submanifold-faithful BN (spconv semantics):
                        # statistics over occupied sites only, inactive
                        # sites zeroed through the stack. DEFAULT ON since
                        # round 3: it is the reference's actual semantics
                        # (sparse_cnn.py:11-40) and decisively better on
                        # the structured retrieval benchmark (RR@1
                        # 97.9±0.3 vs 67.7±17.9 dense over 3 seeds —
                        # PARITY.md), at +4% voxel-encoder cost via the
                        # hybrid masked backward. false selects all-site
                        # statistics (the torch-oracle-pinned path).
                        "masked_bn": True,
                        # Tile-sparse compute for the first N blocks —
                        # EXACT under masked_bn (submanifold zeros
                        # everything outside active 8³ tiles); requires
                        # masked_bn=true + a mask channel. This flag gates
                        # only the DENSE-input plan (voxel_transfer=
                        # packed/dense); the windowed transfers run
                        # tile-sparse inherently. Budget for the dense
                        # plan's on-device compaction =
                        # tile_budget_frac · B·(D/8)³ tiles; overflow
                        # truncates (trainer warns).
                        "tile_sparse": False,
                        "tile_sparse_blocks": 2,
                        "tile_budget_frac": 0.5,
                        # PER-SAMPLE row budget k for the windowed_compact
                        # host compaction ((B, k, s³) rows shard with
                        # their samples under the mesh). "auto" fits the
                        # split's measured max per-sample active-tile
                        # count — truncation is then impossible by
                        # construction; an int pins k (overflow follows
                        # data.tile_overflow).
                        "tile_budget": "auto",
                        # Tile→grid handoff layout: "transpose" (tile-
                        # major rows + transpose) or "lines" (direct
                        # NDHWC line-segment scatter, no transpose
                        # pass). Exact either way; default chosen by
                        # end-to-end bench (PERF.md round 3).
                        "scatter_layout": "transpose",
                        # Opt-in: express the VALID tile-row convs' input
                        # gradient as an explicit forward conv instead of
                        # XLA's transposed op (ops/conv3d.py) — targeted
                        # fusion.146 (30% of floor); the on-chip A/B
                        # measured a wash (PERF.md round 4), so the
                        # default stays the simpler XLA derivation. Same
                        # forward; grads agree to reduction order
                        # (tests/test_conv3d.py).
                        "explicit_dgrad": False,
                    },
                    "clip_model": "ViT-L/14",
                    "clip_feature_dim": 768,
                    "CLIPImageEncoder": {
                        "out_dim": "${model.out_dim}",
                        "num_views": "${data.num_views}",
                        "feature_dim": "${model.modules.clip_feature_dim}",
                        "dropout": 0.1,
                    },
                    "CLIPTextEncoder": {
                        "out_dim": "${model.out_dim}",
                        "feature_dim": "${model.modules.clip_feature_dim}",
                        "dropout": 0.1,
                    },
                },
            },
            # Loss selection (reference config.yaml:96-104).
            "loss": {
                "name": "NTXentLoss",
                # use_pallas: blocked online-softmax Pallas kernel (no O(B²)
                # HBM logits; for very large global batches). Equivalent.
                "NTXentLoss": {
                    "temperature": 0.1,
                    "alpha_weight": 0.25,
                    "use_pallas": False,
                },
                "TripletLoss": {"margin": 0.025},
            },
            "inference": {
                "split": "val",
                "save_predictions": True,
                "evaluate": True,
                "output_dir": "${experiment_output_path}/inference/${inference.split}/predictions",
                # TPU-native addition: run similarity/ranking/metrics under
                # jit instead of the NumPy pipeline (oracle-tested equal).
                "device_eval": False,
            },
            # --- TPU-native additions -------------------------------------
            "parallel": {
                # Number of data-parallel devices; "auto" = all local devices.
                # The port: the world size, one process per GPU ("auto";
                # an int must equal it).
                "data_parallel": "auto",
                # Gather embeddings across the mesh inside the contrastive
                # loss so negatives span the global batch. At global batch ==
                # reference batch this is numerically the reference loss.
                "global_negatives": True,
                # Parameter placement: "replicated" (parity default) or
                # "fsdp" (ZeRO-style sharding of large params over the data
                # axis; numerically identical, tested).
                "param_sharding": "replicated",
                # Use the explicit shard_map ring formulation of the
                # global-negative NT-Xent instead of the pjit-automatic path
                # (equivalent, tested; scales to very large global batches
                # by keeping each chip's logit rows local).
                "explicit_collectives": False,
                # Multi-process (multi-host) runtime: initialize
                # jax.distributed so one global mesh spans every host's
                # devices; each process loads only its stripe of the global
                # batch (parallel/multiprocess.py). The coordinator triple
                # may come from these keys, the JAX_* env vars, or TPU-pod
                # auto-detection (all three None). data.batch_size stays the
                # GLOBAL batch. The port: torch.distributed, the triple from
                # these keys or torchrun's MASTER_ADDR/MASTER_PORT/
                # WORLD_SIZE/RANK.
                "multiprocess": False,
                "coordinator_address": None,
                "num_processes": None,
                "process_id": None,
            },
            "precision": {
                # bfloat16 activations through convs/matmuls (autocast), the
                # loss in float32. param_dtype: the parameters' and the Adam
                # moments' dtype (float32 or bfloat16); BN running
                # statistics stay float32 in either.
                "compute_dtype": "bfloat16",
                "param_dtype": "float32",
                # XLA scoped-VMEM budget for the step programs (TPU only).
                # Re-tuned per program generation: 32 MiB wins on the
                # round-4 per-sample windowed flagship (2508-2525 vs
                # 2429 @16MiB / 2451-2476 @64MiB / 2430 @96MiB pairs/s on
                # v5e — PERF.md round 4; round 3's 64 MiB pick was tuned
                # on the pre-halo-3 program). 0/null keeps XLA's default.
                "scoped_vmem_kib": 32768,
                # Rematerialize the voxel encoder in backward. Off at 64³
                # (neutral, PERF.md "Remat"); required part of the 128³
                # memory plan (with data.batch_size=32 on a 16 GB chip).
                "remat_voxel": False,
            },
            "bench": {"warmup_steps": 3, "steps": 20},
        }
    )


def data_preset(name: str) -> ConfigNode:
    """Data group presets (reference config/data/*.yaml)."""
    base = ConfigNode(
        {
            "preset": name,
            "dataset_root_path": "${project_root_path}/data",
            "batch_size": 128,
            "num_workers": 8,
            "image_size": 128,
            "voxel_size": 64,
            "num_views": 6,
            # Padded sparse-voxel budget per sample. null → the split's max
            # occupied-site count (exact). An explicit cap bounds the device
            # scatter cost / batch bytes; samples above it are truncated in
            # site order (documented divergence from keeping all sites).
            "voxel_max_points": None,
            # Voxel host→device format: "packed" ships sparse u32 pairs and
            # scatters on device (~6.6 ms/step at 64³ on v5e, 16× fewer H2D
            # bytes); "dense" densifies in the prefetch thread and ships the
            # u32 grid (scatter cost vanishes; H2D overlaps with compute);
            # "windowed"/"windowed_compact" materialize halo'd tile windows
            # (10³ rows, or 14³ when VoxelCNNEncoder.tile_sparse_blocks ≥ 2
            # — the loader derives the halo) for the tile-sparse masked
            # voxel encoder (requires masked_bn; the DataModule falls back
            # to packed with a warning when masked_bn=false). DEFAULT is
            # "windowed_compact" since round 4 — the benchmarked flagship
            # path (~2× the dense masked step at 64³, PERF.md): per-sample
            # (B, k, s³) active rows that shard with their samples under
            # the mesh, with k auto-fitted to the split
            # (VoxelCNNEncoder.tile_budget="auto") so no site or tile is
            # ever dropped. "packed" remains for parity studies and
            # unmasked (all-site BN) runs.
            "voxel_transfer": "windowed_compact",
            # windowed_compact overflow policy when an EXPLICIT
            # tile_budget is too small for a batch: "error" (default —
            # truncation silently changes numerics) or "truncate" (warn
            # per occurrence, drop each sample's highest tiles). Inert
            # under tile_budget="auto".
            "tile_overflow": "error",
        }
    )
    if name == "base":
        base.merge(
            {
                "dataset": "Text2ShapeChairTable",
                "dataset_path": "${data.dataset_root_path}/text2shape-data/chair_table",
                "exp_data_root_path": "${data.dataset_path}/preprocessed/exp_data",
                "train_lang_data_path": "${data.exp_data_root_path}/train_map.json",
                "val_lang_data_path": "${data.exp_data_root_path}/val_map.json",
                "test_lang_data_path": "${data.exp_data_root_path}/test_map.json",
                "vocab_size": 3588,
                "ignored_models": [],
            }
        )
    elif name == "text2shape_chair_table":
        base.merge(data_preset("base"))
        base["preset"] = name
        base["ignored_models"] = _ignored_models_chair_table()
    elif name == "text2shape_c13":
        base.merge(data_preset("base"))
        base.merge(
            {
                "preset": name,
                "dataset": "Text2ShapeC13",
                "dataset_path": "${data.dataset_root_path}/text2shape-data/c13",
                "vocab_size": 3968,
                "ignored_models": [],
            }
        )
    elif name == "synthetic":
        # Tiny CPU-runnable synthetic dataset for tests / smoke runs.
        base.merge(
            {
                "preset": name,
                "dataset": "Synthetic",
                "dataset_path": "${project_root_path}/data/synthetic",
                "exp_data_root_path": "${data.dataset_path}",
                "train_lang_data_path": "",
                "val_lang_data_path": "",
                "test_lang_data_path": "",
                "vocab_size": 128,
                "ignored_models": [],
                "batch_size": 8,
                "num_workers": 0,
                "image_size": 32,
                "voxel_size": 32,
                "num_views": 2,
                "num_models": 12,
                "captions_per_model": 3,
                "max_tokens": 16,
            }
        )
    elif name == "structured":
        # Attribute-grounded synthetic dataset (data/structured.py):
        # captions determine shape attributes so retrieval metrics carry
        # signal — the dense-vs-masked BN experiment fixture (PARITY.md).
        base.merge(
            {
                "preset": name,
                "dataset": "StructuredSynthetic",
                "dataset_path": "${project_root_path}/data/structured",
                "exp_data_root_path": "${data.dataset_path}",
                "train_lang_data_path": "",
                "val_lang_data_path": "",
                "test_lang_data_path": "",
                "vocab_size": 64,
                "ignored_models": [],
                "batch_size": 128,
                "num_workers": 0,
                "image_size": 64,
                "voxel_size": 64,
                "num_views": 3,
                "num_models": 300,
                "captions_per_model": 3,
                "max_tokens": 24,
                "structured_seed": 0,
            }
        )
    else:
        raise KeyError(f"unknown data preset: {name}")
    return base

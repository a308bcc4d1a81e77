"""Config entry point: ``load_config(overrides)`` (the port's copy of
``tricolo_tpu.config``; same tree, same grammar).

Override grammar matches the reference's Hydra CLI (README.md:92):
``data=text2shape_chair_table`` selects a data-group preset, ``a.b=v``
overrides an existing key, ``+a.b=v`` adds a new one. YAML files may also be
merged via ``--config path.yaml`` style entries handled by the entry points.
"""

from __future__ import annotations

from typing import Iterable

from .defaults import data_preset, default_config
from .node import ConfigNode, apply_overrides, parse_scalar, resolve_interpolations

__all__ = [
    "ConfigNode",
    "load_config",
    "data_preset",
    "default_config",
    "parse_scalar",
]


def load_config(overrides: Iterable[str] | None = None) -> ConfigNode:
    overrides = list(overrides or [])
    cfg = default_config()

    # The `data=<preset>` group override is applied first, like Hydra's
    # defaults-list (reference config/config.yaml:8-12).
    data_name = "base"
    rest = []
    for item in overrides:
        key, _, value = item.partition("=")
        if key.strip() == "data":
            data_name = value.strip()
        else:
            rest.append(item)
    cfg["data"] = data_preset(data_name)

    apply_overrides(cfg, rest)
    resolve_interpolations(cfg)
    return cfg

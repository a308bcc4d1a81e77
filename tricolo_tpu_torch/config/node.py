"""Minimal structured-config system with dotted CLI overrides.

Mirrors the Hydra surface the reference exposes (root config + a ``data``
group, ``${a.b}`` interpolation, ``key.sub=value`` CLI overrides including
``+new.key=value`` for keys that do not exist yet — reference
config/config.yaml and README.md:92) without depending on Hydra. Any config
key can be overridden from the command line with the same syntax the
reference documents, so invocations carry over unchanged.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Iterable

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
_MISSING = object()


class ConfigNode(dict):
    """A dict with attribute access and recursive wrapping of nested dicts."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = value

    def __setitem__(self, key: str, value: Any):
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- dotted-path access ------------------------------------------------
    def get_path(self, path: str, default: Any = _MISSING) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                if default is _MISSING:
                    raise KeyError(path)
                return default
        return node

    def set_path(self, path: str, value: Any, allow_new: bool = True):
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node:
                if not allow_new:
                    raise KeyError(f"unknown config path: {path}")
                node[part] = ConfigNode()
            node = node[part]
            if not isinstance(node, dict):
                raise KeyError(f"cannot descend into non-dict at {part!r} for {path}")
        if not allow_new and parts[-1] not in node:
            raise KeyError(
                f"unknown config key: {path} (prefix with '+' to add new keys)"
            )
        node[parts[-1]] = value

    def merge(self, other: dict):
        """Recursively merge ``other`` into self (other wins)."""
        for key, value in other.items():
            if (
                key in self
                and isinstance(self[key], dict)
                and isinstance(value, dict)
            ):
                self[key].merge(value)
            else:
                self[key] = copy.deepcopy(value)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()
        }

    def pretty(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def parse_scalar(text: str) -> Any:
    """Parse a CLI override value the way YAML would parse a scalar."""
    stripped = text.strip()
    lowered = stripped.lower()
    if lowered in ("null", "none", "~"):
        return None
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    for caster in (int, float):
        try:
            return caster(stripped)
        except ValueError:
            pass
    if stripped.startswith(("[", "{")):
        try:
            return json.loads(stripped)
        except json.JSONDecodeError:
            pass
    if len(stripped) >= 2 and stripped[0] == stripped[-1] and stripped[0] in "'\"":
        return stripped[1:-1]
    return stripped


def apply_overrides(cfg: ConfigNode, overrides: Iterable[str]):
    """Apply ``key=value`` / ``+key=value`` CLI overrides in order."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key=value, got {item!r}")
        key, _, raw = item.partition("=")
        key = key.strip()
        allow_new = key.startswith("+")
        if allow_new:
            key = key[1:]
        cfg.set_path(key, parse_scalar(raw), allow_new=allow_new)


def resolve_interpolations(cfg: ConfigNode, max_passes: int = 8):
    """Resolve ``${a.b}`` string interpolations against the config root.

    Runs to a fix-point so chained interpolations (as in the reference's
    ``experiment_output_path`` → ``project_root_path`` chain,
    config/config.yaml:15-16) resolve in any order. Non-string lookups that
    fully replace the string (``"${data.vocab_size}"``) keep their type.
    """

    def resolve_value(value: Any) -> Any:
        if not isinstance(value, str):
            return value
        full = _INTERP_RE.fullmatch(value)
        if full:
            target = cfg.get_path(full.group(1), default=value)
            # Leave the placeholder intact while the target is unset (None)
            # so a later set + re-resolve still works (e.g. entry points
            # defaulting experiment_name after load).
            return value if target is None else target

        def sub(match: re.Match) -> str:
            target = cfg.get_path(match.group(1), default=match.group(0))
            return match.group(0) if target is None else str(target)

        return _INTERP_RE.sub(sub, value)

    for _ in range(max_passes):
        changed = False

        def walk(node: ConfigNode):
            nonlocal changed
            for key, value in list(node.items()):
                if isinstance(value, ConfigNode):
                    walk(value)
                else:
                    new = resolve_value(value)
                    if new is not value and new != value:
                        node[key] = new
                        changed = True

        walk(cfg)
        if not changed:
            break
    return cfg

"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names every cell (``workloads``),
configuration, end-to-end metric and per-layer metric. Each part is a file
of its own under this folder, found from its name alone, so a later change
adds a cell, a traffic mix or a metric by adding files and entries:

* a configuration: ``configs/<name>.json`` (the port's overrides, the
  widths the reference reads, the source and what was assumed);
* a traffic mix: ``traffic/<name>.json``, whose ``generator`` names a
  module ``traffic/<generator>.py`` with ``generate(spec, sizes, seed, ...)``;
* a cell's correctness limits: ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<name>.py`` with ``UNIT``, ``LAYER``,
  ``MOVES`` and ``read(run)``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def generator(self):
        return load_module(HERE / "traffic" / f"{self.traffic['generator']}.py",
                           f"benchmark_traffic_{self.traffic['generator']}")

    def metric_reader(self, name: str):
        return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is read in ``cell``: listed in its ``workloads``,
    or, without that key, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
    entry = cells[name]
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)

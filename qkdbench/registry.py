"""Everything a cell needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics; each has files of its own under this folder:

    configs/<config>.json          the configuration as it is run
    workloads/<cell>.json          the cell: its traffic driver and mix
    traffic/<driver>.py            a traffic driver: run(ctx) -> Outcome
    layer_metrics/<metric>.py      a per-layer metric: read(record)

A later change adds a configuration, a cell or a metric by adding its
entry and its files; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "load_benchmark", "Cell", "cell", "load_module"]

HERE = Path(__file__).resolve().parent


def load_benchmark(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """The Python file ``path`` loaded as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json`` with its files: ``entry`` (the
    ``workloads`` entry), ``workload`` (its file), ``config`` (its
    configuration's file), ``end_to_end`` and ``per_layer`` (the metrics
    it reports) and the loaders of its driver and metric readers."""

    def __init__(self, bench: dict, name: str, root: Path = HERE):
        self.root = Path(root)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                           f"{', '.join(sorted(entries))})")
        self.name = name
        self.entry = entries[name]
        self.workload = _read_json(self.root / "workloads" / f"{name}.json")
        self.config = _read_json(self.root / "configs"
                                 / f"{self.entry['config']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        """The cell's traffic driver module (``traffic/<driver>.py``)."""
        name = self.workload["driver"]
        return load_module(self.root / "traffic" / f"{name}.py",
                           f"qkdbench_traffic_{name}")

    def metric_reader(self, metric: str):
        """``read(record)`` of per-layer metric ``metric``."""
        return load_module(self.root / "layer_metrics" / f"{metric}.py",
                           "qkdbench_metric_" + metric.replace(".", "_")
                           ).read


def cell(bench_path, name: str, root: Path = HERE) -> Cell:
    return Cell(load_benchmark(bench_path), name, root)

"""`BENCHMARK.json` and the files found by name: a cell's configuration
(`configs/<config>.json`), its data generator (`data/<config>.py`), its
traffic mix (`traffic/<cell>.json`), its correctness limits
(`limits/<cell>.json`), a per-layer metric's reader
(`metrics/<metric>.py`), a backend's reference (`reference/
backend_<backend>.py`) and a work count (`counts/<name>.py`)."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

from .env import BENCH, ROOT

_MODULES: dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark by path (names may hold `-` and
    `.`), loaded once a process."""
    path = path.resolve()
    if path not in _MODULES:
        name = "bench_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                   .parts).replace("-", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


class Cell:
    """One entry of `workloads` with everything found by its names."""

    def __init__(self, name: str, man: dict | None = None):
        man = man if man is not None else manifest()
        by_name = {w["name"]: w for w in man["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(by_name)}")
        self.entry = by_name[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config_name = self.entry["config"]
        self.traffic_name = self.entry["traffic"]
        cfg_entry = {c["name"]: c for c in man["configs"]}[self.config_name]
        self.config = load_json(ROOT / cfg_entry["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{name}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"]
                          if name in m.get("workloads", [name])]

    def data_generator(self) -> ModuleType:
        return load_module(BENCH / "data" / f"{self.config_name}.py")

    def reference(self) -> ModuleType:
        return load_module(BENCH / "reference"
                           / f"backend_{self.config['spec']['backend']}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py")

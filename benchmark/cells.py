"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (its file is the configuration's ``file``) and
a traffic mix (``benchmark/traffic/<traffic>.json``). Everything else is
found by the name a data file gives it, one module a name:

* ``benchmark/adapters/<adapter>.py`` (the traffic's ``adapter``): how the
  entry point the traffic names is called and what a batch returns;
* ``benchmark/inputs/<kind>.py`` (the configuration's ``cloud.kind``): one
  lane's inputs, for the one generator (`traffic.make_pool`);
* ``benchmark/checks/<check>.py`` (the configuration's ``check``): the
  comparison with the plain reference that decides ``correct``;
* ``benchmark/metrics/<name>.py`` (a per-layer metric's ``name``): its reader.

Adding a cell, a configuration, an entry point, a kind of input or problem,
or a metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and metrics."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = [c for c in bench["configs"] if c["name"] == self.entry["config"]][0]
        with open(root / conf["file"]) as f:
            self.config = json.load(f)
        with open(HERE / "traffic" / f"{self.entry['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.solver = {**self.config["solver"], **self.traffic.get("solver", {})}

    @property
    def shape(self) -> tuple:
        return tuple(self.config["grid"])

    @property
    def lanes(self) -> int:
        return int(self.traffic["lanes"])


def module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded once by its name."""
    key = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(metric_name: str):
    """The ``read(run)`` function of ``benchmark/metrics/<metric_name>.py``."""
    return module("metrics", metric_name).read

"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells (``workloads``),
their configurations and the metrics. Everything else is a file found by
a name in it:

* ``portbench/cells/<cell>.json``: the pipeline driver's name, the
  pipeline's settings, the sample that the correctness check judges and
  its limits;
* the configuration's ``file`` (``portbench/configs/<config>.json``);
* ``portbench/traffic/<traffic>.json``: the traffic generator's
  parameters;
* ``portbench/drivers/<driver>.py``: the pipeline entry point's driver;
* ``portbench/metrics/<metric>.py``, else ``<metric before its first
  dot>.py``: the metric's reader.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict          # the manifest's entry
    spec: dict              # cells/<name>.json
    config: dict            # the configuration's file
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list        # the manifest's metrics this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def driver(self, root: Path = ROOT):
        return load_file(root / "portbench" / "drivers"
                         / f"{self.spec['driver']}.py")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    man = load_manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in man["configs"]}
    pkg = root / "portbench"
    return Cell(
        name=name, workload=w,
        spec=_json(pkg / "cells" / f"{name}.json"),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(pkg / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in man["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in man["per_layer"] if _reports(m, name)])


def load_file(path: Path):
    """Import the module in ``path`` (a name may hold dots and dashes)."""
    if not path.exists():
        raise KeyError(f"no file {path}")
    mod_name = "portbench_file" + "".join(
        c if c.isalnum() else "_" for c in str(path.resolve()))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The module whose ``read(record)`` gives metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = root / "portbench" / "metrics" / f"{stem}.py"
        if path.exists():
            return load_file(path)
    raise KeyError(f"no reader for metric {name!r} under portbench/metrics")

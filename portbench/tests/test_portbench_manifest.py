"""BENCHMARK.json against the benchmark contract's shape, and every name
in it resolving to its file."""

import json
import re
import shutil

import pytest

from portbench.harness.manifest import ROOT, load_cell, metric_reader
from portbench.harness.record import Traced

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    names = [e["name"] for e in MAN[section]]
    assert len(set(names)) == len(names)
    for e in MAN[section]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_metrics_and_cells_agree():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        reports = [m for m in MAN["end_to_end"]
                   if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reports) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in MAN["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    c = load_cell(cell)
    assert hasattr(c.driver(), "Driver")
    assert c.config["dtype"] == "bfloat16"
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]).read)


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A cell, a traffic mix and a per-layer metric added in a copy: new
    files and manifest entries, no existing file edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    man = json.loads(json.dumps(MAN))
    (tmp_path / "portbench" / "traffic" / "pan8.json").write_text(json.dumps(
        dict(json.loads((ROOT / "portbench/traffic/pan16.json").read_text()),
             clip_frames=8, key_every=8)))
    (tmp_path / "portbench" / "cells" / "pixel-pan8-b8.json").write_text(
        (ROOT / "portbench/cells/pixel-pan16-b8.json").read_text())
    (tmp_path / "portbench" / "metrics" / "pairs_per_frame.py").write_text(
        "def read(rec):\n    return rec.traced.pairs / rec.traced.frames\n")
    man["workloads"].append({"name": "pixel-pan8-b8", "config": "sd15-pixel",
                             "traffic": "pan8", "chips": 1, "why": "8"})
    man["per_layer"].append({"name": "pairs_per_frame.pixel", "unit": "1",
                             "better": "lower", "source": "program_counter",
                             "layer": "flow", "moves": "pixel_frames_per_s",
                             "workloads": ["pixel-pan8-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = load_cell("pixel-pan8-b8", root=tmp_path)
    assert c.traffic["clip_frames"] == 8
    assert [m["name"] for m in c.per_layer] == ["pairs_per_frame.pixel"]
    rec = type("R", (), {"traced": Traced(frames=8, pairs=6)})()
    assert metric_reader("pairs_per_frame.pixel", root=tmp_path).read(rec) \
        == 0.75
    for p, data in before.items():
        assert p.read_bytes() == data

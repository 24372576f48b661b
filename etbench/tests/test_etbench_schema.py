"""BENCHMARK.json and the files the harness finds by its names: the schema
of the file (keys, names, units, sources, bounds, limits of size), and a
file for every configuration, traffic mix, cell and metric."""
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _exists(*parts):
    return os.path.exists(os.path.join(ROOT, *parts))


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["etbench"] and bench["command"][1].startswith("etbench/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("etbench/") and _exists(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert _exists("etbench", "reference", f"{config['model']}.py")
        assert _exists(config["checkpoint"])


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in configs and 1 <= len(w["why"]) <= 200
        assert _exists("etbench", "traffic", f"{w['traffic']}.json")
        assert _exists("etbench", "workloads", f"{w['name']}.json")
        with open(os.path.join(ROOT, "etbench", "traffic", f"{w['traffic']}.json")) as f:
            assert _exists("etbench", "loops", f"{json.load(f)['loop']}.py")
        used.add(w["config"])
    assert used == configs


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert _exists("etbench", "end_to_end", f"{m['name']}.py")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m["workloads"]) <= cells
        assert _exists("etbench", "layer_metrics", f"{m['name']}.py")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:         # every cell: set-up, another end-to-end metric, a per-layer one
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])


@pytest.mark.parametrize("metric", ["roofline", "mfu"])
def test_every_cell_has_its_share_of_peak(bench, metric):
    for w in bench["workloads"]:
        assert any(metric in m["name"] and w["name"] in m["workloads"] for m in bench["per_layer"])

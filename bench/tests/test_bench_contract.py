"""``BENCHMARK.json`` against the rules of its format, and every name in
it against the files the harness finds by that name."""

import json
import re

import pytest

from conftest import ROOT

BJ = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BJ) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BJ["paths"]) <= 16
    for p in BJ["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(BJ["command"]) <= 32 and all(_line(w)
                                                 for w in BJ["command"])
    assert isinstance(BJ["run_seconds"], int) and \
        1 <= BJ["run_seconds"] <= 51
    cells = 24          # the most cells the file may hold
    runs = 2 + 14 * cells
    assert runs * (BJ["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in BJ["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    for c in BJ["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BJ["workloads"])


def test_cells():
    names = [w["name"] for w in BJ["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in BJ["workloads"]}) == \
        len(names)
    for w in BJ["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        wl = json.loads((ROOT / "bench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"]
        assert any(wl["check"].get(k) is not None
                   for k in ("logit_gap", "mean_logit_gap"))


def _reports(metric, cell):
    return metric.get("workloads") is None or cell in metric["workloads"]


def test_metrics():
    cells = {w["name"] for w in BJ["workloads"]}
    e2e = {m["name"]: m for m in BJ["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    names = list(e2e) + [m["name"] for m in BJ["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BJ["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BJ["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in cells and _reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert sum(_reports(m, cell) for m in e2e.values()) >= 2
        assert any(_reports(m, cell) for m in BJ["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BJ["workloads"]])
def test_each_cell_reports_a_kernel_roofline_beside_an_mfu(cell):
    mine = [m for m in BJ["per_layer"] if cell in m["workloads"]]
    for r in (m for m in mine if m["name"].endswith("_roofline")):
        assert any("mfu" in m["name"] and m["moves"] == r["moves"]
                   for m in mine)

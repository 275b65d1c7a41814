"""``BENCHMARK.json`` against the contract's shapes: names, units, lengths,
keys, files, and the readers each metric needs."""

import json
import os
import re

import pytest

from benchmark.tests.conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    entries = SPEC[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["name"]
            assert e["better"] in ("lower", "higher")


def test_metric_names_unique_across_groups():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_and_cells():
    configs = {c["name"]: c for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(body["source"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_enough_and_every_metric_has_a_reader():
    from benchmark import harness

    layers = {}
    for w in SPEC["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in SPEC["end_to_end"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "e2e",
                                           f"{m['name']}.py"))
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{m['name']}.py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" or "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())

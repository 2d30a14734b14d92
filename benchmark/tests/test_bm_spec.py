"""``BENCHMARK.json`` and the files it names: found by name, within the
contract's limits, and a cell that names something missing refused."""

from __future__ import annotations

import copy
import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    c = harness.find_cell(SPEC, cell)
    assert c.workload["chips"] == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


def test_every_file_is_where_its_name_says():
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        harness.metric_reader(m["name"])
    for root, _, files in os.walk(harness.HERE):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_names_and_units():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and len(c["source"]) <= 200 and len(c["why"]) <= 200
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    for m in metrics:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_cell_naming_a_missing_config_is_refused():
    spec = copy.deepcopy(SPEC)
    spec["workloads"][0]["config"] = "no-such-config"
    with pytest.raises(harness.SpecError, match="no-such-config"):
        harness.find_cell(spec, CELLS[0])


def test_a_cell_naming_a_missing_metric_is_refused():
    spec = copy.deepcopy(SPEC)
    spec["per_layer"].append({"name": "no_such.metric", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "x", "moves": "proof_ms",
                              "workloads": [CELLS[0]]})
    with pytest.raises(harness.SpecError, match="no_such.metric"):
        harness.find_cell(spec, CELLS[0])


def test_a_cell_naming_a_missing_traffic_or_cell_is_refused():
    spec = copy.deepcopy(SPEC)
    spec["workloads"][0]["traffic"] = "no-such-mix"
    with pytest.raises(harness.SpecError, match="no-such-mix"):
        harness.find_cell(spec, CELLS[0])
    with pytest.raises(harness.SpecError):
        harness.find_cell(SPEC, "no.such.cell")

"""The port's gate (``tools/bench_check.py`` of the port) against the root
``tools/bench_check.py``, the oracle, on one fixture history each case:
the same exit codes for ``check`` (insufficient 0, ok 0, regression 1,
``--json`` the same verdicts) and for ``append`` (a written record, an
artifact without a metric 2, ``TSP_BENCH_HISTORY=off`` 0 and nothing
written), and the same record for the same artifact.
"""

import contextlib
import io
import json
import pathlib
import sys

import pytest

from tsp_mpi_reduction_tpu_torch.obs import bench_history as bh
from tsp_mpi_reduction_tpu_torch.tools import bench_check as port_check

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_check():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import bench_check
    finally:
        sys.path.pop(0)
    return bench_check


def _history(path, values):
    for v in values:
        bh.append(str(path), bh.make_record(
            "bnb", {"metric": "bnb_eil51_nodes_per_sec", "value": v, "unit": "nodes/s"},
            config={"k": 1024}, backend="cuda", card={"device_name": "NVIDIA H100 80GB HBM3",
                                                      "power_limit_w": 700.0, "device_count": 1}))
    return str(path)


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("values,rc", [
    ([], 0),
    ([16000.0, 15000.0], 0),  # insufficient
    ([16000.0, 16400.0, 15900.0, 16200.0, 16100.0, 16300.0], 0),  # ok
    ([16000.0, 16400.0, 15900.0, 16200.0, 16100.0, 16300.0, 12000.0], 1),  # regression
], ids=["empty", "insufficient", "ok", "regression"])
def test_check_exit_codes_and_verdicts_equal_the_root_tool(tmp_path, jax_check, values, rc):
    hist = _history(tmp_path / "h.jsonl", values)
    assert _quiet(port_check.main, ["check", "--history", hist])[0] == rc
    assert _quiet(jax_check.main, ["check", "--history", hist])[0] == rc
    assert _quiet(port_check.main, ["--history", hist])[0] == rc  # check is the default
    prc, pout = _quiet(port_check.main, ["check", "--history", hist, "--json"])
    jrc, jout = _quiet(jax_check.main, ["check", "--history", hist, "--json"])
    assert prc == jrc == rc
    pdoc, jdoc = json.loads(pout), json.loads(jout)
    assert (pdoc["records"], pdoc["regressions"], pdoc["ok"]) == (jdoc["records"], jdoc["regressions"],
                                                                  jdoc["ok"])
    strip = [{k: v for k, v in d.items() if k != "group"} for d in pdoc["verdicts"]]
    assert strip == [{k: v for k, v in d.items() if k != "group"} for d in jdoc["verdicts"]]


def test_check_takes_rules(tmp_path, jax_check):
    hist = _history(tmp_path / "h.jsonl", [16000.0, 16400.0, 15900.0, 16200.0, 16100.0, 16300.0, 12000.0])
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"bnb_eil51_nodes_per_sec": {"direction": "higher", "rel_threshold": 0.5}}))
    for tool in (port_check, jax_check):
        assert _quiet(tool.main, ["check", "--history", hist, "--rules", str(rules)])[0] == 0


def test_append_writes_the_root_tools_record(tmp_path, jax_check):
    art = tmp_path / "BENCH_PIPELINE.json"
    art.write_text(json.dumps({"metric": "pipeline_16x100_wall_ms", "value": 123.5, "unit": "ms",
                               "vs_baseline": 566.8, "ok": True}))
    mine, theirs = tmp_path / "p.jsonl", tmp_path / "j.jsonl"
    argv = ["append", str(art), "--mode", "pipeline", "--backend", "cuda", "--history"]
    assert _quiet(port_check.main, argv + [str(mine)])[0] == 0
    assert _quiet(jax_check.main, argv + [str(theirs)])[0] == 0
    (rec,), (jrec,) = bh.read(str(mine)), bh.read(str(theirs))
    for key in set(jrec) - {"jax", "jaxlib", "ts"}:
        assert rec[key] == jrec[key], key
    assert rec["framework"] == "torch" and rec["config"] == {"artifact": "BENCH_PIPELINE.json"}


def test_append_refuses_a_non_artifact_and_honours_history_off(tmp_path, monkeypatch, jax_check):
    bad = tmp_path / "notbench.json"
    bad.write_text(json.dumps({"hello": 1}))
    hist = tmp_path / "h.jsonl"
    for tool in (port_check, jax_check):
        assert _quiet(tool.main, ["append", str(bad), "--mode", "x", "--history", str(hist)])[0] == 2
    art = tmp_path / "BENCH_X.json"
    art.write_text(json.dumps({"metric": "m", "value": 1.0}))
    monkeypatch.setenv(bh.ENV_VAR, "off")
    files = [ROOT / "bench_history_torch.jsonl", ROOT / "bench_history.jsonl"]
    before = [f.read_bytes() if f.exists() else None for f in files]
    for tool in (port_check, jax_check):
        assert _quiet(tool.main, ["append", str(art), "--mode", "x"])[0] == 0
    assert [f.read_bytes() if f.exists() else None for f in files] == before
    assert not hist.exists()

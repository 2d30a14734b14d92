"""The port's bench history (``obs/bench_history.py``) against the JAX
package's ``obs.bench_history``, the oracle, on the CPU.

- ``config_hash`` and ``host_fingerprint`` (no card here) equal the JAX
  module's; a record holds the JAX record's keys (but ``jax``/``jaxlib``)
  plus the port's framework, versions and card keys;
- ``check`` gives the JAX verdicts (status, latest, median, MAD, band,
  deviation, samples) on any single-group history (hypothesis);
- ``load_rules`` merges alike, and every port default rule is the JAX one;
- a torn tail is skipped; 4 processes x 50 appends give 200 whole lines;
- ``TSP_BENCH_HISTORY=off`` disables appending, and the default file is
  the port's own ``bench_history_torch.jsonl``;
- a JAX record and a port record, or two cards, never share a group;
- importing the module loads neither torch nor jax nor the JAX package.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tsp_mpi_reduction_tpu.obs import bench_history as jbh
from tsp_mpi_reduction_tpu_torch.obs import bench_history as bh

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_CARD = {"device_name": None, "power_limit_w": None, "device_count": 0}
H100 = {"device_name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0, "device_count": 1}


@pytest.mark.parametrize("config", [{}, {"k": 1024}, {"instance": "eil51", "k": 1024, "capacity": 409600},
                                    {"folds": ["scan", "tree"], "quick": True, "n": 16}])
def test_config_hash_and_host_equal_the_jax_module(config):
    assert bh.config_hash(config) == jbh.config_hash(config)
    assert bh.host_fingerprint() == jbh.host_fingerprint()


def test_record_keys_hold_the_jax_record_and_the_ports():
    art = {"metric": "bnb_eil51_nodes_per_sec", "value": 1.0, "unit": "nodes/s", "ok": True,
           "vs_baseline": 0.5}
    jrec = jbh.make_record("bnb", art, config={"k": 1}, backend="cpu")
    rec = bh.make_record("bnb", art, config={"k": 1}, backend="cpu", card=NO_CARD)
    shared = set(jrec) - {"jax", "jaxlib"}
    assert len(shared) == 13
    assert set(rec) == shared | {"framework", "torch", "cuda", "device_name", "power_limit_w",
                                 "device_count"}
    for key in shared - {"ts"}:
        assert rec[key] == jrec[key], key
    assert rec["framework"] == "torch"
    assert rec["torch"] == getattr(sys.modules.get("torch"), "__version__", None)
    assert (rec["device_name"], rec["power_limit_w"]) == (None, None)


def test_card_fingerprint_is_null_without_nvidia_smi(monkeypatch):
    def absent(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bh.subprocess, "run", absent)
    assert bh.card_fingerprint() == NO_CARD
    rec = bh.make_record("x", {"metric": "m", "value": 1.0}, backend="cpu")
    assert rec["device_name"] is None and rec["device_count"] == 0


def test_card_fingerprint_parses_nvidia_smi(monkeypatch):
    out = subprocess.CompletedProcess([], 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")
    monkeypatch.setattr(bh.subprocess, "run", lambda *a, **k: out)
    assert bh.card_fingerprint() == H100


def _records(metric, values, framework=None, card=None, host="h0", backend="cpu"):
    recs = []
    for v in values:
        rec = {"metric": metric, "value": v, "backend": backend, "config_hash": "c0", "host": host}
        if framework:
            rec.update(framework=framework, **(card or NO_CARD))
        recs.append(rec)
    return recs


def _fields(v):
    return (v.metric, v.status, v.latest, v.median, v.mad, v.allowed, v.deviation, v.samples)


@settings(max_examples=150, deadline=None)
@given(metric=st.sampled_from(sorted(bh.DEFAULT_RULES)),
       values=st.lists(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False), min_size=1,
                       max_size=12))
def test_check_gives_the_jax_verdicts_on_one_group(metric, values):
    (jv,) = jbh.check(_records(metric, values))
    (pv,) = bh.check(_records(metric, values, framework="torch", card=H100))
    assert _fields(pv) == _fields(jv)


def test_check_detects_a_20pct_slowdown_and_tolerates_noise():
    base = [16000, 16400, 15900, 16200, 16100, 16300]
    recs = _records("bnb_eil51_nodes_per_sec", base + [16100 * 0.8], "torch", H100)
    assert [v.status for v in bh.check(recs)] == ["regression"]
    noisy = _records("pipeline_16x100_wall_ms", [100, 140, 80, 130, 75, 135, 85, 120, 140], "torch")
    assert [v.status for v in bh.check(noisy)] == ["ok"]
    assert [v.status for v in bh.check(_records("obs_overhead", [0.1, 9.0], "torch"))] == ["insufficient"]


def test_load_rules_and_default_rules_equal_the_jax_module(tmp_path):
    for metric, rule in bh.DEFAULT_RULES.items():
        assert rule.__dict__ == jbh.DEFAULT_RULES[metric].__dict__, metric
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({
        "bnb_eil51_nodes_per_sec": {"direction": "higher", "rel_threshold": 0.5},
        "obs_overhead": None,
        "my_metric": {"direction": "lower", "min_samples": 2},
    }))
    rules, jrules = bh.load_rules(str(p)), jbh.load_rules(str(p))
    assert "obs_overhead" not in rules
    for metric in ("bnb_eil51_nodes_per_sec", "my_metric", "pipeline_16x100_wall_ms"):
        assert rules[metric].__dict__ == jrules[metric].__dict__
    with pytest.raises(ValueError):
        bh.MetricRule(direction="sideways")


def test_append_read_and_torn_tail(tmp_path):
    path = str(tmp_path / "h.jsonl")
    rec = bh.make_record("bnb", {"metric": "bnb_eil51_nodes_per_sec", "value": 1.5}, backend="cpu",
                         card=NO_CARD)
    bh.append(path, rec)
    bh.append(path, rec)
    with open(path, "a") as fh:
        fh.write('{"metric": "torn')
    back = bh.read(path)
    assert len(back) == 2 and back[0] == json.loads(json.dumps(rec))
    assert bh.read(path) == jbh.read(path)
    with pytest.raises(TypeError):
        bh.append(path, ["not", "a", "dict"])


def test_four_processes_append_200_whole_lines(tmp_path):
    path = tmp_path / "h.jsonl"
    code = ("import sys\nfrom tsp_mpi_reduction_tpu_torch.obs import bench_history as bh\n"
            "for j in range(50):\n"
            "    bh.append(sys.argv[1], {'metric': 'm', 'value': int(sys.argv[2]) * 1000 + j, "
            "'pad': 'x' * 2000})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(path), str(i)], cwd=ROOT, env=env)
             for i in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    lines = path.read_text().splitlines()
    assert len(lines) == 200
    values = sorted(json.loads(ln)["value"] for ln in lines)
    assert values == sorted(i * 1000 + j for i in range(4) for j in range(50))


def test_history_off_and_the_default_file(monkeypatch, tmp_path):
    monkeypatch.delenv(bh.ENV_VAR, raising=False)
    assert bh.DEFAULT_PATH == "bench_history_torch.jsonl" != jbh.DEFAULT_PATH
    assert bh.resolve_history_path(str(tmp_path)) == str(tmp_path / "bench_history_torch.jsonl")
    for off in ("off", "0", "none", "disabled", ""):
        monkeypatch.setenv(bh.ENV_VAR, off)
        assert bh.resolve_history_path(str(tmp_path)) is None
    monkeypatch.setenv(bh.ENV_VAR, str(tmp_path / "x.jsonl"))
    assert bh.resolve_history_path() == str(tmp_path / "x.jsonl")


def test_jax_and_port_records_and_two_cards_never_share_a_group():
    base = [16000.0, 16100.0, 15900.0, 16050.0, 16000.0]
    jax_recs = _records("bnb_eil51_nodes_per_sec", base)  # no framework key: the JAX package's
    port_recs = _records("bnb_eil51_nodes_per_sec", [100.0], "torch", H100)
    verdicts = bh.check(jax_recs + port_recs)
    assert sorted(v.status for v in verdicts) == ["insufficient", "ok"]
    assert {v.group.split("/")[0] for v in verdicts} == {"jax", "torch"}
    low = dict(H100, power_limit_w=350.0)
    cards = (_records("bnb_eil51_nodes_per_sec", base, "torch", H100)
             + _records("bnb_eil51_nodes_per_sec", [100.0], "torch", low))
    assert sorted(v.status for v in bh.check(cards)) == ["insufficient", "ok"]


def test_importing_the_history_and_the_gate_loads_no_torch_or_jax():
    code = ("import sys, json; import tsp_mpi_reduction_tpu_torch.obs.bench_history; "
            "import tsp_mpi_reduction_tpu_torch.tools.bench_check; "
            "import tsp_mpi_reduction_tpu_torch.obs; "
            "print(json.dumps([m for m in ('torch', 'jax', 'tsp_mpi_reduction_tpu') "
            "if m in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout) == []

"""The harness end to end on the CPU at the tests' small sizes: the result
line, the control and the planted faults that must read not correct, and
the modules a run loads. The card's own run is the ``cuda`` test at the
end, which skips without one."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.tests import small

ROOT = harness.ROOT
CELLS = small.CELLS
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_prints_the_contracts_keys(cell, trace):
    r = small.run(cell, seconds=0.3, trace=trace)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert ("busy_s" in r["device"]) == trace
    c = small.cell(cell)
    want = c.per_layer if trace else c.end_to_end
    for m in r["metrics"]:
        assert m in {x["name"] for x in want}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    for name, v in r["checks"].items():
        assert v["value"] <= v["limit"], name
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    got = control.readings(small.cell(cell), seed=2**31 + 11, calls=2, device="cpu")
    assert got["correct"] is False, got


def _tour_swapped(res):
    t = np.array(res.tour)
    t[[1, 2]] = t[[2, 1]]
    return dataclasses.replace(res, tour=t)


def _bnb_faults(bb):
    solve, sharded = bb.solve, bb.solve_sharded
    return {
        "search returns its state unchanged": {
            "solve": lambda d, **kw: solve(d, **dict(kw, max_iters=0)),
            "solve_sharded": lambda d, r, **kw: sharded(d, r, **dict(kw, max_iters=0))},
        "answer altered where produced": {
            "solve": lambda d, **kw: _tour_swapped(solve(d, **kw)),
            "solve_sharded": lambda d, r, **kw: _tour_swapped(sharded(d, r, **kw))},
    }


@pytest.mark.parametrize("fault", ["search returns its state unchanged", "answer altered where produced"])
@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("eil51")])
def test_bnb_faults_read_not_correct(cell, fault, monkeypatch):
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb

    for name, fn in _bnb_faults(bb)[fault].items():
        monkeypatch.setattr(bb, name, fn)
    assert small.run(cell, seconds=0.2)["correct"] is False


def _half_batch(orig):
    def solve(dists, dtype=torch.float64):
        half = dists.shape[0] // 2
        costs, tours = orig(dists[:half], dtype)
        return torch.cat([costs, costs]), torch.cat([tours, tours])
    return solve


def _altered(orig):
    def fold(*a, **kw):
        ids, length, cost = orig(*a, **kw)
        ids = ids.clone()
        ids[[1, 2]] = ids[[2, 1]]
        return ids, length, cost
    return fold


PIPELINE_FAULTS = ["half of the batch left out", "fold step returns its state unchanged",
                   "answer altered where produced", "exchange between ranks left out"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS if c.startswith("blocked16") for f in PIPELINE_FAULTS
                                        if c.endswith("tree") or f != "exchange between ranks left out"])
def test_pipeline_faults_read_not_correct(cell, fault, monkeypatch):
    from tsp_mpi_reduction_tpu_torch.models import distributed, pipeline
    from tsp_mpi_reduction_tpu_torch.ops import merge
    from tsp_mpi_reduction_tpu_torch.parallel import reduce

    ranks = cell.endswith("tree")
    if fault == "half of the batch left out":
        mod = distributed if ranks else pipeline
        monkeypatch.setattr(mod, "solve_blocks_from_dists", _half_batch(mod.solve_blocks_from_dists))
    elif fault == "fold step returns its state unchanged":
        if ranks:
            monkeypatch.setattr(reduce, "merge_tours", lambda t1, t2, dist: t1)
        else:
            def unchanged(acc_ids, acc_len, acc_cost, tours, costs, dist, step):
                step.add_(1)
                return acc_ids, acc_len, acc_cost
            monkeypatch.setattr(merge, "_fold_step", unchanged)
    elif fault == "answer altered where produced":
        if ranks:
            monkeypatch.setattr(distributed, "tree_reduce_single_device",
                                _altered(distributed.tree_reduce_single_device))
        else:
            monkeypatch.setattr(pipeline, "fold_tours", _altered(pipeline.fold_tours))
    else:
        monkeypatch.setattr(reduce, "tree_schedule", lambda num_ranks: [])
    assert small.run(cell, seconds=0.2)["correct"] is False


def test_no_jax_module_after_a_rehearsal():
    code = ("import json, sys\n"
            "from benchmark.tests import small\n"
            "from benchmark import harness\n"
            f"for c in {CELLS!r}:\n"
            "    small.run(c, seconds=0.2, trace=True)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tsp_mpi_reduction_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def _cli(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "eil51.proof", "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = _cli(ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec()["workloads"]])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(2**31 + 19),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"

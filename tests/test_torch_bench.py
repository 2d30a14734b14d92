"""The port's bench harness (``tools/bench.py``) on the CPU, at tiny sizes.

- every mode with ``--backend=cpu``: the last stdout line is one JSON
  object with the JAX mode's metric name and unit, ``vs_baseline`` and
  ``ok``; the artifact is written where asked and the history records
  carry ``framework``/``backend``;
- ``pipeline --n=6 --blocks=8``: every fold's ``cost`` and ``measured``
  equal the JAX package's ``make_step`` for the same fold on the same
  instance (float64, relative tolerance 1e-9: the two start from
  different distance tensors, whose square roots may differ by an ulp);
- ``bnb`` on burma14 (k = 64): proves the JAX package's cost;
- ``faults`` and ``obs`` at 2 reps: byte-identical payloads, no orphan span;
- ``serve`` at 6 requests: bit-identical batched tours, equal proofs,
  every deadline response valid, every resubmission a hit;
- without a card, ``--backend=cuda``/``auto`` exit 2 with one JSON line
  whose ``ok`` is false; under ``TSP_BENCH_BUDGET_S=0.01`` every mode still
  prints its line (``ok`` false, exit 1);
- every mode records the four kernels' launches of each of its windows
  (all 0 on the CPU, where the wrappers run their plain versions);
- ``--git-rev`` names the commit in the history records where git cannot;
- the default outputs are the port's own: ``build/bench_torch/`` and
  ``bench_history_torch.jsonl``, never a root ``BENCH_*.json`` or
  ``bench_history.jsonl``.
"""

import json
import os
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.ops import distance as jdist
from tsp_mpi_reduction_tpu.ops import generator as jgen
from tsp_mpi_reduction_tpu.ops import held_karp as jhk
from tsp_mpi_reduction_tpu.ops import local_search as jls
from tsp_mpi_reduction_tpu.ops import merge as jmerge
from tsp_mpi_reduction_tpu.perf import compile_cache
from tsp_mpi_reduction_tpu_torch.obs import bench_history as bh
from tsp_mpi_reduction_tpu_torch.tools import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9
#: the four hand kernels' counts of a window on the CPU
NO_LAUNCHES = {"relax_dense": 0, "relax_minplus": 0, "prim_chain": 0, "push_rows": 0}


@pytest.fixture(autouse=True)
def _fresh_run(monkeypatch):
    """A budget anchored at the test's start (the module's anchor is its
    import), one torch thread, no JAX AOT store (it can hand back
    executables of another mesh)."""
    monkeypatch.setattr(bench, "_T0", time.monotonic())
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, tmp_path, *argv):
    rc = bench.main(["--backend=cpu", f"--out-dir={tmp_path}", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "ok"):
        assert key in last, key
    assert last["device"] == {"backend": "cpu", "name": None, "count": 0, "power_limit_w": None}
    return rc, last


def _jax_fold(fold, n, nb):
    """The JAX bench's ``make_step`` for one fold, in float64, with the
    block solve outside ``jit`` (the package's eager solve, the port's
    oracle: fused under ``jit`` a block's tour can come back reversed, a
    tie of equal cost that changes the fold)."""
    fn, from_xy, do_polish = {
        "tree_xy": (jmerge.fold_tours_tree_xy, True, False),
        "tree": (jmerge.fold_tours_tree, False, False),
        "scan": (jmerge.fold_tours, False, False),
        "tree_xy_polish": (jmerge.fold_tours_tree_xy, True, True),
    }[fold]
    _, xy = jgen.generate_instance(n, nb, 1000, 1000)
    xy_blocks = jnp.asarray(np.asarray(xy, np.float64))
    block_d = jax.vmap(jdist.distance_matrix)(xy_blocks)
    costs, local_tours = jhk.solve_blocks_from_dists(block_d, jnp.float64)

    @jax.jit
    def step(xy_blocks, costs, local_tours):
        flat = xy_blocks.reshape(-1, 2)
        offsets = (jnp.arange(nb, dtype=jnp.int32) * n)[:, None]
        ctx = flat if from_xy else jdist.distance_matrix(flat)
        ids, _, cost = fn(local_tours.astype(jnp.int32) + offsets, costs, ctx)
        dist = ctx if not from_xy else jdist.distance_matrix(flat)
        t_open = ids[: n * nb]
        if do_polish:
            t_open, _ = jls.polish(t_open, dist, max_rounds=bench.POLISH_MAX_ROUNDS)
        return cost, jls.tour_length(t_open, dist)

    cost, measured = step(xy_blocks, costs, local_tours)
    return float(cost), float(measured)


def test_pipeline_folds_equal_the_jax_make_step(capsys, tmp_path, monkeypatch):
    hist = tmp_path / "h.jsonl"
    monkeypatch.setenv(bh.ENV_VAR, str(hist))
    monkeypatch.setenv("TSP_BENCH_REPS", "2")
    rc, last = _run(capsys, tmp_path, "--mode=pipeline", "--n=6", "--blocks=8")
    assert rc == 0 and last["ok"] is True
    assert (last["metric"], last["unit"], last["vs_baseline"]) == ("pipeline_6x8_wall_ms", "ms", None)
    assert set(last["folds"]) == set(bench.VALID_FOLDS) and last["dtype"] == "float64"
    assert last["value"] == min(f["ms"] for f in last["folds"].values())
    assert last["folds"][last["fold"]]["ms"] == last["value"]
    for fold, got in last["folds"].items():
        cost, measured = _jax_fold(fold, 6, 8)
        assert got["cost"] == pytest.approx(cost, rel=RTOL), fold
        assert got["measured"] == pytest.approx(measured, rel=RTOL), fold
        assert got["reps"] == 2 and got["ms_min"] <= got["ms"] <= got["ms_max"]
        assert got["tour_is_permutation"] is True
        assert set(got["layers"]) == {"distances", "solve", "merge_fold", "polish"}
    assert last["launches"] == NO_LAUNCHES and last["runs"] == 2 * len(bench.VALID_FOLDS)
    assert json.loads((tmp_path / "BENCH_PIPELINE.json").read_text())["value"] == last["value"]
    (rec,) = bh.read(str(hist))
    assert (rec["metric"], rec["backend"], rec["framework"], rec["mode"]) == (
        "pipeline_6x8_wall_ms", "cpu", "torch", "pipeline")
    assert rec["config"]["folds"] == sorted(bench.VALID_FOLDS)


def test_pipeline_quick_runs_tree_and_scan(capsys, tmp_path):
    rc, last = _run(capsys, tmp_path, "--mode=pipeline", "--n=5", "--blocks=4", "--quick")
    assert rc == 0 and sorted(last["folds"]) == ["scan", "tree"]
    assert all(f["reps"] == 2 for f in last["folds"].values())


def test_bnb_proves_the_jax_cost(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TSP_BENCH_INSTANCE", "burma14")
    monkeypatch.setenv("TSP_BENCH_K", "64")
    monkeypatch.setenv("TSP_BENCH_BNB_REPS", "2")
    rc, last = _run(capsys, tmp_path, "--mode=bnb")
    assert rc == 0 and last["ok"] is True
    assert (last["metric"], last["unit"]) == ("bnb_burma14_nodes_per_sec", "nodes/s")
    assert last["vs_baseline"] == pytest.approx(last["value"] / bench.BNB_CPU_8RANK_ANCHOR)
    assert last["reps"] == 2 and last["nodes_per_sec_min"] <= last["value"] <= last["nodes_per_sec_max"]
    assert last["capacity"] == max(1 << 17, 8 * 64 * 13) and last["device_loop"] is False
    assert last["proven_optimal"] is True and last["time_to_proof_s"] > 0
    assert last["launches"] == NO_LAUNCHES and all(r["launches"] == NO_LAUNCHES for r in last["runs"])
    from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib

    d = jtsplib.embedded("burma14").distance_matrix()
    ref = jbb.solve(d, capacity=last["capacity"], k=64, node_ascent=2, device_loop=False,
                    max_iters=5_000_000)
    assert ref.proven_optimal and last["cost"] == ref.cost == 3323.0


def test_faults_payloads_are_identical(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TSP_BENCH_FAULTS_REPS", "2")
    rc, last = _run(capsys, tmp_path, "--mode=faults")
    assert rc == 0 and last["ok"] is True and last["payload_identical"] is True
    assert (last["metric"], last["unit"], last["reps"]) == ("atomic_checkpoint_overhead", "ms/save", 2)
    assert last["value"] == last["atomic_ms"]
    assert last["vs_baseline"] == pytest.approx(last["direct_ms"] / last["atomic_ms"])
    assert last["file_bytes"] > last["payload_bytes"] > 0
    assert last["launches"] == {"seed_solve": NO_LAUNCHES, "saves": NO_LAUNCHES}
    assert last["step_kernel"] == "reference"


def test_obs_meters_the_hooks_and_traces_no_orphan(capsys, tmp_path, monkeypatch):
    hist = tmp_path / "h.jsonl"
    monkeypatch.setenv(bh.ENV_VAR, str(hist))
    monkeypatch.setenv("TSP_BENCH_OBS_REPS", "2")
    monkeypatch.setenv("TSP_BENCH_OBS_INSTANCE", "random:9:33")
    rc, last = _run(capsys, tmp_path, "--mode=obs")
    assert (last["metric"], last["unit"]) == ("obs_overhead", "pct")
    assert last["reps_per_arm"] == 4 and last["bnb"]["series_rows"] > 0
    assert last["serve"]["orphan_spans"] == 0 and last["serve"]["ok"] is True
    assert last["serve"]["request_roots"] == 12 and last["serve"]["responses"] == 13
    assert last["bnb"]["launches"] == {"on": NO_LAUNCHES, "off": NO_LAUNCHES}
    assert last["serve"]["launches"] == NO_LAUNCHES
    assert last["vs_baseline"] == pytest.approx(last["bnb"]["off_ms"] / last["bnb"]["on_ms"])
    assert last["ok"] == (last["bnb"]["overhead_pct"] <= 2.0) and rc == (0 if last["ok"] else 1)
    assert [r["metric"] for r in bh.read(str(hist))] == ["obs_overhead", "obs_us_per_dispatch"]


def test_serve_tours_and_proofs_agree(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TSP_BENCH_SERVE_REQS", "6")
    monkeypatch.setenv("TSP_BENCH_SERVE_BNB_N", "14")
    rc, last = _run(capsys, tmp_path, "--mode=serve")
    assert (last["metric"], last["unit"], last["vs_baseline"]) == (
        "serve_microbatch_vs_sequential_throughput", "x", None)
    assert last["tours_match"] is True and last["bnb_identical"] is True
    assert last["cache_hit_rate_resubmit"] == 1.0
    assert last["deadline_valid_responses"] == last["deadline_requests"] == 32
    assert last["launches"] == dict.fromkeys(
        ("sequential", "microbatch", "request_level", "iteration_level", "deadline"), NO_LAUNCHES)
    assert rc == (0 if last["ok"] else 1)
    assert last["ok"] == (last["service_tours_match"] and last["admission"]["preemptions"] >= 1
                          and last["preempt_spans"] >= 1 and last["resume_spans"] >= 1)


@pytest.mark.parametrize("mode", bench.MODES)
@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_no_card_exits_2_with_one_json_line(capsys, tmp_path, mode, backend):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([f"--mode={mode}", f"--backend={backend}", f"--out-dir={tmp_path}"]) == 2
    (line,) = capsys.readouterr().out.strip().splitlines()
    last = json.loads(line)
    assert last["ok"] is False and last["value"] is None and "CUDA" in last["error"]
    assert last["metric"] == bench.headline(mode)[0]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("mode", bench.MODES)
def test_always_prints_under_a_spent_budget(capsys, tmp_path, monkeypatch, mode):
    monkeypatch.setenv("TSP_BENCH_BUDGET_S", "0.01")
    monkeypatch.setattr(bench, "_T0", time.monotonic() - 1.0)
    rc, last = _run(capsys, tmp_path, f"--mode={mode}", "--n=5", "--blocks=4")
    assert rc == 1 and last["ok"] is False and last["value"] is None and last["skipped"]
    assert last["metric"] == bench.headline(mode, 5, 4)[0]
    assert last["budget_s"] == 0.01


def test_git_rev_names_the_commit_where_git_cannot(capsys, tmp_path, monkeypatch):
    hist = tmp_path / "h.jsonl"
    monkeypatch.setenv(bh.ENV_VAR, str(hist))
    monkeypatch.setattr(bh, "git_rev", lambda cwd=None: None)  # a copy without .git
    rc, _ = _run(capsys, tmp_path, "--mode=pipeline", "--n=5", "--blocks=4", "--quick",
                 "--git-rev=abc1234")
    assert rc == 0 and [r["git_rev"] for r in bh.read(str(hist))] == ["abc1234"]
    monkeypatch.setattr(bh, "git_rev", lambda cwd=None: "fedcba9")  # git's own rev wins
    _run(capsys, tmp_path, "--mode=pipeline", "--n=5", "--blocks=4", "--quick", "--git-rev=abc1234")
    assert [r["git_rev"] for r in bh.read(str(hist))] == ["abc1234", "fedcba9"]


def test_default_outputs_are_the_ports_own(monkeypatch):
    monkeypatch.delenv(bh.ENV_VAR, raising=False)
    for mode in bench.MODES:
        fname, knob = bench.ARTIFACTS[mode]
        if knob:
            monkeypatch.delenv(knob, raising=False)
        path = pathlib.Path(bench.artifact_path(mode, None))
        assert path == ROOT / "build" / "bench_torch" / fname
        if knob:
            monkeypatch.setenv(knob, "/elsewhere/x.json")
            assert bench.artifact_path(mode, None) == "/elsewhere/x.json"
    # the JAX bench's artifact knobs, and no others
    assert {m: k for m, (_, k) in bench.ARTIFACTS.items() if k} == {
        "faults": "TSP_BENCH_FAULTS_OUT", "obs": "TSP_BENCH_OBS_OUT", "serve": "TSP_BENCH_SERVE_OUT",
        "shard": "TSP_BENCH_SHARD_OUT", "balance": "TSP_BENCH_BALANCE_OUT", "step": "TSP_BENCH_STEP_OUT",
        "fleet": "TSP_BENCH_FLEET_OUT", "compile": "TSP_BENCH_COMPILE_OUT"}
    assert bh.resolve_history_path(bench.REPO_ROOT) == os.path.join(ROOT, "bench_history_torch.jsonl")

"""The bench harness's ``spill``, ``shard``, ``balance``, ``step`` and ``fleet``
modes on the CPU, at small sizes, against the JAX package.

- ``spill`` (4 ranks, 10 cities): rounds, events, full merges and bytes
  each way equal a JAX ``solve_sharded`` on the same call; the value is
  their bytes a round, ``vs_baseline`` the JAX mode's full-buffer anchor;
  a configuration that never spills prints the JAX mode's error and exits 1;
- ``shard`` (4 ranks, 10 cities): nodes, cost, nodes per rank, the whole
  ``rank_series`` and the timing-free ``rank_balance`` equal JAX's, and
  the starved ranks are named by ``rank_starvation`` events;
- ``balance`` (4 ranks, 10 cities): each leg's cost, certified LB, nodes
  per rank, moved rows, collective dispatches, actions and switches equal
  JAX's, and ``ok`` is the four gates;
- ``step`` (eil51, k = 32): both legs' final incumbent and nodes a step
  equal a chain of the JAX ``_expand_loop_ref`` from the same warm state,
  and the packed row bytes equal JAX's;
- ``fleet``: one leg of 2 CPU replicas of the port's serve CLI under
  ``replica.kill``: every request answered exactly once with a valid tour,
  a restart and a re-dispatch;
- each mode's history records carry ``framework`` and ``backend``; the
  port's rules are the JAX rules but the one of the ``compile`` mode.

The JAX oracles are computed in one fresh interpreter (``jax_fresh``).
The last line, ``ok``, the exit 2 without a card and the spent-budget line
of every mode are ``tests/test_torch_bench.py``'s, parametrized over
``bench.MODES``.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax_fresh
from tsp_mpi_reduction_tpu.obs import bench_history as jbh
from tsp_mpi_reduction_tpu_torch.obs import bench_history as bh
from tsp_mpi_reduction_tpu_torch.resilience import faults
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH
from tsp_mpi_reduction_tpu_torch.tools import bench

#: the small sizes: (ranks, cities, capacity a rank)
SPILL = (4, 10, 64)
SHARD = (4, 10, 96)
BALANCE = (4, 10, 160)
#: the step chain: instance, k, steps a dispatch, dispatches, warm steps, capacity
STEP = ("eil51", 32, 8, 6, 10, 40000)
#: the JAX solve_sharded keywords of the modes (bench.py:566-650, 1419-1773)
JAX_SPILL_KW = dict(capacity_per_rank=SPILL[2], k=4, inner_steps=1, bound="min-out", mst_prune=False,
                    node_ascent=0, max_iters=2_000_000)
JAX_SHARD_KW = dict(k=4, inner_steps=2, bound="min-out", mst_prune=False, node_ascent=0,
                    device_loop=False, seed_mode="single-rank", max_iters=2_000_000)


@pytest.fixture(scope="module")
def oracles():
    """Every JAX oracle of the file, in one fresh interpreter."""
    rd = bench._uniform_d
    cases = [
        (rd(SPILL[1], 51), SPILL[0], JAX_SPILL_KW),
        (rd(SHARD[1], 77), SHARD[0], dict(JAX_SHARD_KW, capacity_per_rank=SHARD[2], balance="ring",
                                          transfer=4)),
        (rd(BALANCE[1], 77), BALANCE[0], dict(JAX_SHARD_KW, capacity_per_rank=BALANCE[2],
                                              balance="ring", transfer=4)),
        (rd(BALANCE[1], 77), BALANCE[0], dict(JAX_SHARD_KW, capacity_per_rank=BALANCE[2],
                                              balance="adaptive")),
        (bench._ring_and_centre_d(), BALANCE[0], dict(JAX_SHARD_KW, capacity_per_rank=BALANCE[2],
                                                      balance="adaptive", seed_mode="round-robin")),
    ]
    spill, shard, ring, ada, flat = jax_fresh.call("solve_sharded_many", cases)
    step = jax_fresh.call("step_chain", *STEP)
    return {"spill": spill, "shard": shard, "ring": ring, "adaptive": ada, "balanced": flat,
            "step": step}


@pytest.fixture(autouse=True)
def _fresh_run(monkeypatch, tmp_path):
    """A budget anchored at the test's start, one torch thread, the
    history in the test's own file."""
    monkeypatch.setattr(bench, "_T0", time.monotonic())
    monkeypatch.setenv(bh.ENV_VAR, str(tmp_path / "history.jsonl"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, tmp_path, mode, *argv):
    rc = bench.main([f"--mode={mode}", "--backend=cpu", f"--out-dir={tmp_path}", *argv])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (last["metric"], last["unit"]) == bench.headline(mode)
    for key in ("value", "vs_baseline", "ok"):
        assert key in last, key
    assert last["device"]["backend"] == "cpu"
    return rc, last


def _records(tmp_path):
    return bh.read(str(tmp_path / "history.jsonl"))


def _check_records(tmp_path, mode, metrics):
    recs = _records(tmp_path)
    assert [r["metric"] for r in recs] == list(metrics)
    assert all(r["mode"] == mode and r["framework"] == "torch" and r["backend"] == "cpu" for r in recs)


def test_spill_counters_equal_jax(capsys, tmp_path, monkeypatch, oracles):
    ranks, n, cap = SPILL
    for knob, val in zip(("RANKS", "N", "CAPACITY"), SPILL):
        monkeypatch.setenv(f"TSP_BENCH_SPILL_{knob}", str(val))
    rc, last = _run(capsys, tmp_path, "spill")
    want = oracles["spill"]
    assert rc == 0 and last["ok"] is True and last["proven_optimal"] == want.proven_optimal
    for key in ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
                "spill_bytes_to_device", "nodes_expanded"):
        assert last[key] == getattr(want, key), key
    assert want.spill_rounds > 0 and last["cost"] == want.cost
    assert last["value"] == (want.spill_bytes_to_host + want.spill_bytes_to_device) / want.spill_rounds
    anchor = 2 * ranks * (cap + 4 * n) * (n + (n + 31) // 32 + 4) * 4
    assert last["head_equiv_bytes_per_round"] == anchor and last["vs_baseline"] == anchor / last["value"]
    assert not last["device_loop"] and last["launches"]["push_rows"] == 0
    _check_records(tmp_path, "spill", ["sharded_spill_transfer_bytes_per_round"])
    assert (tmp_path / "BENCH_SPILL.json").exists()


def test_spill_without_rounds_prints_the_jax_error(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TSP_BENCH_SPILL_RANKS", "2")
    monkeypatch.setenv("TSP_BENCH_SPILL_N", "7")
    monkeypatch.setenv("TSP_BENCH_SPILL_CAPACITY", "4096")
    rc, last = _run(capsys, tmp_path, "spill")
    assert rc == 1 and last["ok"] is False and last["value"] is None and last["spill_rounds"] == 0
    assert last["error"].startswith("no spill rounds occurred at this config")
    assert _records(tmp_path) == []


def test_shard_rank_view_equals_jax_and_names_the_starved(capsys, tmp_path, monkeypatch, oracles):
    for knob, val in zip(("RANKS", "N", "CAPACITY"), SHARD):
        monkeypatch.setenv(f"TSP_BENCH_SHARD_{knob}", str(val))
    monkeypatch.setenv("TSP_BENCH_SHARD_REPS", "1")
    rc, last = _run(capsys, tmp_path, "shard")
    want = oracles["shard"]
    assert rc == 0 and last["ok"] is True and last["coherent"] is True
    assert last["cost"] == want.cost and last["proven_optimal"] == want.proven_optimal
    assert last["nodes_expanded"] == want.nodes_expanded
    assert last["nodes_per_rank"] == [int(x) for x in want.nodes_per_rank]
    assert last["rank_series"] == json.loads(json.dumps(want.rank_series))
    assert last["rank_balance"] == json.loads(json.dumps(want.rank_balance))
    assert last["spill_rounds"] == want.spill_rounds > 0
    starved = [e for e in want.anomalies["events"] if e["kind"] == "rank_starvation"]
    assert last["starved_ranks"] == want.rank_balance["starved_ranks"] != []
    assert last["starvation_events"] == len(starved) > 0
    assert last["bnb"]["dispatches"] == want.series["samples_total"]
    assert 0.0 < last["value"] <= 2.0 and last["vs_baseline"] is None
    assert last["runs"][0]["launches"] == {k: 0 for k in last["runs"][0]["launches"]}
    _check_records(tmp_path, "shard", ["shard_rank_obs_overhead", "shard_rank_us_per_dispatch"])


def test_balance_legs_equal_jax(capsys, tmp_path, monkeypatch, oracles):
    for knob, val in zip(("RANKS", "N", "CAPACITY"), BALANCE):
        monkeypatch.setenv(f"TSP_BENCH_BALANCE_{knob}", str(val))
    monkeypatch.setenv("TSP_BENCH_BALANCE_REPS", "1")
    rc, last = _run(capsys, tmp_path, "balance")
    for name in ("ring", "adaptive", "balanced"):
        got, want = last["legs"][name], oracles[name]
        assert got["cost"] == want.cost and got["lower_bound"] == want.lower_bound, name
        assert got["nodes"] == want.nodes_expanded, name
        assert got["nodes_per_rank"] == [int(x) for x in want.nodes_per_rank], name
        assert got["moved_rows"] == want.balance["moved_rows_total"], name
        for key in ("collective_dispatches", "actions", "switches"):
            assert got[key] == want.balance[key], (name, key)
    assert last["legs"]["adaptive"]["actions"]["steal"] > 0
    gates = last["gates"]
    assert last["ok"] is (rc == 0) is all(gates[g] for g in ("imbalance_reduction_ok", "wall_ratio_ok",
                                                               "exactness_ok",
                                                               "balanced_zero_dispatches_ok"))
    assert gates["exactness_ok"] and gates["balanced_zero_dispatches_ok"]
    assert last["wall_ratio_pairs_min"] <= last["wall_ratio_pairs_max"]
    _check_records(tmp_path, "balance", ["shard_balance_imbalance", "shard_steal_bytes_per_node"])


def test_step_legs_equal_the_jax_chain(capsys, tmp_path, monkeypatch, oracles):
    instance, k, steps, dispatches, warm, capacity = STEP
    for knob, val in (("INSTANCE", instance), ("K", k), ("STEPS", steps), ("DISPATCHES", dispatches),
                      ("WARM", warm), ("CAPACITY", capacity)):
        monkeypatch.setenv(f"TSP_BENCH_STEP_{knob}", str(val))
    rc, last = _run(capsys, tmp_path, "step")
    want = oracles["step"]
    assert rc == 0 and last["ok"] is True and last["incumbent_match"] is True
    for leg in ("reference", "fused"):
        got = last[leg]
        assert got["final_incumbent"] == want["final_incumbent"], leg
        assert got["nodes_per_step"] == want["nodes"] // steps, leg
        assert got["steps_run"] == steps * dispatches and got["dispatches"] == dispatches, leg
    assert last["row_bytes_packed"] == want["row_bytes"]
    assert last["row_bytes_v1_unpacked"] == (51 + 2 + 4) * 4 and last["fused_mode"] == "plain"
    assert last["value"] == last["reference"]["ms_per_step"] / last["fused"]["ms_per_step"]
    _check_records(tmp_path, "step", ["fused_vs_reference_expansion_step"])


def test_fleet_leg_answers_exactly_once_through_a_kill(tmp_path):
    HEALTH.reset_for_testing()
    faults.clear()
    rng = np.random.default_rng(17)
    n = 6
    cfg = bench.fleet_config("cpu", 2, str(tmp_path / "shared"))
    requests = bench.fleet_requests(rng, n, 8, uniques=4)
    warm = [{"id": f"w{i}", "xy": rng.uniform(0, 1000, (n, 2)).tolist(), "deadline_ms": 60_000.0}
            for i in range(2)]
    try:
        leg = bench.fleet_leg(cfg, requests, warm, n, chaos_spec="replica.kill:raise,nth=3")
    finally:
        faults.clear()
    assert leg["answered_exactly_once"] and leg["answered"] == leg["valid_tours"] == 8
    assert leg["restarts"] >= 1 and leg["redispatches"] >= 1
    assert leg["stats_fleet"]["restarts_total"] >= 1
    assert cfg.supervisor.startup_grace_s == bench.FLEET_SUPERVISOR["startup_grace_s"] == 15.0


def test_fleet_requests_are_the_jax_traffic():
    reqs = bench.fleet_requests(np.random.default_rng(17), 8, 48, uniques=24, tight_every=4)
    assert [r["deadline_ms"] for r in reqs[:8]] == [20_000.0, 20_000.0, 20_000.0, 50.0] * 2
    first = np.asarray(reqs[0]["xy"])
    again = np.asarray(reqs[24]["xy"])
    # a resubmission: the same points, permuted and translated
    shift = again.min(0) - first.min(0)
    assert np.allclose(np.sort(again - shift, 0), np.sort(first, 0))


def test_rules_are_the_jax_rules_but_the_compile_modes():
    """Every JAX rule, ``compile_once_warm_start`` included now that the
    port has the ``compile`` mode (the graph store and the ascent memo)."""
    assert set(jbh.DEFAULT_RULES) == set(bh.DEFAULT_RULES)
    for metric in ("compile_once_warm_start", "sharded_spill_transfer_bytes_per_round",
                   "fused_vs_reference_expansion_step",
                   "shard_rank_obs_overhead", "shard_rank_us_per_dispatch", "fleet_chaos_answered_rate",
                   "shard_balance_imbalance", "shard_steal_bytes_per_node"):
        assert bh.DEFAULT_RULES[metric].__dict__ == jbh.DEFAULT_RULES[metric].__dict__, metric

"""The port's bench ``compile`` mode on the CPU (``--backend=cpu``, a small
fold): the JAX mode's legs in fresh processes and the merge fold's leg.

On the CPU nothing is captured (the fold runs its eager step), so the fold
leg reports no capture; the chunk and serve legs run as on the card. The
chunk children resume an eil51 checkpoint at k 8 to keep the CPU solves
short.
"""

import json
import statistics

import pytest

from tsp_mpi_reduction_tpu.obs import bench_history as jbh
from tsp_mpi_reduction_tpu.perf import compile_cache as jcc
from tsp_mpi_reduction_tpu_torch.obs import bench_history as bh
from tsp_mpi_reduction_tpu_torch.tools import bench


@pytest.fixture
def quick_compile(monkeypatch, tmp_path):
    monkeypatch.setenv("TSP_BENCH_COMPILE_K", "8")
    monkeypatch.setenv(bh.ENV_VAR, str(tmp_path / "h.jsonl"))
    monkeypatch.delenv("TSP_COMPILE_CACHE", raising=False)
    return tmp_path


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_compile_mode_runs_its_legs_on_the_cpu(capsys, quick_compile, quick):
    argv = ["--mode=compile", "--backend=cpu", f"--out-dir={quick_compile}", "--n=5", "--blocks=6"]
    rc = bench.main(argv + (["--quick"] if quick else []))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["ok"] is True, last
    assert (last["metric"], last["unit"]) == bench.headline("compile")
    assert last["metric"] in jbh.DEFAULT_RULES and last["value"] > 0
    chunk = last["chunk"]
    assert chunk["costs_equal"] and chunk["lb_equal"] and chunk["warm_startup_s"] > 0
    assert (chunk["populate_startup_s"] is None) == quick
    # full runs go cold, populate, warm, warm, cold and report medians
    reps = 1 if quick else 2
    assert len(chunk["cold_startup_runs"]) == len(chunk["warm_startup_runs"]) == reps
    assert chunk["warm_startup_s"] == statistics.median(chunk["warm_startup_runs"])
    assert chunk["cold_startup_s"] == statistics.median(chunk["cold_startup_runs"])
    # warm reads the root ascent from the shared directory, cold cannot
    assert chunk["cold_compile_cache"]["ascent_memo_hits"] == 0
    assert chunk["warm_compile_cache"]["ascent_memo_hits"] >= 1
    assert set(chunk["warm_compile_cache"]) == set(jcc.stats_dict())
    assert last["serve"]["tours_match"] and last["serve"]["warm_precompile_s"] > 0
    fold = last["fold"]
    assert fold["equal"] and fold["graph"] is False and fold["capture_s"] is None
    assert fold["captures_in_fold"] == 0 and (fold["n"], fold["blocks"]) == (5, 6)
    assert fold["first_fold_s"] > 0
    assert last["serve_store"] is None  # serve traffic through a graph needs the card
    # the one-shot CLI with and without the store, ABBA (full runs only)
    if quick:
        assert last["cli"] is None
    else:
        cli = last["cli"]
        assert cli["costs_equal"] and (cli["n"], cli["blocks"], cli["order"]) == (5, 6, "ABBA")
        assert [len(cli["runs"][k]) for k in ("store", "off")] == [2, 2]
    assert last["device"]["backend"] == "cpu" and last["skipped"] == []
    records = bh.read(str(quick_compile / "h.jsonl"))
    assert [r["metric"] for r in records] == ["compile_once_warm_start"]
    assert (quick_compile / "BENCH_COMPILE_CACHE.json").exists()



def test_serve_mix_child_on_the_cpu(monkeypatch):
    """The serve_store leg's child at a small mix: phase 14's groups, B's
    cache hits, the sized stream on the pipeline tier, nothing captured."""
    import torch

    monkeypatch.delenv("TSP_COMPILE_CACHE", raising=False)
    got = bench.serve_mix_child(torch.device("cpu"), groups=(("A", 3, 8, 5000.0), ("C", 1, 72, 20_000.0)),
                                sizes=(72, 80))
    assert got["mode"] == "serve_mix" and got["store"] is True
    assert {g: got["abc"][g]["count"] for g in "ABC"} == {"A": 3, "B": 3, "C": 1}
    assert got["abc"]["C"]["tiers"] == ["pipeline"] and got["abc"]["fold_s"] > 0
    mix = got["mix"]
    assert [(m["round"], m["n"]) for m in mix["requests"]] == [(0, 72), (0, 80), (1, 72), (1, 80)]
    assert mix["tiers"] == ["pipeline"] and mix["count"] == 4 and mix["p99"] >= mix["p50"] > 0
    assert all(m["fold_s"] > 0 and m["captures"] == 0 for m in mix["requests"])
    assert got["captures"] == 0 and got["store_info"]["graphs"] == 0


def _mix_record(costs, captures=0, tiers=("pipeline",)):
    return {"mix": {"requests": [{"cost": c} for c in costs], "tiers": list(tiers)}, "captures": captures}


@pytest.mark.parametrize("records,ok", [
    ({"store": [_mix_record([1.0, 2.0], 3)] * 2, "off": [_mix_record([1.0, 2.0])] * 2}, True),
    ({"store": [_mix_record([1.0, 2.0], 3)] * 2, "off": [_mix_record([1.0, 2.5])] * 2}, False),
    ({"store": [_mix_record([1.0], 3, ("greedy",))] * 2, "off": [_mix_record([1.0])] * 2}, False),
    ({"store": [_mix_record([1.0], 3)] * 2, "off": [_mix_record([1.0], 1)] * 2}, False),
], ids=["agree", "costs-differ", "off-tier", "off-captured"])
def test_serve_store_leg_runs_abba_and_holds_the_answers(records, ok):
    calls = []

    def child(mode, cache):
        setting = "off" if cache == "off" else "store"
        calls.append((mode, setting))
        return records[setting][sum(1 for _, s in calls if s == setting) - 1]

    leg = bench._serve_store_leg(child, "/nowhere")
    assert [s for _, s in calls] == ["store", "off", "off", "store"] and {m for m, _ in calls} == {"serve_mix"}
    assert leg["order"] == "ABBA" and leg["ok"] is ok and len(leg["runs"]["store"]) == 2


def _wide_record(costs, captures, polish_captures, evictions):
    reqs = [{"cost": c, "round": r, "captures": captures[r], "polish_captures": polish_captures[r]}
            for r in (0, 1) for c in costs]
    return {"mix": {"requests": reqs, "tiers": ["pipeline"]}, "captures": sum(captures),
            "store_info": {"evictions": evictions}}


def test_serve_wide_leg_counts_evictions_and_second_pass_captures():
    """The wide stream's leg: ABBA on its own child mode; each store run's
    evictions and the captures its second pass made again."""
    records = {"store": [_wide_record([1.0, 2.0], (2, 1), (2, 1), 3), _wide_record([1.0, 2.0], (2, 0), (2, 0), 0)],
               "off": [_wide_record([1.0, 2.0], (0, 0), (0, 0), 0)] * 2}
    calls = []

    def child(mode, cache):
        setting = "off" if cache == "off" else "store"
        calls.append((mode, setting))
        return records[setting][sum(1 for _, s in calls if s == setting) - 1]

    leg = bench._serve_wide_leg(child, "/nowhere")
    assert calls == [("serve_mix_wide", s) for s in ("store", "off", "off", "store")]
    assert leg["ok"] and leg["sizes"] == list(bench.STORE_WIDE_SIZES) and len(leg["sizes"]) == 24
    assert leg["second_pass_captures"] == [4, 0] and leg["evictions"] == [3, 0]
    assert set(bench.STORE_MIX_SIZES) < set(bench.STORE_WIDE_SIZES)

"""A serve proof's slices stay near their limit: the ILS in rounds, the
search's time checks every few steps, and the serve bench's named gates.

- ``_IlsRun`` stepped a round at a time ends on the tour of one
  uninterrupted ``strong_incumbent``, the port's and the JAX package's; a
  round that raises leaves the run as it was;
- a fresh proof cut into slices shorter than one ILS round runs the ILS
  one round a slice (handles with no bound yet), then the search, and ends
  on the unsliced proof (cost, certified LB, tour); through the scheduler,
  HK tickets are answered while the proof's ILS still runs;
- the ladder's default bnb rung hands ``BNB_INNER_STEPS`` to
  ``solve`` as ``inner_steps``;
- ``tools/bench --mode=serve`` names each gate and reports the
  iteration-level leg's tiers, latencies and proof slices.

Instances are uniform points made with numpy from a seed; 30 cities is the
smallest size whose ILS runs its 30 rounds.
"""

import json
import time

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import local_search as tls
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.serve import ladder as tladder
from tsp_mpi_reduction_tpu_torch.serve.scheduler import MicroBatchScheduler
from tsp_mpi_reduction_tpu_torch.tools import bench

#: a 30-city proof: the one-tree bound, a small frontier, fine time checks
PROOF_KW = dict(capacity=1024, k=16, device_loop=False, inner_steps=4, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _d(n: int, seed: int) -> np.ndarray:
    return distance_matrix_np(np.random.default_rng(seed).uniform(0, 1000, (n, 2)))


@pytest.mark.parametrize("n, seed, rounds", [(12, 1, None), (20, 7, 3), (30, 5, None)])
def test_ils_rounds_equal_the_uninterrupted_ils(n, seed, rounds):
    d = _d(n, seed)
    run = tbb._IlsRun(d, starts=16, perturbations=rounds, device="cpu")
    steps = 0
    while not run.done:
        run.step()
        steps += 1
    assert steps == (rounds if rounds is not None else (30 if n >= 30 else 0))
    got = run.tour()
    np.testing.assert_array_equal(got, tbb.strong_incumbent(d, starts=16, perturbations=rounds, device="cpu"))
    if rounds is not None:
        np.testing.assert_array_equal(got, jbb.strong_incumbent(d, starts=16, perturbations=rounds))


def test_a_round_that_raises_leaves_the_run_as_it_was(monkeypatch):
    d = _d(20, 7)
    want = tbb.strong_incumbent(d, starts=16, perturbations=3, device="cpu")
    run = tbb._IlsRun(d, starts=16, perturbations=3, device="cpu")
    run.step()
    before = (run.rounds_left, run.best.copy(), run.best_cost, run.rng.bit_generator.state)

    def broken(*a, **k):
        raise RuntimeError("polish failed")

    monkeypatch.setattr(tbb, "polish", broken)
    with pytest.raises(RuntimeError, match="polish failed"):
        run.step()
    monkeypatch.setattr(tbb, "polish", tls.polish)
    assert run.rounds_left == before[0] and run.best_cost == before[2]
    np.testing.assert_array_equal(run.best, before[1])
    assert run.rng.bit_generator.state == before[3]
    while not run.done:
        run.step()
    np.testing.assert_array_equal(run.tour(), want)


def test_a_sliced_ils_ends_at_the_unsliced_proof(tmp_path):
    d = _d(30, 5)
    ref = tbb.solve(d, **PROOF_KW)
    res, handle = tbb.solve_slice(d, 0.0, checkpoint_path=str(tmp_path / "p.npz"), **PROOF_KW)
    ils_slices = 0
    while isinstance(handle, tbb._IlsHandle):
        ils_slices += 1
        assert handle.slices == ils_slices and handle.ils.rounds_left == 31 - ils_slices
        assert res.nodes_expanded == 0 and res.lower_bound == handle.lower_bound == -np.inf
        assert handle.incumbent == res.cost and handle.gap_progress() == 0.0
        assert res.tour[0] == res.tour[-1] == 0 and sorted(res.tour[:-1]) == list(range(30))
        res, handle = tbb.solve_slice(d, 0.0, handle, **PROOF_KW)
    # the construction's slice, then one round a slice; the last round and
    # the search's first steps share the 31st
    assert ils_slices == 30 and res.nodes_expanded > 0
    assert handle is None or handle.first_lower_bound == res.root_lower_bound
    while handle is not None:
        res, handle = tbb.solve_slice(d, 60.0, handle, **PROOF_KW)
    assert ref.proven_optimal and res.proven_optimal
    assert (res.cost, res.lower_bound) == (ref.cost, ref.lower_bound)
    np.testing.assert_array_equal(res.tour, ref.tour)


def test_hk_tickets_are_answered_while_the_ils_runs(tmp_path, monkeypatch):
    """A ticket queued during the proof's third ILS round is answered
    before the next round: the worker takes it between two ILS slices."""
    d = _d(30, 5)
    ref = tbb.solve(d, **PROOF_KW)
    hk_d = _d(8, 9)
    kw = {k: v for k, v in PROOF_KW.items() if k != "device"}
    seen = {}
    step = tbb._IlsRun.step

    def watched(run):
        if "ticket" in seen and "answered_at" not in seen and seen["ticket"].wait(timeout=0) is not None:
            seen["answered_at"] = run.rounds_left
        step(run)
        if run.rounds_left == 27:
            seen["ticket"], seen["queued_at"] = sched.submit(hk_d[None]), run.rounds_left

    monkeypatch.setattr(tbb._IlsRun, "step", watched)
    with MicroBatchScheduler(max_batch=8, max_wait_ms=1.0, device="cpu") as sched:
        job = sched.submit_bnb(d, budget_s=600.0, slice_s=1e-4,
                               checkpoint_path=str(tmp_path / "job.npz"), solve_kw=kw)
        res = job.wait(timeout=300.0)
        got = seen["ticket"].wait(timeout=120.0)
        stats = sched.stats()
    assert got is not None and sorted(got[1][0][:-1]) == list(range(8))
    assert seen["answered_at"] == seen["queued_at"] == 27
    assert res is not None and res.proven_optimal and (res.cost, res.lower_bound) == (ref.cost, ref.lower_bound)
    np.testing.assert_array_equal(res.tour, ref.tour)
    assert stats["bnb_slices"] >= 31 and stats["bnb_preemptions"] == stats["bnb_slices"] - 1
    assert stats["admit_flushes"] == stats["batches"] == 1


class _Job:
    handle = None

    def wait(self, timeout=None):
        return tbb.BnBResult(cost=1.0, tour=np.array([0, 1, 2, 0]), nodes_expanded=1, iterations=1,
                             proven_optimal=True, wall_seconds=0.0, nodes_per_sec=0.0, time_to_best=0.0,
                             lower_bound=1.0)


class _Scheduler:
    device = "cpu"

    def submit_bnb(self, d, budget_s, slice_s, checkpoint_path, solve_kw):
        self.solve_kw = solve_kw
        return _Job()


def test_the_ladder_hands_its_inner_steps_to_the_rung(tmp_path):
    sched = _Scheduler()
    got = tladder.DeadlineLadder(sched, tladder.LadderConfig(bnb_checkpoint_dir=str(tmp_path)))._run_bnb(
        _d(3, 0), 10.0)
    assert got is not None and got.tier == "bnb" and got.certified_gap == 0.0
    assert sched.solve_kw["inner_steps"] == tladder.BNB_INNER_STEPS == 4
    assert sched.solve_kw["device_loop"] is False


def test_serve_bench_names_its_gates(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_T0", time.monotonic())
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)
    monkeypatch.setenv("TSP_BENCH_SERVE_REQS", "6")
    monkeypatch.setenv("TSP_BENCH_SERVE_BNB_N", "14")
    rc = bench.main(["--backend=cpu", f"--out-dir={tmp_path}", "--mode=serve"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last["gates"]) == {"tours_match", "service_tours_match", "bnb_identical", "resubmits_hit",
                                  "deadline_valid", "preempted_and_resumed"}
    assert last["ok"] == all(last["gates"].values()) and rc == (0 if last["ok"] else 1)
    it = last["iteration_level"]
    assert sum(it["tiers"].values()) == 6
    assert 0 < it["latency_ms"]["p50"] <= it["latency_ms"]["max"]
    assert len(it["bnb_slice_s"]) == len(it["bnb_slice_save_s"]) == last["service_scheduler"]["bnb_slices"]

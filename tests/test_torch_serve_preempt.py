"""Preemptible B&B slices on the port's scheduler, against the JAX package.

- a proof submitted to the scheduler (``submit_bnb``) and cut into slices
  by a per-slice ``max_iters`` ends on the port's uninterrupted proof
  (cost, certified LB, tour) and on the JAX package's own sliced proof,
  slice for slice (cost, LB, nodes, iterations, tour of the last slice);
  every slice but the last is a preemption and every later one a resume;
- HK tickets submitted while the proof holds the loop are admitted into
  its gaps (``admit`` flushes) and answered with the JAX package's costs;
- what the ladder learns from slices (``observe_partial``, service time
  rather than queue wait), the burn meter, the SLO verdicts and the
  queue-age quantiles equal the JAX package's on the same inputs.

The proof instance is the JAX tests' (n = 12, rounded x10 Euclidean, made
with numpy from a seed), under min-out with a small frontier, so it takes
several 400-iteration slices.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.obs import metrics as jmetrics
from tsp_mpi_reduction_tpu.obs import slo as jslo
from tsp_mpi_reduction_tpu.ops import held_karp as jhk
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.serve import ladder as jladder
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.obs import metrics as tmetrics
from tsp_mpi_reduction_tpu_torch.obs import slo as tslo
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.serve import ladder as tladder
from tsp_mpi_reduction_tpu_torch.serve.scheduler import MicroBatchScheduler

N, SEED = 12, 33
SOLVE_KW = dict(capacity=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
                node_ascent=0, device_loop=False, max_iters=400)


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path. Once ``compile_cache.enable()``
    has run in this process (an earlier test's serve CLI does), its
    solves would load whatever executables the shared AOT store holds,
    some compiled for an 8-device mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _d() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return np.rint(distance_matrix_np(rng.uniform(0, 100, (N, 2))) * 10)


def _jax_sliced(d, path):
    res, handle = jbb.solve_slice(d, 600.0, checkpoint_path=path, **SOLVE_KW)
    slices = 1
    while handle is not None:
        res, handle = jbb.solve_slice(d, 600.0, handle, **SOLVE_KW)
        slices += 1
    return res, slices


def _fields(res):
    return (res.cost, res.lower_bound, res.nodes_expanded, res.iterations, res.proven_optimal,
            tuple(int(c) for c in res.tour))


def test_submit_bnb_slices_equal_uninterrupted_and_jax(tmp_path):
    d = _d()
    ref = tbb.solve(d, device="cpu", **dict(SOLVE_KW, max_iters=2_000_000))
    rng = np.random.default_rng(9)
    hk_d = distance_matrix_np(rng.uniform(0, 100, (8, 2)))
    with MicroBatchScheduler(max_batch=8, max_wait_ms=5.0, device="cpu") as sched:
        job = sched.submit_bnb(d, budget_s=600.0, slice_s=600.0,
                               checkpoint_path=str(tmp_path / "job.npz"), solve_kw=SOLVE_KW)
        tickets = [sched.submit(hk_d[None]) for _ in range(3)]
        got = [t.wait(timeout=120.0) for t in tickets]
        res = job.wait(timeout=300.0)
        stats = sched.stats()
    want, want_slices = _jax_sliced(d, str(tmp_path / "jax.npz"))
    assert ref.proven_optimal and res is not None and res.proven_optimal
    assert (res.cost, res.lower_bound) == (ref.cost, ref.lower_bound)
    np.testing.assert_array_equal(res.tour, ref.tour)
    assert _fields(res) == _fields(want)
    assert want_slices >= 3
    assert stats["bnb_jobs"] == 1 and stats["bnb_slices"] == want_slices
    assert stats["bnb_preemptions"] == job.preemptions == want_slices - 1
    assert stats["bnb_resumes"] == job.resumes == want_slices - 1
    jc, _ = jhk.solve_blocks_from_dists(jnp.asarray(hk_d[None], jnp.float32), jnp.float32)
    for g in got:
        assert g is not None and g[0][0] == np.asarray(jc)[0]
    assert stats["admit_flushes"] + stats["wait_flushes"] + stats["full_flushes"] == stats["batches"] >= 1


def test_submit_bnb_validation_is_synchronous(tmp_path):
    path = str(tmp_path / "x.npz")
    with MicroBatchScheduler(max_batch=4, device="cpu") as sched:
        with pytest.raises(ValueError, match="distance matrix"):
            sched.submit_bnb(np.ones((3, 4)), budget_s=1.0, slice_s=0.1, checkpoint_path=path)
        with pytest.raises(ValueError, match="n >= 3"):
            sched.submit_bnb(np.ones((2, 2)), budget_s=1.0, slice_s=0.1, checkpoint_path=path)
        with pytest.raises(ValueError, match="must be > 0"):
            sched.submit_bnb(np.ones((4, 4)), budget_s=0.0, slice_s=0.1, checkpoint_path=path)
        with pytest.raises(ValueError, match="checkpoint_path"):
            sched.submit_bnb(np.ones((4, 4)), budget_s=1.0, slice_s=0.1, checkpoint_path="")


def test_ticket_queue_age_stamped_at_flush():
    d = distance_matrix_np(np.random.default_rng(2).uniform(0, 100, (8, 2)))
    before = tmetrics.REGISTRY.snapshot(prefix="serve_queue_age_seconds")
    with MicroBatchScheduler(max_batch=2, max_wait_ms=2.0, device="cpu") as sched:
        t = sched.submit(d[None])
        assert t.wait(timeout=30.0) is not None
    assert t.queue_age_s is not None and t.queue_age_s >= 0.0
    series = tmetrics.REGISTRY.delta(before, prefix="serve_queue_age_seconds").data.get(
        "serve_queue_age_seconds", {}).get("series", {})
    assert sum(h["count"] for h in series.values() if isinstance(h, dict)) >= 1


@pytest.mark.parametrize("elapsed,progress,cap", [(1.0, 0.25, 64.0), (1.0, 0.0, 64.0),
                                                  (0.0, 0.5, 64.0), (2.0, 1.5, 8.0)])
def test_observe_partial_matches_jax(elapsed, progress, cap):
    t, j = tladder.LatencyEstimator(), jladder.LatencyEstimator()
    t.observe_partial("bnb", 12, elapsed, progress, cap_factor=cap)
    j.observe_partial("bnb", 12, elapsed, progress, cap_factor=cap)
    assert t.estimate("bnb", 12, -1.0) == j.estimate("bnb", 12, -1.0)


def test_attempt_feeds_service_time_not_queue_wait():
    ladder = tladder.DeadlineLadder(scheduler=None)

    def run_with_wait():
        time.sleep(0.03)
        ladder._tls.queue_wait = 10.0  # pretend it all sat in the queue
        return "ok"

    assert ladder._attempt("pipeline", 8, run_with_wait) == "ok"
    assert ladder.estimator.estimate("pipeline", 8, 99.0) < 0.01
    ladder2 = tladder.DeadlineLadder(scheduler=None)

    def run_timeout():
        time.sleep(0.03)
        return None

    assert ladder2._attempt("pipeline", 8, run_timeout) is None
    assert ladder2.estimator.estimate("pipeline", 8, 0.0) >= 0.03


#: one latency stream (seconds) across tiers, some over their targets
LATENCIES = [("greedy", 1.0), ("greedy", 0.001), ("pipeline", 0.2), ("greedy", 0.07),
             ("pipeline", 2.5), ("bnb", 12.0), ("greedy", 0.01), ("greedy", 0.002),
             ("greedy", 0.3), ("pipeline", 0.4), ("greedy", 0.0005), ("greedy", 0.0004)]


@pytest.mark.parametrize("window,min_count", [(4, 2), (8, 4), (64, 8)])
def test_burn_meter_matches_jax(window, min_count):
    t = tslo.BurnMeter(window=window, min_count=min_count)
    j = jslo.BurnMeter(window=window, min_count=min_count)
    for tier, lat in LATENCIES:
        t.observe(tier, lat)
        j.observe(tier, lat)
        assert t.snapshot() == j.snapshot()
    with pytest.raises(ValueError, match="window"):
        tslo.BurnMeter(window=0)


def test_slo_verdicts_and_quantiles_match_jax():
    treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for tier, lat in LATENCIES:
        treg.observe("serve_request_seconds", lat, tier=tier)
        jreg.observe("serve_request_seconds", lat, tier=tier)

    def by_tier(reg):
        series = reg.snapshot().data["serve_request_seconds"]["series"]
        return {dict(k)["tier"]: v for k, v in series.items()}

    ht, hj = by_tier(treg), by_tier(jreg)
    assert ht == hj
    assert tslo.evaluate(ht) == jslo.evaluate(hj)
    assert tslo.evaluate(ht, {"greedy": {"target_ms": 5.0, "goal": 0.5}}) == jslo.evaluate(
        hj, {"greedy": {"target_ms": 5.0, "goal": 0.5}})
    for q in (0.0, 0.5, 0.9, 0.99, 1.0, 1.5):
        assert tmetrics.hist_quantile(ht["greedy"], q) == jmetrics.hist_quantile(hj["greedy"], q)

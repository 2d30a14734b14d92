"""Fleet chaos with real port replicas on the CPU.

Each case runs the port's ``FleetFront`` in-process over two replica
subprocesses of the port's serve CLI (``--backend cpu``) while the fault
registry kills or wedges a replica mid-flight. What must hold:

- every request answered exactly once, 0 errors, no degraded answer, and
  each answer (tour, cost, tier, certificate) equal to the port's
  in-process ``SolveService`` answer for the same request;
- the healing actions (restart, re-dispatch, the wedge verdict) in the
  health counters and the stats ``fleet`` block;
- one stitched span tree per fleet request, across the front and the
  replica processes, the replica's spans under ``front.dispatch``, no
  orphan; the JAX package's ``tools/obs_report.py --trace`` reads it;
- a cache hit served across the replica boundary (the shared disk tier);
- a fresh replica traces its first requests even when several threads
  meet the lazily opened ``TSP_TRACE`` sink at once;
- a replica killed while a nested span is still open orphans nothing.

The margins are generous (a 15 s startup grace, 30 s hops, 60 s
deadlines); the cases assert outcomes, never latencies.
"""

import io
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tsp_mpi_reduction_tpu_torch.fleet import FleetConfig, FleetFront
from tsp_mpi_reduction_tpu_torch.fleet.supervisor import SupervisorConfig
from tsp_mpi_reduction_tpu_torch.obs import tracing
from tsp_mpi_reduction_tpu_torch.resilience import faults
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH
from tsp_mpi_reduction_tpu_torch.serve.service import ServiceConfig, SolveService, run_jsonl

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.fleet,
    pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

ROOT = pathlib.Path(__file__).resolve().parent.parent
_N = 6
POLL_S = 20.0
ANSWER = ("n", "cost", "tour", "tier", "certified_gap")


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.clear()
    yield
    faults.clear()
    tracing.configure(None)


def _cfg(tmp_path):
    return FleetConfig(
        replicas=2,
        threads=4,
        replica_threads=2,
        backend="cpu",
        shared_cache_dir=str(tmp_path / "shared"),
        compile_cache_dir=str(tmp_path / "cc"),
        default_deadline_ms=60_000.0,
        hop_timeout_s=30.0,
        dispatch_attempts=4,
        supervisor=SupervisorConfig(
            probe_interval_s=0.1,
            wedge_timeout_s=2.0,
            startup_grace_s=15.0,
            scrape_timeout_s=1.0,
            restart_backoff_base_s=0.2,
            restart_backoff_max_s=1.0,
            healthy_reset_s=30.0,
        ),
    )


def _requests(count, seed, prefix="q"):
    rng = np.random.default_rng(seed)
    return [{"id": f"{prefix}{i}", "xy": rng.uniform(0, 1000, (_N, 2)).tolist(),
             "deadline_ms": 60_000.0} for i in range(count)]


def _run(front, requests):
    out = io.StringIO()
    run_jsonl([json.dumps(r) + "\n" for r in requests], out, service=front)
    return [json.loads(ln) for ln in out.getvalue().strip().splitlines()]


def _poll(cond):
    deadline = time.monotonic() + POLL_S
    while time.monotonic() < deadline and not cond():
        time.sleep(0.1)
    return cond()


def _restarts(front):
    return sum(r.restarts for r in front.supervisor.replicas)


def _in_process(requests):
    """The port's in-process service on the same requests, one by one."""
    with SolveService(ServiceConfig(device="cpu", threads=2)) as svc:
        return {r["id"]: svc.handle(r) for r in requests}


def _assert_exactly_once_as_in_process(responses, requests):
    ids = [r.get("id") for r in responses]
    assert ids == [r["id"] for r in requests], "dropped, duplicated or reordered responses"
    want = _in_process(requests)
    for r in responses:
        assert "error" not in r and "degraded" not in r, r
        assert {f: r[f] for f in ANSWER} == {f: want[r["id"]][f] for f in ANSWER}, r["id"]


def _warm(front):
    """Pay both replicas' start-up outside the chaos window."""
    _run(front, _requests(2, seed=99, prefix="w"))


def test_replica_kill_mid_flight_exactly_once_with_a_stitched_trace(tmp_path):
    trace = str(tmp_path / "trace.jsonl")
    tracing.configure(trace)
    front = FleetFront(_cfg(tmp_path))
    try:
        _warm(front)
        h0 = HEALTH.snapshot()
        faults.configure("replica.kill:raise,nth=3")
        requests = _requests(10, seed=1)
        responses = _run(front, requests)
        faults.clear()
        _poll(lambda: _restarts(front) >= 1)
        stats = json.loads(front.stats_json())
    finally:
        faults.clear()
        front.close()
        tracing.configure(None)
    _assert_exactly_once_as_in_process(responses, requests)
    h = HEALTH.delta_since(h0)
    assert h["faults_injected"].get("replica.kill") == 1
    assert h["fleet_redispatches"] >= 1 and stats["fleet"]["redispatches_total"] >= 1
    assert stats["fleet"]["restarts_total"] >= 1 and h["fleet_replica_restarts"] >= 1
    assert stats["errors"] == 0 and sum(stats["fleet"]["degraded_answers"].values()) == 0

    spans = tracing.read_trace(trace)
    assert tracing.orphan_spans(spans) == []
    roots = [root for t in tracing.build_trees(spans).values() for root in t["roots"]
             if root["span"]["name"] == "fleet.request"
             and str(root["span"]["attrs"].get("id", "")).startswith("q")]
    assert sorted(r["span"]["attrs"]["id"] for r in roots) == sorted(r["id"] for r in requests)
    for root in roots:  # the answering replica's request span sits under a dispatch hop
        hops = [c for c in root["children"] if c["span"]["name"] == "front.dispatch"]
        assert any(g["span"]["name"] == "serve.request" for hop in hops for g in hop["children"])
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_report.py"), "--trace", trace],
                       capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"{len(spans)} spans" in r.stdout and " 0 orphans" in r.stdout


def test_replica_hang_wedge_detected_exactly_once(tmp_path):
    """``replica.hang`` (SIGSTOP) mid-flight: the scrape probe stops
    answering, the wedge rule kills and restarts the replica once its
    start-up grace has passed, and the hung request re-dispatches."""
    front = FleetFront(_cfg(tmp_path))
    try:
        _warm(front)
        h0 = HEALTH.snapshot()
        faults.configure("replica.hang:raise,nth=3")
        requests = _requests(10, seed=2)
        responses = _run(front, requests)
        faults.clear()
        _poll(lambda: _restarts(front) >= 1)
        stats = json.loads(front.stats_json())
    finally:
        faults.clear()
        front.close()
    _assert_exactly_once_as_in_process(responses, requests)
    h = HEALTH.delta_since(h0)
    assert h["faults_injected"].get("replica.hang") == 1
    assert h["stuck_restarts"] >= 1  # the wedge verdict
    assert h["fleet_redispatches"] >= 1
    assert stats["fleet"]["restarts_total"] >= 1 and stats["errors"] == 0


def test_cache_hits_cross_the_replica_boundary(tmp_path):
    """An instance one replica solved is a hit for permuted, translated
    resubmissions, served by the OTHER replica from the shared disk tier:
    the solver is killed after answering, so its survivor, whose L1 never
    held the entry, answers the resubmissions."""
    front = FleetFront(_cfg(tmp_path))
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 1000, (_N, 2))
    try:
        _warm(front)
        before = [rep.answered for rep in front.supervisor.replicas]
        (first,) = _run(front, [{"id": "orig", "xy": xy.tolist(), "deadline_ms": 60_000.0}])
        (solver,) = [rep for rep, n in zip(front.supervisor.replicas, before) if rep.answered > n]
        front.supervisor.kill_replica(solver)
        resubs = [{"id": f"dup{i}", "xy": (xy[rng.permutation(_N)] + float(rng.integers(-300, 300))).tolist(),
                   "deadline_ms": 60_000.0} for i in range(4)]
        responses = _run(front, resubs)

        def shared_hits():
            rows = json.loads(front.stats_json())["fleet"]["replicas"]
            return sum(row["scrape"].get("shared_cache_hits", 0) for row in rows)

        # the scrapes and the respawn land on the supervisor's cadence
        assert _poll(lambda: shared_hits() >= 1 and _restarts(front) >= 1)
        stats = json.loads(front.stats_json())
    finally:
        front.close()
    assert "error" not in first and first["cache"] == "miss"
    assert all(r["cache"] == "hit" and "degraded" not in r for r in responses), responses
    for r in responses:
        assert abs(r["cost"] - first["cost"]) < 1e-6 and r["tier"] == first["tier"]
    assert stats["errors"] == 0 and stats["fleet"]["restarts_total"] >= 1


def test_a_kill_inside_a_nested_span_orphans_nothing(tmp_path):
    """A replica's request root is announced at open, and so is every span
    under it: read while the rung and its queue wait are still open (the
    kill's moment, after the worker emitted its flush), every record's
    parent is in the sink. Only the root's parent, the front's hop, which
    another process writes, is missing here."""
    path = tmp_path / "trace.jsonl"
    tracing.configure(str(path))
    hop = ("a" * 32, "b" * 16)
    with tracing.span("serve.request", parent=hop, announce=True):
        with tracing.span("cache.lookup"):
            pass
        with tracing.span("ladder.rung", tier="exact"):
            with tracing.span("sched.wait", blocks=1) as wait:
                flush = tracing.emit_span("sched.flush", wait.context, time.time(), 0.002)
                tracing.emit_span("device.dispatch", flush, time.time(), 0.001)
                spans = tracing.read_trace(str(path))
    assert [s["name"] for s in tracing.orphan_spans(spans)] == ["serve.request"]
    assert [s["name"] for s in spans if s["attrs"].get("partial")] == [
        "serve.request", "cache.lookup", "ladder.rung", "sched.wait"]
    # an unannounced root (a serve request with no fleet parent) writes
    # each span once, at its close
    tracing.configure(str(tmp_path / "plain.jsonl"))
    with tracing.span("serve.request"):
        with tracing.span("ladder.rung"):
            pass
    plain = tracing.read_trace(str(tmp_path / "plain.jsonl"))
    assert [s["name"] for s in plain] == ["ladder.rung", "serve.request"]
    assert not any(s["attrs"].get("partial") for s in plain)


def test_lazy_trace_sink_is_open_before_a_second_thread_reads_it(tmp_path, monkeypatch):
    """A restarted replica's first requests reach ``TRACER.active`` on two
    threads at once while the first one still opens the ``TSP_TRACE``
    sink: the second must wait for the sink, not trace nothing."""
    monkeypatch.setenv("TSP_TRACE", str(tmp_path / "t.jsonl"))
    tracer = tracing.Tracer()
    opening, release = threading.Event(), threading.Event()

    def slow_open(*args, **kwargs):
        opening.set()
        release.wait(10)
        return open(*args, **kwargs)

    monkeypatch.setattr(tracing, "open", slow_open, raising=False)
    seen = []
    first = threading.Thread(target=lambda: seen.append(("first", tracer.active)))
    first.start()
    assert opening.wait(10)
    second = threading.Thread(target=lambda: seen.append(("second", tracer.active)))
    second.start()
    second.join(0.5)
    release.set()
    first.join(10)
    second.join(10)
    assert not first.is_alive() and not second.is_alive()
    assert sorted(seen) == [("first", True), ("second", True)]

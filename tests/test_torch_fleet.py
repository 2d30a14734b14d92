"""The port's fleet (front, supervisor, replicas) against the JAX package's.

Each case drives the same traffic through the JAX ``FleetFront`` and the
port's, over the stdlib stub replica (``fleet_stub_replica.py``, which
imports neither jax nor torch), and holds the fields that do not depend on
timing equal: ids, tiers, costs, tours, ``cache``, the degraded reasons,
the deterministic ``fleet``/``health`` counters and the key sets of the
stats lines. The shared disk tier cases run in-process (two tier instances
over one directory are two replicas as far as the disk is concerned); the
CLI cases run ``fleet --backend=cpu`` with real replicas of each package.

Races are ordered by wide margins (a 0.8 s hop against a 3 s stub, a 2 s
wedge timeout against a 10 s hop; no wedge verdict inside a replica's
first 2 s; a loaded host can stall a process for hundreds of ms), and
outcomes that land on the supervisor's cadence are polled for up to 10 s,
never read once.
"""

import io
import json
import os
import pathlib
import random
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tsp_mpi_reduction_tpu.fleet as jfleet
import tsp_mpi_reduction_tpu_torch.fleet as tfleet
from tsp_mpi_reduction_tpu.fleet import front as jfront
from tsp_mpi_reduction_tpu.fleet import replica as jreplica
from tsp_mpi_reduction_tpu.fleet import supervisor as jsupervisor
from tsp_mpi_reduction_tpu.resilience import faults as jfaults
from tsp_mpi_reduction_tpu.resilience import retry as jretry
from tsp_mpi_reduction_tpu.resilience.health import HEALTH as JHEALTH
from tsp_mpi_reduction_tpu.serve import cache as jcache
from tsp_mpi_reduction_tpu.serve import canonical as jcanon
from tsp_mpi_reduction_tpu.serve import service as jservice
from tsp_mpi_reduction_tpu_torch.fleet import front as tfront
from tsp_mpi_reduction_tpu_torch.fleet import replica as treplica
from tsp_mpi_reduction_tpu_torch.fleet import supervisor as tsupervisor
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.resilience import retry as tretry
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH
from tsp_mpi_reduction_tpu_torch.serve import cache as tcache
from tsp_mpi_reduction_tpu_torch.serve import canonical as tcanon
from tsp_mpi_reduction_tpu_torch.serve import ladder as tladder
from tsp_mpi_reduction_tpu_torch.serve import service as tservice
from tsp_mpi_reduction_tpu_torch.utils.cli import main as torch_main

pytestmark = [
    pytest.mark.fleet,
    pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

ROOT = pathlib.Path(__file__).resolve().parent.parent
STUB = os.path.join(os.path.dirname(__file__), "fleet_stub_replica.py")
PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, front=jfront, replica=jreplica, sup=jsupervisor,
                           faults=jfaults, retry=jretry, health=JHEALTH, cache=jcache,
                           canon=jcanon, service=jservice),
    "torch": SimpleNamespace(fleet=tfleet, front=tfront, replica=treplica, sup=tsupervisor,
                             faults=tfaults, retry=tretry, health=THEALTH, cache=tcache,
                             canon=tcanon, service=tservice),
}
#: response fields that depend on timing
TIMING = ("fleet_latency_ms", "latency_ms")
POLL_S = 10.0


@pytest.fixture(autouse=True)
def _no_faults():
    for p in PKGS.values():
        p.faults.clear()
    # the conftest resets the JAX package's health counters before every
    # test; the port's too, so an anomaly event an earlier B&B solve in
    # this worker fired is not a key of this test's health block
    THEALTH.reset_for_testing()
    yield
    for p in PKGS.values():
        p.faults.clear()


def _stub_specs(p, count, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return [p.fleet.ReplicaSpec(argv=[sys.executable, STUB], env=env, scrape=False)
            for _ in range(count)]


def _front(p, root, specs, supervisor=None, **kw):
    sup = p.sup.SupervisorConfig(**(supervisor or dict(
        probe_interval_s=0.05, wedge_timeout_s=5.0, startup_grace_s=2.0,
        restart_backoff_base_s=0.05, restart_backoff_max_s=0.3, healthy_reset_s=2.0)))
    cfg = p.fleet.FleetConfig(
        threads=kw.pop("threads", 4),
        shared_cache_dir=str(root / "shared"),
        compile_cache_dir=str(root / "cc"),
        replica_specs=specs,
        hop_timeout_s=kw.pop("hop_timeout_s", 10.0),
        supervisor=sup,
        **kw,
    )
    return p.fleet.FleetFront(cfg)


def _requests(count, n=6, seed=0, deadline_ms=5000.0):
    rng = np.random.default_rng(seed)
    return [{"id": f"r{i}", "xy": rng.uniform(0, 100, (n, 2)).tolist(), "deadline_ms": deadline_ms}
            for i in range(count)]


def _run(p, front, requests):
    out = io.StringIO()
    p.service.run_jsonl([json.dumps(r) + "\n" for r in requests], out, service=front)
    return [json.loads(ln) for ln in out.getvalue().strip().splitlines()]


def _poll(cond):
    deadline = time.monotonic() + POLL_S
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def _drive(tmp_path, make_specs, requests, *, until=None, **front_kw):
    """The same traffic through each package's front: per package, the
    responses, the stats line (read once ``until(front)`` holds, polled)
    and the health delta."""
    out = {}
    for name, p in PKGS.items():
        front = _front(p, tmp_path / name, make_specs(p), **front_kw)
        h0 = p.health.snapshot()
        try:
            responses = _run(p, front, requests)
            if until is not None:
                _poll(lambda: until(front))
            stats = json.loads(front.stats_json())
        finally:
            front.close()
        out[name] = (responses, stats, p.health.delta_since(h0))
    return out


def _det(resp):
    return {k: v for k, v in resp.items() if k not in TIMING}


def _assert_valid(resp, n):
    assert "error" not in resp, resp
    tour = resp["tour"]
    assert tour[0] == tour[-1] and sorted(tour[:-1]) == list(range(n))


def _assert_same_answers(got):
    (jr, _, _), (tr, _, _) = got["jax"], got["torch"]
    assert [_det(r) for r in tr] == [_det(r) for r in jr]


def _assert_same_stats_keys(js, ts):
    assert list(ts) == list(js)
    for block in ("fleet", "cache", "health", "slo"):
        assert set(ts[block]) == set(js[block]), block
    assert set(ts["obs"]) <= set(js["obs"])  # the port's obs block has no XLA keys
    assert set(ts["fleet"]["shared_cache"]) == set(js["fleet"]["shared_cache"])
    for jrow, trow in zip(js["fleet"]["replicas"], ts["fleet"]["replicas"]):
        assert list(trow) == list(jrow)


def _restarted(front):
    return sum(r.restarts for r in front.supervisor.replicas) >= 1


def _entry(p, cost, tier="greedy", gap=None, n=6):
    tour = np.concatenate([np.arange(n, dtype=np.int32), [0]])
    return p.cache.CacheEntry(cost=float(cost), tour=tour, certified_gap=gap, tier=tier)


# -- shared disk cache tier ----------------------------------------------------


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_shared_tier_better_entry_arbitration(tmp_path, name):
    """A certified optimum survives a later weaker publish; a strictly
    cheaper tour wins. The same counters in both packages, whichever
    package's tier reads the directory."""
    writer, reader = PKGS[name], PKGS["torch"]
    tier = writer.fleet.SharedCacheTier(str(tmp_path))
    tier.put("k", _entry(writer, 10.0, tier="bnb", gap=0.0))
    tier.put("k", _entry(writer, 10.0, tier="greedy"))
    assert reader.fleet.SharedCacheTier(str(tmp_path)).get("k").tier == "bnb"
    tier.put("k", _entry(writer, 8.0, tier="greedy"))
    assert reader.fleet.SharedCacheTier(str(tmp_path)).get("k").cost == 8.0
    stats = tier.stats()
    assert stats["publishes"] == 2 and stats["kept_better"] == 1


def test_shared_tier_concurrent_publishers_of_both_packages(tmp_path):
    """Ten threads, half the JAX package's tier and half the port's, race
    one key: every read during and after parses, and the final entry is
    one of the published ones; a re-publish of the best converges."""
    costs = [50.0 - i for i in range(10)]
    barrier = threading.Barrier(10)
    reads = []

    def publish(i, c):
        p = PKGS["jax" if i % 2 else "torch"]
        barrier.wait()
        tier = p.fleet.SharedCacheTier(str(tmp_path))
        tier.put("k", _entry(p, c))
        reads.append(tier.get("k"))

    threads = [threading.Thread(target=publish, args=(i, c)) for i, c in enumerate(costs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert all(r is not None and r.cost in costs for r in reads)
    tier = tfleet.SharedCacheTier(str(tmp_path))
    assert tier.get("k").cost in costs
    tier.put("k", _entry(PKGS["torch"], min(costs)))
    assert jfleet.SharedCacheTier(str(tmp_path)).get("k").cost == min(costs)
    assert tier.stats()["corrupt_skipped"] == 0


@pytest.mark.parametrize("certifier", ["torch", "jax"])
def test_certified_entry_survives_degraded_resubmit_across_replicas(tmp_path, certifier):
    """Replica A (either package) certifies an instance; the port's replica
    B gets a deadline-degraded resubmission (permuted, translated) and
    answers from the shared tier with the certificate intact; B's own
    greedy publish does not clobber the certified entry."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 100, (8, 2))
    a_mod = PKGS[certifier].service
    a_cfg = dict(shared_cache_dir=str(tmp_path), threads=2)
    if certifier == "torch":
        a_cfg.update(device="cpu", ladder=tladder.LadderConfig(bnb_max_n=0))
    else:
        from tsp_mpi_reduction_tpu.serve.ladder import LadderConfig

        a_cfg.update(ladder=LadderConfig(bnb_max_n=0))
    with a_mod.SolveService(a_mod.ServiceConfig(**a_cfg)) as a:
        r1 = a.handle({"id": "a", "xy": xy.tolist(), "deadline_ms": 60_000.0})
    assert r1["certified_gap"] == 0.0 and r1["tier"] == "pipeline"
    resub = xy[rng.permutation(8)] + 123.0
    b_cfg = tservice.ServiceConfig(shared_cache_dir=str(tmp_path), threads=2, device="cpu",
                                   ladder=tladder.LadderConfig(bnb_max_n=0))
    with tservice.SolveService(b_cfg) as b:
        r2 = b.handle({"id": "b", "xy": resub.tolist(), "deadline_ms": 0.5})
        stats = json.loads(b.stats_json())
    assert r2["cache"] == "hit" and r2["tier"] == "pipeline" and r2["certified_gap"] == 0.0
    assert abs(r2["cost"] - r1["cost"]) < 1e-6
    assert stats["cache"]["shared"]["hits"] == 1
    ci = tcanon.canonicalize(resub)
    assert jfleet.SharedCacheTier(str(tmp_path)).get(ci.key).certified_gap == 0.0


def test_shared_tier_survives_l1_eviction(tmp_path):
    """The disk tier outlives the L1: an entry evicted from a one-slot L1
    is still served (and re-promoted) from disk, in both packages."""
    for name, p in PKGS.items():
        tier = p.fleet.TieredSolutionCache(1, str(tmp_path / name))
        tier.put("k1", _entry(p, 1.0))
        tier.put("k2", _entry(p, 2.0))
        assert tier.get("k1").cost == 1.0, name
        assert tier.shared.stats()["hits"] >= 1
        assert tier.get("k1") is not None and tier.stats()["hits"] >= 1


# -- supervisor + front over stub replicas -------------------------------------


def test_fleet_basic_workload_exactly_once(tmp_path):
    reqs = _requests(12)
    got = _drive(tmp_path, lambda p: _stub_specs(p, 2), reqs)
    _assert_same_answers(got)
    for name, (responses, stats, _) in got.items():
        assert [r["id"] for r in responses] == [r["id"] for r in reqs]
        for r in responses:
            _assert_valid(r, 6)
            assert "fleet_latency_ms" in r
        assert stats["responses"] == 12 and stats["errors"] == 0 and stats["fleet"]["alive"] == 2
        assert sum(row["answered"] for row in stats["fleet"]["replicas"]) == 12
    _assert_same_stats_keys(got["jax"][1], got["torch"][1])
    assert got["torch"][1]["tiers"] == got["jax"][1]["tiers"] == {"greedy": 12}


def test_replica_death_restart_and_redispatch(tmp_path):
    """A replica crashing mid-stream: its in-flight requests re-dispatch to
    the survivor (exactly once, all valid), the supervisor restarts it, and
    both actions land in health and stats, in both packages."""

    def specs(p):  # the dying replica is fast; the survivor stays busy
        return (_stub_specs(p, 1, {"STUB_DIE_AFTER": "2", "STUB_SLEEP_MS": "20"})
                + _stub_specs(p, 1, {"STUB_SLEEP_MS": "150"}))

    got = _drive(tmp_path, specs, _requests(16, deadline_ms=20_000.0), until=_restarted, threads=3)
    _assert_same_answers(got)
    for name, (responses, stats, h) in got.items():
        assert len({r["id"] for r in responses}) == len(responses) == 16
        for r in responses:
            _assert_valid(r, 6)
            assert "degraded" not in r
        assert stats["fleet"]["restarts_total"] >= 1 and h["fleet_replica_restarts"] >= 1, name
        assert h["fleet_redispatches"] >= 1, name
        assert stats["fleet"]["redispatches_total"] == h["fleet_redispatches"]
        assert stats["errors"] == 0
    _assert_same_stats_keys(got["jax"][1], got["torch"][1])


def test_first_writer_wins_suppresses_duplicate(tmp_path):
    """A hop that times out on a slow replica (0.8 s against 3 s)
    re-dispatches; the slow replica's late answer is suppressed."""

    def specs(p):
        return _stub_specs(p, 1, {"STUB_SLEEP_MS": "3000"}) + _stub_specs(p, 1)

    got = _drive(
        tmp_path, specs, _requests(2, deadline_ms=20_000.0), threads=1, hop_timeout_s=0.8,
        until=lambda f: json.loads(f.stats_json())["fleet"]["duplicates_suppressed"] >= 1,
        supervisor=dict(probe_interval_s=0.05, wedge_timeout_s=30.0,
                        restart_backoff_base_s=0.05, restart_backoff_max_s=0.2),
    )
    _assert_same_answers(got)
    for name, (responses, stats, _) in got.items():
        assert len(responses) == 2
        for r in responses:
            _assert_valid(r, 6)
        assert stats["fleet"]["duplicates_suppressed"] >= 1, name
        assert stats["fleet"]["redispatches_total"] >= 1, name


def test_degraded_no_replicas_answers_the_jax_greedy_tour(tmp_path):
    """Zero replicas: every request gets the JAX front's greedy tour,
    locally, with the reason counted."""
    got = _drive(tmp_path, lambda p: [], _requests(4))
    _assert_same_answers(got)
    for name, (responses, stats, h) in got.items():
        for r in responses:
            _assert_valid(r, 6)
            assert r["degraded"] == "no_replicas" and r["tier"] == "greedy"
        assert stats["fleet"]["degraded_answers"] == {"no_replicas": 4, "deadline": 0, "dispatch": 0}
        assert h["fleet_degraded_answers"] == 4
    _assert_same_stats_keys(got["jax"][1], got["torch"][1])


@pytest.mark.parametrize("n", [1, 2, 3, 6, 17, 60])
def test_greedy_tour_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    for xy in (rng.uniform(0, 1000, (n, 2)), np.rint(rng.uniform(0, 10, (n, 2)))):  # ties too
        jc, jt = jfront._greedy_tour_np(xy)
        tc, tt = tfront._greedy_tour_np(xy)
        assert tc == jc and tt.dtype == jt.dtype and np.array_equal(tt, jt)


@pytest.mark.parametrize("publisher", ["jax", "torch"])
def test_degraded_answers_from_shared_cache(tmp_path, publisher):
    """A degraded front serves certified work from the shared tier, here an
    entry that either package published, instead of a greedy tour."""
    p = PKGS[publisher]
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (6, 2))
    ci = p.canon.canonicalize(xy)
    tour = np.concatenate([np.arange(6, dtype=np.int32), [0]])
    entry = p.cache.CacheEntry(cost=p.canon.tour_length_np(p.canon.from_canonical_tour(tour, ci), xy),
                               tour=tour, certified_gap=0.0, tier="bnb")
    for name in PKGS:
        p.fleet.TieredSolutionCache(4, str(tmp_path / name / "shared")).put(ci.key, entry)
    got = _drive(tmp_path, lambda q: [], [{"id": "c", "xy": xy.tolist(), "deadline_ms": 500.0}])
    _assert_same_answers(got)
    (resp,) = got["torch"][0]
    _assert_valid(resp, 6)
    assert resp["cache"] == "hit" and resp["tier"] == "bnb"
    assert resp["certified_gap"] == 0.0 and resp["degraded"] == "no_replicas"


@pytest.mark.chaos
def test_dispatch_retry_capped_by_deadline(tmp_path):
    """``front.dispatch`` raising on every crossing: the bounded retry burns
    its attempts (counted as retries), the request still gets a local
    answer, and the 1 s budgets do not compound into seconds."""
    out = {}
    for name, p in PKGS.items():
        front = _front(p, tmp_path / name, _stub_specs(p, 1))
        h0 = p.health.snapshot()
        p.faults.configure("front.dispatch:raise,count=0")
        try:
            t0 = time.monotonic()
            responses = _run(p, front, _requests(2, deadline_ms=1000.0))
            wall = time.monotonic() - t0
        finally:
            p.faults.clear()
            front.close()
        out[name] = (responses, p.health.delta_since(h0))
        assert wall < 5.0
    for name, (responses, h) in out.items():
        for r in responses:
            _assert_valid(r, 6)
            assert r["degraded"] in ("dispatch", "deadline")
        assert h["retries"] >= 1 and h["faults_injected"].get("front.dispatch", 0) >= 2, name
    (jr, jh), (tr, th) = out["jax"], out["torch"]
    assert [_det(r) for r in tr] == [_det(r) for r in jr]
    assert (th["retries"], th["faults_injected"]) == (jh["retries"], jh["faults_injected"])


def test_wedged_stub_detected_and_redispatched(tmp_path):
    """A replica that silently stops answering is wedge-detected (2 s, far
    inside the 10 s hop), killed and restarted; its request lands
    elsewhere exactly once. One request at a time: the first goes to the
    stub that answers once, and so does the second (the tie goes to the
    lower index), which that stub then ignores."""
    got = _drive(
        tmp_path,
        lambda p: _stub_specs(p, 1, {"STUB_IGNORE_AFTER": "1"}) + _stub_specs(p, 1),
        _requests(3, deadline_ms=60_000.0), threads=1, hop_timeout_s=10.0,
        until=lambda f: _restarted(f) and json.loads(f.stats_json())["health"]["stuck_restarts"] >= 1,
        supervisor=dict(probe_interval_s=0.05, wedge_timeout_s=2.0, startup_grace_s=2.0,
                        restart_backoff_base_s=0.05, restart_backoff_max_s=0.2, healthy_reset_s=2.0),
    )
    _assert_same_answers(got)
    for name, (responses, stats, h) in got.items():
        assert len({r["id"] for r in responses}) == len(responses) == 3
        for r in responses:
            _assert_valid(r, 6)
            assert "degraded" not in r
        assert h["stuck_restarts"] >= 1 and h["fleet_redispatches"] >= 1, name
        assert stats["fleet"]["restarts_total"] >= 1, name


def test_restart_backoff_is_bounded():
    """A crash-looping replica's respawn delays follow the bounded
    exponential curve, the same delays in both packages."""
    cap = 0.25
    delays = {}
    for name, p in PKGS.items():
        rep = p.replica.Replica(0, _stub_specs(p, 1, {"STUB_DIE_AFTER": "1"})[0],
                                on_response=lambda *a: None)
        policy = p.retry.RetryPolicy(max_attempts=100, base_delay_s=0.05, max_delay_s=cap, seed=0)
        want, got = [], []
        for attempt in range(1, 12):
            rep.restart_due_at = None  # a fresh death
            t0 = time.monotonic()
            k = rep.schedule_restart(lambda k: policy.delay_s(k, random.Random(k)))
            assert k == attempt
            got.append(rep.restart_due_at - t0)
            want.append(policy.delay_s(attempt, random.Random(attempt)))
        assert all(d <= cap + 0.01 for d in got) and got[0] <= 0.06 and max(got) > got[0]
        delays[name] = want
    assert delays["torch"] == delays["jax"]


def test_scrape_lifetime_keeps_a_killed_generations_counts():
    """The port's own bookkeeping (JAX keeps the live process's totals
    only): a restarted replica's process counts from zero, so the slot's
    lifetime totals add its dead predecessor's last scrape to the live
    one's, and a scrape of the same generation replaces, never adds."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    payload = {}

    class Metrics(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    def serve(hits, publishes):
        payload.clear()
        payload["fleet_shared_cache_ops_total"] = {"series": [
            {"labels": {"op": "get", "outcome": "hit"}, "value": hits},
            {"labels": {"op": "put", "outcome": "published"}, "value": publishes}]}

    server = ThreadingHTTPServer(("127.0.0.1", 0), Metrics)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    rep = treplica.Replica(0, treplica.ReplicaSpec(argv=[sys.executable, STUB], env=dict(os.environ)),
                           on_response=lambda *a: None)
    try:
        rep.spawn()
        rep.metrics_port = server.server_port
        serve(2, 3)
        assert rep.scrape()["shared_cache_hits"] == 2
        serve(5, 3)
        rep.scrape()
        assert rep.scrape_lifetime()["shared_cache_hits"] == 5
        rep.kill()
        rep.spawn()
        # the successor is not scraped yet: its predecessor's totals stand once
        assert rep.scrape_lifetime()["shared_cache_hits"] == 5
        rep.metrics_port = server.server_port
        serve(1, 0)
        rep.scrape()
        assert rep.snapshot()["scrape"]["shared_cache_hits"] == 1 and rep.snapshot()["generation"] == 2
        life = rep.scrape_lifetime()
        assert (life["shared_cache_hits"], life["shared_cache_publishes"]) == (6, 3)
    finally:
        rep.kill()
        server.shutdown()
        server.server_close()


def test_front_stats_fleet_block_and_obs_report(tmp_path, capsys):
    """The port's stats line carries the JAX fleet block's keys, and the
    JAX ``tools/obs_report.py --fleet`` renders it."""
    sys.path.insert(0, str(ROOT / "tools"))
    import obs_report

    got = _drive(tmp_path, lambda p: _stub_specs(p, 1), _requests(3))
    _assert_same_answers(got)
    _assert_same_stats_keys(got["jax"][1], got["torch"][1])
    stats = got["torch"][1]
    assert set(stats["fleet"]) >= {
        "replicas", "replica_count", "alive", "restarts_total", "redispatches_total",
        "degraded_answers", "duplicates_suppressed", "shared_cache",
    }
    good = tmp_path / "fleet_stats.json"
    good.write_text(json.dumps(stats) + "\n")
    assert obs_report.main(["--fleet", str(good)]) == 0
    out = capsys.readouterr().out
    assert "replica 0" in out and "supervision:" in out


def test_fleet_stats_slo_block_judges_front_latency(tmp_path):
    """The front's SLO verdicts come from its own end-to-end histograms
    (``fleet_request_seconds``), windowed to the front's lifetime."""
    got = _drive(tmp_path, lambda p: _stub_specs(p, 1), _requests(5, deadline_ms=5000.0))
    _assert_same_answers(got)
    for name, (_, stats, _) in got.items():
        greedy = stats["slo"]["greedy"]
        assert greedy["requests"] == 5 and greedy["attainment"] is not None, name
    js, ts = got["jax"][1]["slo"], got["torch"][1]["slo"]
    assert {t: set(v) - {"interpolated"} for t, v in ts.items()} == \
        {t: set(v) - {"interpolated"} for t, v in js.items()}
    assert {t: v["requests"] for t, v in ts.items()} == {t: v["requests"] for t, v in js.items()}


# -- the CLI -------------------------------------------------------------------

README_REQUESTS = [
    {"id": "a", "xy": [[0, 0], [3, 0], [3, 4], [0, 4], [1, 2], [2, 1]], "deadline_ms": 5000},
    {"id": "b", "xy": [[10, 10], [13, 10], [13, 14], [10, 14], [12, 11]], "deadline_ms": 0.1},
]
ANSWER = ("id", "n", "cost", "tour", "tier", "certified_gap", "deadline_missed")


#: sent first, with a long deadline, to a front of one request thread: the
#: replica that answers it is warm when ``a`` follows (the front dispatches
#: at once, and ``a``'s 5 s would otherwise run during a cold start)
WARM_UP = {"id": "w", "xy": [[0, 0], [5, 0], [5, 5], [0, 5]], "deadline_ms": 240_000}


def test_fleet_cli_readme_requests_match_serve_and_jax(tmp_path):
    inp = tmp_path / "req.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in [WARM_UP, *README_REQUESTS]))
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    procs = {
        pkg: subprocess.Popen([sys.executable, "-m", pkg, "fleet", "--backend=cpu", "--replicas", "2",
                               "--threads", "1", "--stats", "--in", str(inp),
                               "--out", str(tmp_path / f"{pkg}.jsonl")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
                              env=env)
        for pkg in ("tsp_mpi_reduction_tpu_torch", "tsp_mpi_reduction_tpu")
    }
    errs = {}
    for pkg, proc in procs.items():
        try:
            _, errs[pkg] = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, errs[pkg][-2000:]
    got, want = ([json.loads(x) for x in (tmp_path / f"{pkg}.jsonl").read_text().splitlines()][1:]
                 for pkg in procs)
    readme = tmp_path / "readme.jsonl"
    readme.write_text("".join(json.dumps(r) + "\n" for r in README_REQUESTS))
    serve_out = tmp_path / "serve.jsonl"
    assert torch_main(["serve", "--backend=cpu", "--in", str(readme), "--out", str(serve_out)]) == 0
    served = [json.loads(x) for x in serve_out.read_text().splitlines()]
    for g, w, s in zip(got, want, served):
        assert {f: g[f] for f in ANSWER} == {f: w[f] for f in ANSWER} == {f: s[f] for f in ANSWER}
        assert g["cache"] == w["cache"] and g.get("degraded") == w.get("degraded")
    assert [g["tier"] for g in got] == ["pipeline", "greedy"] and got[0]["tour"] == [0, 4, 3, 2, 5, 1, 0]
    assert got[1]["degraded"] == "deadline"  # 0.1 ms: answered by the front itself
    stats = json.loads(errs["tsp_mpi_reduction_tpu_torch"].strip().splitlines()[-1])
    assert stats["responses"] == 3 and stats["errors"] == 0 and stats["fleet"]["replica_count"] == 2
    assert stats["tiers"]["pipeline"] == 1 and stats["tiers"]["greedy"] == 1


def test_fleet_cli_default_backend_needs_a_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs there")

    def no_front(*a, **k):
        raise AssertionError("a replica was spawned")

    monkeypatch.setattr(tfront, "FleetFront", no_front)
    for backend in ([], ["--backend=auto"], ["--backend=cuda"]):
        assert torch_main(["fleet", *backend]) == 2
    inp = tmp_path / "req.jsonl"
    inp.write_text(json.dumps(README_REQUESTS[0]) + "\n")
    r = subprocess.run([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "fleet", "--in", str(inp)],
                       capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert r.returncode == 2 and r.stdout == "" and "needs a CUDA device" in r.stderr

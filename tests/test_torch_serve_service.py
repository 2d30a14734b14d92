"""The port's deadline ladder, solve service and ``serve`` CLI on the CPU,
against the JAX package.

- the ladder answers the cases of ``tests/test_serve_service.py`` on the
  same tiers as the JAX ladder (the injected ``bnb_solver`` where the JAX
  tests inject one, the real sliced B&B rung on a tiny instance), with the
  same cost and tour wherever the tier is deterministic;
- a JSONL session gives, request for request, the JAX service's tier,
  certificate, cache provenance, cost and tour, and a ``--stats`` line
  with the JAX line's keys (``compile_cache`` and ``obs`` hold the port's
  subset: no XLA keys), which the JAX package's ``obs_report --serve``
  renders;
- the README's two requests through ``python -m tsp_mpi_reduction_tpu_torch
  serve --backend=cpu`` answer as the JAX service does; without a GPU the
  default backend exits 2;
- a service with ``shared_cache_dir`` publishes entries the JAX service
  hits, and hits the JAX service's entries.

Instances are made with numpy from a seed.
"""

import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.serve import ladder as jladder
from tsp_mpi_reduction_tpu.serve import scheduler as jsched
from tsp_mpi_reduction_tpu.serve import service as jservice
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH
from tsp_mpi_reduction_tpu_torch.serve import ladder as tladder
from tsp_mpi_reduction_tpu_torch.serve import scheduler as tsched
from tsp_mpi_reduction_tpu_torch.serve import service as tservice
from tsp_mpi_reduction_tpu_torch.utils.cli import main as torch_main

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    # the port's health counters are process-global, as the JAX package's
    # that the conftest resets before every test: an anomaly event a B&B
    # solve of an earlier test in this worker fired must not appear as a
    # key of this session's health block
    THEALTH.reset_for_testing()
    yield
    torch.set_num_threads(before)


def _valid_closed_tour(tour, n):
    tour = list(tour)
    return tour[0] == tour[-1] and sorted(tour[:-1]) == list(range(n))


def _fake_bnb(proven):
    def solver(d, time_limit_s):
        n = d.shape[0]
        tour = np.asarray(list(range(n)) + [0], np.int32)
        cost = float(d[tour[:-1], tour[1:]].sum())
        return (cost, tour, cost, True) if proven else (cost + 10.0, tour, cost, False)
    return solver


def _exploding_bnb(d, time_limit_s):
    raise MemoryError("synthetic device OOM")


#: (name, n, deadline_s, LadderConfig kwargs, estimator seeds, expected tier)
LADDER_CASES = [
    ("impossible_deadline", 9, 0.0, {}, (), "greedy"),
    ("generous_pipeline", 8, 120.0, {"bnb_max_n": 0}, (), "pipeline"),
    ("bnb_certified", 8, 30.0, {"bnb_solver": _fake_bnb(True), "bnb_min_budget_s": 0.1},
     (("bnb", 8, 0.01),), "bnb"),
    ("bnb_unproven_gap", 8, 30.0, {"bnb_solver": _fake_bnb(False), "bnb_min_budget_s": 0.1},
     (("bnb", 8, 0.01),), "bnb"),
    ("real_bnb_tiny", 7, 300.0, {"bnb_min_budget_s": 0.1, "bnb_capacity": 1 << 10, "bnb_k": 8},
     (("bnb", 8, 0.01),), "bnb"),
    ("blocked_pipeline", 24, 300.0, {"bnb_max_n": 0, "polish_rounds": 2}, (), "pipeline"),
    ("prime_n_greedy_seed_polish", 17, 300.0, {"bnb_max_n": 0, "polish_rounds": 2}, (), "pipeline"),
    ("rung_exception_degrades", 8, 30.0, {"bnb_solver": _exploding_bnb, "bnb_min_budget_s": 0.1},
     (("bnb", 8, 0.01),), "greedy"),
]


def _ladder_solve(ladder_mod, sched_mod, xy, deadline_s, cfg_kw, seeds, **sched_kw):
    sched = sched_mod.MicroBatchScheduler(max_batch=8, max_wait_ms=1.0, buckets=(1, 2, 4, 8), **sched_kw)
    ladder = ladder_mod.DeadlineLadder(sched, ladder_mod.LadderConfig(**cfg_kw))
    for tier, n, s in seeds:
        ladder.estimator.observe(tier, n, s)
    with sched:
        res = ladder.solve(xy, deadline_s=deadline_s)
    ladder.cleanup()
    return res, ladder


@pytest.mark.parametrize("name,n,deadline_s,cfg_kw,seeds,tier", LADDER_CASES,
                         ids=[c[0] for c in LADDER_CASES])
def test_ladder_tiers_match_jax(name, n, deadline_s, cfg_kw, seeds, tier):
    xy = np.random.default_rng(len(name) + n).uniform(0, 100 if n <= 7 else 1000, (n, 2))
    got, tl = _ladder_solve(tladder, tsched, xy, deadline_s, cfg_kw, seeds, device="cpu")
    want, jl = _ladder_solve(jladder, jsched, xy, deadline_s, cfg_kw, seeds)
    assert got.tier == want.tier == tier
    assert _valid_closed_tour(got.tour, n)
    assert got.certified_gap == pytest.approx(want.certified_gap)
    assert tl.counts_snapshot() == jl.counts_snapshot()
    if name != "real_bnb_tiny":  # a time-sliced proof: same optimum, any optimal tour
        np.testing.assert_array_equal(got.tour, want.tour)
        assert got.cost == pytest.approx(want.cost, rel=1e-6)
    else:
        assert got.certified_gap == 0.0 and got.cost == pytest.approx(want.cost, rel=1e-6)


def test_trivial_instances_divisors_and_estimator_match():
    for xy in (np.asarray([[1.0, 2.0]]), np.asarray([[0.0, 0.0], [3.0, 4.0]])):
        got, _ = _ladder_solve(tladder, tsched, xy, 10.0, {}, (), device="cpu")
        want, _ = _ladder_solve(jladder, jsched, xy, 10.0, {}, ())
        assert list(got.tour) == list(want.tour) and got.cost == want.cost and got.tier == "greedy"
    for n in range(1, 70):
        assert tladder._largest_block_divisor(n) == jladder._largest_block_divisor(n)
    t, j = tladder.LatencyEstimator(alpha=0.5), jladder.LatencyEstimator(alpha=0.5)
    for tier, n, s in (("bnb", 8, 1.0), ("bnb", 8, 3.0), ("bnb", 7, 2.0), ("pipeline", 33, 0.4)):
        t.observe(tier, n, s)
        j.observe(tier, n, s)
    for tier, n in (("bnb", 8), ("bnb", 9), ("pipeline", 64), ("greedy", 3)):
        assert t.estimate(tier, n, 9.0) == j.estimate(tier, n, 9.0)


def test_ladder_timeout_teaches_estimator():
    class NeverTicket:
        queue_age_s = None

        def wait(self, timeout=None):
            import time as _t

            _t.sleep(min(timeout or 0.01, 0.05))
            return None

    class StuckScheduler:
        def submit(self, dists):
            return NeverTicket()

    ladder = tladder.DeadlineLadder(StuckScheduler(), tladder.LadderConfig(bnb_max_n=0))
    xy = np.random.default_rng(22).uniform(0, 1000, (8, 2))
    assert ladder.solve(xy, deadline_s=0.6).tier == "greedy"
    assert ladder.estimator.estimate("pipeline", 8, 0.0) > 0.0


# --------------------------------------------------------------------------- the service


def _session_lines():
    """Requests on deterministic tiers, a duplicate of one of them
    (translated and permuted), a malformed line and a non-object."""
    rng = np.random.default_rng(12)
    reqs = []
    for i, n in enumerate((5, 6, 7, 8, 8)):
        reqs.append({"id": f"hk{i}", "xy": rng.uniform(0, 1000, (n, 2)).tolist(), "deadline_ms": 60_000})
    reqs.append({"id": "blocked", "xy": rng.uniform(0, 1000, (24, 2)).tolist(), "deadline_ms": 60_000})
    reqs.append({"id": "tight", "xy": rng.uniform(0, 1000, (30, 2)).tolist(), "deadline_ms": 0.001})
    dup = np.asarray(reqs[3]["xy"])[rng.permutation(8)] + np.array([37.5, -12.25])
    lines = [json.dumps(r) for r in reqs]
    lines.append("not json{")
    lines.append(json.dumps([1, 2, 3]))
    lines.append(json.dumps({"id": "dup", "xy": dup.tolist(), "deadline_ms": 60_000}))
    lines.append(json.dumps({"id": "no-xy"}))
    return lines


def _cfg(mod, **kw):
    kw.setdefault("ladder", mod.LadderConfig(bnb_max_n=0))
    return mod.ServiceConfig(threads=1, max_wait_ms=1.0, **kw)


def _session(mod, **kw):
    out = io.StringIO()
    svc = mod.run_jsonl(_session_lines(), out, _cfg(mod, **kw))
    return [json.loads(x) for x in out.getvalue().splitlines()], json.loads(svc.stats_json())


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_jsonl_session_matches_jax_service(tmp_path):
    got, gstats = _session(tservice, device="cpu")
    want, wstats = _session(jservice)
    assert [r.get("id") for r in got] == [r.get("id") for r in want]
    assert [r.get("id") for r in got] == ["hk0", "hk1", "hk2", "hk3", "hk4", "blocked", "tight",
                                          None, None, "dup", "no-xy"]
    for g, w in zip(got, want):
        assert ("error" in g) == ("error" in w)
        if "error" in g:
            continue
        for f in ("n", "tier", "certified_gap", "cache", "tour", "deadline_ms", "deadline_missed"):
            assert g[f] == w[f], (g["id"], f)
        assert g["cost"] == w["cost"], g["id"]
        assert _valid_closed_tour(g["tour"], g["n"])
    tiers = {r["id"]: (r["tier"], r["cache"]) for r in got if "tier" in r}
    assert tiers["blocked"] == ("pipeline", "miss") and tiers["tight"] == ("greedy", "miss")
    assert tiers["dup"] == ("pipeline", "hit")
    # the stats line: the JAX keys two levels down; compile_cache and obs
    # are the port's subsets (no XLA keys), and the port times the blocked
    # rung's fold and polish as phases of their own
    for sub in ("compile_cache", "obs", "health"):
        assert set(gstats[sub]) <= set(wstats[sub]), sub
    assert set(gstats["phases_s"]) == set(wstats["phases_s"]) | {"serve.fold", "serve.polish"}
    kg, kw = _keys(gstats), _keys(wstats)
    for k in ("compile_cache", "obs", "phases_s"):
        kg.pop(k), kw.pop(k)
    assert kg == kw
    for k in ("responses", "errors", "deadline_misses", "refreshes", "rung_failures", "tiers"):
        assert gstats[k] == wstats[k], k
    assert gstats["cache"]["hits"] == wstats["cache"]["hits"] == 1
    for k in ("batches", "blocks_solved", "padded_blocks"):
        assert gstats["scheduler"][k] == wstats["scheduler"][k], k
    # the JAX package's report tool renders the port's stats line
    sys.path.insert(0, str(ROOT / "tools"))
    import obs_report

    line = tmp_path / "stats.json"
    line.write_text(json.dumps(gstats) + "\n")
    assert obs_report.main(["--serve", str(line)]) == 0


@pytest.mark.parametrize("first,second", [("torch", "jax"), ("jax", "torch")])
def test_shared_cache_dir_crosses_packages(first, second, tmp_path):
    """A service with ``shared_cache_dir`` answers a request; a fresh
    service of the other package over the same directory hits it."""
    mods = {"torch": (tservice, {"device": "cpu"}), "jax": (jservice, {})}
    xy = np.random.default_rng(31).uniform(0, 1000, (7, 2))
    resp = []
    for who in (first, second):
        mod, kw = mods[who]
        with mod.SolveService(_cfg(mod, shared_cache_dir=str(tmp_path / "shared"), **kw)) as svc:
            resp.append(svc.handle({"id": who, "xy": (xy + len(resp)).tolist(), "deadline_ms": 60_000}))
    assert resp[0]["cache"] == "miss" and resp[1]["cache"] == "hit"
    assert resp[0]["tour"] == resp[1]["tour"] and resp[1]["tier"] == "pipeline"


def test_service_upgrades_greedy_and_keeps_exact_entry():
    xy = np.random.default_rng(20).uniform(0, 1000, (8, 2))
    with tservice.SolveService(_cfg(tservice, device="cpu")) as svc:
        r1 = svc.handle({"id": "a", "xy": xy.tolist(), "deadline_ms": 0.001})
        r2 = svc.handle({"id": "b", "xy": xy.tolist(), "deadline_ms": 60_000})
        r3 = svc.handle({"id": "c", "xy": xy.tolist(), "deadline_ms": 0.001})
        assert svc.refreshes == 1 and svc.errors == 0
    assert (r1["tier"], r1["cache"]) == ("greedy", "miss")
    assert (r2["tier"], r2["cache"], r2["certified_gap"]) == ("pipeline", "refresh", 0.0)
    assert (r3["tier"], r3["cache"]) == ("pipeline", "hit") and r2["cost"] <= r1["cost"] + 1e-9


def test_run_jsonl_streams_responses_before_input_ends():
    import threading

    rng = np.random.default_rng(23)
    seen = threading.Event()

    class Out:
        lines = []

        def write(self, s):
            self.lines.append(s)
            seen.set()

        def flush(self):
            pass

    def lazy():
        yield json.dumps({"id": "first", "xy": rng.uniform(0, 1000, (7, 2)).tolist()})
        assert seen.wait(timeout=60.0), "no response before the input ended"
        yield json.dumps({"id": "second", "xy": rng.uniform(0, 1000, (7, 2)).tolist()})

    out = Out()
    tservice.run_jsonl(lazy(), out, _cfg(tservice, device="cpu"))
    assert [json.loads(x)["id"] for x in out.lines] == ["first", "second"]


README_REQUESTS = [
    {"id": "a", "xy": [[0, 0], [3, 0], [3, 4], [0, 4], [1, 2], [2, 1]], "deadline_ms": 5000},
    {"id": "b", "xy": [[10, 10], [13, 10], [13, 14], [10, 14], [12, 11]], "deadline_ms": 0.1},
]


def test_serve_cli_readme_requests_match_jax(tmp_path, capsys):
    inp, outp = tmp_path / "req.jsonl", tmp_path / "resp.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in README_REQUESTS))
    rc = torch_main(["serve", "--in", str(inp), "--out", str(outp), "--backend=cpu", "--stats"])
    assert rc == 0
    got = [json.loads(x) for x in outp.read_text().splitlines()]
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    out = io.StringIO()
    jservice.run_jsonl([json.dumps(r) for r in README_REQUESTS], out, jservice.ServiceConfig())
    want = [json.loads(x) for x in out.getvalue().splitlines()]
    for g, w in zip(got, want):
        for f in ("id", "n", "cost", "tour", "tier", "certified_gap", "cache", "deadline_missed"):
            assert g[f] == w[f], f
    assert [g["tier"] for g in got] == ["pipeline", "greedy"] and got[0]["tour"] == [0, 4, 3, 2, 5, 1, 0]
    assert stats["responses"] == 2 and stats["tiers"]["pipeline"] == 1


def test_serve_cli_default_backend_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs there")
    inp = tmp_path / "req.jsonl"
    inp.write_text(json.dumps(README_REQUESTS[0]) + "\n")
    for backend in ([], ["--backend=auto"], ["--backend=cuda"]):
        r = subprocess.run([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "serve", "--in", str(inp),
                            *backend], capture_output=True, text=True, cwd=str(ROOT), timeout=120)
        assert r.returncode == 2 and r.stdout == "" and "needs a CUDA device" in r.stderr
    assert torch_main(["fleet"]) == 2
    assert torch_main(["serve", "--backend=cpu", "--warm", "8,x"]) == 2

"""Port parity of the B&B line's telemetry, on the CPU, against the JAX package.

- the pure-Python layers (``obs/timeseries``, ``obs/anomaly``,
  ``obs/rankview``) fed the same synthetic streams (made from a numpy
  seed) give the same rows, events, summaries and balance blocks;
- ``make_rank_stats`` on the same packed rows gives the JAX collective's
  ``[R, 3]`` row;
- ``solve`` on burma14 and ulysses16 in the host loop yields the JAX
  package's series row for row (the timing columns ``wall_s`` and
  ``nodes_per_s`` only by count);
- ``solve_sharded`` on the 12-city spill-forcing case in the host loop
  (re-sort every 8 steps) yields the JAX package's ``rank_series`` (every
  column), series and the timing-free ``rank_balance``, batched and over
  2-4 gloo rank processes, and the per-rank spill sums equal the
  aggregate counters;
- the root ``tools/obs_report.py --ranks`` renders the port's sharded
  line.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_probes as probes
from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.obs import anomaly as janomaly
from tsp_mpi_reduction_tpu.obs import rankview as jrankview
from tsp_mpi_reduction_tpu.obs import timeseries as jtimeseries
from tsp_mpi_reduction_tpu.parallel import reduce as jreduce
from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.resilience.health import HEALTH as JHEALTH
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.obs import anomaly as tanomaly
from tsp_mpi_reduction_tpu_torch.obs import metrics as tmetrics
from tsp_mpi_reduction_tpu_torch.obs import rankview as trankview
from tsp_mpi_reduction_tpu_torch.obs import timeseries as ttimeseries
from tsp_mpi_reduction_tpu_torch.parallel import reduce as treduce
from tsp_mpi_reduction_tpu_torch.parallel.mesh import spawn_ranks
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH
from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the series columns that carry no time
SERIES_EXACT = ("step", "nodes", "frontier", "spill_to_host", "spill_to_device", "incumbent",
                "lb_floor", "reservoir")

#: the spill-forcing sharded case of tests/test_torch_sharded.py, in the
#: host loop with the mesh run's re-sort every 8 steps
SPILL_HOST_KW = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=False, reorder_every=8,
                     bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000,
                     balance="pair")


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path: once ``compile_cache.enable()``
    has run in this process, its store can hand back executables compiled
    for another mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    THEALTH.reset_for_testing()
    yield
    torch.set_num_threads(before)


def random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _timing_free(series: dict) -> dict:
    """A series block with its timing columns reduced to their row count."""
    cols = series["columns"]
    keep = [cols.index(c) for c in SERIES_EXACT]
    out = {k: v for k, v in series.items() if k != "rows"}
    out["rows"] = [[r[i] for i in keep] for r in series["rows"]]
    out["timing_rows"] = len(series["rows"])
    return out


def _stagnation(anomalies: dict) -> list:
    """The anomaly events that read no clock: ``nodes_rate_collapse``
    follows the measured nodes/s, ``lb_stagnation`` only the bounds and
    the open work."""
    return [e for e in anomalies["events"] if e["kind"] != "nodes_rate_collapse"]


# --------------------------------------------------------------------------- the pure layers


def _feed(rng, steps):
    """A synthetic per-dispatch stream: a rate that collapses midway, a
    flat certified floor, an incumbent that improves twice, open work that
    holds then drains, and some inf / nan entries."""
    rows = []
    for s in range(steps):
        rate = float(rng.uniform(900, 1100)) if s < steps // 2 else float(rng.uniform(50, 120))
        inc = 500.0 if s < steps // 3 else (480.0 if s < 2 * steps // 3 else 470.0)
        frontier = int(rng.integers(100, 200)) if s < 3 * steps // 4 else max(0, 200 - 10 * s)
        rows.append((s * 32, s * 0.01, int(rng.integers(0, 5000)), rate, frontier,
                     int(rng.integers(0, 3)) * 64, int(rng.integers(0, 2)) * 64,
                     float("inf") if s == 0 else inc, float("-inf") if s == 1 else 400.0,
                     int(rng.integers(0, 50))))
    return rows


@pytest.mark.parametrize("capacity,steps", [(512, 90), (16, 90), (7, 300)], ids=["ring-big", "wrap", "wrap-long"])
def test_step_sampler_and_stall_sentinel_equal_jax(capacity, steps):
    rows = _feed(np.random.default_rng(steps + capacity), steps)
    got, want = [], []
    for pkg_series, pkg_anomaly, out in ((ttimeseries, tanomaly, got), (jtimeseries, janomaly, want)):
        sampler = pkg_series.StepSampler(capacity)
        sampler.row_bytes, sampler.frontier_layout = 48, 2
        sentinel = pkg_anomaly.StallSentinel(window=4, lb_window=16)
        sampler.sentinel = sentinel
        for r in rows:
            sampler.sample(*r)
        out.append((sampler.series(), sentinel.summary(), len(sampler)))
    assert got == want
    series, summary, _ = got[0]
    assert series["columns"] == list(jtimeseries.COLUMNS) == list(ttimeseries.COLUMNS)
    assert series["rows"][0][7] is None or capacity < steps  # inf -> null
    assert {e["kind"] for e in summary["events"]} <= {"nodes_rate_collapse", "lb_stagnation"}


def test_stall_sentinel_feed_path_and_surfaces_equal_jax():
    """The direct feed path fires the same events, and each event reaches
    the health block, the registry counter and the caller's list."""
    rng = np.random.default_rng(3)
    feed = [(s, float(rng.uniform(900, 1100)) if s < 40 else 10.0, 400.0, 500.0, 100) for s in range(120)]
    t, j = tanomaly.StallSentinel(window=4), janomaly.StallSentinel(window=4)
    JHEALTH.reset_for_testing()
    got = [t.observe(step=a, nodes_per_s=b, lb_floor=c, incumbent=d, open_nodes=e) for a, b, c, d, e in feed]
    want = [j.observe(step=a, nodes_per_s=b, lb_floor=c, incumbent=d, open_nodes=e) for a, b, c, d, e in feed]
    assert got == want and t.summary() == j.summary() and t.summary()["fired"] >= 1
    kinds = {e["kind"] for e in t.events}
    for kind in kinds:
        assert THEALTH.get(f"anomaly_{kind}") == JHEALTH.get(f"anomaly_{kind}") >= 1
        assert tmetrics.REGISTRY.value("bnb_anomalies_total", kind=kind) >= 1


def test_sentinels_maybe_respect_tsp_obs_off(monkeypatch):
    monkeypatch.setenv("TSP_OBS", "off")
    assert ttimeseries.StepSampler.maybe() is None
    assert tanomaly.StallSentinel.maybe() is None
    assert tanomaly.RankStarvationSentinel.maybe(4) is None
    assert trankview.RankSampler.maybe(4) is None
    assert tanomaly.merge_summaries(None, None) is None
    monkeypatch.setenv("TSP_OBS", "on")
    assert isinstance(ttimeseries.StepSampler.maybe(), ttimeseries.StepSampler)
    monkeypatch.setenv("TSP_RANK_WINDOW", "3")
    s = trankview.RankSampler.maybe(4)
    assert s.window == 3 and isinstance(s.watch, tanomaly.RankStarvationSentinel)


def _rank_feed(rng, ranks, windows):
    """Cumulative per-rank counters and snapshots, one starving rank."""
    nodes = np.zeros(ranks, np.int64)
    ev, th, td = (np.zeros(ranks, np.int64) for _ in range(3))
    out = []
    for w in range(windows):
        add = rng.integers(100, 1000, ranks)
        add[ranks - 1] = 0 if w % 5 < 3 else 900  # starves three windows in five
        nodes = nodes + add
        ev = ev + rng.integers(0, 2, ranks)
        th = th + rng.integers(0, 3, ranks) * 128
        td = td + rng.integers(0, 2, ranks) * 128
        occ = rng.integers(0, 300, ranks)
        best = rng.uniform(100, 200, ranks)
        best[0] = np.inf if w % 4 == 0 else best[0]
        out.append((w * 8, occ, np.minimum(occ, rng.integers(0, 300, ranks)), nodes.copy(),
                    rng.integers(0, 40, ranks), ev.copy(), th.copy(), td.copy(), best))
    return out


@pytest.mark.parametrize("ranks,capacity", [(4, 256), (3, 5)], ids=["ring-big", "wrap"])
def test_rank_sampler_balance_and_merge_equal_jax(ranks, capacity):
    feed = _rank_feed(np.random.default_rng(ranks), ranks, 23)
    results = []
    for rv, an in ((trankview, tanomaly), (jrankview, janomaly)):
        s = rv.RankSampler(ranks, capacity=capacity, window=2)
        s.watch = an.RankStarvationSentinel(ranks)
        stall = an.StallSentinel(window=2)
        for i, row in enumerate(feed):
            s.due()
            s.sample(*row)
            stall.observe(step=row[0], nodes_per_s=1000.0 if i < 10 else 1.0, lb_floor=1.0)
        series = s.series()
        last = feed[-1]
        bal = rv.rank_balance(series, last[3], spill_events=last[5], spill_bytes_to_host=last[6],
                              spill_bytes_to_device=last[7], reservoir=last[4], events=s.watch.events)
        results.append((series, bal, an.merge_summaries(stall, s.watch), s.watch.summary(),
                        s.watch.episodes_per_rank, s.pending(), len(s)))
    assert results[0] == results[1]
    bal, merged = results[0][1], results[0][2]
    assert bal["starved_ranks"] == [ranks - 1] and bal["starvation_episodes"] >= 1
    assert merged["fired"] == len(merged["events"]) >= 2
    assert [e["step"] for e in merged["events"]] == sorted(e["step"] for e in merged["events"])


def test_rank_balance_edge_cases_equal_jax():
    for args, kw in (((None, [0, 0, 0]), {}), (({"columns": list(jrankview.RANK_COLUMNS), "rows": []}, [5]), {}),
                     ((None, [7, 0, 3]), dict(events=[{"kind": "rank_starvation", "rank": 1, "step": 3}]))):
        assert trankview.rank_balance(*args, **kw) == jrankview.rank_balance(*args, **kw)


def test_fold_rank_view_exports_rank_gauges():
    bal = trankview.rank_balance(None, [10, 30], spill_events=[1, 2], spill_bytes_to_host=[64, 0],
                                 spill_bytes_to_device=[0, 128])
    tmetrics.REGISTRY.clear_metric("bnb_rank_nodes_total")
    trankview.fold_rank_view(bal)
    assert tmetrics.REGISTRY.value("bnb_rank_nodes_total", rank=1) == 30
    assert tmetrics.REGISTRY.value("bnb_rank_spill_bytes_total", rank=1, direction="to_device") == 128
    assert tmetrics.REGISTRY.value("bnb_rank_straggler_score") == bal["straggler_score"]


# --------------------------------------------------------------------------- make_rank_stats


@pytest.mark.parametrize("integral", [True, False])
def test_make_rank_stats_equals_jax(integral):
    rng = np.random.default_rng(5 + integral)
    r, f, c = 4, 64, 8
    nodes = rng.integers(-2**31, 2**31 - 1, (r, f, c), dtype=np.int64).astype(np.int32)
    bounds = rng.uniform(90, 110, (r, f)).astype(np.float32)
    if integral:
        bounds = np.rint(bounds).astype(np.float32)
    nodes[..., -2] = bounds.view(np.int32)
    counts = np.asarray([0, 1, 37, 64], np.int32)
    inc = 100.0
    want = np.asarray(jreduce.make_rank_stats(make_rank_mesh(r), integral=integral)(
        jnp.asarray(nodes), jnp.asarray(counts), jnp.asarray(inc, jnp.float32)))
    got = treduce.make_rank_stats(torch.from_numpy(nodes), torch.from_numpy(counts), inc, integral)
    assert got.dtype == torch.float32 and tuple(got.shape) == (r, len(treduce.RANK_STAT_COLUMNS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert treduce.RANK_STAT_COLUMNS == jreduce.RANK_STAT_COLUMNS
    assert got[0, 2] == float("inf") and got[0, 1] == 0


# --------------------------------------------------------------------------- whole solves


@pytest.mark.parametrize("spec,kw", [("burma14", dict(capacity=1 << 14, k=16, inner_steps=2, bound="min-out",
                                                      ils_rounds=0)),
                                     ("ulysses16", dict(capacity=1 << 14, k=32, inner_steps=8, max_iters=400,
                                                        bound="min-out", ils_rounds=0))],
                         ids=["burma14", "ulysses16"])
def test_solve_series_equals_jax_row_for_row(spec, kw):
    d = jtsplib.resolve_instance(spec).distance_matrix()
    want = jbb.solve(d, device_loop=False, **kw)
    got = tbb.solve(d, device="cpu", **kw)
    assert got.nodes_expanded == want.nodes_expanded
    assert _timing_free(got.series) == _timing_free(want.series)
    assert _stagnation(got.anomalies) == _stagnation(want.anomalies)
    rows = got.series["rows"]
    assert len(rows) >= 2 and sum(r[2] for r in rows) == got.nodes_expanded
    # a proof ends with no open work; a cut run (ulysses16 at 400 steps) not
    assert (rows[-1][4] + rows[-1][9] == 0) == got.proven_optimal
    assert got.rank_series is None and got.rank_balance is None


def test_solve_spilling_series_equals_jax():
    """A solve that exchanges with the host reservoir over thousands of
    dispatches: the ring keeps the newest 512 rows in both packages, and
    the reservoir column moves, row for row as in JAX."""
    d = random_d(13, 11)
    kw = dict(capacity=4 * 8 * 12, k=8, inner_steps=1, bound="min-out", mst_prune=False,
              node_ascent=0, max_iters=2_000_000)
    want = jbb.solve(d, device_loop=False, **kw)
    got = tbb.solve(d, device="cpu", **kw)
    assert got.spill_rounds == want.spill_rounds > 0
    assert _timing_free(got.series) == _timing_free(want.series)
    assert _stagnation(got.anomalies) == _stagnation(want.anomalies) != []
    rows = got.series["rows"]
    assert got.series["samples_dropped"] == got.series["samples_total"] - len(rows) > 0
    assert max(r[9] for r in rows) > 0


def test_solve_telemetry_off_gives_none(monkeypatch):
    monkeypatch.setenv("TSP_OBS", "off")
    res = tbb.solve(jtsplib.resolve_instance("burma14").distance_matrix(), device="cpu",
                    capacity=1 << 14, k=64)
    assert res.proven_optimal and res.series is None and res.anomalies is None


def _rank_fields(res) -> dict:
    bal = dict(res.rank_balance)
    return dict(rank_series=res.rank_series, rank_balance=bal, series=_timing_free(res.series),
                anomalies=_stagnation(res.anomalies) + [e for e in res.anomalies["events"]
                                                        if e["kind"] == "rank_starvation"],
                nodes=[int(x) for x in res.nodes_per_rank])


@pytest.fixture(scope="module")
def spill_case():
    d = random_d(12, 7)
    want = jbb.solve_sharded(d, make_rank_mesh(4), **SPILL_HOST_KW)
    return d, want


def _check_rank_sums(res):
    rows, cols = res.rank_series["rows"], res.rank_series["columns"]
    ranks = len(res.nodes_per_rank)
    bal = res.rank_balance
    for name, total in (("spill_events", res.spill_events), ("spill_to_host", res.spill_bytes_to_host),
                        ("spill_to_device", res.spill_bytes_to_device)):
        i = cols.index(name)
        assert sum(sum(r[i]) for r in rows) == total
    assert sum(bal["spill_events_per_rank"]) == res.spill_events > 0
    assert sum(bal["spill_bytes_to_host_per_rank"]) == res.spill_bytes_to_host > 0
    assert sum(bal["spill_bytes_to_device_per_rank"]) == res.spill_bytes_to_device > 0
    i = cols.index("nodes")
    assert [sum(r[i][q] for r in rows) for q in range(ranks)] == [int(x) for x in res.nodes_per_rank]
    assert sum(r[2] for r in res.series["rows"]) == res.nodes_expanded


def test_sharded_rank_series_equals_jax_batched(spill_case):
    d, want = spill_case
    got = tbb.solve_sharded(d, 4, device="cpu", step_kernel="fused", **SPILL_HOST_KW)
    assert got.spill_rounds == want.spill_rounds > 0 and not got.device_loop
    assert _rank_fields(got) == _rank_fields(want)
    _check_rank_sums(got)
    _check_rank_sums(want)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_rank_series_over_processes_equals_jax(ranks, spill_case):
    d, want4 = spill_case
    want = want4 if ranks == 4 else jbb.solve_sharded(d, make_rank_mesh(ranks), **SPILL_HOST_KW)
    got = spawn_ranks(probes.telemetry_rank, ranks, args=(d, SPILL_HOST_KW), device="cpu", timeout_s=300)
    assert got["rank_series"] == want.rank_series
    assert got["rank_balance"] == want.rank_balance
    assert got["series"] == _timing_free(want.series)
    assert _stagnation(got["anomalies"]) == _stagnation(want.anomalies)
    assert got["spill_events"] == want.spill_events


# --------------------------------------------------------------------------- the CLI line


def test_obs_report_ranks_renders_the_ports_sharded_line(tmp_path, capsys):
    assert bnb_solve.main(["random:12:7", "--ranks=4", "--backend=cpu", "--k=8", "--capacity=1024",
                           "--reorder-every=8", "--inner-steps=1", "--bound=min-out"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(line)
    assert payload["rank_series"]["ranks"] == 4 and payload["obs"]["rank_balance"]["ranks"] == 4
    path = tmp_path / "payload.json"
    path.write_text(line)
    spec = importlib.util.spec_from_file_location("obs_report", REPO / "tools" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--ranks", str(path)]) == 0
    out = capsys.readouterr().out
    assert "4 ranks" in out and "occupancy heatmap" in out
    for r in range(4):
        assert f"rank {r}" in out

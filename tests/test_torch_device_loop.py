"""Port parity of the device loop, on-device compaction and re-sort, and
the host reservoir, on the CPU, against the JAX package.

- ``_compact_frontier`` and ``_reorder_frontier`` on one frontier: the
  same rows over the whole logical prefix and the same count;
- ``_Reservoir``: prune, refill and exchange (merge and fast path) return
  the same rows and the same transfer counters as the JAX class on the
  same numpy rows;
- whole solves under ``device_loop=True`` against the JAX package's device
  loop, and host-loop solves that spill and re-sort against its host loop:
  nodes, iterations, cost, tour, certified bound and every spill counter;
- the device loop's capacity floor, its step budget, its per-step
  deadline check and its time to best.

Inputs are embedded TSPLIB instances or made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.utils import state


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


def random_d(n, seed):
    """Integer metric: rounded Euclidean distances of seeded random points."""
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _rows(n, m, seed, bound_range=(0.0, 100.0)):
    """``m`` packed rows of ``n`` cities with bounds in ``bound_range``."""
    rng = np.random.default_rng(seed)
    w = (n + 31) // 32
    mask = rng.integers(0, 2**32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    bounds = rng.uniform(*bound_range, size=m).astype(np.float32)
    bounds[rng.integers(0, m, size=m // 8)] = bounds[0]  # ties: stable order matters
    return tbb._pack_rows_np(rng.integers(0, n, size=(m, n)), mask, rng.integers(1, n, size=m),
                             rng.uniform(0, 50, size=m), bounds, rng.uniform(0, 50, size=m))


def _frontiers(rows, count, extra_rows):
    buf = np.concatenate([rows, np.zeros((extra_rows, rows.shape[1]), np.int32)])
    j_fr = jbb.Frontier(jnp.asarray(buf), jnp.asarray(count, jnp.int32), jnp.asarray(False))
    return j_fr, state.frontier_from_numpy(buf, count, False, "cpu")


# --------------------------------------------------------------------------- compaction, re-sort


@pytest.mark.parametrize("integral", [True, False])
def test_compact_frontier_matches_jax(integral):
    n, m, count = 33, 300, 260
    rows = _rows(n, m, seed=1)
    j_fr, t_fr = _frontiers(rows, count, extra_rows=40)
    inc = 60.0
    want = jbb._compact_frontier(j_fr, jnp.asarray(inc, jnp.float32), integral, rows=m)
    tbb.reset_frontier_stats()
    got = tbb._compact_frontier(t_fr, torch.tensor(inc), integral, rows=m)
    assert tbb.FRONTIER_STATS["compactions"] == 1
    assert 0 < int(got.count) == int(want.count) < count
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))


@pytest.mark.parametrize("rows_arg", [None, 300])
def test_reorder_frontier_matches_jax(rows_arg):
    n, m, count = 51, 300, 211
    rows = _rows(n, m, seed=2)
    j_fr, t_fr = _frontiers(rows, count, extra_rows=40)
    want = jbb._reorder_frontier(j_fr, rows=rows_arg)
    tbb.reset_frontier_stats()
    got = tbb._reorder_frontier(t_fr, rows=rows_arg)
    assert tbb.FRONTIER_STATS["reorders"] == 1
    assert int(got.count) == count
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    top = tbb._np_bound_col(got.nodes[:count].numpy())
    assert top[-1] == top.min()  # the best bound is popped next


# --------------------------------------------------------------------------- reservoir


def _reservoir_pair(chunks):
    j_rv, t_rv = jbb._Reservoir(), tbb._Reservoir()
    j_rv.chunks = [c.copy() for c in chunks]
    t_rv.chunks = [c.copy() for c in chunks]
    return j_rv, t_rv


def _assert_same_reservoir(t_rv, j_rv):
    assert len(t_rv.chunks) == len(j_rv.chunks)
    for a, b in zip(t_rv.chunks, j_rv.chunks):
        np.testing.assert_array_equal(a, b)
    assert t_rv.stats.__dict__ == j_rv.stats.__dict__


@pytest.mark.parametrize("integral", [True, False])
def test_reservoir_prune_and_refill_rows_match_jax(integral):
    chunks = [_rows(20, 90, seed=s) for s in (3, 4, 5)]
    j_rv, t_rv = _reservoir_pair(chunks)
    j_rv.prune(70.0, integral)
    t_rv.prune(70.0, integral)
    _assert_same_reservoir(t_rv, j_rv)
    assert t_rv.min_bound() == j_rv.min_bound() and len(t_rv) == len(j_rv)
    np.testing.assert_array_equal(t_rv._partition(None, 55.0, integral, 64),
                                  j_rv.refill_rows(55.0, integral, 64))
    _assert_same_reservoir(t_rv, j_rv)


@pytest.mark.parametrize("merge", [True, False])
def test_reservoir_exchange_rows_match_jax(merge):
    chunks = [_rows(33, 120, seed=6), _rows(33, 50, seed=7)]
    live = _rows(33, 200, seed=8)
    j_rv, t_rv = _reservoir_pair(chunks)
    want = j_rv.exchange_rows(live.copy(), 80.0, True, 150, merge=merge)
    host_core = t_rv._partition if merge else t_rv._keep_live_only
    got = host_core(live.copy(), 80.0, True, 150)
    np.testing.assert_array_equal(got, want)
    _assert_same_reservoir(t_rv, j_rv)


@pytest.mark.parametrize("low_reservoir", [True, False], ids=["full-merge", "fast-path"])
def test_reservoir_exchange_and_refill_on_frontiers_match_jax(low_reservoir):
    """``exchange`` fetches the live prefix and writes the kept rows back
    in place; the reservoir holds the alive minimum or not. Then the stack
    is emptied and ``refill`` reloads it."""
    n, m, count, capacity = 20, 240, 230, 200
    rows = _rows(n, m, seed=9, bound_range=(10.0, 100.0))
    spilled = _rows(n, 80, seed=10, bound_range=(0.0, 100.0) if low_reservoir else (50.0, 100.0))
    j_rv, t_rv = _reservoir_pair([spilled])
    j_fr, t_fr = _frontiers(rows, count, extra_rows=n * 4)
    want = j_rv.exchange(j_fr, 90.0, True, capacity)
    got = t_rv.exchange(t_fr, 90.0, True, capacity)
    take = int(want.count)
    assert int(got.count) == take > 0 and got.nodes is t_fr.nodes  # written in place
    np.testing.assert_array_equal(got.nodes[:take].numpy(), np.asarray(want.nodes)[:take])
    assert t_rv.stats.full_merges == int(low_reservoir)
    _assert_same_reservoir(t_rv, j_rv)

    empty_j = jbb.Frontier(want.nodes, jnp.asarray(0, jnp.int32), want.overflow)
    empty_t = tbb.Frontier(got.nodes, torch.tensor(0, dtype=torch.int32), got.overflow)
    want = j_rv.refill(empty_j, 85.0, True, capacity)
    got = t_rv.refill(empty_t, 85.0, True, capacity)
    take = int(want.count)
    assert int(got.count) == take > 0
    np.testing.assert_array_equal(got.nodes[:take].numpy(), np.asarray(want.nodes)[:take])
    _assert_same_reservoir(t_rv, j_rv)


def test_final_lower_bound_reads_the_reservoir():
    rv = tbb._Reservoir()
    rv.chunks = [_rows(12, 10, seed=11, bound_range=(40.0, 60.0))]
    lb = tbb._final_lower_bound(False, 100.0, 30.0, [np.array([70.0], np.float32)], rv)
    assert lb == rv.min_bound() < 70.0
    assert tbb._final_lower_bound(False, 100.0, 30.0, [], rv, overflow=True) == 30.0


# --------------------------------------------------------------------------- whole solves


SPILL_FIELDS = ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
                "spill_bytes_to_device")


def _fields(res):
    return (res.cost, res.proven_optimal, res.nodes_expanded, res.iterations, res.lower_bound,
            res.lower_bound_raw, tuple(int(x) for x in res.tour),
            *(getattr(res, f) for f in SPILL_FIELDS))


@pytest.mark.parametrize(
    "make_d,kw,want_compact,want_spill",
    [
        # tests/test_bnb.py's tiny-capacity device-loop proof
        (lambda: random_d(12, 21), dict(capacity=4 * 8 * 11 + 64, k=8, bound="min-out",
                                        mst_prune=False, node_ascent=0, max_iters=2_000_000),
         False, False),
        # capacity at the 4*k*(n-1) floor: compacts on the device and spills
        (lambda: random_d(13, 1), dict(capacity=384, k=8, bound="min-out", mst_prune=False,
                                       node_ascent=0, ils_rounds=0, max_iters=2_000_000),
         True, True),
        # re-sorts every 4 steps inside the loop, compacts and exchanges
        (lambda: jtsplib.embedded("burma14").distance_matrix(),
         dict(capacity=1024, k=16, bound="min-out", ils_rounds=0, node_ascent=0, reorder_every=4,
              max_iters=400), True, True),
    ],
    ids=["tiny-capacity", "compact-and-spill", "reorder-4"],
)
def test_device_loop_solve_matches_jax(make_d, kw, want_compact, want_spill):
    d = make_d()
    want = jbb.solve(d, device_loop=True, **kw)
    tbb.reset_frontier_stats()
    got = tbb.solve(d, device="cpu", device_loop=True, **kw)
    assert got.device_loop and got.step_kernel == "reference"
    assert _fields(got) == _fields(want)
    assert (tbb.FRONTIER_STATS["compactions"] > 0) == want_compact
    assert (got.spill_rounds > 0) == want_spill
    if kw.get("reorder_every"):
        assert tbb.FRONTIER_STATS["reorders"] == got.iterations // kw["reorder_every"]


def test_device_loop_fused_equals_reference_on_the_spill_proof():
    d = random_d(13, 1)
    kw = dict(capacity=384, k=8, bound="min-out", mst_prune=False, node_ascent=0, ils_rounds=0,
              max_iters=2_000_000, device="cpu", device_loop=True)
    ref = tbb.solve(d, step_kernel="reference", **kw)
    fused = tbb.solve(d, step_kernel="fused", **kw)
    assert fused.proven_optimal and fused.spill_rounds > 0
    assert _fields(fused) == _fields(ref)


@pytest.mark.parametrize(
    "kw",
    [
        # the config that raised before the reservoir was ported
        dict(capacity=2048, k=32, inner_steps=4, bound="min-out", ils_rounds=0, max_iters=300),
        dict(capacity=2048, k=32, inner_steps=4, bound="min-out", ils_rounds=0, max_iters=200,
             reorder_every=8),
    ],
    ids=["spill", "spill-reorder-8"],
)
def test_host_loop_spill_and_reorder_match_jax(kw):
    d = jtsplib.embedded("ulysses16").distance_matrix()
    want = jbb.solve(d, device_loop=False, **kw)
    got = tbb.solve(d, device="cpu", **kw)
    assert not got.device_loop
    assert got.spill_rounds > 0
    assert _fields(got) == _fields(want)


def test_device_loop_capacity_floor():
    d = random_d(12, 3)
    with pytest.raises(ValueError, match="device_loop needs capacity"):
        tbb.solve(d, capacity=64, k=64, device="cpu", device_loop=True)
    with pytest.raises(ValueError, match="device_loop needs capacity"):
        jbb.solve(d, capacity=64, k=64, device_loop=True)
    assert tbb._resolve_device_loop(True, True, 64, 64, 12) is False  # auto: host loop
    assert tbb._resolve_device_loop(True, False, 4 * 64 * 11, 64, 12) is True


def test_device_loop_default_is_off_on_the_cpu():
    r = tbb.solve(jtsplib.embedded("burma14").distance_matrix(), capacity=1 << 14, k=64,
                  device="cpu")
    assert not r.device_loop and r.proven_optimal


@pytest.mark.parametrize("args", [(100, 50), (10_000, 50), (10_000, 10**9), (0, 10), (7, 7)])
def test_dispatch_budget_matches_jax(args):
    """Without a time limit a run's step budget is the JAX package's: the
    remaining iterations under the int32 node-counter cap, at least 1."""
    remaining, cap = args
    assert tbb._dispatch_budget(remaining, cap) == jbb._dispatch_budget(
        remaining, cap, None, 0.0, None, 5000)


@pytest.mark.parametrize("max_iters", [2, 50, 100_000])
def test_device_loop_stops_at_the_first_step_past_the_deadline(max_iters):
    """The device loop checks the clock after every step, so a time limit
    already passed stops it after the root's step, whatever its budget."""
    d = jtsplib.embedded("ulysses16").distance_matrix()
    r = tbb.solve(d, capacity=2048, k=32, bound="min-out", ils_rounds=0, device="cpu",
                  device_loop=True, time_limit_s=0.0, max_iters=max_iters)
    assert (r.iterations, r.steps_run, r.nodes_expanded) == (1, 1, 1)
    assert not r.proven_optimal


def test_device_loop_stamps_the_time_to_best(monkeypatch):
    """From an identity-tour incumbent the search improves it; the device
    loop stamps the improving step's time, within the search's wall."""
    d = random_d(12, 3)
    identity = np.append(np.arange(12), 0).astype(np.int32)
    monkeypatch.setattr(tbb, "_initial_incumbent", lambda d, ils_rounds, device: identity)
    r = tbb.solve(d, capacity=4096, k=16, bound="min-out", device="cpu", device_loop=True)
    want = jbb.solve(d, capacity=4096, k=16, bound="min-out")
    assert r.proven_optimal and r.cost == want.cost < tbb.tour_cost(d, identity)
    assert 0.0 < r.time_to_best <= r.wall_seconds


def test_time_limited_device_loop_stops_and_keeps_open_nodes():
    """A time limit stops the device loop at the first step past it; an
    early stop reports an unproven result whose certified bound covers the
    open nodes."""
    d = jtsplib.embedded("ulysses16").distance_matrix()
    r = tbb.solve(d, capacity=2048, k=32, bound="min-out", ils_rounds=0, device="cpu",
                  device_loop=True, time_limit_s=0.5, max_iters=100_000)
    assert not r.proven_optimal and r.root_lower_bound <= r.lower_bound <= r.cost
    assert 0 < r.iterations < 100_000


def test_cli_reports_the_loop_the_push_and_the_reservoir(capsys):
    import json

    from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

    argv = ["burma14", "--backend=cpu", "--k=16", "--capacity=1024", "--bound=min-out",
            "--ils-rounds=0", "--node-ascent=0", "--reorder-every=4", "--device-loop=on",
            "--max-iters=400", "--step-kernel=fused"]
    assert bnb_solve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jbb.solve(jtsplib.embedded("burma14").distance_matrix(), capacity=1024, k=16,
                     bound="min-out", ils_rounds=0, node_ascent=0, reorder_every=4,
                     device_loop=True, max_iters=400)
    assert out["step_kernel"] == "fused" and out["device_loop"] is True
    assert out["reorder_every"] == 4 and out["push_rows_launches"] == 0  # the CPU: plain version
    assert (out["nodes_expanded"], out["iterations"]) == (want.nodes_expanded, want.iterations)
    assert out["spill_rounds"] > 0
    for key in SPILL_FIELDS:
        assert out[key] == getattr(want, key), key

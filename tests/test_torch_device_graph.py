"""The B&B search as one predicated step (``models/branch_bound._search_step``),
on the CPU, against the JAX package's device loop.

- ``_guarded_expand_steps`` (the port's runs of predicated steps, one read
  a run) from a packed frontier equals the JAX ``_guarded_expand_steps``
  (``_solve_device``, computed in a fresh interpreter by
  ``tests/jax_fresh.py``) on the same frontier, incumbent and budget: the
  live prefix's rows, count, incumbent and tour, popped, steps and
  ``best_step``; the cases compact the stack on the device, stop on a
  full stack, and re-sort every 3 steps;
- steps issued past the stop are no-ops: the whole node buffer, dead rows
  included, is the same whether the host reads after every step or once
  after all of them;
- the dispatch budget (the JAX six-argument ``_dispatch_budget``), the time
  to best interpolated from ``best_step``, ``warm_compile_device_solver``
  on the CPU, the launch counts of a captured graph at each replay, and
  ``push_block`` (``solve`` refuses it; the sharded solve's eager rank
  steps keep it).

The step's graph needs a card: ``tests/test_torch_cuda_device_graph.py``.
"""

import numpy as np
import pytest
import torch

import jax_fresh
from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.perf import compile_cache as cc


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


#: name -> (distances, kw, start): the start is the root frontier or, with
#: ``warm``, the rows that many host-loop steps under an incumbent nothing
#: beats left (copied into a buffer of ``capacity`` + k*n rows), and the
#: incumbent: the identity tour, the nearest-neighbour tour, or a cost
#: nothing beats with the identity tour
CASES = {
    # one-tree bound with the node ascent, a re-sort every 3 run-global
    # steps, improvements, the proof (the stack empties) inside the budget
    "burma14-reorder-3": (jtsplib.embedded("burma14").distance_matrix(),
                          dict(bound="one-tree", node_ascent=2, use_mst=True, k=4, capacity=832,
                               max_steps=300, reorder_every=3, step0=1),
                          dict(inc="identity", warm=0)),
    # min-out: a stack past the pressure line whose rows the incumbent
    # closes, compacted on the device, then 200 steps with improvements
    "random12-compact": (random_d(12, 5), dict(bound="min-out", node_ascent=0, use_mst=False, k=8,
                                               capacity=411, max_steps=200, reorder_every=0, step0=0),
                         dict(inc="nn", warm=10)),
    # an incumbent nothing beats: compaction frees nothing, the loop stops full
    "random12-full": (random_d(12, 5), dict(bound="min-out", node_ascent=0, use_mst=False, k=8,
                                            capacity=352, max_steps=120, reorder_every=0, step0=0),
                      dict(inc=1e9, warm=0)),
}


def _start(d, kw, start):
    """-> (frontier, incumbent cost, incumbent tour, bound data)."""
    n, k = d.shape[0], kw["k"]
    d64 = np.asarray(d, np.float64)
    bd = tbb._bound_setup(d, kw["bound"], node_ascent=kw["node_ascent"], device="cpu")
    min_out = bd.min_out.numpy().astype(np.float64)
    identity = np.append(np.arange(n), 0).astype(np.int32)
    fr = tbb.make_root_frontier(n, kw["capacity"], min_out, "cpu", k * n)
    if start["warm"]:
        big = tbb.make_root_frontier(n, 8192, min_out, "cpu", k * n)
        big = tbb._expand_loop(big, torch.tensor(1e9), torch.as_tensor(identity),
                               torch.as_tensor(np.asarray(d, np.float32)), bd, k, n, start["warm"],
                               use_mst=kw["use_mst"], node_ascent=kw["node_ascent"], mst_kernel="prim")[0]
        cnt = int(big.count)
        fr.nodes[:cnt] = big.nodes[:cnt]
        fr = tbb.Frontier(fr.nodes, big.count, fr.overflow)
    if start["inc"] == "nn":
        tour = tbb.nearest_neighbor_tour(d64)
    else:
        tour = identity
    cost = tbb.tour_cost(d64, tour) if isinstance(start["inc"], str) else start["inc"]
    return fr, np.float32(cost), tour, bd


@pytest.fixture(scope="module")
def jax_runs():
    cases = []
    for d, kw, start in CASES.values():
        fr, cost, tour, _ = _start(d, kw, start)
        cases.append((fr.nodes.numpy(), int(fr.count), cost, tour, d, kw))
    return dict(zip(CASES, jax_fresh.call("guarded_steps_many", cases)))


def _port(name, read_every):
    d, kw, start = CASES[name]
    fr, cost, tour, bd = _start(d, kw, start)
    tbb.reset_frontier_stats()
    out = tbb._guarded_expand_steps(
        fr, torch.tensor(cost), torch.as_tensor(tour), torch.as_tensor(np.asarray(d, np.float32)), bd,
        kw["k"], d.shape[0], kw["max_steps"], kw["reorder_every"], kw["step0"], graph=True,
        read_every=read_every, use_mst=kw["use_mst"], node_ascent=kw["node_ascent"], mst_kernel="prim",
        step_kernel="reference")
    return out, dict(tbb.FRONTIER_STATS)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("read_every", [1, 5, 32])
def test_predicated_steps_equal_the_jax_device_loop(jax_runs, name, read_every):
    want = jax_runs[name]
    (fr, ic, itour, popped, steps, best, expanded), stats = _port(name, read_every)
    cnt = int(fr.count)
    assert (cnt, bool(fr.overflow)) == (want["count"], want["overflow"])
    np.testing.assert_array_equal(fr.nodes[:cnt].numpy(), want["nodes"][:cnt])
    assert float(ic) == want["inc_cost"]
    np.testing.assert_array_equal(itour.numpy(), want["inc_tour"])
    assert (popped, steps, best) == (want["popped"], want["steps"], want["best_step"])
    kw = CASES[name][1]
    if name == "random12-compact":
        assert stats["compactions"] > 0 and best >= 0 and expanded == steps == kw["max_steps"]
    if name == "random12-full":
        assert expanded == steps - 1 < kw["max_steps"] and best == -1  # the stopping iteration
    if name == "burma14-reorder-3":
        assert cnt == 0 and best >= 0 and steps < kw["max_steps"]
        assert stats["reorders"] == sum((kw["step0"] + i) % 3 == 2 for i in range(steps)) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_steps_past_the_stop_change_nothing(name):
    """Read after every step (none issued past the stop) or once after
    the whole budget (the rest issued as no-ops): the same buffer, dead
    rows included, and the same counters."""
    (a, *ra), _ = _port(name, 1)
    (b, *rb), _ = _port(name, CASES[name][1]["max_steps"])
    assert ra[3:] == rb[3:]
    assert torch.equal(a.nodes, b.nodes) and torch.equal(a.count, b.count)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])


def test_a_stopped_search_issues_no_step_when_it_reads_first():
    d, kw, start = CASES["random12-compact"]
    fr, cost, tour, bd = _start(d, kw, start)
    fr = tbb.Frontier(fr.nodes, torch.zeros((), dtype=torch.int32), fr.overflow)
    with tbb._Search(fr, torch.tensor(cost), torch.as_tensor(tour), torch.as_tensor(np.asarray(d, np.float32)),
                     bd, kw["k"], 12, guard=True, graph=False, use_mst=False) as s:
        run = s.dispatch(10, 0, 1, check_first=True)
        assert (run.replays, run.steps, run.popped) == (0, 0, 0)
        run = s.dispatch(10, 0, 10)
        assert (run.replays, run.steps, run.popped, run.height) == (10, 0, 0, 0)


# --------------------------------------------------------------------------- the dispatch


@pytest.mark.parametrize("args", [
    (100, 50, None, 0.0, None, 5000),
    (10_000, 10**9, 300, 0.0, None, 5000),
    (10_000, 10**9, None, 0.0, 2.5, 5000),  # a time limit, no rate yet: the first budget
    (10_000, 10**9, None, 120.0, 2.5, 5000),  # 120 steps/s x 2.5 s + 1
    (10_000, 10**9, 40, 120.0, 2.5, 5000),
    (10_000, 10**9, None, 120.0, -3.0, 5000),  # past the limit: one step
    (0, 10, None, 0.0, None, 5000),
    (7, 7, 0, 3.0, 0.0, 11),
])
def test_dispatch_budget_six_arguments_match_jax(args):
    assert tbb._dispatch_budget(*args) == jbb._dispatch_budget(*args)
    assert tbb._FIRST_DISPATCH_STEPS == jbb._FIRST_DISPATCH_STEPS


@pytest.mark.parametrize("best,steps", [(0, 1), (4, 10), (9, 10), (0, 0)])
def test_time_to_best_is_interpolated_from_the_dispatch(best, steps):
    """The JAX solve's formula (``branch_bound.py:2349-2359``): the
    dispatch's start plus the improving step's share of its wall."""
    offset, disp = 1.25, 0.5
    want = offset + (best + 1) / max(steps, 1) * disp
    assert tbb._time_to_best(offset, best, steps, disp) == want
    assert offset <= want <= offset + disp or steps == 0


def test_solve_reports_its_steps_replays_and_dispatches():
    """A device-loop solve on the CPU: the steps it issued (predicated,
    a no-op tail past the proof within the last run), one dispatch, no
    graph and no capture."""
    d = random_d(12, 21)
    kw = dict(capacity=4 * 8 * 11 + 64, k=8, bound="min-out", mst_prune=False, node_ascent=0,
              max_iters=2_000_000, inner_steps=8)
    got = tbb.solve(d, device="cpu", device_loop=True, **kw)
    want = jbb.solve(d, device_loop=True, **kw)
    assert (got.nodes_expanded, got.iterations, got.cost) == (want.nodes_expanded, want.iterations, want.cost)
    assert not got.step_graph and got.warm_steps == 0 and got.capture_seconds == 0.0
    assert got.dispatches >= 1 and 0 <= got.replays - got.iterations <= 7 * got.dispatches
    assert got.steps_run <= got.iterations <= got.replays


def test_warm_compile_device_solver_on_the_cpu_captures_nothing():
    before = tbb.STEP._cache_size()
    assert tbb.warm_compile_device_solver(51, 1 << 12, 16, device="cpu") is None
    assert tbb.warm_compile_device_solver(14, 1024, 16, integral=False, reorder_every=4,
                                          mst_kernel="prim", step_kernel="reference", device="cpu") is None
    assert tbb.STEP._cache_size() == before
    with pytest.raises(ValueError, match="push_block"):
        tbb.warm_compile_device_solver(14, 1024, 16, push_block=64, device="cpu")


def test_push_block_is_refused_by_solve_and_kept_by_the_sharded_eager_steps():
    d = random_d(12, 7)
    with pytest.raises(ValueError, match="push_block"):
        tbb.solve(d, capacity=1024, k=8, push_block=16, device="cpu")
    kw = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
              node_ascent=0, device_loop=False, max_iters=2_000_000, step_kernel="reference")
    plain = tbb.solve_sharded(d, 2, device="cpu", **kw)
    capped = tbb.solve_sharded(d, 2, device="cpu", push_block=40, **kw)
    assert capped.proven_optimal and capped.cost == plain.cost
    assert (capped.nodes_expanded, capped.iterations, capped.replays) == (
        plain.nodes_expanded, plain.iterations, plain.replays)


# --------------------------------------------------------------------------- launches under replay


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_counts_the_launches_its_capture_recorded():
    """While a thread captures, a wrapper's launch is recorded for the
    graph, not counted; each replay of a variant counts its launches."""
    counts = {"prim_chain": 0, "push_rows": 0}
    cc._RECORDING.launches = []
    try:
        cc.count_launch(counts, "prim_chain")
        cc.count_launch(counts, "prim_chain")
        cc.count_launch(counts, "push_rows")
        recorded = cc._RECORDING.launches
    finally:
        cc._RECORDING.launches = None
    assert counts == {"prim_chain": 0, "push_rows": 0}
    cc.count_launch(counts, "push_rows")  # outside a capture: counted at once
    assert counts["push_rows"] == 1
    plain, resort = _FakeGraph(), _FakeGraph()
    buf = torch.zeros(4, dtype=torch.int32)
    g = cc.CapturedGraph("bnb_step", "k", plain, (buf,), (buf,), 0.0, graphs=[plain, resort],
                         launches=[recorded, recorded[:1]])
    g.replay(5)
    g.replay(2, variant=1)
    assert (plain.replays, resort.replays) == (5, 2)
    assert counts == {"prim_chain": 2 * 5 + 2, "push_rows": 1 + 5}
    assert g.nbytes == buf.numel() * 4 and g.pool_bytes == 0


def test_key_captures_follow_one_key_only():
    a, b = cc.KeyCaptures("key-a"), cc.KeyCaptures("key-b")
    with cc._STORE._lock:
        cc._STORE.key_captures["key-a"] = cc._STORE.key_captures.get("key-a", 0) + 1
    try:
        assert a._cache_size() >= 1 and b._cache_size() == 0
    finally:
        with cc._STORE._lock:
            cc._STORE.key_captures["key-a"] -= 1

"""The B&B step over every local rank at once (``models/branch_bound``:
``_search_step`` on ``nodes [L, F, C]``) and the sharded round around it,
on the CPU, against the JAX package.

- L stacked rank states stepped together (one step function, the MST
  bound over L*k lanes, one push into the flattened ``[L*F, C]`` stack)
  equal the JAX ``_guarded_expand_steps`` (``_solve_device``) and
  ``_expand_loop`` run rank by rank on the same states (the oracles run in
  a fresh interpreter, ``tests/jax_fresh.py``): each rank's live rows,
  count, overflow, incumbent and tour, nodes popped, and under the guard
  its steps and ``best_step``, bit for bit. L is 1, 3 and 8; the ranks
  have their own incumbents, and among them an empty rank, a rank
  stopped by its overflow flag, ranks over the pressure line (one that
  compaction frees, one it cannot), and re-sort steps; the one-tree bound
  with the node ascent runs each lane's own ``lam``;
- a step function handed one rank's stack alone or inside a stack of
  others leaves it the same;
- the balance's fixed-shape write (``parallel/balance._receive``) equals
  the JAX steps under ``shard_map`` for every action, with live lanes
  past ``phys_rows`` that must be dropped, a device round counter, and an
  inactive step that moves nothing;
- the round's tail (``_rank_tail``) balances and shares the incumbent as
  ``parallel/balance.apply`` and ``jnp.argmin`` do, counts its round,
  makes the rank sampler's stats row, and once the device loop is done
  leaves everything as it was.

States are grown from seeded instances (rounded x10 Euclidean distances of
numpy-seeded points) by the port's own single-device steps.
"""

import numpy as np
import pytest
import torch

import jax_fresh
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.parallel import balance as tbal
from tsp_mpi_reduction_tpu_torch.parallel.reduce import make_rank_stats


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


#: one rank's start: ``warm`` host steps from the root under an incumbent
#: nothing beats, then the rank's incumbent ("nn", "identity" or a cost
#: with the identity tour); ``empty`` drops its rows, ``overflow`` sets its
#: sticky flag
def rank(warm, inc, empty=False, overflow=False):
    return dict(warm=warm, inc=inc, empty=empty, overflow=overflow)


#: name -> (instance (n, seed), loop kwargs, the ranks). The guarded cases'
#: capacity puts the pressure line (f_cap - min(f_cap // 4, k (n-1))) under
#: the larger warm stacks: with 1e9 a rank cannot compact and stops full,
#: with the nearest-neighbour incumbent compaction frees it
CASES = {
    "L1-guarded-mst": ((12, 5), dict(loop="guarded", bound="one-tree", node_ascent=2, use_mst=True, k=4,
                                     capacity=480, max_steps=40, reorder_every=3, step0=1),
                       [rank(0, "identity")]),
    "L3-host": ((12, 5), dict(loop="host", bound="min-out", node_ascent=0, use_mst=False, k=8,
                              capacity=2048, max_steps=24, reorder_every=0, step0=0),
                [rank(6, "nn"), rank(0, "identity", empty=True), rank(3, "identity")]),
    "L8-guarded-mst": ((11, 2), dict(loop="guarded", bound="one-tree", node_ascent=2, use_mst=True, k=8,
                                     capacity=400, max_steps=30, reorder_every=3, step0=2),
                       [rank(0, "nn"), rank(8, 1e9), rank(0, "nn", empty=True), rank(4, "nn", overflow=True),
                        rank(6, "identity"), rank(2, "nn"), rank(9, "nn"), rank(5, 1e9)]),
    "L8-guarded-minout": ((12, 7), dict(loop="guarded", bound="min-out", node_ascent=0, use_mst=False, k=8,
                                        capacity=352, max_steps=60, reorder_every=0, step0=0),
                          [rank(10, 1e9), rank(7, "nn"), rank(0, "identity"), rank(3, "nn", empty=True),
                           rank(12, "nn"), rank(1, "identity"), rank(6, "nn", overflow=True), rank(9, "identity")]),
}


def _bound(d, kw):
    return tbb._bound_setup(d, kw["bound"], node_ascent=kw["node_ascent"], device="cpu")


def _ranks(d, kw, specs):
    """The stacked start: ``nodes [L, F, C]``, ``count``/``overflow``/
    ``inc_cost [L]``, ``inc_tour [L, n+1]`` (numpy)."""
    n, k = d.shape[0], kw["k"]
    d64 = np.asarray(d, np.float64)
    bd = _bound(d, kw)
    min_out = bd.min_out.numpy().astype(np.float64)
    identity = np.append(np.arange(n), 0).astype(np.int32)
    d32 = torch.as_tensor(np.asarray(d, np.float32))
    rows, counts, flags, costs, tours = [], [], [], [], []
    for spec in specs:
        fr = tbb.make_root_frontier(n, kw["capacity"], min_out, "cpu", k * n)
        if spec["warm"]:
            big = tbb.make_root_frontier(n, 8192, min_out, "cpu", k * n)
            big = tbb._expand_loop(big, torch.tensor(1e9), torch.as_tensor(identity), d32, bd, k, n, spec["warm"],
                                   use_mst=kw["use_mst"], node_ascent=kw["node_ascent"], mst_kernel="prim")[0]
            cnt = min(int(big.count), kw["capacity"])
            fr.nodes[:cnt] = big.nodes[:cnt]
            fr = tbb.Frontier(fr.nodes, torch.tensor(cnt, dtype=torch.int32), fr.overflow)
        if spec["inc"] == "nn":
            tour = tbb.nearest_neighbor_tour(d64)
        else:
            tour = identity
        cost = tbb.tour_cost(d64, tour) if isinstance(spec["inc"], str) else spec["inc"]
        rows.append(fr.nodes.numpy())
        counts.append(0 if spec["empty"] else int(fr.count))
        flags.append(spec["overflow"])
        costs.append(np.float32(cost))
        tours.append(tour)
    return (np.stack(rows), np.asarray(counts, np.int32), np.asarray(flags), np.asarray(costs, np.float32),
            np.stack(tours).astype(np.int32))


@pytest.fixture(scope="module")
def states():
    out = {}
    for name, ((n, seed), kw, specs) in CASES.items():
        d = random_d(n, seed)
        out[name] = (d, _ranks(d, kw, specs))
    return out


@pytest.fixture(scope="module")
def jax_runs(states):
    cases, where = [], []
    for name, (d, (rows, counts, flags, costs, tours)) in states.items():
        kw = CASES[name][1]
        for j in range(rows.shape[0]):
            cases.append((rows[j], int(counts[j]), bool(flags[j]), float(costs[j]), tours[j], d, kw))
            where.append((name, j))
    got = jax_fresh.call("rank_loops_many", cases)
    out = {}
    for (name, j), res in zip(where, got):
        out.setdefault(name, []).append(res)
    return out


def _port(d, kw, start, read_every, step_kernel="reference"):
    rows, counts, flags, costs, tours = start
    n = d.shape[0]
    fr = tbb.Frontier(torch.from_numpy(rows.copy()), torch.from_numpy(counts.copy()), torch.from_numpy(flags.copy()))
    args = (fr, torch.from_numpy(costs.copy()), torch.from_numpy(tours.copy()),
            torch.as_tensor(np.asarray(d, np.float32)), _bound(d, kw), kw["k"], n)
    step_kw = dict(graph=False, read_every=read_every, use_mst=kw["use_mst"], node_ascent=kw["node_ascent"],
                   mst_kernel="prim", step_kernel=step_kernel)
    tbb.reset_frontier_stats()
    if kw["loop"] == "guarded":
        out = tbb._guarded_expand_steps(*args, kw["max_steps"], kw["reorder_every"], kw["step0"], **step_kw)
    else:
        out = tbb._expand_loop(*args, kw["max_steps"], kw["step0"], **step_kw)
    return out, dict(tbb.FRONTIER_STATS)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("read_every", [1, 7])
def test_stacked_step_equals_the_jax_loops_rank_by_rank(states, jax_runs, name, read_every):
    d, start = states[name]
    kw = CASES[name][1]
    kernel = "fused" if read_every == 7 else "reference"
    (fr, ic, itour, popped, *rest), stats = _port(d, kw, start, read_every, kernel)
    steps = rest[0]
    assert len(popped) == len(steps) == start[0].shape[0]
    for j, want in enumerate(jax_runs[name]):
        cnt = int(fr.count[j])
        assert (cnt, bool(fr.overflow[j])) == (want["count"], want["overflow"]), j
        np.testing.assert_array_equal(fr.nodes[j, :cnt].numpy(), want["nodes"][:cnt])
        assert float(ic[j]) == want["inc_cost"], j
        np.testing.assert_array_equal(itour[j].numpy(), want["inc_tour"])
        assert popped[j] == want["popped"], j
        if kw["loop"] == "guarded":
            assert (steps[j], rest[1][j]) == (want["steps"], want["best_step"]), j
    specs = CASES[name][2]
    for j, spec in enumerate(specs):
        if spec["empty"] or spec["overflow"]:
            assert popped[j] == 0 and steps[j] == 0  # stopped at entry: no step counted
    if name == "L8-guarded-minout":
        # the 1e9 rank over the line stops full; another compacts and goes on
        assert jax_runs[name][0]["steps"] == 1 and jax_runs[name][0]["popped"] == 0
        assert stats["compactions"] > 0
    if kw["reorder_every"]:
        assert stats["reorders"] > 0


def test_a_rank_steps_the_same_alone_and_inside_a_stack(states):
    """Rank j of the 8-rank stack, stepped alone (L = 1, the single-device
    solve's shape) or with the other 7: the same buffer, dead rows
    included, and the same counters."""
    name = "L8-guarded-mst"
    d, (rows, counts, flags, costs, tours) = states[name]
    kw = CASES[name][1]
    (fr8, ic8, it8, *r8), _ = _port(d, kw, (rows, counts, flags, costs, tours), 5)
    for j in (0, 1, 6):
        one = (rows[j:j + 1], counts[j:j + 1], flags[j:j + 1], costs[j:j + 1], tours[j:j + 1])
        (fr1, ic1, it1, *r1), _ = _port(d, kw, one, 5)
        assert torch.equal(fr1.nodes[0], fr8.nodes[j]) and int(fr1.count[0]) == int(fr8.count[j])
        assert torch.equal(ic1[0], ic8[j]) and torch.equal(it1[0], it8[j])
        assert [x[0] for x in r1] == [x[j] for x in r8]


# --------------------------------------------------------------------------- the balance write


def _balance_cases():
    """Stacked buffers whose counts reach into the push padding, so that a
    receiver's window of t rows is shifted back from the buffer's end and
    holds rows of its own stack on either side of the received ones."""
    rng = np.random.default_rng(2024)
    cases = []
    for r in (3, 4, 8):
        capacity, t_slots, cols = 40, 8, 6
        phys_rows = capacity + 3  # fewer pad rows than t_slots
        skews = [np.eye(1, r, 0)[0] * phys_rows, np.eye(1, r, r - 1)[0] * (phys_rows - 1),
                 rng.integers(0, phys_rows + 1, r), rng.integers(capacity - 4, phys_rows + 1, r), np.zeros(r)]
        for action in tbal.ACTIONS:
            for i, counts in enumerate(skews):
                nodes = rng.integers(-2**31, 2**31 - 1, (r, phys_rows, cols), dtype=np.int64).astype(np.int32)
                cases.append((action, nodes, counts.astype(np.int32), i + r, t_slots, capacity, phys_rows))
    return cases


@pytest.fixture(scope="module")
def balance_runs():
    cases = _balance_cases()
    return cases, jax_fresh.call("balance_steps_many", cases)


def test_fixed_shape_receive_equals_the_jax_shard_map_steps(balance_runs):
    cases, wants = balance_runs
    shifted = 0
    for (action, nodes, counts, round_i, t_slots, capacity, phys_rows), want in zip(cases, wants):
        r = nodes.shape[0]
        got_nodes = torch.from_numpy(nodes.copy())
        # the round counter as the tail passes it: a 0-d device tensor
        out_nodes, out_c, m = tbal.apply(action, got_nodes, torch.from_numpy(counts.copy()),
                                         torch.tensor(round_i, dtype=torch.int64), num_ranks=r, t_slots=t_slots,
                                         capacity=capacity, phys_rows=phys_rows)
        assert out_nodes is got_nodes  # in place
        np.testing.assert_array_equal(out_nodes.numpy(), want[0], err_msg=f"{action} {counts}")
        np.testing.assert_array_equal(out_c.numpy(), want[1])
        np.testing.assert_array_equal(m.numpy(), want[2])
        base = counts - want[2]
        shifted += int(((want[1] > base) & (base > phys_rows - t_slots)).sum())
    assert shifted > 0  # some receiver's window started before its base


@pytest.mark.parametrize("action", [a for a in tbal.ACTIONS if a != "skip"])
def test_an_inactive_balance_step_moves_nothing(action):
    rng = np.random.default_rng(5)
    nodes = rng.integers(-2**31, 2**31 - 1, (4, 44, 6), dtype=np.int64).astype(np.int32)
    counts = np.asarray([40, 0, 3, 17], np.int32)
    got = torch.from_numpy(nodes.copy())
    _, c, m = tbal.apply(action, got, torch.from_numpy(counts), 1, num_ranks=4, t_slots=8, capacity=40,
                         phys_rows=44, active=torch.tensor(False))
    assert np.array_equal(got.numpy(), nodes) and np.array_equal(c.numpy(), counts) and not m.any()
    _, c, m = tbal.apply(action, torch.from_numpy(nodes.copy()), torch.from_numpy(counts), 1, num_ranks=4,
                         t_slots=8, capacity=40, phys_rows=44, active=torch.tensor(True))
    assert m.sum() > 0


# --------------------------------------------------------------------------- the round's tail


def _tail_state(seed=3, r=4, n=9):
    rng = np.random.default_rng(seed)
    nodes = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (r, 60, 6), dtype=np.int64).astype(np.int32))
    count = torch.tensor([50, 0, 12, 30], dtype=torch.int32)
    overflow = torch.zeros(r, dtype=torch.bool)
    inc_cost = torch.tensor([7.0, 5.0, 9.0, 5.0], dtype=torch.float32)
    inc_tour = torch.from_numpy(rng.integers(0, n, (r, n + 1)).astype(np.int32))
    ctr = torch.from_numpy(rng.integers(0, 50, (r, len(tbb._CTR))))
    acc = torch.zeros((r, len(tbb._ACC)), dtype=torch.int64)
    flags = torch.tensor([0, 0, 5], dtype=torch.int64)
    stats = torch.zeros((r, 3), dtype=torch.float32)
    return [nodes, count, overflow, inc_cost, inc_tour, ctr, acc, flags, stats]


TAIL_KW = dict(num_ranks=4, t_slots=8, capacity=48, phys_rows=60, line=44, integral=True)


@pytest.mark.parametrize("action", tbal.ACTIONS)
@pytest.mark.parametrize("guard", [False, True])
def test_the_round_tail_balances_shares_and_counts(action, guard):
    st = _tail_state()
    nodes, count, overflow, ic, itour, ctr, acc, flags, stats = st
    ctr0 = ctr.clone()
    want_nodes, want_count, want_moved = tbal.apply(action, nodes.clone(), count.clone(), 5, num_ranks=4,
                                                    t_slots=8, capacity=48, phys_rows=60)
    best = int(np.argmin(ic.numpy()))  # the first of the ties, as jnp.argmin
    assert best == 1
    want_tour = itour[best].clone()
    tbb._rank_tail(*st, action=action, guard=guard, rank_stats=True, **TAIL_KW)
    assert torch.equal(nodes, want_nodes) and torch.equal(count, want_count)
    # the rank sampler's row, as a window's sample would compute it now
    assert torch.equal(stats, make_rank_stats(nodes, count, torch.tensor(5.0), True))
    assert torch.equal(acc[:, tbb._A_MOVED], want_moved.long())
    assert torch.equal(acc[:, tbb._A_POPPED], ctr0[:, tbb._C_POPPED])
    assert torch.equal(acc[:, tbb._A_PEAK], ctr0[:, tbb._C_PEAK])
    assert (ic == 5.0).all() and (itour == want_tour).all()
    assert flags.tolist()[1:] == [1, 6]
    # done under the guard: a rank past the line (rank 0's 50 > 44, unless
    # it gave rows away)
    done = guard and bool((count > 44).any())
    assert flags.tolist()[0] == int(done)
    # the next round's counters: an empty rank stopped at entry, every rank once done
    assert ctr[:, tbb._C_STOPPED].tolist() == [int(c == 0 or done) for c in count.tolist()]
    assert (ctr[:, tbb._C_BEST] == -1).all() and torch.equal(ctr[:, tbb._C_COUNT], count.long())


def test_a_round_entered_done_changes_nothing():
    """Past the device loop's stop the host may issue rounds until its next
    read: the steps are no-ops (every rank stopped), and the tail moves no
    row, keeps the shared incumbent and counts no round."""
    st = _tail_state()
    st[3].fill_(5.0)
    st[4].copy_(st[4][1].expand_as(st[4]))  # the share the last live round made
    st[7] = torch.tensor([1, 3, 5], dtype=torch.int64)  # done, 3 rounds, round_i 5
    before = [t.clone() for t in st]
    for action in tbal.ACTIONS:
        tbb._rank_tail(*st, action=action, guard=True, rank_stats=False, **TAIL_KW)
        for i in (0, 1, 2, 3, 4, 7):
            assert torch.equal(st[i], before[i]), (action, i)
        assert not st[6][:, tbb._A_MOVED].any()
        assert (st[5][:, tbb._C_STOPPED] == 1).all()  # every rank's next steps are no-ops


@pytest.mark.parametrize("integral", [True, False])
def test_host_stats_of_a_rewritten_stack_equal_make_rank_stats(integral):
    """After a spill round the host knows the rows it wrote: its stats row
    for those ranks equals ``make_rank_stats`` on the device's stacks (an
    empty rank, a rank the incumbent closes whole, a half-closed one)."""
    rng = np.random.default_rng(11)
    n, cap = 9, 24
    cols = tbb._path_words(n) + 1 + 4
    nodes = np.zeros((4, cap, cols), np.int32)
    counts = np.asarray([0, 5, 17, 24], np.int32)
    for r, c in enumerate(counts):
        nodes[r, :c] = rng.integers(0, 2**20, (c, cols))
        nodes[r, :c, -2] = rng.uniform(90.0, 110.0, c).round().astype(np.float32).view(np.int32)
    nodes[1, :5, -2] = np.float32(500.0).view(np.int32)  # all closed under 100
    inc = 100.0
    want = make_rank_stats(torch.from_numpy(nodes), torch.from_numpy(counts), torch.tensor(inc), integral).numpy()
    for r, c in enumerate(counts):
        got = tbb._host_rank_stats(nodes[r, :c] if c else None, inc, integral)
        np.testing.assert_array_equal(got, want[r])

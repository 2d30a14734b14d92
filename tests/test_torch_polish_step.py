"""The flattened polish step and the table-driven device ascent, on the CPU.

On CUDA the port's local search is one predicated step
(``ops/local_search._polish_step``) replayed from the graph store, and the
device ascent one captured iteration (``ops/one_tree._ascent_step``)
replayed ``steps`` times. Here the same steps run eagerly until every
lane is done, and must equal both the nested lane loops (``_run_lanes``,
the CPU's and ``TSP_COMPILE_CACHE=off``'s path) and the JAX package's
``polish`` / ``two_opt_sweep`` / ``or_opt_sweep`` bit for bit: the tours,
and the float32 sums as int32 views. Inputs are made with numpy from a
seed: the ILS's batches on eil51 and berlin52 (16 nearest-neighbour
starts, then 16 double-bridge kicks of the best), random permutations
whose lanes stop at different steps, lanes cut by a sweep's iteration
cap or by ``max_rounds``, and the ring's open segments.
"""

import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import local_search as jls
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import local_search as tls
from tsp_mpi_reduction_tpu_torch.ops import one_tree as tot
from tsp_mpi_reduction_tpu_torch.utils import tsplib as ttsplib

POLISH = dict(closed=True, two_iters=tls.TWO_OPT_ITERS, or_iters=tls.OR_OPT_ITERS)


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path, never an executable another
    test stored for another mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small batched ops: one intra-op thread is fastest and keeps parallel
    test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _d32(name):
    return np.asarray(jtsplib.embedded(name).distance_matrix(), np.float32)


def _ils_batches(name):
    """The ILS's first batch (the polish of 16 nearest-neighbour starts)
    and its first round's batch (16 double-bridge kicks of the best
    polished start), as ``strong_incumbent`` makes them."""
    d64 = np.asarray(ttsplib.embedded(name).distance_matrix(), np.float64)
    n = d64.shape[0]
    ss = sorted(set(np.linspace(0, n - 1, 16).astype(int).tolist()))
    first = np.stack([tbb.nearest_neighbor_tour(d64, s)[:-1] for s in ss]).astype(np.int64)
    polished, _ = tls.polish(torch.as_tensor(first), torch.as_tensor(d64.astype(np.float32)))
    polished = polished.numpy()
    costs = [tbb.tour_cost(d64, np.r_[t, t[:1]]) for t in polished]
    best = polished[int(np.argmin(costs))]
    rng = np.random.default_rng(0)
    kicks = np.stack([tbb._double_bridge(rng, best, n) for _ in range(len(ss))]).astype(np.int64)
    return {"first": first, "round": kicks}


def _perms(name, batch, seed):
    n = _d32(name).shape[0]
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(batch)]).astype(np.int64)


def _jax(fn, tours, d32):
    out = jax.vmap(lambda t: fn(t, jnp.asarray(d32)))(jnp.asarray(tours.astype(np.int32)))
    return np.asarray(out[0]), np.asarray(out[1])


def _flat(tours, d32, **statics):
    """The flattened step run eagerly to the end -> (tours, acc)."""
    t, acc = tls._stepped(torch.as_tensor(tours), torch.as_tensor(d32), **statics)
    return t.numpy(), acc.numpy()


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got[1], np.float32).view(np.int32),
                                  np.asarray(want[1], np.float32).view(np.int32))


@pytest.mark.parametrize("name", ["eil51", "berlin52"])
@pytest.mark.parametrize("batch", ["first", "round"])
def test_ils_batch_polish_equals_nested_and_jax(name, batch):
    d32 = _d32(name)
    tours = _ils_batches(name)[batch]
    got = _flat(tours, d32, max_rounds=8, **POLISH)
    nested = tls.polish(torch.as_tensor(tours), torch.as_tensor(d32))
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(jls.polish, tours, d32))


@pytest.mark.parametrize("name,seed", [("burma14", 1), ("ulysses16", 2), ("eil51", 3), ("berlin52", 4)])
@pytest.mark.parametrize("sweep", ["polish", "two_opt", "or_opt"])
def test_lanes_stopping_at_different_steps(name, seed, sweep):
    """Random starts: each lane stops after its own number of moves, and
    the lanes that stopped early stay frozen while the others step."""
    d32 = _d32(name)
    tours = _perms(name, 7, seed)
    statics = {"polish": dict(max_rounds=8, **POLISH),
               "two_opt": dict(closed=True, two_iters=512, or_iters=0, max_rounds=1),
               "or_opt": dict(closed=True, two_iters=0, or_iters=256, max_rounds=1)}[sweep]
    nested_fn = {"polish": tls.polish, "two_opt": tls.two_opt_sweep, "or_opt": tls.or_opt_sweep}[sweep]
    jax_fn = {"polish": jls.polish, "two_opt": jls.two_opt_sweep, "or_opt": jls.or_opt_sweep}[sweep]
    before = dict(tls.POLISH_STATS)
    got = _flat(tours, d32, **statics)
    lane_steps = tls.POLISH_STATS["lane_steps"] - before["lane_steps"]
    issued = tls.POLISH_STATS["steps"] - before["steps"]
    assert 0 < lane_steps <= issued < lane_steps + tls.POLISH_READ_STEPS
    nested = nested_fn(torch.as_tensor(tours), torch.as_tensor(d32))
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(jax_fn, tours, d32))


def _moves_per_lane(tours, d32, **statics):
    """Each lane's own step count, from the step run one lane at a time."""
    out = []
    for t in tours:
        before = tls.POLISH_STATS["lane_steps"]
        _flat(t[None], d32, **statics)
        out.append(tls.POLISH_STATS["lane_steps"] - before)
    return out


def test_lanes_really_stop_at_different_steps():
    d32 = _d32("eil51")
    tours = _perms("eil51", 7, 3)
    moves = _moves_per_lane(tours, d32, max_rounds=8, **POLISH)
    assert len(set(moves)) > 1, moves


@pytest.mark.parametrize("cap", [1, 5, 17])
def test_two_opt_lanes_cut_by_max_iters(cap):
    d32 = _d32("eil51")
    tours = _perms("eil51", 5, 7)
    statics = dict(closed=True, two_iters=cap, or_iters=0, max_rounds=1)
    assert max(_moves_per_lane(tours, d32, **statics)) == cap  # the cap cuts a lane
    got = _flat(tours, d32, **statics)
    nested = tls.two_opt_sweep(torch.as_tensor(tours), torch.as_tensor(d32), max_iters=cap)
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(partial(jls.two_opt_sweep, max_iters=cap), tours, d32))


@pytest.mark.parametrize("cap", [1, 4])
def test_or_opt_lanes_cut_by_max_iters(cap):
    d32 = _d32("berlin52")
    tours = _perms("berlin52", 5, 8)
    statics = dict(closed=True, two_iters=0, or_iters=cap, max_rounds=1)
    got = _flat(tours, d32, **statics)
    nested = tls.or_opt_sweep(torch.as_tensor(tours), torch.as_tensor(d32), max_iters=cap)
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(partial(jls.or_opt_sweep, max_iters=cap), tours, d32))


@pytest.mark.parametrize("rounds", [1, 2])
def test_lanes_cut_by_max_rounds(rounds):
    """Random eil51 starts improve in their first round, so with one round
    the cap, not a round without a move, ends every lane: its last round
    (a 2-opt and an Or-opt iteration that find nothing) is not run."""
    d32 = _d32("eil51")
    tours = _perms("eil51", 6, 11)
    before = tls.POLISH_STATS["lane_steps"]
    got = _flat(tours, d32, max_rounds=rounds, **POLISH)
    cut = tls.POLISH_STATS["lane_steps"] - before
    before = tls.POLISH_STATS["lane_steps"]
    _flat(tours, d32, max_rounds=8, **POLISH)
    full = tls.POLISH_STATS["lane_steps"] - before
    assert (cut < full) == (rounds == 1)
    nested = tls.polish(torch.as_tensor(tours), torch.as_tensor(d32), max_rounds=rounds)
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(partial(jls.polish, max_rounds=rounds), tours, d32))


def _capped_jax_polish(tours, d32, two_iters, or_iters, max_rounds):
    """The JAX polish's round loop (``local_search.py:212-219``) over the
    JAX sweeps with other caps, one lane at a time; a cap of 0 leaves its
    sweep out of each round (its sum 0.0)."""
    dj = jnp.asarray(d32)
    outs, accs = [], []
    for t in tours:
        t = jnp.asarray(t.astype(np.int32))
        acc = jnp.float32(0.0)
        for _ in range(max_rounds):
            d1 = d2 = jnp.float32(0.0)
            if two_iters:
                t, d1 = jls.two_opt_sweep(t, dj, closed=True, max_iters=two_iters)
            if or_iters:
                t, d2 = jls.or_opt_sweep(t, dj, max_iters=or_iters)
            acc = acc + d1 + d2
            if not bool((d1 + d2) < 0):
                break
        outs.append(np.asarray(t))
        accs.append(np.asarray(acc))
    return np.stack(outs), np.stack(accs)


@pytest.mark.parametrize("two_iters,or_iters,max_rounds", [(3, 2, 3), (1, 1, 8), (6, 1, 2)])
def test_both_caps_and_the_round_cap_at_once(two_iters, or_iters, max_rounds):
    d32 = _d32("berlin52")
    tours = _perms("berlin52", 4, 13)
    got = _flat(tours, d32, closed=True, two_iters=two_iters, or_iters=or_iters, max_rounds=max_rounds)
    _assert_bits(got, _capped_jax_polish(tours, d32, two_iters, or_iters, max_rounds))


@pytest.mark.parametrize("two_iters,or_iters,max_rounds", [(3, 0, 4), (0, 2, 4), (0, 1, 8)])
def test_one_sweep_a_round_over_several_rounds(two_iters, or_iters, max_rounds):
    """Rounds of one capped sweep: each round starts its sweep's sum at 0.0,
    so ``acc`` adds every round's gain once."""
    d32 = _d32("berlin52")
    tours = _perms("berlin52", 4, 17)
    statics = dict(closed=True, two_iters=two_iters, or_iters=or_iters, max_rounds=max_rounds)
    assert max(_moves_per_lane(tours, d32, **statics)) > two_iters + or_iters  # a second round ran
    got = _flat(tours, d32, **statics)
    _assert_bits(got, _capped_jax_polish(tours, d32, two_iters, or_iters, max_rounds))


@pytest.mark.parametrize("ranks", [2, 4])
def test_open_segments_pin_their_endpoints(ranks):
    """The ring's open sweep: a tour cut into one segment a rank, each
    swept with its endpoints pinned (``closed=False``, 256 iterations)."""
    d32 = _d32("eil51")
    n = 48
    d32 = np.ascontiguousarray(d32[:n, :n])
    tour = np.random.default_rng(ranks).permutation(n).astype(np.int64)
    seg = tour.reshape(ranks, n // ranks)
    statics = dict(closed=False, two_iters=256, or_iters=0, max_rounds=1)
    # the ring sweeps segments of global ids against the whole matrix: its
    # rows are gathered by city, not position
    got = _flat(seg, d32, **statics)
    np.testing.assert_array_equal(got[0][:, [0, -1]], seg[:, [0, -1]])
    nested = tls.two_opt_sweep(torch.as_tensor(seg), torch.as_tensor(d32), closed=False, max_iters=256)
    _assert_bits(got, (nested[0].numpy(), nested[1].numpy()))
    _assert_bits(got, _jax(partial(jls.two_opt_sweep, closed=False, max_iters=256), seg, d32))


def test_step_does_not_write_the_callers_tours_and_a_done_lane_is_a_no_op():
    d32 = torch.as_tensor(_d32("ulysses16"))
    tours = torch.as_tensor(_perms("ulysses16", 3, 5))
    keep = tours.clone()
    t, ctr, sums, d, thr = tls._initial_state(tours, d32, 512, 8)
    statics = dict(max_rounds=8, **POLISH)
    for _ in range(400):
        tls._polish_step(t, ctr, sums, d, thr, **statics)
    assert torch.equal(tours, keep)
    assert (ctr[:, tls._PHASE] == tls._DONE).all()
    frozen = (t.clone(), ctr.clone(), sums.clone())
    tls._polish_step(t, ctr, sums, d, thr, **statics)
    assert torch.equal(t, frozen[0]) and torch.equal(ctr, frozen[1]) and torch.equal(sums, frozen[2])


def test_a_polish_with_no_round_or_no_lane_runs_nothing():
    d32 = torch.as_tensor(_d32("burma14"))
    tours = torch.as_tensor(_perms("burma14", 3, 1))
    t, acc = tls._stepped(tours, d32, max_rounds=0, **POLISH)
    assert torch.equal(t, tours) and torch.equal(acc, torch.zeros(3))
    with pytest.raises(ValueError):
        tls._stepped(tours, d32, closed=True, two_iters=0, or_iters=0, max_rounds=1)


@pytest.mark.parametrize("name,steps", [("burma14", 20), ("ulysses16", 1), ("eil51", 100), ("berlin52", 37)])
def test_table_driven_ascent_equals_the_eager_loop(name, steps):
    d = torch.as_tensor(_d32(name))
    want = tot.held_karp_potentials(d, steps)
    dd, pi, best_w, t0, decay = tot._ascent_start(d, steps)
    got = tot._ascent_steps(dd, pi, best_w, t0, decay, steps)
    assert torch.equal(got[0], want[0])
    assert got[1].view(torch.int32).item() == want[1].view(torch.int32).item()


def test_step_table_is_the_eager_expression():
    d = torch.as_tensor(_d32("eil51"))
    _, _, _, t0, decay = tot._ascent_start(d, 100)
    table = tot._step_table(t0, decay, 100)
    for i in (0, 1, 50, 99):
        assert table[i].view(torch.int32).item() == (t0 * decay**i).view(torch.int32).item()


def test_threads_polishing_at_once_keep_every_count():
    """Serve's request threads polish at once: each result is its own and
    the shared counters lose no update (a 0.1 ms switch interval)."""
    d32 = torch.as_tensor(_d32("burma14"))
    tours = [torch.as_tensor(_perms("burma14", 2, seed)) for seed in range(8)]
    want = [tls._stepped(t, d32, max_rounds=8, **POLISH) for t in tours]
    before = dict(tls.POLISH_STATS)
    got, errors = [None] * len(tours), []

    def run(i):
        try:
            for _ in range(3):
                got[i] = tls._stepped(tours[i], d32, max_rounds=8, **POLISH)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(tours))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    counts = {k: tls.POLISH_STATS[k] - before[k] for k in before}
    assert counts["calls"] == 3 * len(tours)
    assert counts["steps"] == counts["reads"] * tls.POLISH_READ_STEPS  # a read after every run

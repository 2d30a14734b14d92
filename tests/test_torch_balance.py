"""The port's load balance (``parallel/balance.py``) and rank collectives
(``parallel/reduce.py``) against the JAX package's, on the CPU.

- ``pair_assignment`` and ``steal_assignment`` equal JAX's on 200 seeded
  count vectors, R in {1, 2, 3, 4, 8}, with ties, zeros and full ranks;
- ``ring_step``, ``pair_step`` and ``steal_step`` on a seeded stacked
  buffer equal the JAX steps run under ``shard_map`` on R virtual devices:
  the new counts, ``m_out`` and the whole buffer, bit for bit;
- ``BalanceController`` decides as JAX's, call for call, on count
  sequences through calm, skewed and starved phases, with and without an
  alive probe, and on the sequence a sharded solve records; its summary
  is the same after each;
- ``rank_alive_min``, ``rank_alive_counts`` and ``pmin_incumbent`` equal the
  JAX collectives on the same stacked frontier.

Inputs are made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tsp_mpi_reduction_tpu.parallel import balance as jbal
from tsp_mpi_reduction_tpu.parallel import reduce as jreduce
from tsp_mpi_reduction_tpu.parallel.mesh import RANK_AXIS, make_rank_mesh
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.utils.backend import shard_map
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.parallel import balance as tbal
from tsp_mpi_reduction_tpu_torch.parallel import reduce as treduce


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
    yield
    torch.set_num_threads(before)


def _count_vectors(r: int, seed: int, cap: int = 64):
    """40 [R] int32 count vectors: fixed corner cases (all zero, all full,
    one rich rank, ties) and seeded draws from narrow ranges (many ties)
    and the full range."""
    rng = np.random.default_rng(seed)
    out = [np.zeros(r), np.full(r, cap), np.eye(1, r, 0)[0] * cap, np.full(r, 3)]
    while len(out) < 40:
        hi = int(rng.choice([2, 5, cap + 1]))
        out.append(rng.integers(0, hi, r))
    return [c.astype(np.int32) for c in out]


@pytest.mark.parametrize("r", [1, 2, 3, 4, 8])
def test_assignments_equal_jax(r):
    for i, counts in enumerate(_count_vectors(r, seed=r)):
        t_slots = (1, 4, 16, 64)[i % 4]
        c_np = counts.copy()
        want = jbal.pair_assignment(jnp.asarray(c_np), jnp.asarray(i, jnp.int32), r, t_slots)
        got = tbal.pair_assignment(torch.from_numpy(c_np), i, r, t_slots)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].dtype == torch.int32
        want = jbal.steal_assignment(jnp.asarray(c_np), t_slots)
        got = tbal.steal_assignment(torch.from_numpy(c_np), t_slots)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _jax_step(action, r, t_slots, capacity, phys_rows):
    """One JAX balance step under shard_map on R virtual devices, as the
    sharded solve's per-action bodies call it (jitted once per shape)."""
    perm_fwd = [(i, (i + 1) % r) for i in range(r)]
    perm_back = [((i + 1) % r, i) for i in range(r)]

    def body(nd, c, ri):
        nd2, c2, m = jbal.apply(action, nd[0], c[0], ri, num_ranks=r, t_slots=t_slots,
                                capacity=capacity, phys_rows=phys_rows, perm_fwd=perm_fwd,
                                perm_back=perm_back)
        return nd2[None], c2[None], m[None]

    fn = jax.jit(shard_map(body, mesh=make_rank_mesh(r), in_specs=(P(RANK_AXIS), P(RANK_AXIS), P()),
                           out_specs=(P(RANK_AXIS), P(RANK_AXIS), P(RANK_AXIS))))

    def run(nodes, counts, round_i):
        return [np.asarray(x) for x in fn(jnp.asarray(nodes), jnp.asarray(counts),
                                           jnp.asarray(round_i, jnp.int32))]

    return run


@pytest.mark.parametrize("r", [3, 4, 8])
@pytest.mark.parametrize("action", tbal.ACTIONS)
def test_balance_steps_equal_jax_shard_map(action, r):
    capacity, t_slots, cols = 40, 8, 6
    phys_rows = capacity + 5
    rng = np.random.default_rng(100 + r)
    skews = [np.full(r, capacity), np.zeros(r), np.eye(1, r, r - 1)[0] * capacity,
             np.full(r, 7)]
    skews += [rng.integers(0, capacity + 1, r) for _ in range(4)]
    for counts in skews:
        counts = counts.astype(np.int32)
        nodes = rng.integers(-2**31, 2**31 - 1, (r, phys_rows, cols), dtype=np.int64).astype(np.int32)
        for round_i in (0, 1, r + 2):
            want = _jax_step(action, r, t_slots, capacity, phys_rows)(nodes, counts, round_i)
            got_nodes = torch.from_numpy(nodes.copy())
            got = tbal.apply(action, got_nodes, torch.from_numpy(counts), round_i, num_ranks=r,
                             t_slots=t_slots, capacity=capacity, phys_rows=phys_rows)
            what = f"{action} R={r} counts={counts.tolist()} round={round_i}"
            assert got[1].dtype == got[2].dtype == torch.int32, what
            np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg=what)
            np.testing.assert_array_equal(got[2].numpy(), want[2], err_msg=what)
            # the whole buffer: rows below each new count and the dead rows
            np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=what)


def _count_sequences(seed: int, r: int = 4, length: int = 120):
    """A count sequence through calm, skewed, starved and drained phases."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(length):
        phase = (i // 15) % 4
        if phase == 0:
            c = rng.integers(90, 110, r)
        elif phase == 1:
            c = rng.integers(0, 300, r)
        elif phase == 2:
            c = np.concatenate([[rng.integers(200, 400)], rng.integers(0, 3, r - 1)])
        else:
            c = rng.integers(0, 2, r) * rng.integers(0, 12, r)
        seq.append(c.astype(np.int64))
    return seq


def _drive(ctrl, seq, probe_seed=None):
    """Decide on every vector of ``seq`` (degrading every third steal, as an
    injected fault would) and record; returns the actions."""
    rng = None if probe_seed is None else np.random.default_rng(probe_seed)
    out = []
    for i, c in enumerate(seq):
        probe = None
        if rng is not None:
            alive = (rng.random(c.shape) < 0.5) * c  # some ranks all dead

            def probe(alive=alive):
                return alive
        a = ctrl.decide(c, alive_probe=probe)
        if a == "steal" and i % 3 == 0:
            a = ctrl.degrade()
        ctrl.record(i, a, np.minimum(c, ctrl.t_slots) // 2)
        out.append(a)
    return out


@pytest.mark.parametrize("probe", [None, 5])
@pytest.mark.parametrize("base,adaptive", [("pair", True), ("ring", False), ("steal", False)])
def test_controller_decides_as_jax(base, adaptive, probe):
    for seed in range(3):
        seq = _count_sequences(seed)
        kw = dict(num_ranks=4, k=8, t_slots=16, base=base, adaptive=adaptive, row_bytes=44,
                  probe_every=4, max_rows=50)
        want = _drive(jbal.BalanceController(**kw), seq, probe)
        ctrl = tbal.BalanceController(**kw)
        assert _drive(ctrl, seq, probe) == want
        j = jbal.BalanceController(**kw)
        _drive(j, seq, probe)
        assert ctrl.summary() == j.summary()


def test_controller_on_a_recorded_solve_sequence(monkeypatch):
    """The count vectors an adaptive sharded solve hands its controller
    (single-rank seeding, n = 11), replayed into both controllers."""
    seen = []
    real = tbal.BalanceController.decide

    def spy(self, counts, alive_probe=None):
        seen.append((np.asarray(counts).copy(),
                     None if alive_probe is None else np.asarray(alive_probe()).copy()))
        return real(self, counts, alive_probe)

    monkeypatch.setattr(tbal.BalanceController, "decide", spy)
    xy = np.random.default_rng(5).uniform(0, 100, (11, 2))
    d = np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)
    res = tbb.solve_sharded(d, 4, capacity_per_rank=256, k=8, inner_steps=1, bound="min-out",
                            mst_prune=False, node_ascent=0, device_loop=False,
                            seed_mode="single-rank", balance="adaptive", device="cpu")
    monkeypatch.setattr(tbal.BalanceController, "decide", real)
    assert res.proven_optimal and len(seen) > 100
    assert res.balance["actions"].get("steal", 0) > 0
    kw = dict(num_ranks=4, k=8, t_slots=64, base="pair", adaptive=True)
    tc, jc = tbal.BalanceController(**kw), jbal.BalanceController(**kw)
    for counts, alive in seen:
        probe = None if alive is None else (lambda alive=alive: alive)
        assert tc.decide(counts, probe) == jc.decide(counts, probe)
    assert tc.summary() == jc.summary()


def _mesh_collective(maker, r, nodes, counts, inc, integral):
    fn = maker(make_rank_mesh(r), integral=integral)
    return np.asarray(fn(jnp.asarray(nodes), jnp.asarray(counts), jnp.asarray(inc, jnp.float32)))


@pytest.mark.parametrize("integral", [True, False])
def test_rank_collectives_equal_jax(integral):
    r, rows, n = 4, 50, 9
    rng = np.random.default_rng(3)
    cols = tbb._path_words(n) + 1 + 4
    nodes = rng.integers(0, 2**20, (r, rows, cols)).astype(np.int32)
    bounds = rng.integers(90, 110, (r, rows)).astype(np.float32)
    bounds[0, :4] = 99.5
    nodes[..., -2] = bounds.view(np.int32)
    counts = np.asarray([rows, 0, 17, 3], np.int32)
    for inc in (100.0, 99.5, 95.0, 80.0):
        want_min = _mesh_collective(jreduce.make_rank_alive_min, r, nodes, counts, inc, integral)
        want_cnt = _mesh_collective(jreduce.make_rank_alive_counts, r, nodes, counts, inc, integral)
        t_nodes, t_counts = torch.from_numpy(nodes), torch.from_numpy(counts)
        got_min = treduce.rank_alive_min(t_nodes, t_counts, inc, integral)
        got_cnt = treduce.rank_alive_counts(t_nodes, t_counts, inc, integral)
        np.testing.assert_array_equal(got_min.numpy(), want_min)
        assert got_cnt.dtype == torch.int32
        np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)
    costs = np.asarray([7.0, 3.0, 3.0, 9.0], np.float32)
    fn = jax.jit(shard_map(lambda v: jreduce.pmin_incumbent(v), mesh=make_rank_mesh(r),
                           in_specs=P(RANK_AXIS), out_specs=P(RANK_AXIS)))
    np.testing.assert_array_equal(treduce.pmin_incumbent(torch.from_numpy(costs)).numpy(),
                                  np.asarray(fn(jnp.asarray(costs))))

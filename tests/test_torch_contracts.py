"""Port parity of the runtime contracts (``analysis/contracts.py``), on the CPU.

- each check passes on good inputs and raises ``ContractError`` on the bad
  shapes and dtypes the JAX package's checks reject, the same inputs (made
  with numpy) going through both packages;
- ``TSP_CONTRACTS=off|on|strict`` behave as their levels say: ``on``
  reads no tensor value, ``strict`` adds the value checks, ``off``
  returns every argument untouched;
- the in-place check (``check_donated``) holds around the engine's
  dispatches and fails on a reallocated buffer;
- a ``strict`` solve (single device and sharded) equals an ``off`` solve
  node for node, and the float64 pipeline still matches ``goldens/`` bit
  for bit with contracts ``on``, both merge operands checked at every
  merge.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.analysis import contracts as jcontracts
from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.ops import merge as jmerge
from tsp_mpi_reduction_tpu.parallel import reduce as jreduce
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.models import pipeline as tpipe
from tsp_mpi_reduction_tpu_torch.ops import merge as tmerge
from tsp_mpi_reduction_tpu_torch.parallel import reduce as treduce


@pytest.fixture(autouse=True)
def _level_on(monkeypatch):
    monkeypatch.delenv("TSP_CONTRACTS", raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both_raise(jfn, tfn, match):
    with pytest.raises(jcontracts.ContractError, match=match):
        jfn()
    with pytest.raises(contracts.ContractError, match=match):
        tfn()


def _root(n=6, capacity=16):
    """The engine's root frontier of an n-city instance, as numpy fields."""
    fr = jbb.make_root_frontier(n, capacity, np.ones(n, np.float64))
    return np.array(fr.nodes), np.array(fr.count), np.array(fr.overflow)


def _fronts(nodes, count, overflow):
    return (jbb.Frontier(jnp.asarray(nodes), jnp.asarray(count), jnp.asarray(overflow)),
            tbb.Frontier(torch.from_numpy(np.asarray(nodes)), torch.from_numpy(np.asarray(count)),
                         torch.from_numpy(np.asarray(overflow))))


# --------------------------------------------------------------------------- Frontier


def test_check_frontier_accepts_the_engines_frontiers():
    j, t = _fronts(*_root())
    assert jcontracts.check_frontier(j, n=6) is j
    assert contracts.check_frontier(t, n=6) is t
    # the port's own root and a sharded [R, F, C] stack
    root = tbb.make_root_frontier(6, 16, np.ones(6), device="cpu", pad_rows=0)
    assert contracts.check_frontier(root, n=6) is root
    nodes, count, overflow = _root()
    stacked = tbb.Frontier(torch.from_numpy(np.stack([nodes] * 3)), torch.zeros(3, dtype=torch.int32),
                           torch.zeros(3, dtype=torch.bool))
    assert contracts.check_frontier(stacked, n=6) is stacked


@pytest.mark.parametrize("case,match", [
    ("float_nodes", "int32"),
    ("narrow_width", "layout"),
    ("wrong_n", "expected n="),
    ("count_shape", "count"),
    ("float_count", "integer"),
    ("int_overflow", "bool"),
    ("one_dim", r"\[F, cols\]"),
])
def test_check_frontier_rejects_what_jax_rejects(case, match):
    nodes, count, overflow = _root()
    n = None
    if case == "float_nodes":
        nodes = nodes.astype(np.float32)
    elif case == "narrow_width":
        nodes = nodes[:, :5]
    elif case == "wrong_n":
        n = 17  # another path-word cell: byte packing makes n ambiguous within one
    elif case == "count_shape":
        count = np.zeros(3, np.int32)
    elif case == "float_count":
        count = np.float32(count)
    elif case == "int_overflow":
        overflow = np.int32(overflow)
    elif case == "one_dim":
        nodes = nodes[0]
    j, t = _fronts(nodes, count, overflow)
    _both_raise(lambda: jcontracts.check_frontier(j, n=n), lambda: contracts.check_frontier(t, n=n), match)


def test_check_frontier_strict_count_range(monkeypatch):
    nodes, _, overflow = _root(capacity=16)
    j, t = _fronts(nodes, np.int32(10_000), overflow)
    assert jcontracts.check_frontier(j) is j and contracts.check_frontier(t) is t  # on: metadata only
    monkeypatch.setenv("TSP_CONTRACTS", "strict")
    _both_raise(lambda: jcontracts.check_frontier(j), lambda: contracts.check_frontier(t), "outside")


def _packed(n, path, depth, count):
    rows = tbb._pack_rows_np(path, np.zeros((path.shape[0], 1), np.uint32), depth,
                             np.zeros(path.shape[0], np.float32), np.zeros(path.shape[0], np.float32),
                             np.zeros(path.shape[0], np.float32))
    return rows, np.int32(count), np.bool_(False)


def test_check_frontier_packed_accepts_valid(monkeypatch):
    monkeypatch.setenv("TSP_CONTRACTS", "strict")
    n = 10
    path = np.random.default_rng(0).integers(0, n, size=(4, n)).astype(np.int32)
    j, t = _fronts(*_packed(n, path, np.full(4, n, np.int32), 4))
    jcontracts.check_frontier_packed(j, n, where="test")
    assert contracts.check_frontier_packed(t, n, where="test") is t


@pytest.mark.parametrize("corrupt,match", [("city", "city id"), ("pad", "pad lanes")])
def test_check_frontier_packed_rejects_corrupt_bytes(monkeypatch, corrupt, match):
    monkeypatch.setenv("TSP_CONTRACTS", "strict")
    n = 10
    rows, count, overflow = _packed(n, np.zeros((2, n), np.int32), np.full(2, 3, np.int32), 2)
    if corrupt == "city":
        rows[0, 0] = n + 5  # byte 0 of word 0: the city at prefix position 0
    else:
        rows[0, tbb._path_words(n) - 1] |= np.int32(1 << 24)  # lane 11 of 12, past n
    j, t = _fronts(rows, count, overflow)
    _both_raise(lambda: jcontracts.check_frontier_packed(j, n, where="test"),
                lambda: contracts.check_frontier_packed(t, n, where="test"), match)
    monkeypatch.setenv("TSP_CONTRACTS", "on")  # the byte checks are strict only
    assert contracts.check_frontier_packed(t, n) is t


def test_check_frontier_packed_width_n_mismatch():
    n = 10
    j, t = _fronts(*_packed(n, np.zeros((2, n), np.int32), np.ones(2, np.int32), 2))
    _both_raise(lambda: jcontracts.check_frontier_packed(j, 50, where="test"),
                lambda: contracts.check_frontier_packed(t, 50, where="test"), "row width")


def test_check_exchange_count_bounds(monkeypatch):
    for count, cap in ((0, 1), (4, 8)):
        assert contracts.check_exchange_count(count, cap) == jcontracts.check_exchange_count(count, cap) == count
    for count, cap in ((5, 8), (-1, 8), (1, 1)):
        _both_raise(lambda: jcontracts.check_exchange_count(count, cap),
                    lambda: contracts.check_exchange_count(count, cap), "outside")
    monkeypatch.setenv("TSP_CONTRACTS", "off")
    assert contracts.check_exchange_count(999, 4) == 999


# --------------------------------------------------------------------------- PaddedTour


def _tours(ids, length, cost):
    return (jmerge.PaddedTour(jnp.asarray(ids), jnp.asarray(length), jnp.asarray(cost)),
            tmerge.PaddedTour(torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(length)),
                              torch.from_numpy(np.asarray(cost))))


def test_check_padded_tour_boundaries():
    t = tmerge.make_padded([0, 1, 2, 0], 4, 10.0, capacity=8)
    assert contracts.check_padded_tour(t, capacity=8) is t
    ids = np.asarray([0, 1, 2, 0, 0, 0, 0, 0], np.int32)
    cases = [((ids.astype(np.int64), np.int32(4), np.float64(10.0)), {}, "int32"),
             ((ids, np.float32(4), np.float64(10.0)), {}, "integer"),
             ((ids, np.int32(4), np.int32(10)), {}, "floating"),
             ((ids, np.int32(4), np.float64(10.0)), {"capacity": 16}, "capacity"),
             ((np.zeros((2, 8), np.int32), np.int32(4), np.float64(1.0)), {}, "length shape"),
             ((np.int32(3), np.int32(4), np.float64(1.0)), {}, "capacity axis")]
    for fields, kw, match in cases:
        j, tt = _tours(*fields)
        _both_raise(lambda: jcontracts.check_padded_tour(j, **kw),
                    lambda: contracts.check_padded_tour(tt, **kw), match)


def test_check_padded_tour_strict_length(monkeypatch):
    j, t = _tours(np.zeros(8, np.int32), np.int32(9), np.float64(1.0))
    assert contracts.check_padded_tour(t) is t  # on: the length is not read
    monkeypatch.setenv("TSP_CONTRACTS", "strict")
    _both_raise(lambda: jcontracts.check_padded_tour(j), lambda: contracts.check_padded_tour(t), "outside")


def test_merge_tours_contract_rejects_batch_drift():
    """The merge's boundary contract fires on malformed operands (batch
    drift between ids and length), as the JAX merge's does."""
    t1 = tmerge.PaddedTour(torch.zeros(8, dtype=torch.int32), torch.tensor(4, dtype=torch.int32),
                           torch.tensor(1.0))
    bad = tmerge.PaddedTour(torch.zeros((2, 8), dtype=torch.int32), torch.tensor(4, dtype=torch.int32),
                            torch.tensor(1.0))
    with pytest.raises(contracts.ContractError):
        tmerge.merge_tours(t1, bad, torch.ones((4, 4)))


def test_contract_error_is_a_value_error():
    assert issubclass(contracts.ContractError, ValueError)


# --------------------------------------------------------------------------- the reductions


@pytest.mark.parametrize("case,match", [
    ("flat_tours", r"\[P\*K, L\]"), ("costs_shape", "must both be"), ("not_divisible", "divisible"),
    ("dist_not_square", "square"), ("valid_int", "bool"), ("short_capacity", "capacity"),
])
def test_reduce_inputs_contract_equals_jax(case, match):
    tours, costs, valid = np.zeros((8, 5), np.int32), np.zeros(8), np.ones(8, bool)
    dist, cap, ranks = np.ones((16, 16)), 33, 4
    if case == "flat_tours":
        tours = tours[0]
    elif case == "costs_shape":
        costs = np.zeros(7)
    elif case == "not_divisible":
        ranks = 3
    elif case == "dist_not_square":
        dist = np.ones((16, 15))
    elif case == "valid_int":
        valid = valid.astype(np.int32)
    else:
        cap = 4
    jargs = [jnp.asarray(x) for x in (tours, costs, valid, dist)]
    targs = [torch.from_numpy(np.asarray(x)) for x in (tours, costs, valid, dist)]
    _both_raise(lambda: jreduce._check_reduce_inputs(*jargs, cap, ranks),
                lambda: treduce._check_reduce_inputs(*targs, cap, ranks), match)


# --------------------------------------------------------------------------- levels


def test_levels(monkeypatch):
    for val, want in (("off", "off"), ("ON", "on"), (" strict ", "strict"), ("bogus", "on")):
        monkeypatch.setenv("TSP_CONTRACTS", val)
        assert contracts.level() == jcontracts.level() == want
    monkeypatch.delenv("TSP_CONTRACTS")
    assert contracts.level() == "on"
    nodes, count, overflow = _root()
    _, bad = _fronts(nodes.astype(np.float32), count, overflow)
    monkeypatch.setenv("TSP_CONTRACTS", "off")
    assert contracts.check_frontier(bad) is bad
    assert contracts.check_frontier_packed(bad, 6) is bad
    assert contracts.check_padded_tour(bad) is bad


def test_on_level_reads_no_tensor_value(monkeypatch):
    """``on`` checks shape, dtype and device only: no tensor is converted to
    a host value on the way (``.item()``, ``.cpu()``, ``int()``)."""
    reads = []
    for name in ("item", "cpu", "tolist", "numpy", "__int__", "__index__", "__bool__", "__float__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    root = tbb.make_root_frontier(6, 16, np.ones(6), device="cpu", pad_rows=0)
    t = tmerge.PaddedTour(torch.zeros(8, dtype=torch.int32), torch.tensor(4, dtype=torch.int32), torch.tensor(1.0))
    reads.clear()
    contracts.check_frontier(root, n=6)
    contracts.check_frontier_packed(root, 6)
    contracts.check_padded_tour(t, capacity=8)
    contracts.check_donated(root.nodes, contracts.donation_ptr(root.nodes))
    treduce._check_reduce_inputs(torch.zeros((8, 5), dtype=torch.int32), torch.zeros(8),
                                 torch.ones(8, dtype=torch.bool), torch.ones((16, 16)), 33, 4)
    assert reads == []


def test_check_donated_is_an_in_place_check(monkeypatch):
    buf = torch.zeros((8, 9), dtype=torch.int32)
    ptr = contracts.donation_ptr(buf)
    buf[:3] = 7  # written in place: the same allocation
    assert contracts.check_donated(buf, ptr, where="test") is buf
    with pytest.raises(contracts.ContractError, match="reallocated"):
        contracts.check_donated(buf.clone(), ptr, where="test")
    monkeypatch.setenv("TSP_CONTRACTS", "off")
    assert contracts.donation_ptr(buf) is None
    assert contracts.check_donated(buf.clone(), ptr) is not buf  # off: no check


def test_solve_dispatches_keep_the_frontier_in_place(monkeypatch):
    """Every dispatch of both loops and both pushes passes the in-place
    check (it would raise otherwise), and the check really runs."""
    calls = []
    real = contracts.check_donated

    def counting(buf, ptr, *, where=""):
        calls.append(where)
        return real(buf, ptr, where=where)

    monkeypatch.setattr(contracts, "check_donated", counting)
    d = jtsplib.resolve_instance("burma14").distance_matrix()
    for loop, kernel in ((False, "reference"), (True, "fused")):
        res = tbb.solve(d, device="cpu", capacity=1 << 14, k=16, bound="min-out", ils_rounds=0,
                        device_loop=loop, step_kernel=kernel, inner_steps=4)
        assert res.proven_optimal
    assert {"solve._expand_loop", "solve._guarded_expand_steps"} <= set(calls)


def _random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def test_strict_solve_equals_off_solve_node_for_node(monkeypatch):
    d = _random_d(13, 11)
    kw = dict(capacity=4 * 8 * 12, k=8, inner_steps=4, bound="min-out", mst_prune=False, node_ascent=0,
              max_iters=400)
    out = {}
    for lv in ("off", "strict"):
        monkeypatch.setenv("TSP_CONTRACTS", lv)
        res = tbb.solve(d, device="cpu", **kw)
        out[lv] = (res.cost, res.nodes_expanded, res.lower_bound, res.iterations, res.spill_rounds,
                   res.spill_bytes_to_host, list(res.tour))
    assert out["strict"] == out["off"] and out["off"][4] > 0


def test_strict_sharded_solve_equals_off_solve(monkeypatch):
    d = _random_d(12, 7)
    kw = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=False, reorder_every=8,
              bound="min-out", mst_prune=False, node_ascent=0, max_iters=300)
    out = {}
    for lv in ("off", "strict"):
        monkeypatch.setenv("TSP_CONTRACTS", lv)
        res = tbb.solve_sharded(d, 4, device="cpu", **kw)
        out[lv] = (res.cost, res.nodes_expanded, [int(x) for x in res.nodes_per_rank], res.lower_bound,
                   res.spill_events, res.spill_bytes_to_host)
    assert out["strict"] == out["off"]


def test_float64_pipeline_matches_goldens_with_contracts_on(goldens_dir, monkeypatch):
    monkeypatch.setenv("TSP_CONTRACTS", "on")
    seen = []
    real = contracts.check_padded_tour

    def counting(t, **kw):
        seen.append(kw.get("where"))
        return real(t, **kw)

    monkeypatch.setattr(contracts, "check_padded_tour", counting)
    g = json.loads((goldens_dir / "full_10x6_500x500.json").read_text())
    cfg = g["config"]
    res = tpipe.run_pipeline(cfg["ncpb"], cfg["nblocks"], cfg["gx"], cfg["gy"], device="cpu")
    assert res.cost == g["final"]["cost"]
    np.testing.assert_array_equal(res.tour_ids, g["final"]["ids"])
    assert res.block_costs.tolist() == [s["cost"] for s in g["block_solutions"]]
    # both operands of every one of the fold's nblocks - 1 merges
    assert seen.count("merge_tours.t1") == seen.count("merge_tours.t2") == cfg["nblocks"] - 1
    assert f"{res.cost:f}" == "3720.557435"

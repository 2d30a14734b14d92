"""Port parity of the Boruvka MST bound (``_mst_conn_boruvka``) against the
JAX package, on the CPU.

- random lanes on an integral grid: value bits and degrees equal;
- random lanes with float ``dbar`` (with and without per-lane ``lam``):
  value to 1e-6 relative (each round's total is a reduction, which may add
  in another order than XLA's), degrees equal (generic position: the MST
  is unique);
- degenerate lanes (empty and one-city U) give the JAX package's value;
- whole solves with ``mst_kernel="boruvka"`` expand the JAX package's node
  counts (pinned from its host loop in a fresh process: burma14 min-out
  proves 3323 in 14,453 nodes; ulysses16 min-out, no ILS, k = 32, 400
  steps: 13,264 nodes, LB 5296.8125), and a step under ``boruvka`` calls no
  Prim chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
from tsp_mpi_reduction_tpu_torch.utils import tsplib as ttsplib


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


def _lanes(n, k, seed, grid=None):
    """A random symmetric metric and lanes; lane 0 has an empty U, lane 1
    a single city; ``grid`` rounds the weights to integers (many ties)."""
    rng = np.random.default_rng(seed)
    d = rng.random((n, n))
    d = (d + d.T) / 2
    if grid:
        d = np.round(d * grid)
    np.fill_diagonal(d, 0)
    unvis = rng.random((k, n)) < 0.6
    cur = rng.integers(0, n, size=k)
    unvis[np.arange(k), cur] = False
    unvis[:, 0] = False
    unvis[0, :] = False
    unvis[1, :] = False
    unvis[1, min(3, n - 1)] = True
    lam = rng.normal(0, 0.1, size=(k, n))
    return d, unvis, cur, lam


def _both(d, unvis, cur, lam, n):
    jv, jg = jbb._mst_conn_boruvka(jnp.asarray(d, jnp.float32), jnp.asarray(unvis),
                                   jnp.asarray(cur, jnp.int32), n,
                                   None if lam is None else jnp.asarray(lam, jnp.float32))
    tv, tg = tbb._mst_conn_boruvka(torch.tensor(d, dtype=torch.float32), torch.tensor(unvis),
                                   torch.tensor(cur), n,
                                   None if lam is None else torch.tensor(lam, dtype=torch.float32))
    return np.asarray(jv), np.asarray(jg), tv.numpy(), tg.numpy()


@pytest.mark.parametrize("n,k,grid", [(23, 32, 64), (100, 8, 1000), (6, 4, 4), (51, 16, 8)])
def test_integral_grid_bits_and_degrees_equal(n, k, grid):
    d, unvis, cur, _ = _lanes(n, k, seed=n * 1000 + k, grid=grid)
    jv, jg, tv, tg = _both(d, unvis, cur, None, n)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(tg, jg)
    assert not np.isfinite(tv[0]) and np.isfinite(tv[1])  # empty U: no connection edge


@pytest.mark.parametrize("n,k", [(17, 8), (51, 16), (33, 24)])
@pytest.mark.parametrize("use_lam", [False, True])
def test_float_value_and_degrees(n, k, use_lam):
    d, unvis, cur, lam = _lanes(n, k, seed=n * 1000 + k)
    jv, jg, tv, tg = _both(d, unvis, cur, lam if use_lam else None, n)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(fin, np.isfinite(tv))
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-6)
    np.testing.assert_array_equal(tg, jg)


def test_value_equals_prim_on_the_integral_grid():
    """Every MST has the same total: on the grid, Boruvka's bits are the
    Prim chain's."""
    n, k = 40, 64
    d, unvis, cur, _ = _lanes(n, k, seed=9, grid=50)
    args = (torch.tensor(d, dtype=torch.float32), torch.tensor(unvis), torch.tensor(cur), n)
    bv, bg = tbb._mst_conn(*args, mst_kernel="boruvka")
    pv, pg = tbb._mst_conn(*args, mst_kernel="prim")
    assert torch.equal(bv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(bg.sum(dim=1), pg.sum(dim=1))


@pytest.mark.parametrize(
    "spec,kw,nodes,cost,proven,lb",
    [
        ("burma14", dict(capacity=1 << 14, k=64, bound="min-out"), 14_453, 3323.0, True, 3323.0),
        ("ulysses16", dict(capacity=1 << 14, k=32, max_iters=400, bound="min-out", ils_rounds=0),
         13_264, 6859.0, False, 5296.8125),
    ],
    ids=["burma14-minout", "ulysses16-minout-400"],
)
def test_solve_matches_jax_node_count(spec, kw, nodes, cost, proven, lb, monkeypatch):
    """The JAX package's ``solve(d, device_loop=False, mst_kernel="boruvka",
    **kw)`` on the CPU gave these numbers (its Prim chain gives the same
    node counts here)."""
    chains = []
    monkeypatch.setattr(prim_kernels, "prim_chain_reference", lambda *a: chains.append(1))
    res = tbb.solve(ttsplib.embedded(spec).distance_matrix(), mst_kernel="boruvka", device="cpu",
                    device_loop=False, **kw)
    assert (res.nodes_expanded, res.cost, res.proven_optimal, res.lower_bound) == (nodes, cost, proven, lb)
    assert res.mst_kernel == "boruvka" and chains == []

"""Port parity of the device 1-tree ascent (``ops/one_tree.py``) against the
JAX package, on the CPU.

- ``mst_cost_degrees`` and ``one_tree_cost_degrees``: the cost equal in
  float64 and the degrees exactly, on random metrics with and without
  integer ties;
- ``held_karp_potentials`` on 12-20-city instances: the best bound to 1e-5
  relative in float32 (its step ``decay ** i`` and the ``sum(pi)`` reduction
  may round differently from XLA's);
- ``_bound_setup(ascent="device")`` and a solve with it prove the optimum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import one_tree as jot
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import one_tree as tot


def _metric(n, seed, grid=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    if grid:
        d = np.round(d / grid)  # coarse integers: many ties
    return d


@pytest.mark.parametrize("n,grid", [(9, None), (17, None), (23, 10), (31, 25)])
def test_mst_and_one_tree_equal_jax_float64(n, grid):
    d = _metric(n, seed=n, grid=grid)
    d_inf = np.where(np.eye(n, dtype=bool), np.inf, d)
    jc, jdeg = jot.mst_cost_degrees(jnp.asarray(d_inf[1:, 1:]))
    tc, tdeg = tot.mst_cost_degrees(torch.tensor(d_inf[1:, 1:]))
    assert float(tc) == float(jc)
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    jc, jdeg = jot.one_tree_cost_degrees(jnp.asarray(d_inf))
    tc, tdeg = tot.one_tree_cost_degrees(torch.tensor(d_inf))
    assert float(tc) == float(jc)
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    assert int(tdeg.sum()) == 2 * n


@pytest.mark.parametrize("spec", ["burma14", "ulysses16", "random:12:3", "random:20:5"])
def test_held_karp_potentials_best_bound_float32(spec):
    d = jtsplib.resolve_instance(spec).distance_matrix()
    _, jw = jot.held_karp_potentials(jnp.asarray(d, jnp.float32), steps=100)
    tpi, tw = tot.held_karp_potentials(torch.tensor(d, dtype=torch.float32), steps=100)
    assert tpi.dtype == torch.float32 and tpi.shape == (d.shape[0],)
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)


def test_bound_setup_device_ascent_and_solve():
    """The device path: float32 potentials, continued in float64 on the
    integral grid; burma14's root bound closes at its optimum."""
    d = jtsplib.resolve_instance("burma14").distance_matrix()
    bd = tbb._bound_setup(d, "one-tree", ascent="device", device="cpu")
    host = tbb._bound_setup(d, "one-tree", ascent="host", device="cpu")
    assert bd.integral and bd.root_lb <= 3323.0 and abs(bd.root_lb - host.root_lb) <= 0.01 * host.root_lb
    res = tbb.solve(d, capacity=1 << 14, k=64, ascent="device", device="cpu")
    assert res.proven_optimal and res.cost == 3323.0
    with pytest.raises(ValueError, match="ascent must be one of"):
        tbb._bound_setup(d, "one-tree", ascent="tpu", device="cpu")

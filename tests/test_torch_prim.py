"""Port parity of the B&B MST bound: the plain Prim chain
(``prim_kernels.prim_chain_reference``) plus the port's connection edges
against ``branch_bound._mst_conn`` of the JAX package, bit for bit (the
bound certifies pruning, so a 1-ulp drift would change the search).

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself is held against the plain chain in
``tests/test_torch_cuda_bnb.py`` and ``chip_smoke.py`` phase 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import prim_kernels


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small batched ops: one intra-op thread is fastest and keeps parallel
    test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(rng, k, n, integral=True, frac_unvis=0.6):
    """dbar [n, n] float32, unvis [k, n] (city 0 never in U), cur [k]: a
    visited city per lane, 0 on every third lane (root lanes)."""
    if integral:
        d = rng.integers(1, 500, size=(n, n)).astype(np.float32)
    else:
        d = (rng.random((n, n)) * 500).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0.0)
    pi = rng.integers(-20, 20, size=n).astype(np.float32)
    dbar = d + pi[None, :] + pi[:, None]
    unvis = rng.random((k, n)) < frac_unvis
    unvis[:, 0] = False
    cur = np.zeros(k, np.int32)
    for i in range(k):
        visited = np.flatnonzero(~unvis[i])
        cur[i] = 0 if i % 3 == 0 else visited[rng.integers(len(visited))]
    return dbar, unvis, cur


def _assert_same(dbar, unvis, cur, n, lam=None):
    ref_val, ref_deg = jbb._mst_conn(
        jnp.asarray(dbar), jnp.asarray(unvis), jnp.asarray(cur), n,
        None if lam is None else jnp.asarray(lam),
    )
    t_lam = None if lam is None else torch.as_tensor(lam)
    tot, deg = prim_kernels.prim_chain_reference(torch.as_tensor(dbar), torch.as_tensor(unvis), n, t_lam)
    conn, bump = tbb._conn_edges(torch.as_tensor(dbar), torch.as_tensor(unvis),
                                 torch.as_tensor(cur).long(), n, t_lam)
    val = (tot + conn).numpy()
    np.testing.assert_array_equal(val.view(np.int32), np.asarray(ref_val).view(np.int32))
    np.testing.assert_array_equal((deg + bump).numpy(), np.asarray(ref_deg))
    assert deg.dtype == torch.int32 and tot.dtype == torch.float32


@pytest.mark.parametrize("n", [5, 14, 51, 100, 200])
@pytest.mark.parametrize("integral", [True, False], ids=["integral", "nonintegral"])
@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
def test_plain_chain_matches_mst_conn(n, integral, with_lam):
    rng = np.random.default_rng(1000 * n + 10 * integral + with_lam)
    k = 37
    dbar, unvis, cur = _case(rng, k, n, integral)
    lam = None
    if with_lam:
        lam = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
        if not integral:
            lam = lam + rng.random((k, n)).astype(np.float32)
    _assert_same(dbar, unvis, cur, n, lam)


@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
def test_degenerate_lanes(with_lam):
    """Lanes with 0, 1 or 3 unvisited cities (the empty lane's value is
    +inf in both), at the root and mid-path."""
    rng = np.random.default_rng(3)
    n = 14
    dbar, _, _ = _case(rng, 6, n)
    unvis = np.zeros((6, n), bool)
    unvis[1, 3] = unvis[4, 3] = True
    unvis[2, 3:6] = unvis[5, 3:6] = True
    cur = np.array([0, 0, 0, 2, 7, 1], np.int32)
    lam = rng.integers(-8, 8, size=(6, n)).astype(np.float32) if with_lam else None
    _assert_same(dbar, unvis, cur, n, lam)


def test_ties_go_to_the_first_index():
    """A metric with many equal edges: the chain's argmin and the two
    cheapest 0-edges (``lax.top_k`` in JAX) must pick the same cities."""
    rng = np.random.default_rng(5)
    n, k = 20, 64
    d = rng.integers(1, 4, size=(n, n)).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0.0)
    unvis = rng.random((k, n)) < 0.7
    unvis[:, 0] = False
    cur = np.where(np.arange(k) % 2 == 0, 0, rng.integers(1, n, size=k)).astype(np.int32)
    unvis[np.arange(k), cur] = False
    _assert_same(d, unvis, cur, n)


def test_wrapper_takes_the_plain_chain_on_the_cpu():
    rng = np.random.default_rng(9)
    dbar, unvis, _ = _case(rng, 16, 30)
    lam = rng.integers(-8, 8, size=(16, 30)).astype(np.float32)
    args = (torch.as_tensor(dbar), torch.as_tensor(unvis), 30, torch.as_tensor(lam))
    before = dict(prim_kernels.LAUNCHES)
    got = prim_kernels.prim_chain(*args)
    want = prim_kernels.prim_chain_reference(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert prim_kernels.LAUNCHES == before  # the plain version is not a launch


@pytest.mark.parametrize("mst_kernel", ["auto", "prim", "prim_chain"])
def test_mst_kernel_names_resolve(mst_kernel):
    assert tbb._resolve_mst_kernel(mst_kernel, "cpu") == ("prim" if mst_kernel == "auto" else mst_kernel)
    assert tbb._resolve_mst_kernel("auto", "cuda") == "prim_chain"


@pytest.mark.parametrize("bad", ["boruvka", "prim_pallas", "nope"])
def test_unported_or_unknown_mst_kernel_raises(bad):
    with pytest.raises(ValueError):
        tbb._resolve_mst_kernel(bad, "cpu")

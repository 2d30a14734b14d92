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


def _assert_same(dbar, unvis, cur, n, lam=None, chain=prim_kernels.prim_chain_reference):
    ref_val, ref_deg = jbb._mst_conn(
        jnp.asarray(dbar), jnp.asarray(unvis), jnp.asarray(cur), n,
        None if lam is None else jnp.asarray(lam),
    )
    t_lam = None if lam is None else torch.as_tensor(lam)
    tot, deg = chain(torch.as_tensor(dbar), torch.as_tensor(unvis), n, t_lam)
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


def _mixed_lanes(rng, n, k):
    """Lanes whose |U| cycles through 0, 1, 2, n - 1 and a random size
    (city 0 never in U), and a visited city per lane for the connection
    edges; ``dbar`` carries +inf and -0.0 entries, and city n - 1 is
    reachable only from city 0, so a lane whose U holds it stalls and the
    chain takes the non-U city 0 into its tree first."""
    dbar, _, _ = _case(rng, 1, n)
    flat = dbar.reshape(-1)
    flat[rng.choice(n * n, size=n, replace=False)] = np.inf
    flat[rng.choice(n * n, size=n, replace=False)] = -0.0
    dbar[1:, n - 1] = np.inf
    unvis = np.zeros((k, n), bool)
    cur = np.zeros(k, np.int32)
    for i in range(k):
        size = (0, 1, 2, n - 1, int(rng.integers(3, n - 1)))[i % 5]
        unvis[i, 1 + rng.permutation(n - 1)[:size]] = True
        visited = np.flatnonzero(~unvis[i])
        cur[i] = visited[rng.integers(len(visited))]
    return dbar, unvis, cur


@pytest.mark.parametrize("n", [5, 14, 51, 100])
@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
def test_early_exit_chain_matches_plain_and_mst_conn(n, with_lam):
    """The kernel's schedule (a lane stops once U is in its tree, argmin by
    order-preserving keys) equals the fixed-length chain and the JAX
    package's ``_mst_conn`` on mixed |U|, +inf and -0.0 entries."""
    rng = np.random.default_rng(77 * n + with_lam)
    k = 40
    dbar, unvis, cur = _mixed_lanes(rng, n, k)
    lam = rng.integers(-8, 8, size=(k, n)).astype(np.float32) if with_lam else None
    t_lam = None if lam is None else torch.as_tensor(lam)
    args = (torch.as_tensor(dbar), torch.as_tensor(unvis), n, t_lam)
    want = prim_kernels.prim_chain_reference(*args)
    got = prim_kernels.prim_chain_early_exit_reference(*args)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    _assert_same(dbar, unvis, cur, n, lam, chain=prim_kernels.prim_chain_early_exit_reference)


def test_float_keys_order_floats_and_invert():
    """The kernel's argmin keys: a < b iff key(a) < key(b) over finite,
    subnormal, signed-zero and infinite floats; -0.0 keys as +0.0."""
    vals = np.array([-np.inf, -3e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 1e-38, 2.0, 3e38, np.inf],
                    np.float32)
    rng = np.random.default_rng(2)
    vals = np.concatenate([vals, rng.standard_normal(200).astype(np.float32) * 1e3])
    t = torch.as_tensor(vals)
    keys = prim_kernels._float_keys(t)
    assert bool((keys >= 0).all() and (keys < 2**32).all())
    lt = t[:, None] < t[None, :]
    assert torch.equal(lt, keys[:, None] < keys[None, :])
    assert torch.equal(t[:, None] == t[None, :], keys[:, None] == keys[None, :])
    back = prim_kernels._key_floats(keys)
    assert torch.equal(back, t)  # value equality: -0.0 == 0.0
    assert int(back[4].view(torch.int32)) == 0  # -0.0 comes back as +0.0


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

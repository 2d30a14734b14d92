"""The compact Held-Karp step's tile schedule, exactly, on the CPU.

``relax_minplus_tiles_reference`` is the plain mirror of the CUDA kernel's
schedule (a block copies one contiguous run of tile rows in head scalars,
16-byte vectors and tail scalars; thread t computes output t + s*NT, row
t // M + s*P and endpoint t % M, for each pass s). It must equal the plain
``relax_minplus_reference`` and the JAX package's ``relax_reference`` and
``relax_minplus`` Pallas kernel (interpret mode) bit for bit: costs and
first-index parents. The kernel itself is held against the plain version
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import held_karp_pallas as jpallas
from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def minplus_case(m, j, np_dtype, bsz=2, seed=0):
    """``g [B, J, M]`` and ``d_t [B, M, M]``: rounded values (many ties),
    masked-out (+inf) predecessors, an all-inf row and a row of equal
    candidates (every m' ties) when J allows."""
    rng = np.random.default_rng(1000 * m + j + seed)
    g = np.round(rng.uniform(0, 20, (bsz, j, m))).astype(np_dtype)
    g[rng.uniform(size=g.shape) < 0.2] = np.inf
    d_t = np.round(rng.uniform(0, 10, (bsz, m, m))).astype(np_dtype)
    if j > 1:
        g[:, 1] = np.inf  # all-inf: inf with parent 0
    if j > 2:
        g[:, 2] = 5.0
        d_t[0] = 3.0  # block 0, row 2: every candidate is 8
    return torch.as_tensor(g), torch.as_tensor(d_t)


def tile_cases():
    """J = 1, J below one tile, J one row past a whole tile (a ragged last
    tile) and J two whole tiles, for M in {1, 4, 15, 17}."""
    for m in (1, 4, 15, 17):
        tj = hkk.minplus_tile_rows(m)
        for j in (1, 7, tj + 1, 2 * tj):
            yield m, j


@pytest.mark.parametrize("m,j", list(tile_cases()))
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_tile_schedule_matches_the_plain_step(m, j, np_dtype, t_dtype):
    g, d_t = minplus_case(m, j, np_dtype)
    want_c, want_p = hkk.relax_minplus_reference(g, d_t)
    v = 16 // g.element_size()
    for sh0 in range(v):  # every offset of g's first element from a 16-byte boundary
        got_c, got_p = hkk.relax_minplus_tiles_reference(g, d_t, sh0)
        assert got_c.dtype == t_dtype and got_p.dtype == torch.int32
        assert torch.equal(got_c, want_c) and torch.equal(got_p, want_p)
    if j > 2:
        assert torch.equal(want_p[0, 2], torch.zeros(m, dtype=torch.int32))  # ties: first m'
        assert torch.isinf(want_c[:, 1]).all() and not want_p[:, 1].any()


@pytest.mark.parametrize("m,j", [(1, 1), (4, 7), (15, 273), (17, 241)])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_tile_schedule_matches_the_jax_kernel(m, j, np_dtype, t_dtype):
    g, d_t = minplus_case(m, j, np_dtype, seed=1)
    got_c, got_p = hkk.relax_minplus_tiles_reference(g, d_t)
    for b in range(g.shape[0]):
        gb, db = jnp.asarray(g[b].numpy()), jnp.asarray(d_t[b].numpy())
        ker_c, ker_p = jpallas.relax_minplus(gb, db, interpret=True)
        ref_c, ref_p = jpallas.relax_reference(gb, db)
        for want_c, want_p in ((ker_c, ker_p), (ref_c, ref_p)):
            np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(want_c))
            np.testing.assert_array_equal(got_p[b].numpy(), np.asarray(want_p))


@pytest.mark.parametrize("v", [2, 4])
def test_copy_split_covers_every_run_once(v):
    """Head scalars stop at the first 16-byte boundary, the vectors start
    on it, and the tail is shorter than a vector: for every offset and
    every run length up to a few vectors."""
    for sh in range(v):
        for count in range(0, 6 * v):
            head, nvec, tail = hkk.minplus_copy_split(count, sh, v)
            assert 0 <= head < v and head <= count
            assert tail == head + nvec * v <= count and count - tail < v
            if head < count:  # the head reaches the boundary the vectors start on
                assert (sh + head) % v == 0


@pytest.mark.parametrize("m,rows,threads", [(1, 4096, 256), (4, 1024, 256), (15, 272, 255), (16, 256, 256),
                                            (17, 240, 255)])
def test_tile_shape(m, rows, threads):
    assert hkk.minplus_tile_rows(m) == rows
    assert (hkk.MINPLUS_MAX_THREADS // m) * m == threads <= hkk.MINPLUS_MAX_THREADS

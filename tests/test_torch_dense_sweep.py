"""The dense Held-Karp sweep: its tile schedule and its CPU path, exactly.

``relax_dense_tiles_reference`` is the plain mirror of the CUDA kernel's
tile schedule (high-bit pre-pass from the previous launch's tiles, then a
low-bit sweep inside the tile); it must equal the per-level plain loop bit
for bit for every split of the mask into high and low bits. On the CPU
``relax_dense_sweep`` runs the per-level plain loop and must equal the JAX
package's per-level ``relax_dense`` Pallas kernel in interpret mode. The
kernel itself is held against the plain loop on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phases 2 and 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import held_karp_pallas as jpallas
from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _dense_case(m, np_dtype, bsz=2, seed=0):
    """``d_sub [B, m, m]`` and the initial table: rounded distances (many
    ties), some zero and some +inf distances, one +inf init entry."""
    rng = np.random.default_rng(1000 * m + seed)
    d_sub = np.round(rng.uniform(0, 20, (bsz, m, m))).astype(np_dtype)
    d_sub[rng.uniform(size=d_sub.shape) < 0.1] = 0.0
    d_sub[rng.uniform(size=d_sub.shape) < 0.1] = np.inf
    table = np.full((bsz, m, 1 << m), np.inf, np_dtype)
    table[:, :, 0] = np.round(rng.uniform(0, 20, (bsz, m)))
    table[0, m - 1, 0] = np.inf
    return torch.as_tensor(d_sub), torch.as_tensor(table)


def _per_level(table, d_sub):
    for c in range(1, table.shape[1]):
        table = hkk.relax_dense_reference(table, d_sub, c)
    return table


@pytest.mark.parametrize("m", [2, 3, 5, 8, 11])
@pytest.mark.parametrize("low", [1, 2, 4, "m"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_tile_schedule_matches_the_per_level_loop(m, low, np_dtype, t_dtype):
    d_sub, table = _dense_case(m, np_dtype)
    l = m if low == "m" else low
    want = _per_level(table, d_sub)
    got = hkk.relax_dense_tiles_reference(table, d_sub, l)
    assert got.dtype == t_dtype
    assert torch.equal(got, want)
    assert torch.equal(table[:, :, 0], got[:, :, 0])  # the init row is read, never written


def _jax_dense_loop(table, d_sub, m):
    """The JAX package's per-level Pallas ``relax_dense`` (interpret mode)
    over c = 1 .. m-1, on one block of the port's [m, 2^m] layout padded to
    the JAX kernel's 16 rows with its bit-swapped table G."""
    s = table.shape[1]
    rows = 16
    masks = np.arange(s)
    dpad = np.full((rows, rows), np.inf, table.dtype)
    dpad[:m, :m] = d_sub
    for c in range(1, m):
        cost = np.full((rows, s), np.inf, table.dtype)
        cost[:m] = table
        g = np.full((rows, s), np.inf, table.dtype)
        for b in range(m):
            g[b] = table[b, masks ^ (1 << b)]
        out = jpallas.relax_dense(
            jnp.asarray(cost), jnp.asarray(g), jnp.asarray(dpad), jnp.asarray(c, jnp.int32), m, True
        )
        table = np.asarray(out)[:m].copy()
    return table


@pytest.mark.parametrize("n", [6, 10])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_sweep_on_the_cpu_matches_the_jax_kernel_loop(n, np_dtype, t_dtype):
    m = n - 1
    rng = np.random.default_rng(n)
    d_sub = np.round(rng.uniform(0, 50, (m, m))).astype(np_dtype)
    table = np.full((m, 1 << m), np.inf, np_dtype)
    table[:, 0] = np.round(rng.uniform(0, 50, m))
    want = _jax_dense_loop(table, d_sub, m)
    got = torch.as_tensor(table)[None].clone()
    hkk.reset_launches()
    out = hkk.relax_dense_sweep(got, torch.as_tensor(d_sub)[None])
    assert out is got and got.dtype == t_dtype  # in place
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert hkk.LAUNCHES["relax_dense"] == 0  # the plain loop is not a launch
    # and the kernel's own schedule at its own l agrees with the JAX loop
    tiles = hkk.relax_dense_tiles_reference(torch.as_tensor(table)[None], torch.as_tensor(d_sub)[None],
                                            hkk.sweep_low_bits(m))
    np.testing.assert_array_equal(tiles[0].numpy(), want)


@pytest.mark.parametrize(
    "m,low,launches",
    [(15, 9, 7), (17, 9, 9), (10, 9, 2), (9, 9, 1), (5, 5, 1), (2, 2, 1), (1, 1, 0)],
)
def test_sweep_launches_are_one_per_high_popcount(m, low, launches):
    assert hkk.sweep_low_bits(m) == low
    assert hkk.sweep_launches(m) == launches


def test_sweep_refuses_a_non_cpu_tensor_it_cannot_take():
    """The ``meta`` device stands in for a non-CPU device: no fallback."""
    before = dict(hkk.LAUNCHES)
    with pytest.raises(ValueError):
        hkk.relax_dense_sweep(torch.empty((1, 4, 16), device="meta"), torch.empty((1, 4, 4), device="meta"))
    assert hkk.LAUNCHES == before

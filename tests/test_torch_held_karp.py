"""Port parity: Held-Karp relaxation kernels (plain versions on the CPU) and
the batched solver vs the JAX package and the oracle goldens.

Every comparison here is exact: the port and the JAX package add the same
operands in the same order and break ties on the first index. The CUDA
kernels themselves are tested in ``test_torch_cuda_kernels.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import held_karp as jhk
from tsp_mpi_reduction_tpu.ops import held_karp_pallas as jpallas
from tsp_mpi_reduction_tpu_torch.ops import held_karp as thk
from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]
IMPLS = ["compact", "dense", "fused", "pallas"]
GOLDENS = [
    "full_10x6_500x500.json",
    "full_16x2_1000x1000.json",
    "full_13x4_1000x1000.json",
    "full_5x10_1000x1000.json",
]


def _minplus_inputs(m, np_dtype, batch=None):
    rng = np.random.default_rng(m)
    shape = (130, m) if batch is None else (batch, 130, m)
    g = np.round(rng.uniform(0, 100, shape)).astype(np_dtype)  # rounded: ties
    g[rng.uniform(size=shape) < 0.2] = np.inf  # masked-out predecessors
    g[..., 3, :] = np.inf  # an all-inf row: inf with parent 0
    d_shape = (m, m) if batch is None else (batch, m, m)
    d_t = np.round(rng.uniform(0, 50, d_shape)).astype(np_dtype)
    return g, d_t


@pytest.mark.parametrize("m", [4, 9, 15, 17])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_relax_minplus_reference_matches_jax_kernel(m, np_dtype, t_dtype):
    g, d_t = _minplus_inputs(m, np_dtype)
    want_c, want_p = jpallas.relax_minplus(jnp.asarray(g), jnp.asarray(d_t), interpret=True)
    got_c, got_p = hkk.relax_minplus_reference(torch.as_tensor(g), torch.as_tensor(d_t))
    assert got_c.dtype == t_dtype and got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def _jax_dense_step(table, d_sub, c, m):
    """One JAX relax_dense step (interpret mode) on the port's [m, S] table:
    pad to the JAX kernel's 16 rows and build its bit-swapped table G."""
    s = table.shape[1]
    rows = 16
    masks = np.arange(s)
    cost = np.full((rows, s), np.inf, table.dtype)
    cost[:m] = table
    g = np.full((rows, s), np.inf, table.dtype)
    for b in range(m):
        g[b] = table[b, masks ^ (1 << b)]
    dpad = np.full((rows, rows), np.inf, table.dtype)
    dpad[:m, :m] = d_sub
    out = jpallas.relax_dense(
        jnp.asarray(cost), jnp.asarray(g), jnp.asarray(dpad), jnp.asarray(c, jnp.int32), m, True
    )
    return np.asarray(out)[:m]


@pytest.mark.parametrize("n", [6, 10])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_relax_dense_reference_matches_jax_kernel(n, np_dtype, t_dtype):
    m = n - 1
    rng = np.random.default_rng(n)
    d_sub = np.round(rng.uniform(0, 50, (m, m))).astype(np_dtype)
    table = np.full((m, 1 << m), np.inf, np_dtype)
    table[:, 0] = np.round(rng.uniform(0, 50, m))
    for c in range(1, m):
        want = _jax_dense_step(table, d_sub, c, m)
        got = hkk.relax_dense_reference(torch.as_tensor(table)[None], torch.as_tensor(d_sub)[None], c)[0]
        assert got.dtype == t_dtype
        np.testing.assert_array_equal(got.numpy(), want)
        table = want.copy()


def test_cpu_wrappers_run_plain_versions_without_counting():
    hkk.reset_launches()
    g, d_t = _minplus_inputs(6, np.float64, batch=2)
    c1, p1 = hkk.relax_minplus(torch.as_tensor(g), torch.as_tensor(d_t))
    c2, p2 = hkk.relax_minplus_reference(torch.as_tensor(g), torch.as_tensor(d_t))
    assert torch.equal(c1, c2) and torch.equal(p1, p2)
    table = torch.full((2, 5, 32), float("inf"), dtype=torch.float64)
    table[:, :, 0] = 1.0
    d_sub = torch.ones((2, 5, 5), dtype=torch.float64)
    want = table.clone()
    for c in range(1, 5):
        want = hkk.relax_dense_reference(want, d_sub, c)
    got = hkk.relax_dense_sweep(table, d_sub)
    assert got is table and torch.equal(got, want)  # updated in place
    assert hkk.LAUNCHES == {"relax_minplus": 0, "relax_dense": 0}


def test_masks_by_popcount_groups_every_mask_once():
    masks, offsets = hkk.masks_by_popcount(6, "cpu")
    assert sorted(masks.tolist()) == list(range(64))
    for c in range(7):
        group = masks[offsets[c]:offsets[c + 1]].tolist()
        assert all(bin(x).count("1") == c for x in group) and group == sorted(group)


@pytest.mark.parametrize("n", [3, 6, 10, 13])
def test_build_plan_matches_jax(n):
    a, b = thk.build_plan(n), jhk.build_plan(n)
    np.testing.assert_array_equal(a.scatter_idx, b.scatter_idx)
    np.testing.assert_array_equal(a.prev_idx, b.prev_idx)
    np.testing.assert_array_equal(a.member, b.member)
    assert (a.dp_states, a.dp_transitions) == (b.dp_states, b.dp_transitions)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", GOLDENS)
def test_solve_matches_golden_blocks(goldens_dir, impl, name):
    g = json.loads((goldens_dir / name).read_text())
    cfg = g["config"]
    n = cfg["ncpb"]
    _, xy = generate_instance(n, cfg["nblocks"], cfg["gx"], cfg["gy"])
    d = torch.as_tensor(distance_matrix_np(xy))
    with thk.use_impl(impl):
        costs, tours = thk.solve_blocks_from_dists(d, torch.float64)
    assert tours.dtype == torch.int32
    for b, sol in enumerate(g["block_solutions"]):
        assert float(costs[b]) == sol["cost"]
        assert (tours[b].numpy() + b * n).tolist() == sol["ids"]


@pytest.mark.parametrize("impl", IMPLS)
def test_solve_float32_matches_jax(impl):
    """Same float32 distance array into both packages: exact equality."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 500, (6, 9, 2))
    d32 = distance_matrix_np(xy).astype(np.float32)
    want_c, want_t = jhk.solve_blocks_from_dists(jnp.asarray(d32), jnp.float32)
    with thk.use_impl(impl):
        got_c, got_t = thk.solve_blocks_from_dists(torch.as_tensor(d32), torch.float32)
    assert got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_impl_selection():
    assert thk.effective_impl("cpu") == "compact"
    assert thk.effective_impl(torch.device("cuda")) == "fused"  # auto: a kernel
    with thk.use_impl("jnp"):
        assert thk.effective_impl("cpu") == "compact"
    with thk.use_impl("pallas"):
        assert thk.effective_impl(torch.device("cuda")) == "pallas"
    assert thk.effective_impl("cpu") == "compact"  # restored
    with pytest.raises(ValueError):
        thk.set_impl("bogus")


def test_solver_rejects_bad_shapes():
    with pytest.raises(ValueError):
        thk.solve_blocks_from_dists(torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError):
        thk.solve_blocks_from_dists(torch.zeros((2, 19, 19)))
    with pytest.raises(ValueError):
        thk.build_plan(2)


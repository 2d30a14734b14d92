"""The port's hand CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. This file imports neither ``jax`` nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

All comparisons are exact (``torch.equal``): the kernels only add and
compare, in the plain versions' order, with first-index ties.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
from tsp_mpi_reduction_tpu_torch.ops import held_karp as thk
from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance

GOLDENS = pathlib.Path(__file__).resolve().parent.parent / "goldens"
DTYPES = [torch.float32, torch.float64]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _minplus_inputs(m, dtype, device, batch=3):
    rng = np.random.default_rng(m)
    g = np.round(rng.uniform(0, 100, (batch, 130, m)))  # rounded: many ties
    g[rng.uniform(size=g.shape) < 0.2] = np.inf  # masked-out predecessors
    g[:, 3] = np.inf  # an all-inf row: inf with parent 0
    d_t = np.round(rng.uniform(0, 50, (batch, m, m)))
    return torch.as_tensor(g, dtype=dtype, device=device), torch.as_tensor(d_t, dtype=dtype, device=device)


@pytest.mark.parametrize("m", [4, 15, 17])
@pytest.mark.parametrize("dtype", DTYPES)
def test_relax_minplus_kernel_exact(cuda, m, dtype):
    g, d_t = _minplus_inputs(m, dtype, cuda)
    before = hkk.LAUNCHES["relax_minplus"]
    got = hkk.relax_minplus(g, d_t)
    want = hkk.relax_minplus_reference(g, d_t)
    torch.cuda.synchronize()
    assert hkk.LAUNCHES["relax_minplus"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1][:, 3], torch.zeros_like(got[1][:, 3]))  # all-inf row


def _minplus_tile_case(m, j, dtype, device, offset):
    """``g [3, J, M]`` and ``d_t``, rounded (ties), with +inf entries, an
    all-inf row, a row whose candidates all tie, and ``g`` starting
    ``offset`` elements into its storage (off a 16-byte boundary)."""
    rng = np.random.default_rng(1000 * m + j)
    g = np.round(rng.uniform(0, 20, (3, j, m)))
    g[rng.uniform(size=g.shape) < 0.2] = np.inf
    d_t = np.round(rng.uniform(0, 10, (3, m, m)))
    if j > 2:
        g[:, 1] = np.inf
        g[:, 2] = 5.0
        d_t[0] = 3.0
    store = torch.empty(g.size + offset, dtype=dtype, device=device)
    gt = store[offset:].view(g.shape)
    gt.copy_(torch.as_tensor(g, dtype=dtype))
    return gt, torch.as_tensor(d_t, dtype=dtype, device=device)


@pytest.mark.parametrize("m", [1, 4, 15, 16, 17])
@pytest.mark.parametrize("rows", ["one", "ragged", "two-tiles"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_relax_minplus_kernel_tile_edges_exact(cuda, m, rows, offset, dtype):
    """J = 1, J one row past a whole tile, two whole tiles; g aligned or
    one element off."""
    tj = hkk.minplus_tile_rows(m)
    j = {"one": 1, "ragged": tj + 1, "two-tiles": 2 * tj}[rows]
    g, d_t = _minplus_tile_case(m, j, dtype, cuda, offset)
    assert g.is_contiguous() and (g.data_ptr() % 16 != 0) == (offset * g.element_size() % 16 != 0)
    got = hkk.relax_minplus(g, d_t)
    want = hkk.relax_minplus_reference(g, d_t)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dense_case(m, dtype, device, bsz):
    rng = np.random.default_rng(m)
    d_sub = np.round(rng.uniform(0, 50, (bsz, m, m)))  # rounded: many ties
    d_sub[rng.uniform(size=d_sub.shape) < 0.05] = 0.0
    d_sub[rng.uniform(size=d_sub.shape) < 0.05] = np.inf
    table = torch.full((bsz, m, 1 << m), float("inf"), dtype=dtype, device=device)
    table[:, :, 0] = torch.as_tensor(np.round(rng.uniform(0, 50, (bsz, m))), dtype=dtype)
    return torch.as_tensor(d_sub, dtype=dtype, device=device), table


@pytest.mark.parametrize("m", [2, 5, 9, 10, 11, 15, 17])
@pytest.mark.parametrize("dtype", DTYPES)
def test_relax_dense_sweep_kernel_exact(cuda, m, dtype):
    d_sub, table = _dense_case(m, dtype, cuda, 3 if m < 17 else 1)
    want = table.clone()
    for c in range(1, m):
        want = hkk.relax_dense_reference(want, d_sub, c)
    before = hkk.LAUNCHES["relax_dense"]
    got = hkk.relax_dense_sweep(table, d_sub)
    torch.cuda.synchronize()
    assert got is table and torch.equal(table, want)
    assert hkk.LAUNCHES["relax_dense"] == before + hkk.sweep_launches(m)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_solve_matches_golden(cuda, impl):
    g = json.loads((GOLDENS / "full_16x2_1000x1000.json").read_text())
    _, xy = generate_instance(16, 2, 1000, 1000)
    d = torch.as_tensor(distance_matrix_np(xy), device=cuda)
    with thk.use_impl(impl):
        costs, tours = thk.solve_blocks_from_dists(d, torch.float64)
    for b, sol in enumerate(g["block_solutions"]):
        assert float(costs[b]) == sol["cost"]
        assert (tours[b].cpu().numpy() + b * 16).tolist() == sol["ids"]


def test_auto_pipeline_runs_the_dense_kernel(cuda):
    hkk.reset_launches()
    res = run_pipeline(10, 6, 500, 500, dtype=torch.float64, device=cuda)
    assert f"{res.cost:f}" == "3720.557435"
    assert hkk.LAUNCHES == {"relax_minplus": 0, "relax_dense": hkk.sweep_launches(9)}


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.zeros((1, 4, 18), device=cuda)
    with pytest.raises(ValueError):
        hkk.relax_minplus(g, torch.zeros((1, 18, 18), device=cuda))  # M > 17
    with pytest.raises(ValueError):
        hkk.relax_minplus(g[..., :4].half(), torch.zeros((1, 4, 4), device=cuda).half())
    with pytest.raises(ValueError):
        hkk.relax_dense_sweep(torch.zeros((1, 4, 8), device=cuda), torch.zeros((1, 4, 4), device=cuda))
    with pytest.raises(ValueError):
        hkk.relax_dense_sweep(torch.zeros((1, 4, 16), device=cuda), torch.zeros((1, 4, 4), device=cuda).double())

"""The in-place contract and the cost records around real kernel launches.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package:

    python -m pytest tests/test_torch_cuda_contracts.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.obs import costs
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def test_check_donated_around_a_real_push_rows_step(cuda, monkeypatch):
    """One fused expansion step launches ``push_rows`` on the frontier
    buffer: the buffer is the same allocation afterwards, and a copy of it
    fails the check."""
    monkeypatch.delenv("TSP_CONTRACTS", raising=False)
    d = _random_d(14, 3)
    n, k = 14, 16
    bd = bb._bound_setup(d, "one-tree", node_ascent=2, device=cuda)
    fr = bb.make_root_frontier(n, 4096, bd.min_out.cpu().numpy().astype(np.float64), device=cuda,
                               pad_rows=k * n)
    inc_tour = torch.as_tensor(bb.nearest_neighbor_tour(d), dtype=torch.int32, device=cuda)
    inc = torch.tensor(bb.tour_cost(d, inc_tour.cpu().numpy()), dtype=torch.float32, device=cuda)
    d32 = torch.as_tensor(d, dtype=torch.float32, device=cuda)
    ek.reset_launches()
    ptr = contracts.donation_ptr(fr.nodes)
    for _ in range(3):
        fr, inc, inc_tour, _ = bb._expand_step(fr, inc, inc_tour, d32, bd, k, n, node_ascent=2,
                                               mst_kernel="prim_chain", step_kernel="fused")
        assert contracts.check_donated(fr.nodes, ptr, where="test") is fr.nodes
    torch.cuda.synchronize()
    assert ek.LAUNCHES["push_rows"] == 3
    with pytest.raises(contracts.ContractError, match="reallocated"):
        contracts.check_donated(fr.nodes.clone(), ptr, where="test")


def test_device_loop_solve_records_both_kernels(cuda):
    costs.reset_for_testing()
    res = bb.solve(_random_d(14, 5), capacity=1 << 14, k=16, device=cuda)
    assert res.proven_optimal and res.series is not None
    kernels = {r["kernel"] for r in costs.device_costs_block()["entries"].values()}
    assert {"prim_chain", "push_rows"} <= kernels
    for rec in costs.device_costs_block()["entries"].values():
        assert rec["backend"] == "gpu" and rec["card"] == torch.cuda.get_device_name(cuda)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0

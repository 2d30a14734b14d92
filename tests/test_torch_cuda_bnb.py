"""The hand ``prim_chain`` CUDA kernel and the B&B solve on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_bnb.py -m cuda --noconftest -q

The kernel is held against its plain version bit for bit (``tot`` as
int32 bits, ``deg`` exactly): it adds and compares in the plain chain's
order, with first-index ties.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
from tsp_mpi_reduction_tpu_torch.utils import tsplib

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _lanes(n, k, integral, device, seed):
    rng = np.random.default_rng(seed)
    if integral:
        d = rng.integers(1, 500, size=(n, n)).astype(np.float32)
    else:
        d = (rng.random((n, n)) * 500).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0.0)
    pi = rng.integers(-20, 20, size=n).astype(np.float32)
    unvis = rng.random((k, n)) < 0.6
    unvis[:, 0] = False
    lam = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
    return (torch.as_tensor(d + pi[None, :] + pi[:, None], device=device),
            torch.as_tensor(unvis, device=device), torch.as_tensor(lam, device=device))


@pytest.mark.parametrize("n", [5, 14, 51, 100, 200])
@pytest.mark.parametrize("integral", [True, False], ids=["integral", "nonintegral"])
@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
def test_prim_chain_kernel_bit_exact(cuda, n, integral, with_lam):
    dbar, unvis, lam = _lanes(n, 300, integral, cuda, n)
    lam = lam if with_lam else None
    before = prim_kernels.LAUNCHES["prim_chain"]
    tot, deg = prim_kernels.prim_chain(dbar, unvis, n, lam)
    ref_tot, ref_deg = prim_kernels.prim_chain_reference(dbar, unvis, n, lam)
    torch.cuda.synchronize()
    assert prim_kernels.LAUNCHES["prim_chain"] == before + 1
    assert torch.equal(tot.view(torch.int32), ref_tot.view(torch.int32))
    assert torch.equal(deg, ref_deg)


def test_prim_chain_kernel_degenerate_lanes(cuda):
    dbar, _, _ = _lanes(14, 4, True, cuda, 3)
    unvis = torch.zeros((4, 14), dtype=torch.bool, device=cuda)
    unvis[1, 3] = True
    unvis[2, 3:6] = True
    tot, deg = prim_kernels.prim_chain(dbar, unvis, 14)
    ref_tot, ref_deg = prim_kernels.prim_chain_reference(dbar, unvis, 14)
    assert torch.equal(tot.view(torch.int32), ref_tot.view(torch.int32)) and torch.equal(deg, ref_deg)


def test_prim_chain_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dbar, unvis, lam = _lanes(20, 8, True, cuda, 1)
    before = prim_kernels.LAUNCHES["prim_chain"]
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar.double(), unvis, 20)  # float64
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar.t(), unvis, 20)  # not contiguous
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar, unvis, 20, lam[:4].contiguous())  # lam not [k, n]
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar, unvis.to(torch.uint8), 20)  # not bool
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar, unvis.cpu(), 20)  # two devices
    assert prim_kernels.LAUNCHES["prim_chain"] == before


def test_solve_on_the_card_goes_through_the_kernel(cuda):
    d = tsplib.embedded("ulysses16").distance_matrix()
    kw = dict(capacity=1 << 14, k=32, max_iters=300, bound="min-out", ils_rounds=0)
    prim_kernels.reset_launches()
    got = bb.solve(d, device=cuda, **kw)
    assert got.mst_kernel == "prim_chain"
    assert prim_kernels.LAUNCHES["prim_chain"] == 3 * got.steps_run > 0  # node_ascent = 2
    plain = bb.solve(d, device=cuda, mst_kernel="prim", **kw)
    assert (got.nodes_expanded, got.cost, got.lower_bound) == (
        plain.nodes_expanded, plain.cost, plain.lower_bound)


def test_burma14_proves_on_the_card(cuda):
    r = bb.solve(tsplib.embedded("burma14").distance_matrix(), capacity=1 << 14, k=64, device=cuda)
    assert r.proven_optimal and r.cost == 3323.0

"""The frozen counts read as the program's own count functions do today."""

from __future__ import annotations

import pytest
import torch

from benchmark import counts
from tsp_mpi_reduction_tpu_torch.obs import costs


@pytest.mark.parametrize("k,n,has_lam", [(1024, 51, False), (1024, 51, True), (7, 13, True), (128, 100, False)])
def test_prim_chain_counts(k, n, has_lam):
    g = torch.Generator().manual_seed(k + n)
    unvis = torch.rand((k, n), generator=g) < 0.6
    want = costs.prim_chain_counts(unvis, has_lam)
    got = counts.prim_chain_counts(k, n, unvis.sum(dim=1).tolist(), has_lam)
    assert got == pytest.approx(want, rel=1e-12)
    assert counts.prim_chain_counts(k, n, None, has_lam)[0] == want[0]


@pytest.mark.parametrize("k,n,n_push", [(1024, 51, 0), (1024, 51, 311.2), (16, 9, 40)])
def test_push_rows_counts(k, n, n_push):
    cols = counts.frontier_cols(n)
    assert counts.push_rows_counts(k, n, cols, n_push) == pytest.approx(costs.push_rows_counts(k, n, cols, n_push))


def test_frontier_cols_is_the_programs_row_width():
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb

    for n in (9, 14, 51, 52, 100, 200):
        assert counts.frontier_cols(n) == bb._path_words(n) + (n + 31) // 32 + 4
        assert bb._layout(counts.frontier_cols(n))[1] == (n + 31) // 32


@pytest.mark.parametrize("bsz,m,elt", [(1024, 15, 4), (100, 15, 8), (3, 5, 4)])
def test_relax_dense_counts(bsz, m, elt):
    assert counts.relax_dense_counts(bsz, m, elt) == pytest.approx(costs.relax_dense_counts(bsz, m, elt))


@pytest.mark.parametrize("nbytes,ops,dt", [(1e9, 1e6, "float32"), (1e3, 1e12, "float32"), (1e6, 1e12, "float64")])
def test_bound_and_peaks(nbytes, ops, dt):
    ms, _ = costs.bound_ms(nbytes, ops, dt)
    assert counts.bound_s(nbytes, ops, dt) * 1e3 == pytest.approx(ms)
    assert counts.PEAK_BYTES_PER_S == costs.PEAK_BYTES_PER_S
    assert counts.PEAK_OPS_PER_S == costs.PEAK_OPS_PER_S

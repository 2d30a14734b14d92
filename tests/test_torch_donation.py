"""The port's in-place frontier writes (``perf/donation.py``) against the
JAX package's donating ones, on the CPU: the same values, and the same
allocation afterwards (``data_ptr``), which ``check_donated`` holds; the
B&B engine's spill writebacks go through them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.perf import donation as jdonation
from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.perf import donation


def _rand(rng, shape):
    return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("shape,rows", [((256, 21), 7), ((64, 23), 64), ((16, 5), 0), ((33, 76), 1)])
@pytest.mark.parametrize("host_rows", [False, True], ids=["device-rows", "host-rows"])
def test_set_rows_donated_equals_the_jax_write_in_place(shape, rows, host_rows):
    rng = np.random.default_rng(shape[0] + rows)
    nodes_np, rows_np = _rand(rng, shape), _rand(rng, (rows, shape[1]))
    want = np.asarray(jdonation.set_rows_donated(jnp.asarray(nodes_np), jnp.asarray(rows_np)))
    nodes = torch.from_numpy(nodes_np.copy())
    ptr = nodes.data_ptr()
    src = torch.from_numpy(rows_np) if host_rows else torch.from_numpy(rows_np.copy())
    out = donation.set_rows_donated(nodes, src)
    assert out is nodes and out.data_ptr() == ptr
    contracts.check_donated(out, ptr, where="test")
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("ridx,t", [([1, 3], 5), ([0], 64), ([0, 1, 2, 3], 1), ([2], 0)])
def test_set_rank_rows_donated_equals_the_jax_write_in_place(ridx, t):
    rng = np.random.default_rng(len(ridx) * 7 + t)
    nodes_np = _rand(rng, (4, 64, 21))
    block_np = _rand(rng, (len(ridx), t, 21))
    want = np.asarray(jdonation.set_rank_rows_donated(
        jnp.asarray(nodes_np), jnp.asarray(ridx, jnp.int32), jnp.asarray(block_np)))
    nodes = torch.from_numpy(nodes_np.copy())
    ptr = nodes.data_ptr()
    out = donation.set_rank_rows_donated(nodes, torch.as_tensor(ridx), torch.from_numpy(block_np))
    assert out is nodes and out.data_ptr() == ptr
    contracts.check_donated(out, ptr, where="test")
    np.testing.assert_array_equal(out.numpy(), want)


def test_check_donated_fails_on_a_copy():
    nodes = torch.zeros(8, 21, dtype=torch.int32)
    ptr = nodes.data_ptr()
    with pytest.raises(contracts.ContractError, match="reallocated"):
        contracts.check_donated(nodes.clone(), ptr, where="test")


def _live_frontier(rng, rows=32, n=14):
    cols = (n + 3) // 4 + (n + 31) // 32 + 4
    nodes = torch.from_numpy(_rand(rng, (rows, cols)))
    return bb.Frontier(nodes, torch.tensor(8, dtype=torch.int32), torch.tensor(False))


def test_the_reservoirs_writebacks_keep_the_buffer():
    """``_Reservoir.refill`` and ``exchange`` write the kept rows through
    ``set_rows_donated``: the frontier they return holds the same
    allocation, and its prefix is the kept rows."""
    rng = np.random.default_rng(4)
    fr = _live_frontier(rng)
    res = bb._Reservoir()
    chunk = _rand(rng, (6, fr.nodes.shape[1]))
    chunk[:, -2] = 0  # the float32 bound column (bits of 0.0): every row alive
    res.chunks = [chunk]
    keep = res.refill_rows(float("inf"), False, 32)
    res.chunks = [chunk]
    ptr = fr.nodes.data_ptr()
    out = res.refill(fr, float("inf"), False, 32)
    assert out.nodes.data_ptr() == ptr and int(out.count) == keep.shape[0]
    np.testing.assert_array_equal(out.nodes[: keep.shape[0]].numpy(), keep)
    out2 = res.exchange(out, float("inf"), False, 32)
    assert out2.nodes.data_ptr() == ptr


def test_apply_keeps_writes_the_stacked_buffer_in_place():
    rng = np.random.default_rng(6)
    nodes = torch.from_numpy(_rand(rng, (3, 16, 9)))
    before = nodes.clone()
    fr = bb.Frontier(nodes, torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.bool))
    keeps = {0: _rand(rng, (4, 9)), 2: _rand(rng, (2, 9))}
    out = bb._apply_keeps(fr, keeps, np.array([4, 5, 2]), bb.SpillStats())
    assert out.nodes.data_ptr() == nodes.data_ptr()
    np.testing.assert_array_equal(out.nodes[0, :4].numpy(), keeps[0])
    np.testing.assert_array_equal(out.nodes[2, :2].numpy(), keeps[2])
    assert (out.nodes[2, 2:4] == 0).all()  # zero-padded to the widest keep
    assert torch.equal(out.nodes[1], before[1]) and torch.equal(out.nodes[0, 4:], before[0, 4:])
    assert out.count.tolist() == [4, 5, 2]

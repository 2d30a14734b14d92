"""The fused B&B push's warp schedule, bit for bit, on the CPU.

``push_rows_chunked_reference`` is the plain mirror of the CUDA kernel's
schedule: one warp a (parent, chunk of 32 children), 8 warps a block, the
parent row and the chunk's ``dest`` read first, the pushed lanes' float
columns next, then one row stored per pushed child in lane order. It must
leave the frontier buffer exactly as the plain ``push_rows_reference`` and
the JAX package's ``expand_pallas.push_rows`` (interpret mode) do. The
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_expand.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import expand_pallas
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

#: quiet NaN, NaN with a payload, -0.0, +inf, -inf as int32 bit patterns
SPECIAL_BITS = np.array([0x7FC00000, 0x7FC00123, 0x80000000, 0x7F800000, 0xFF800000],
                        np.uint32).view(np.int32)


def push_case(n, k, case, seed, negative=True):
    """Frontier, parents, dest and the float columns (numpy). ``case``:
    "mixed" (30% pushed), "all", "none", or "one-full" (parent 0 pushes
    all n children, the others about 10%). Pushed children land in a
    random order from a random base row, or end at row F-1 when every
    child is pushed; with ``negative`` some pruned children are parked at
    -1 instead of past F."""
    rng = np.random.default_rng(seed)
    cols = ek.row_width(n)
    pw, w = (n + 3) // 4, (n + 31) // 32
    f_rows = k * n + 17
    nodes = rng.integers(-(2**31), 2**31, size=(f_rows, cols), dtype=np.int64).astype(np.int32)
    parents = rng.integers(-(2**31), 2**31, size=(k, cols), dtype=np.int64).astype(np.int32)
    parents[:, pw + w] = rng.integers(0, n + 3, size=k)  # depths, some past n - 1
    if case == "one-full":
        push = rng.random((k, n)) < 0.1
        push[0] = True
    else:
        push = {"mixed": rng.random((k, n)) < 0.3, "none": np.zeros((k, n), bool),
                "all": np.ones((k, n), bool)}[case]
    flat = push.reshape(-1)
    n_push = int(flat.sum())
    rank = np.zeros(k * n, np.int64)
    rank[rng.permutation(np.flatnonzero(flat))] = np.arange(n_push)
    base = f_rows - n_push if case == "all" else int(rng.integers(0, f_rows - n_push + 1))
    dest = np.where(flat, base + rank, rng.integers(f_rows, f_rows + 50, size=k * n))
    if negative:
        dest[~flat & (rng.random(k * n) < 0.1)] = -1
    floats = []
    for _ in range(3):
        bits = rng.integers(-(2**31), 2**31, size=k * n, dtype=np.int64).astype(np.int32)
        bits[rng.integers(0, k * n, size=len(SPECIAL_BITS))] = SPECIAL_BITS
        floats.append(bits.view(np.float32).reshape(k, n))
    return nodes, parents, dest.reshape(k, n).astype(np.int32), floats


def torch_push(fn, nodes, parents, dest, floats, n):
    t_nodes = torch.from_numpy(nodes.copy())
    out = fn(t_nodes, torch.from_numpy(parents), torch.from_numpy(dest),
             *(torch.from_numpy(f) for f in floats), n)
    assert out is t_nodes  # in place
    return out.numpy()


@pytest.mark.parametrize("n", [13, 51, 100, 128, 200])
@pytest.mark.parametrize("k", [1, 11, 37])
@pytest.mark.parametrize("case", ["mixed", "all", "none", "one-full"])
def test_chunked_schedule_matches_the_plain_push(n, k, case):
    inputs = push_case(n, k, case, seed=n * k + len(case))
    want = torch_push(ek.push_rows_reference, *inputs, n)
    got = torch_push(ek.push_rows_chunked_reference, *inputs, n)
    np.testing.assert_array_equal(got, want)
    if case == "all":
        assert int(inputs[2].max()) == inputs[0].shape[0] - 1
    if case == "none":
        np.testing.assert_array_equal(got, inputs[0])


@pytest.mark.parametrize("n", [13, 51, 100, 128, 200])
@pytest.mark.parametrize("case", ["mixed", "one-full"])
def test_chunked_schedule_matches_the_jax_kernel(n, case):
    """k = 11 parents: k * ceil(n/32) warps is not a multiple of the 8 a
    block. The JAX kernel parks pruned children past F only."""
    inputs = push_case(n, 11, case, seed=n, negative=False)
    got = torch_push(ek.push_rows_chunked_reference, *inputs, n)
    nodes, parents, dest, floats = inputs
    want = expand_pallas.push_rows(jnp.asarray(nodes), jnp.asarray(parents), jnp.asarray(dest),
                                   *(jnp.asarray(f) for f in floats), n, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_chunked_schedule_keeps_special_float_bits():
    n = 200  # city ids >= 128 at shift 24 set the sign bit of a path word
    nodes, parents, dest, floats = push_case(n, 5, "all", seed=3)
    got = torch_push(ek.push_rows_chunked_reference, nodes, parents, dest, floats, n)
    flat = dest.reshape(-1)
    for col, f in zip((-3, -2, -1), floats):
        np.testing.assert_array_equal(got[flat, col], f.view(np.int32).reshape(-1))
    assert set(SPECIAL_BITS.tolist()) <= set(got[flat, -3:].reshape(-1).tolist())


@pytest.mark.parametrize("k,n,blocks", [(1, 13, 1), (11, 51, 6), (37, 100, 37), (1024, 51, 512),
                                        (1024, 100, 1024), (1024, 200, 1792)])
def test_push_blocks(k, n, blocks):
    assert ek.push_blocks(k, n) == blocks

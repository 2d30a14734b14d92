"""The hand ``push_rows`` CUDA kernel and the device loop on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_expand.py -m cuda --noconftest -q

The kernel only moves and ORs bits, so it is held against its plain
version bit for bit on the whole frontier buffer.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

pytestmark = pytest.mark.cuda

#: quiet NaN, NaN with a payload, -0.0, +inf, -inf as int32 bit patterns
SPECIAL_BITS = np.array([0x7FC00000, 0x7FC00123, 0x80000000, 0x7F800000, 0xFF800000],
                        np.uint32).view(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def push_inputs(n, k, case, device, seed):
    """Frontier, parents, dest and the float columns on ``device``; the
    pushed children land in a random order from a random base row (or end
    at row F - 1 when every child is pushed)."""
    rng = np.random.default_rng(seed)
    cols = ek.row_width(n)
    pw, w = (n + 3) // 4, (n + 31) // 32
    f_rows = k * n + 17
    nodes = rng.integers(-(2**31), 2**31, size=(f_rows, cols), dtype=np.int64).astype(np.int32)
    parents = rng.integers(-(2**31), 2**31, size=(k, cols), dtype=np.int64).astype(np.int32)
    parents[:, pw + w] = rng.integers(0, n + 3, size=k)
    if case == "one-full":  # parent 0 pushes every child, the others about 10%
        push = rng.random((k, n)) < 0.1
        push[0] = True
    else:
        push = {"mixed": rng.random((k, n)) < 0.3, "none": np.zeros((k, n), bool),
                "all": np.ones((k, n), bool)}[case]
    n_push = int(push.sum())
    rank = np.zeros(k * n, np.int64)
    rank[rng.permutation(np.flatnonzero(push.reshape(-1)))] = np.arange(n_push)
    base = f_rows - n_push if case == "all" else int(rng.integers(0, f_rows - n_push + 1))
    parked = rng.integers(f_rows, f_rows + 50, size=k * n)
    dest = np.where(push.reshape(-1), base + rank, parked).reshape(k, n).astype(np.int32)
    dest.reshape(-1)[~push.reshape(-1) & (rng.random(k * n) < 0.1)] = -1  # negative: not stored
    floats = []
    for _ in range(3):
        bits = rng.integers(-(2**31), 2**31, size=(k, n), dtype=np.int64).astype(np.int32)
        bits.reshape(-1)[rng.integers(0, k * n, size=len(SPECIAL_BITS))] = SPECIAL_BITS
        floats.append(torch.as_tensor(bits.view(np.float32), device=device))
    return (torch.as_tensor(nodes, device=device), torch.as_tensor(parents, device=device),
            torch.as_tensor(dest, device=device), *floats)


@pytest.mark.parametrize("n", [5, 13, 14, 33, 51, 100, 128, 200])
@pytest.mark.parametrize("k", [1, 11, 37, 1024])
@pytest.mark.parametrize("case", ["mixed", "none", "all", "one-full"])
def test_push_rows_kernel_bit_exact(cuda, n, k, case):
    nodes, parents, dest, cc, cb, cs = push_inputs(n, k, case, cuda, seed=n * k)
    want = ek.push_rows_reference(nodes.clone(), parents, dest, cc, cb, cs, n)
    before = ek.LAUNCHES["push_rows"]
    got = ek.push_rows(nodes, parents, dest, cc, cb, cs, n)
    torch.cuda.synchronize()
    assert got is nodes and ek.LAUNCHES["push_rows"] == before + 1
    assert torch.equal(got, want)
    if case == "all":
        assert int(dest.max()) == nodes.shape[0] - 1


def test_push_rows_kernel_keeps_special_float_bits(cuda):
    n = 100
    nodes, parents, dest, cc, cb, cs = push_inputs(n, 8, "all", cuda, seed=5)
    ek.push_rows(nodes, parents, dest, cc, cb, cs, n)
    flat = dest.reshape(-1).long()
    for col, f in zip((-3, -2, -1), (cc, cb, cs)):
        assert torch.equal(nodes[flat, col], f.view(torch.int32).reshape(-1))


def test_push_rows_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n = 20
    nodes, parents, dest, cc, cb, cs = push_inputs(n, 4, "mixed", cuda, seed=1)
    before = ek.LAUNCHES["push_rows"]
    bad = [
        (nodes, parents, dest.cpu(), cc, cb, cs),  # two devices
        (nodes, parents, dest, cc.t().contiguous().t(), cb, cs),  # not contiguous
        (nodes, parents, dest.long(), cc, cb, cs),  # dest not int32
        (nodes, parents, dest, cc.double(), cb, cs),  # not float32
        (nodes[:, :-1].contiguous(), parents, dest, cc, cb, cs),  # row width
        (nodes, parents[:, 1:].contiguous(), dest, cc, cb, cs),  # parent width
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ek.push_rows(*args, n)
    assert ek.LAUNCHES["push_rows"] == before


def _random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def test_device_loop_spill_proof_on_the_card(cuda):
    """Capacity at the device loop's floor: the search compacts on the
    card, exchanges with the host reservoir and still proves; the fused
    push launches once per step issued (replayed or a capture's warm-up),
    and the reference push gives the same search."""
    d = _random_d(13, 1)
    kw = dict(capacity=384, k=8, bound="min-out", mst_prune=False, node_ascent=0, ils_rounds=0,
              max_iters=2_000_000, device=cuda)
    ek.reset_launches()
    bb.reset_frontier_stats()
    fused = bb.solve(d, **kw)
    assert fused.device_loop and fused.step_kernel == "fused"
    assert ek.LAUNCHES["push_rows"] == fused.replays + fused.warm_steps > 0
    assert bb.FRONTIER_STATS["compactions"] > 0 and fused.spill_rounds > 0
    assert fused.proven_optimal
    ref = bb.solve(d, step_kernel="reference", **kw)
    fields = ("cost", "nodes_expanded", "iterations", "lower_bound", "spill_rounds",
              "spill_events", "spill_full_merges", "spill_bytes_to_host", "spill_bytes_to_device")
    assert [getattr(fused, f) for f in fields] == [getattr(ref, f) for f in fields]

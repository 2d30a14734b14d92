"""The graph store on the card: the merge fold captured once and replayed.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package:

    python -m pytest tests/test_torch_cuda_compile_cache.py -m cuda --noconftest -q

The fold through the store equals the eager fold (``TSP_COMPILE_CACHE=off``)
bit for bit, a second fold of the same shapes captures nothing, and a
result stays the caller's after later replays overwrite the graph's
buffers.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.ops import merge
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.perf import compile_cache as cc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    monkeypatch.delenv("TSP_CONTRACTS", raising=False)
    return torch.device("cuda")


def _blocks(n, nb, seed, dtype, device):
    """``nb`` random closed tours of ``n`` cities each over one instance."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1000, (n * nb, 2))
    dist = torch.as_tensor(distance_matrix_np(xy), dtype=dtype, device=device)
    tours = np.stack([np.r_[p, p[0]] for p in (rng.permutation(n) + n * i for i in range(nb))])
    tours = torch.as_tensor(tours.astype(np.int32), device=device)
    costs = torch.as_tensor(rng.uniform(100, 200, nb), dtype=dtype, device=device)
    return tours, costs, dist


def _eager(monkeypatch, *args):
    monkeypatch.setenv(cc.ENV_VAR, "off")
    try:
        return merge.fold_tours(*args)
    finally:
        monkeypatch.delenv(cc.ENV_VAR)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nb", [(16, 64), (5, 9), (10, 2)])
def test_the_replayed_fold_equals_the_eager_fold(cuda, monkeypatch, dtype, n, nb):
    args = _blocks(n, nb, n * nb, dtype, cuda)
    before = cc.stats_dict()
    got = merge.fold_tours(*args)
    want = _eager(monkeypatch, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    after = cc.stats_dict()
    assert after["aot_misses"] + after["aot_hits"] == before["aot_misses"] + before["aot_hits"] + 1
    t = got[0][: int(got[1])].cpu().numpy()
    assert int(got[1]) == n * nb + 1 and t[0] == t[-1] and np.array_equal(np.sort(t[:-1]), np.arange(n * nb))


def test_a_second_fold_of_the_same_shapes_captures_nothing(cuda):
    args = _blocks(16, 32, 1, torch.float32, cuda)
    merge.fold_tours(*args)  # captures on a cold key
    hits = cc.stats_dict()["aot_hits"]
    with contracts.RecompilationGuard({"fold_tours": merge.FOLD}, limit=0) as g:
        for seed in (2, 3):
            merge.fold_tours(*_blocks(16, 32, seed, torch.float32, cuda))
    assert g.misses() == {"fold_tours": 0}
    assert cc.stats_dict()["aot_hits"] == hits + 2
    with pytest.raises(contracts.RecompilationError, match="recompiled"):
        with contracts.RecompilationGuard({"fold_tours": merge.FOLD}, limit=0):
            merge.fold_tours(*_blocks(16, 33, 4, torch.float32, cuda))  # a new shape: a capture


def test_results_are_cloned_out_of_the_graph(cuda, monkeypatch):
    first = _blocks(8, 16, 11, torch.float64, cuda)
    ids1, len1, cost1 = merge.fold_tours(*first)
    kept = (ids1.clone(), len1.clone(), cost1.clone())
    merge.fold_tours(*_blocks(8, 16, 12, torch.float64, cuda))  # replays over the same buffers
    torch.cuda.synchronize()
    assert torch.equal(ids1, kept[0]) and torch.equal(len1, kept[1]) and torch.equal(cost1, kept[2])
    want = _eager(monkeypatch, *first)
    assert torch.equal(ids1, want[0]) and float(cost1) == float(want[2])


def test_threads_folding_through_one_graph_get_their_own_results(cuda, monkeypatch):
    """Serve's request threads fold at once: 12 threads (more than the
    card host's 8 cores), one shape, so one graph, every other thread on a
    stream of its own. The per-graph lock keeps every copy-in, replay and
    clone-out together, and a call waits for the last one's clone-out on
    the device, so each thread gets the fold of its own inputs."""
    import contextlib
    import sys
    import threading

    cases = [_blocks(8, 24, 100 + i, torch.float32, cuda) for i in range(12)]
    merge.fold_tours(*cases[0])  # the capture, before the threads
    want = [_eager(monkeypatch, *c) for c in cases]
    got, errors = [None] * len(cases), []

    torch.cuda.synchronize()

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()) if i % 2 else contextlib.nullcontext():
                for _ in range(5):
                    got[i] = merge.fold_tours(*cases[i])
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_the_inputs_are_not_written(cuda):
    tours, costs, dist = _blocks(6, 12, 5, torch.float32, cuda)
    copies = (tours.clone(), costs.clone(), dist.clone())
    merge.fold_tours(tours, costs, dist)
    torch.cuda.synchronize()
    assert torch.equal(tours, copies[0]) and torch.equal(costs, copies[1]) and torch.equal(dist, copies[2])


def test_warm_entry_captures_without_replaying(cuda):
    x = torch.arange(4.0, device=cuda)

    def bump(t):
        t.add_(1.0)
        return (t,)

    secs = cc.warm_entry("probe_bump", bump, (x,))
    assert secs > 0 and torch.equal(x, torch.arange(4.0, device=cuda))  # nothing replayed on x
    g = cc.aot_load_or_compile("probe_bump", bump, (x,))
    (out,) = g(x, replays=3)
    assert torch.equal(out, x + 3) and torch.equal(x, torch.arange(4.0, device=cuda))


def test_a_failed_capture_raises_naming_the_key(cuda):
    """A host read inside the captured function breaks the capture: the
    store raises, it never hands over to eager dispatch."""
    x = torch.ones(3, device=cuda)

    def reads_the_host(t):
        return (t * float(t.sum()),)

    errors = cc.stats_dict()["aot_errors"]
    with pytest.raises(cc.GraphStoreError, match="capture of probe_sync"):
        cc.aot_load_or_compile("probe_sync", reads_the_host, (x,))
    assert cc.stats_dict()["aot_errors"] == errors + 1
    torch.cuda.synchronize()
    # the device is still usable: a fold through the store still runs
    got = merge.fold_tours(*_blocks(5, 4, 9, torch.float32, cuda))
    assert int(got[1]) == 21

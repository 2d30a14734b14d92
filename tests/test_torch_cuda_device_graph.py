"""The B&B step's graph on the card: the search replayed from one capture.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package:

    python -m pytest tests/test_torch_cuda_device_graph.py -m cuda --noconftest -q

The replayed steps equal the eager steps (``TSP_COMPILE_CACHE=off``) bit
for bit, the whole node buffer included; a second solve of the same key
captures nothing; the kernels' launches are counted at each replay; a
failed capture raises instead of running eagerly; threads solving the
same shapes take turns on the one graph.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels, prim_kernels
from tsp_mpi_reduction_tpu_torch.perf import compile_cache as cc
from tsp_mpi_reduction_tpu_torch.utils import tsplib

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    monkeypatch.delenv("TSP_CONTRACTS", raising=False)
    return torch.device("cuda")


def random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _state(d, k, capacity, bound, device):
    n = d.shape[0]
    bd = bb._bound_setup(d, bound, node_ascent=2, device=device)
    fr = bb.make_root_frontier(n, capacity, bd.min_out.cpu().numpy().astype(np.float64), device, k * n)
    tour = bb.nearest_neighbor_tour(np.asarray(d, np.float64))
    ic = torch.tensor(bb.tour_cost(np.asarray(d, np.float64), tour), dtype=torch.float32, device=device)
    return fr, ic, torch.as_tensor(tour, device=device), torch.as_tensor(np.asarray(d, np.float32), device=device), bd


@pytest.mark.parametrize("name,k,capacity,bound,reorder", [
    ("burma14", 16, 832, "one-tree", 3),
    ("eil51", 256, 51_200, "one-tree", 0),
    ("random13", 8, 384, "min-out", 4),
])
@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_replayed_steps_equal_the_eager_steps(cuda, monkeypatch, name, k, capacity, bound, reorder, kernel):
    d = random_d(13, 1) if name == "random13" else tsplib.embedded(name).distance_matrix()
    n = d.shape[0]
    runs = []
    for cache in (None, "off"):
        if cache:
            monkeypatch.setenv(cc.ENV_VAR, cache)
        fr, ic, tour, d32, bd = _state(d, k, capacity, bound, cuda)
        out = bb._guarded_expand_steps(fr, ic, tour, d32, bd, k, n, 60, reorder, 0, graph=True,
                                       read_every=16, node_ascent=2, mst_kernel="prim_chain",
                                       step_kernel=kernel)
        runs.append(out)
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    (a, *ra), (b, *rb) = runs
    torch.cuda.synchronize()
    assert torch.equal(a.nodes, b.nodes) and torch.equal(a.count, b.count) and torch.equal(a.overflow, b.overflow)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1]) and ra[2:] == rb[2:]
    assert ra[3] > 0  # steps


def test_solves_replay_one_capture_and_count_launches_at_each_replay(cuda, monkeypatch):
    d = tsplib.embedded("ulysses16").distance_matrix()
    kw = dict(capacity=1 << 14, k=64, device=cuda)
    res = []
    for cache in (None, None, "off"):
        if cache:
            monkeypatch.setenv(cc.ENV_VAR, cache)
        prim_kernels.reset_launches()
        expand_kernels.reset_launches()
        guard = contracts.RecompilationGuard({"bnb_step": bb.STEP}, limit=0) if len(res) == 1 else None
        with guard or contextlib.nullcontext():
            r = bb.solve(d, **kw)
        issued = r.replays + r.warm_steps
        assert prim_kernels.LAUNCHES["prim_chain"] == 3 * issued > 0
        assert expand_kernels.LAUNCHES["push_rows"] == issued
        res.append(r)
    graph, again, eager = res
    assert graph.step_graph and again.step_graph and not eager.step_graph
    assert again.warm_steps == 0 and again.capture_seconds == 0.0
    for r in (again, eager):
        assert (r.cost, r.nodes_expanded, r.iterations, r.steps_run, r.replays, r.lower_bound) == (
            graph.cost, graph.nodes_expanded, graph.iterations, graph.steps_run, graph.replays, graph.lower_bound)
        assert (r.tour == graph.tour).all()
    assert graph.proven_optimal and graph.cost == 6859.0


def test_warm_compile_then_solve_captures_nothing(cuda):
    d = tsplib.embedded("burma14").distance_matrix()
    n, k, cap = 14, 32, 4096
    bb.warm_compile_device_solver(n, cap, k, node_ascent=2, device=cuda)
    with contracts.RecompilationGuard({"bnb_step": bb.STEP}, limit=0) as g:
        r = bb.solve(d, capacity=cap, k=k, device=cuda)
    assert g.misses() == {"bnb_step": 0} and r.step_graph and r.warm_steps == 0 and r.proven_optimal


def test_a_failed_capture_raises_and_does_not_run_eagerly(cuda, monkeypatch):
    def bad_step(*args, **kw):
        args[5].add_(1)
        return args[5].sum().item()  # a host read: forbidden while capturing

    monkeypatch.setattr(bb, "STEP", cc.GraphEntry("bnb_step_probe", bad_step))
    d = tsplib.embedded("burma14").distance_matrix()
    with pytest.raises(cc.GraphStoreError, match="capture of bnb_step_probe"):
        bb.solve(d, capacity=4096, k=32, device=cuda, ils_rounds=0)


def test_threads_take_turns_on_one_graph(cuda):
    """12 threads (more than the card host's 8 cores) prove the same
    instance at once, every other one on a stream of its own, with a short
    switch interval: each solve holds the one graph of the key for its
    whole search, so each gets the same proof as a solve alone."""
    import sys

    d = tsplib.embedded("ulysses16").distance_matrix()
    kw = dict(capacity=1 << 14, k=64, device=cuda)
    want = bb.solve(d, **kw)  # captures before the threads
    got, errors = [None] * 12, []

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()) if i % 2 else contextlib.nullcontext():
                got[i] = bb.solve(d, **kw)
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(got))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for r in got:
        assert r.step_graph and r.warm_steps == 0
        assert (r.cost, r.nodes_expanded, r.replays) == (want.cost, want.nodes_expanded, want.replays)
        assert (r.tour == want.tour).all()

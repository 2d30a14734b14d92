"""The sharded B&B round as a replayed program on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package:

    python -m pytest tests/test_torch_cuda_rank_graph.py -m cuda --noconftest -q

The rounds replayed from the store (the batched step's graph and the
round tail's, one variant a balance action) equal the same rounds run
eagerly (``TSP_COMPILE_CACHE=off``) in every reported number; every
action the run can pick is captured at setup and a second solve of the
same key captures nothing; one batched step launches ``prim_chain`` 3
times (node ascent 2) and ``push_rows`` once for all ranks; a tail whose
capture fails raises instead of running eagerly.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels, prim_kernels
from tsp_mpi_reduction_tpu_torch.perf import compile_cache as cc

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


#: the host loop of ``tests/test_torch_sharded.py`` and its spill-forcing
#: device loop, and a one-tree run with the MST screen and node ascent
HOST_KW = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
               node_ascent=0, device_loop=False, max_iters=2_000_000)
SPILL_KW = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=True, reorder_every=8,
                bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)
MST_KW = dict(capacity_per_rank=4096, k=16, inner_steps=8, device_loop=True, bound="one-tree",
              node_ascent=2, max_iters=2_000_000)


def _fields(res) -> dict:
    return dict(cost=res.cost, tour=[int(c) for c in res.tour], proven=res.proven_optimal, lb=res.lower_bound,
                nodes=res.nodes_expanded, per_rank=[int(x) for x in res.nodes_per_rank],
                iterations=res.iterations, steps=res.steps_run, replays=res.replays,
                dispatches=res.dispatches,
                spill=[res.spill_rounds, res.spill_events, res.spill_full_merges, res.spill_bytes_to_host,
                       res.spill_bytes_to_device], balance=res.balance)


@pytest.mark.parametrize("name,inst,kw,balance", [
    ("host-adaptive", (11, 1), HOST_KW, "adaptive"),
    ("device-pair-spill", (12, 7), SPILL_KW, "pair"),
    ("device-ring-mst", (16, 4), MST_KW, "ring"),
])
@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_replayed_rounds_equal_the_eager_rounds(cuda, monkeypatch, name, inst, kw, balance, kernel):
    d = random_d(*inst)
    runs = []
    for cache in (None, "off"):
        if cache:
            monkeypatch.setenv(cc.ENV_VAR, cache)
        runs.append(bb.solve_sharded(d, 4, balance=balance, step_kernel=kernel, mst_kernel="prim_chain",
                                     device="cuda", **kw))
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    replayed, eager = runs
    assert _fields(replayed) == _fields(eager)
    assert replayed.step_graph and not eager.step_graph and replayed.proven_optimal


def test_every_action_is_captured_at_setup_and_a_second_solve_captures_nothing(cuda):
    d = random_d(11, 1)
    kw = dict(HOST_KW, capacity_per_rank=320, balance="adaptive", seed_mode="single-rank")
    steps0, tails0 = bb.STEP._cache_size(), bb.RANK_TAIL._cache_size()
    first = bb.solve_sharded(d, 4, device="cuda", **kw)
    assert bb.STEP._cache_size() - steps0 <= 1 and bb.RANK_TAIL._cache_size() - tails0 <= 1
    stored = [g for g in cc._STORE._graphs.values() if g.name == "bnb_rank_tail"
              and g.inputs[0].shape == (4, 320 + 8 * 11, first_cols(11))]
    assert stored and len(stored[-1].graphs) == 3  # skip, pair, steal
    assert set(first.balance["actions"]) <= {"skip", "pair", "steal"}
    steps1, tails1 = bb.STEP._cache_size(), bb.RANK_TAIL._cache_size()
    second = bb.solve_sharded(d, 4, device="cuda", **kw)
    assert (bb.STEP._cache_size(), bb.RANK_TAIL._cache_size()) == (steps1, tails1)
    assert second.warm_steps == 0 and second.capture_seconds == 0.0
    assert _fields(second) == _fields(first)


def first_cols(n: int) -> int:
    """The packed row width for n cities."""
    return bb._path_words(n) + (n + 31) // 32 + 4


def test_one_batched_step_launches_one_chain_and_one_push_for_all_ranks(cuda):
    d = random_d(16, 4)
    prim_kernels.reset_launches()
    expand_kernels.reset_launches()
    res = bb.solve_sharded(d, 4, balance="pair", step_kernel="fused", mst_kernel="prim_chain", device="cuda",
                           **MST_KW)
    torch.cuda.synchronize()
    issued = res.replays + res.warm_steps
    assert res.proven_optimal and res.step_graph and issued > 0
    assert prim_kernels.LAUNCHES["prim_chain"] == 3 * issued
    assert expand_kernels.LAUNCHES["push_rows"] == issued


def test_a_failed_tail_capture_raises(cuda, monkeypatch):
    def reads_the_host(*args, **kw):
        flags = bb._rank_tail(*args, **kw)
        float(flags.sum())  # a host read inside the capture
        return flags

    monkeypatch.setattr(bb, "RANK_TAIL", cc.GraphEntry("bnb_rank_tail_probe", reads_the_host))
    d = random_d(10, 9)
    with pytest.raises(cc.GraphStoreError, match="capture of bnb_rank_tail_probe"):
        bb.solve_sharded(d, 4, device="cuda", **dict(HOST_KW, capacity_per_rank=296))

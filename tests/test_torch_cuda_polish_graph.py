"""The local search and the device ascent replayed from the graph store.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor the JAX package:

    python -m pytest tests/test_torch_cuda_polish_graph.py -m cuda --noconftest -q

On the card ``polish``, ``two_opt_sweep`` and ``or_opt_sweep`` replay one
captured predicated step (store entry ``polish``) and
``held_karp_potentials`` one captured ascent iteration (entry
``one_tree_ascent``). Each must equal its eager path
(``TSP_COMPILE_CACHE=off``: the nested lane loops, the eager ascent) bit
for bit, capture once per key, and read the host once a run of
``POLISH_READ_STEPS`` steps.
"""

import threading

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu_torch.analysis.contracts import RecompilationGuard
from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.ops import local_search as ls
from tsp_mpi_reduction_tpu_torch.ops import one_tree as ot
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


def _instance(name, batch, seed, device):
    d = torch.as_tensor(tsplib.embedded(name).distance_matrix().astype(np.float32), device=device)
    n = d.shape[0]
    rng = np.random.default_rng(seed)
    tours = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(batch)]), device=device)
    return tours, d


def _eager(monkeypatch, fn, *args, **kw):
    monkeypatch.setenv(cc.ENV_VAR, "off")
    try:
        return fn(*args, **kw)
    finally:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)


def _same(a, b):
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.parametrize("name", ["eil51", "berlin52"])
def test_polish_replayed_equals_eager_and_captures_once(cuda, monkeypatch, name):
    tours, d = _instance(name, 16, 0, cuda)
    before = ls.POLISH._cache_size()
    first = ls.polish(tours, d)
    assert ls.POLISH._cache_size() == before + 1
    with RecompilationGuard({"polish": ls.POLISH}, limit=0) as guard:
        stats = dict(ls.POLISH_STATS)
        second = ls.polish(tours, d)
    assert guard.misses() == {"polish": 0}
    issued = ls.POLISH_STATS["steps"] - stats["steps"]
    assert ls.POLISH_STATS["reads"] - stats["reads"] == issued // ls.POLISH_READ_STEPS
    eager = _eager(monkeypatch, ls.polish, tours, d)
    _same(first, eager)
    _same(second, eager)


def test_sweeps_and_open_segments_replayed_equal_eager(cuda, monkeypatch):
    tours, d = _instance("eil51", 8, 1, cuda)
    for fn, kw in ((ls.two_opt_sweep, {}), (ls.or_opt_sweep, {}),
                   (ls.two_opt_sweep, dict(closed=False, max_iters=256)), (ls.polish, dict(max_rounds=1))):
        _same(fn(tours, d, **kw), _eager(monkeypatch, fn, tours, d, **kw))
    segs = tours[:, :48].reshape(4 * 8, 12)  # segments of global ids, as the ring sweeps them
    _same(ls.two_opt_sweep(segs, d, closed=False, max_iters=256),
          _eager(monkeypatch, ls.two_opt_sweep, segs, d, closed=False, max_iters=256))


def test_a_result_stays_the_callers_and_two_threads_share_a_key(cuda, monkeypatch):
    tours, d = _instance("eil51", 16, 2, cuda)
    other, _ = _instance("eil51", 16, 3, cuda)
    want = [_eager(monkeypatch, ls.polish, t, d) for t in (tours, other)]
    first = ls.polish(tours, d)
    keep = tuple(x.clone() for x in first)
    ls.polish(other, d)  # a later replay writes the graph's buffers, not the result
    _same(first, keep)
    out, errors = [None, None], []

    def run(i, t):
        try:
            with torch.cuda.stream(torch.cuda.Stream()) if i else torch.cuda.stream(torch.cuda.current_stream()):
                out[i] = ls.polish(t, d)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i, t)) for i, t in enumerate((tours, other))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    _same(out[0], want[0])
    _same(out[1], want[1])


def test_ils_on_the_card_equals_the_cpu(cuda):
    d = tsplib.embedded("eil51").distance_matrix()
    np.testing.assert_array_equal(bb.strong_incumbent(d, starts=16, device="cuda"),
                                  bb.strong_incumbent(d, starts=16, device="cpu"))


@pytest.mark.parametrize("steps", [1, 100])
def test_device_ascent_replayed_equals_eager(cuda, monkeypatch, steps):
    d = torch.as_tensor(tsplib.embedded("eil51").distance_matrix().astype(np.float32), device=cuda)
    first = ot.held_karp_potentials(d, steps)
    with RecompilationGuard({"one_tree_ascent": ot.ASCENT}, limit=0) as guard:
        second = ot.held_karp_potentials(d, steps)
    assert guard.misses() == {"one_tree_ascent": 0}
    eager = _eager(monkeypatch, ot.held_karp_potentials, d, steps)
    _same(first, eager)
    _same(second, eager)

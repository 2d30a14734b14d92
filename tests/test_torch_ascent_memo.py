"""The port's root-ascent memo (``perf/ascent_memo.py``) on the CPU.

- a put then a get returns the same bytes, from the in-process LRU and
  from the disk tier;
- the key bytes are the JAX package's: a memo file its
  ``compile_cache.ascent_memo_put`` wrote is read by the port, and the port
  writes the file name the JAX package computes;
- a second ``solve_slice`` of the same instance hits the memo, and the
  hit changes no result (bound tables and root bound bit for bit);
- the drivers' switch: ``TSP_COMPILE_CACHE=off`` leaves the disk tier off.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.perf import compile_cache as jcc
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.perf import ascent_memo as memo


@pytest.fixture(autouse=True)
def _fresh_memo(monkeypatch):
    """Each test starts with an empty LRU and the disk tier off."""
    memo.ascent_memo_reset_memory()
    monkeypatch.setattr(memo, "_enabled_dir", None)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    memo.ascent_memo_reset_memory()


def _d(spec="ulysses16"):
    return jtsplib.resolve_instance(spec).distance_matrix()


def test_roundtrip_identical_bytes(tmp_path, monkeypatch):
    d = _d()
    pi = np.random.default_rng(0).normal(size=d.shape[0])
    assert memo.ascent_memo_get(d, "one-tree", 400) is None  # disk tier off: no miss counted
    memo.ascent_memo_put(d, "one-tree", 400, pi)
    got = memo.ascent_memo_get(d, "one-tree", 400)
    assert got.tobytes() == pi.tobytes()
    got[0] += 1.0  # a caller's copy: the memo keeps its own
    assert memo.ascent_memo_get(d, "one-tree", 400).tobytes() == pi.tobytes()

    monkeypatch.setattr(memo, "_enabled_dir", str(tmp_path))
    memo.ascent_memo_put(d, "one-tree", 400, pi)
    memo.ascent_memo_reset_memory()
    before = memo.STATS.snapshot()
    got = memo.ascent_memo_get(d, "one-tree", 400)  # from disk
    assert got.tobytes() == pi.tobytes()
    assert memo.STATS.snapshot()["ascent_memo_hits"] == before["ascent_memo_hits"] + 1
    assert memo.ascent_memo_get(d, "one-tree", 399) is None  # another key
    assert memo.STATS.snapshot()["ascent_memo_misses"] == before["ascent_memo_misses"] + 1


def test_reads_a_memo_file_the_jax_package_wrote(tmp_path, monkeypatch):
    d = _d("burma14")
    pi = np.linspace(-3.0, 7.0, d.shape[0])
    assert memo.ascent_key(d, "one-tree", 400) == jcc.ascent_key(d, "one-tree", 400)
    monkeypatch.setattr(jcc, "_enabled_dir", str(tmp_path))
    jcc.ascent_memo_put(d, "one-tree", 400, pi)
    jcc.ascent_memo_reset_memory()
    monkeypatch.setattr(memo, "_enabled_dir", str(tmp_path))
    got = memo.ascent_memo_get(d, "one-tree", 400)
    assert got is not None and got.tobytes() == pi.tobytes()
    # and the port's file is the one the JAX package looks for
    memo.ascent_memo_put(_d(), "one-tree", 400, pi[:1].repeat(16))
    assert jcc.ascent_memo_get(_d(), "one-tree", 400).tobytes() == pi[:1].repeat(16).tobytes()
    jcc.ascent_memo_reset_memory()


def test_second_slice_hits_the_memo(tmp_path):
    d = _d("eil51")
    before = memo.STATS.snapshot()["ascent_memo_hits"]
    kw = dict(capacity=1 << 14, k=16, max_iters=2, inner_steps=1, ils_rounds=0, device="cpu")
    res1, handle = tbb.solve_slice(d, 60.0, checkpoint_path=str(tmp_path / "s.npz"), **kw)
    assert handle is not None and memo.STATS.snapshot()["ascent_memo_hits"] == before
    res2, _ = tbb.solve_slice(d, 60.0, handle, **kw)
    assert memo.STATS.snapshot()["ascent_memo_hits"] == before + 1
    assert res2.root_lower_bound == res1.root_lower_bound
    memo.ascent_memo_reset_memory()
    cold = tbb._bound_setup(d, "one-tree", node_ascent=2, device="cpu")
    warm = tbb._bound_setup(d, "one-tree", node_ascent=2, device="cpu")
    for a, b in zip(cold[:7], warm[:7]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert cold.root_lb == warm.root_lb


def test_cache_dir_setting(tmp_path, monkeypatch):
    monkeypatch.setenv(memo.ENV_VAR, "off")
    assert memo.enable() is None and memo.enabled_dir() is None
    monkeypatch.setenv(memo.ENV_VAR, str(tmp_path / "c"))
    assert memo.enable() == str(tmp_path / "c") and (tmp_path / "c").is_dir()
    monkeypatch.delenv(memo.ENV_VAR)
    assert memo.resolve_cache_dir().endswith("build/torch_cache")

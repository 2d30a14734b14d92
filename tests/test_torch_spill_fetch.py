"""The ``spill.fetch`` fault seam of the port's spill readback, against the
JAX package's.

The spill-forcing proof (13 random cities, min-out, k = 8, capacity 384,
the device loop's floor) exchanges rows with the host reservoir 14 times,
each through ``_fetch_live_rows``. A fault on the first crossing is
absorbed by the bounded retry (3 attempts, 5 ms base delay, seed 0) and
the proof lands on the JAX package's numbers under the same fault; a fault
on all three attempts raises in both packages. Only transient faults and
``OSError`` are retried: a CUDA error is sticky and surfaces at once.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.resilience import faults as jfaults
from tsp_mpi_reduction_tpu.resilience.health import HEALTH as JHEALTH
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH

KW = dict(capacity=384, k=8, bound="min-out", mst_prune=False, node_ascent=0, ils_rounds=0,
          max_iters=2_000_000, device_loop=True)
SPILL_FIELDS = ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
                "spill_bytes_to_device")


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path. Once ``compile_cache.enable()``
    has run in this process (an earlier test's serve CLI does), its
    solves would load whatever executables the shared AOT store holds,
    some compiled for an 8-device mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread_no_faults():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()
    torch.set_num_threads(before)


def _d():
    xy = np.random.default_rng(1).uniform(0, 100, (13, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _fields(res):
    return (res.cost, res.proven_optimal, res.nodes_expanded, res.iterations, res.lower_bound,
            tuple(int(x) for x in res.tour), *(getattr(res, f) for f in SPILL_FIELDS))


def test_one_failed_fetch_is_retried_and_lands_on_the_jax_numbers():
    d = _d()
    clean = tbb.solve(d, device="cpu", **KW)
    assert clean.spill_rounds > 0 and clean.proven_optimal
    spec = "spill.fetch:raise,nth=1"
    jfaults.configure(spec)
    j0 = JHEALTH.snapshot()
    want = jbb.solve(d, **KW)
    tfaults.configure(spec)
    t0 = THEALTH.snapshot()
    got = tbb.solve(d, device="cpu", **KW)
    assert _fields(got) == _fields(want) == _fields(clean)
    jh, th = JHEALTH.delta_since(j0), THEALTH.delta_since(t0)
    assert th["retries"] == jh["retries"] == 1
    assert th["faults_injected"]["spill.fetch"] == jh["faults_injected"]["spill.fetch"] == 1
    assert tfaults.registry().hits("spill.fetch") == jfaults.registry().hits("spill.fetch")


def test_a_fault_on_every_attempt_raises_in_both_packages():
    d = _d()
    spec = "spill.fetch:raise,nth=1,count=3"
    jfaults.configure(spec)
    with pytest.raises(jfaults.FaultInjected) as jexc:
        jbb.solve(d, **KW)
    tfaults.configure(spec)
    with pytest.raises(tfaults.FaultInjected) as texc:
        tbb.solve(d, device="cpu", **KW)
    assert (texc.value.seam, texc.value.hit) == (jexc.value.seam, jexc.value.hit) == ("spill.fetch", 3)


def test_a_device_error_is_not_retried(monkeypatch):
    calls = []

    class _Registry:
        def fire(self, seam):
            calls.append(seam)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tbb, "_fault_registry", lambda: _Registry())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tbb._fetch_live_rows(torch.zeros((4, 3), dtype=torch.int32), 2)
    assert calls == ["spill.fetch"]

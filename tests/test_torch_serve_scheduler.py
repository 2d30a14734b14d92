"""The port's micro-batch scheduler on the CPU against the JAX package.

- an HK flush equals, exactly, the JAX package's ``solve_blocks_from_dists``
  on each ticket's own stack, in float32 and float64, and the pad lanes of
  a bucket leave the real lanes as an unpadded solve leaves them;
- batching, grouping by shape, synchronous validation, close, and the
  oversized flush behave as the JAX scheduler's tests pin them;
- the watchdog revives a worker killed by the ``sched.flush`` fault (the
  port's own fault registry) and the re-queued tickets get the right
  answers; ``submit`` revives a dead worker between watchdog ticks;
- ``precompile`` warms each (block size, bucket) through
  ``ops.held_karp.warm_blocks``, and the phase timer mirrors into the
  port's metrics registry;
- the kernel build of ``kernels/_build.py`` is safe under racing first
  calls from 8 threads (the compiler and the loader stubbed).

Blocks are distance matrices of random points made with numpy from a seed.
"""

import ctypes
import pathlib
import subprocess
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import held_karp as jhk
from tsp_mpi_reduction_tpu_torch.kernels import _build
from tsp_mpi_reduction_tpu_torch.obs.metrics import REGISTRY
from tsp_mpi_reduction_tpu_torch.ops import held_karp as thk
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH
from tsp_mpi_reduction_tpu_torch.serve.scheduler import MicroBatchScheduler, Ticket
from tsp_mpi_reduction_tpu_torch.utils.profiling import PhaseTimer


def _stack(b, n, seed):
    rng = np.random.default_rng(seed)
    return distance_matrix_np(rng.uniform(0, 1000, (b, n, 2)))


def _sched(**kw):
    kw.setdefault("device", "cpu")
    return MicroBatchScheduler(**kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_flush_equals_jax_solve_blocks_and_pads_leave_lanes(dtype):
    """Three tickets (1 + 2 + 2 blocks, n = 8) flush as ONE padded batch of
    8 lanes; each ticket's costs and tours equal the JAX package's solve of
    that ticket's stack and the port's unpadded solve, bit for bit."""
    stacks = [_stack(1, 8, 1), _stack(2, 8, 2), _stack(2, 8, 3)]
    with _sched(max_batch=8, max_wait_ms=300.0, buckets=(1, 2, 4, 8), dtype=dtype) as s:
        tickets = [s.submit(st) for st in stacks]
        got = [t.wait(timeout=60.0) for t in tickets]
        stats = s.stats()
    assert stats["batches"] == 1 and stats["blocks_solved"] == 5 and stats["padded_blocks"] == 8
    assert stats["batch_occupancy"] == 5 / 8
    tdt = getattr(torch, dtype)
    for st, (costs, tours) in zip(stacks, got):
        jc, jt = jhk.solve_blocks_from_dists(jnp.asarray(st, dtype), jnp.dtype(dtype))
        assert costs.dtype == np.dtype(dtype) and tours.dtype == np.int32
        np.testing.assert_array_equal(costs, np.asarray(jc))
        np.testing.assert_array_equal(tours, np.asarray(jt))
        uc, ut = thk.solve_blocks_from_dists(torch.as_tensor(st, dtype=tdt), tdt)
        np.testing.assert_array_equal(costs, uc.numpy())
        np.testing.assert_array_equal(tours, ut.numpy())


def test_concurrent_submissions_form_batches():
    ds = _stack(6, 6, 4)
    with _sched(max_batch=8, max_wait_ms=50.0, buckets=(8,)) as s:
        results = [None] * 6

        def go(i):
            results[i] = s.submit(ds[i: i + 1]).wait(timeout=60.0)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = s.stats()
    assert all(r is not None for r in results)
    assert stats["blocks_solved"] == 6 and stats["batches"] < 6
    assert stats["mean_batch_blocks"] > 1.0


def test_mixed_shapes_grouped_separately():
    with _sched(max_batch=8, max_wait_ms=50.0) as s:
        t6, t7 = s.submit(_stack(2, 6, 5)), s.submit(_stack(3, 7, 6))
        (c6, tr6), (c7, tr7) = t6.wait(timeout=60.0), t7.wait(timeout=60.0)
        stats = s.stats()
    assert c6.shape == (2,) and tr6.shape == (2, 7)
    assert c7.shape == (3,) and tr7.shape == (3, 8)
    assert stats["batches"] == 2


def test_submit_validation_is_synchronous_and_close_fails_pending():
    with _sched(max_batch=4) as s:
        for bad in (np.zeros((6, 6)), np.zeros((1, 6, 5)), np.zeros((1, 2, 2)),
                    np.zeros((1, 19, 19)), np.zeros((0, 6, 6))):
            with pytest.raises(ValueError):
                s.submit(bad)
    s = _sched(max_wait_ms=10_000.0)
    s.close()
    with pytest.raises(RuntimeError):
        s.submit(np.zeros((1, 6, 6)))
    s.close()  # idempotent


def test_oversized_submission_flushes_alone():
    with _sched(max_batch=2, max_wait_ms=1.0, buckets=(2, 4)) as s:
        got = s.submit(_stack(3, 6, 7)).wait(timeout=60.0)
    assert got is not None and got[0].shape == (3,)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_revives_worker_killed_by_flush_fault():
    """sched.flush:raise kills the worker with the group in flight; the
    watchdog re-queues it and a fresh generation answers every ticket
    with the JAX package's costs."""
    ds = _stack(2, 7, 8)
    tfaults.configure("sched.flush:raise")
    try:
        before = THEALTH.get("worker_restarts")
        with _sched(max_batch=2, max_wait_ms=5.0, buckets=(2,), watchdog_interval_s=0.05) as s:
            tickets = [s.submit(ds[i: i + 1]) for i in range(2)]
            results = [t.wait(timeout=60.0) for t in tickets]
            stats = s.stats()
        assert tfaults.registry().hits("sched.flush") >= 2
    finally:
        tfaults.clear()
    assert all(r is not None for r in results)
    want, _ = jhk.solve_blocks_from_dists(jnp.asarray(ds, jnp.float32), jnp.float32)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in results]), np.asarray(want))
    assert stats["worker_restarts"] >= 1
    assert THEALTH.get("worker_restarts") > before


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_submission_after_worker_death_revives_without_watchdog_tick():
    ds = _stack(2, 6, 9)
    tfaults.configure("sched.flush:raise")
    try:
        with _sched(max_batch=1, max_wait_ms=1.0, buckets=(1,), watchdog_interval_s=3600.0) as s:
            t1 = s.submit(ds[0:1])
            time.sleep(0.3)  # the worker pops t1, hits the seam and dies
            t2 = s.submit(ds[1:2])  # revives the worker and re-queues t1
            r2, r1 = t2.wait(timeout=60.0), t1.wait(timeout=60.0)
    finally:
        tfaults.clear()
    assert r1 is not None and r2 is not None


def test_ticket_outcome_is_first_writer_wins():
    t = Ticket(np.zeros((1, 4, 4)))
    t._resolve(np.asarray([1.5]), np.asarray([[0, 1, 2, 3, 0]]))
    t._fail(RuntimeError("stale generation's late failure"))
    assert float(t.wait(timeout=1.0)[0][0]) == 1.5
    t2 = Ticket(np.zeros((1, 4, 4)))
    t2._fail(RuntimeError("real failure"))
    t2._resolve(np.asarray([9.9]), np.asarray([[0, 1, 2, 3, 0]]))
    with pytest.raises(RuntimeError, match="real failure"):
        t2.wait(timeout=1.0)


def test_precompile_warms_every_bucket_and_mirrors_phases():
    timer = PhaseTimer(mirror_metric="phase_seconds_total")
    before = REGISTRY.value("phase_seconds_total", phase="serve.batch_solve")
    with _sched(max_batch=4, buckets=(1, 2, 4), timer=timer) as s:
        # 2 is below the block-size floor and skipped; 5 and 6 warm 3 buckets each
        assert s.precompile([2, 5, 6]) == 6
        stats = s.stats()
        s.submit(_stack(1, 5, 10)).wait(timeout=60.0)
    assert stats["precompiled_buckets"] == 6 and stats["precompile_seconds"] >= 0.0
    assert thk.warm_blocks(5, 2, "float64", "cpu") > 0.0
    seconds = timer.snapshot()["serve.batch_solve"]
    assert seconds > 0.0
    assert REGISTRY.value("phase_seconds_total", phase="serve.batch_solve") - before == pytest.approx(seconds)


# --------------------------------------------------------------------------- the kernel build


class _FakeLib:
    """Stands in for a ``ctypes.CDLL``: takes the loaders' argtypes/restype."""

    loads = []

    def __init__(self, path):
        self.path = path
        _FakeLib.loads.append(path)

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_kernel_build_survives_racing_first_calls(tmp_path, monkeypatch):
    """8 threads race the first calls of the three loaders and of
    ``build``: each library is loaded once and every thread gets the same
    object; no two compiler runs write one temp file (the temp name
    carries the pid and the thread id); every library lands under its
    ``_lib_path`` name and no temp is left behind."""
    outs = []
    lock = threading.Lock()

    def fake_run(cmd, capture_output, text):
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        with lock:
            outs.append(out)
        time.sleep(0.02)
        out.write_bytes(b"not a real library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "subprocess", types.SimpleNamespace(run=fake_run))
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(
        CDLL=_FakeLib, c_void_p=ctypes.c_void_p, c_int=ctypes.c_int, c_char_p=ctypes.c_char_p))
    loaders = (_build.library, _build.prim_library, _build.push_library)
    _FakeLib.loads = []
    for f in loaders:
        f.cache_clear()
    barrier = threading.Barrier(8)
    got, errors = [None] * 8, []

    def race(i):
        try:
            barrier.wait()
            got[i] = [f() for f in (loaders if i % 2 else loaders[::-1])]
            _build.build(_build.SOURCES[i % 3])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=race, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for f in loaders:
            f.cache_clear()
    assert not errors, errors
    libs = [_build._lib_path(src) for src in _build.SOURCES]
    assert sorted(_FakeLib.loads) == sorted(str(p) for p in libs)  # each loaded once
    for g in got:
        assert g is not None and {lib.path for lib in g} == {str(p) for p in libs}
        assert all(a is b for a, b in zip(sorted(g, key=lambda x: x.path), sorted(got[0], key=lambda x: x.path)))
    assert len(outs) == len(set(outs)) >= 3  # one temp per compiler run
    assert all(o.suffix == ".tmp" and o.parent == tmp_path for o in outs)
    assert all(p.exists() for p in libs) and not list(tmp_path.glob("*.tmp"))
    names = set()
    alive = threading.Barrier(4)  # all alive at once: no thread id is reused

    def name(_):
        alive.wait()
        names.add(_build._tmp_path(libs[0]).name)
        alive.wait()

    workers = [threading.Thread(target=name, args=(i,)) for i in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert len(names) == 4

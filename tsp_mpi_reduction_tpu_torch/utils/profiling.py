"""Per-phase wall-clock timing.

The reference's only observability is one timer around everything
(tsp.cpp:275-276,360-363). Every port pipeline reports seconds per named
phase. PyTorch returns before the device finishes, so each phase ends by
synchronising the timer's device — the counterpart of JAX's
``block_until_ready`` — and a phase's time includes its device work.
:func:`device_trace` is the ``--trace`` capture (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import threading
import time
import os
from typing import Dict, Iterator, Optional

import torch

from .backend import synchronize


class PhaseTimer:
    """Accumulates seconds per named phase; re-entering a name adds to it.

    >>> timer = PhaseTimer(device="cpu")
    >>> with timer.phase("solve"):
    ...     ...
    >>> sorted(timer.seconds)
    ['solve']

    Thread-safe: the read-modify-write into ``seconds`` holds a lock.

    ``mirror_metric``: when set, every :meth:`add` also increments the
    counter series ``<mirror_metric>{phase=<name>}`` in the process-global
    obs registry (``tsp_mpi_reduction_tpu/utils/profiling.py:48-75``), so
    the phase table has the registry's snapshot/delta semantics too.
    """

    def __init__(self, device: Optional[torch.device] = None,
                 mirror_metric: Optional[str] = None) -> None:
        self.seconds: Dict[str, float] = {}
        self.device = torch.device(device) if device is not None else None
        self.mirror_metric = mirror_metric
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None:
                synchronize(self.device)
            self.add(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, float]:
        """Copy of the phase table taken under the lock."""
        with self._lock:
            return dict(self.seconds)

    def add(self, name: str, seconds: float) -> None:
        """Accumulate an externally measured duration into a phase."""
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        if self.mirror_metric:
            from ..obs import enabled as _obs_enabled
            from ..obs.metrics import REGISTRY

            if _obs_enabled():
                REGISTRY.inc(self.mirror_metric, max(seconds, 0.0), phase=name)


#: is a :func:`device_trace` capture running? (``obs.tracing``'s step
#: annotations exist exactly when there is a profiler to consume them)
_TRACE_ACTIVE = False

#: the Chrome/Perfetto trace file of a capture, under its ``trace_dir``
TRACE_FILE = "trace.json"


def trace_active() -> bool:
    return _TRACE_ACTIVE


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device=None) -> Iterator[None]:
    """``torch.profiler`` capture of the block, exported as a Chrome/Perfetto
    trace JSON to ``trace_dir/trace.json``; a no-op for None.

    CPU activity always, CUDA activity too when ``device`` is a CUDA device
    (default: whenever CUDA is available). While it runs, the B&B loops
    wrap every expansion step in a ``bnb_step#<i>`` range
    (``obs.tracing.step_annotation_factory``).
    """
    global _TRACE_ACTIVE
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    _TRACE_ACTIVE = True
    try:
        with profile(activities=activities) as prof:
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        _TRACE_ACTIVE = False
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))

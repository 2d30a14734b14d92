"""Per-phase wall-clock timing.

The reference's only observability is one timer around everything
(tsp.cpp:275-276,360-363). Every port pipeline reports seconds per named
phase. PyTorch returns before the device finishes, so each phase ends by
synchronising the timer's device — the counterpart of JAX's
``block_until_ready`` — and a phase's time includes its device work.
"""

from __future__ import annotations

import contextlib
import threading
import time
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
    """

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.seconds: Dict[str, float] = {}
        self.device = torch.device(device) if device is not None else None
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

"""resilience/: fault injection, crash-safe checkpoints, self-healing.

The north star is a service under heavy traffic, where preemption,
truncated writes, dead worker threads, and flaky transfers are routine —
this package makes those failures (a) survivable and (b) *testable*:

- ``faults``      deterministic ``TSP_FAULTS`` injection registry with a
                  named seam at every durability/transfer boundary
- ``checkpoint``  atomic-publish checkpoint store: integrity header,
                  instance fingerprint, last-N rotation, fallback restore
- ``retry``       bounded exponential backoff + seeded jitter for
                  transient faults
- ``health``      process-global self-healing counters (worker restarts,
                  retries, fallback restores, injected faults)

Everything here is numpy/stdlib-only — importable by lint-stage tooling
and light drivers (``tools/bnb_chunked.py``) without importing torch.
"""

from .checkpoint import (
    CheckpointError,
    instance_fingerprint,
    read_header,
    read_with_fallback,
    write_atomic,
    write_json_atomic,
)
from .faults import SEAMS, FaultInjected, FaultRegistry, TransientFault, registry
from .health import HEALTH, HealthCounters
from .retry import RetryPolicy

__all__ = [
    "CheckpointError",
    "instance_fingerprint",
    "read_header",
    "read_with_fallback",
    "write_atomic",
    "write_json_atomic",
    "SEAMS",
    "FaultInjected",
    "FaultRegistry",
    "TransientFault",
    "registry",
    "HEALTH",
    "HealthCounters",
    "RetryPolicy",
]

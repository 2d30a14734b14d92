"""Telemetry of the port: the metrics registry and span tracing.

Counterpart of ``tsp_mpi_reduction_tpu/obs``, as far as the B&B
checkpoint paths and the chunked campaign need it:

- :mod:`.metrics` — the process-global :data:`~.metrics.REGISTRY` of
  counters / gauges / histograms with labeled series, snapshot/delta
  semantics and two exporters (structured JSON, Prometheus text). The
  ``resilience.health`` counters record into it.
- :mod:`.tracing` — span tracing with propagated trace/span IDs, emitted
  as JSONL to the ``TSP_TRACE`` sink; injected faults surface as span
  events. It also propagates across PROCESSES through the
  ``TSP_TRACE_PARENT=<trace_id>:<span_id>`` env contract, so a chunked
  campaign (``tools/bnb_chunked.py``) reconstructs as one span tree.

- :mod:`.slo` — per-tier latency objectives of the serve layer: the
  session verdicts (:func:`~.slo.evaluate`) and the live burn meter the
  scheduler and the ladder steer by (:class:`~.slo.BurnMeter`).

Not ported yet: the time-series sampler, the stall sentinel, and the
rank and bench-history views.

Gating: ``TSP_OBS=off`` disables the *optional-overhead* telemetry (span
tracing). Plain registry counters stay on regardless: correctness paths
and the stats JSON depend on them, and they cost one locked dict add per
*event* (a save, a restore, a fault), never per expansion step.
"""

from __future__ import annotations

import os
from typing import Optional

#: env knob: "off"/"0"/"false"/"none" disables tracing (counters stay on;
#: see module docstring)
ENV_VAR = "TSP_OBS"
_OFF = ("off", "0", "false", "none", "disabled")

_override: Optional[bool] = None


def enabled() -> bool:
    """Is the optional-overhead telemetry (tracing) on?"""
    if _override is not None:
        return _override
    return os.environ.get(ENV_VAR, "on").strip().lower() not in _OFF


def set_enabled(value: Optional[bool]) -> None:
    """Programmatic override for benches/tests (None = back to the env)."""
    global _override
    _override = value

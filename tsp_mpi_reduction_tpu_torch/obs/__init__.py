"""Telemetry of the port: metrics, tracing, the B&B line's series and views.

Counterpart of ``tsp_mpi_reduction_tpu/obs``:

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
- :mod:`.timeseries` — the B&B host loops' ring-buffered sampler, one
  row a dispatch (nodes/s, frontier occupancy, spill bytes each way,
  incumbent and certified floor), flushed as ``series``.
- :mod:`.anomaly` — the sentinels that watch it: nodes/s collapse and
  certified-LB stagnation, and per-rank starvation, fired on the health
  block, the registry, the active span and ``anomalies``.
- :mod:`.rankview` — the sharded search's per-rank windows
  (``rank_series``), fed by ``parallel.reduce.make_rank_stats``, and the
  imbalance block ``obs.rank_balance``.
- :mod:`.costs` — the hand kernels' analytic flops, bytes and roofline
  estimate per kernel and shape (``obs.device_costs``).
- :mod:`.bench_history` — the bench history (``bench_history_torch.jsonl``)
  that ``tools/bench.py`` appends to, and the median/MAD regression gate
  that ``tools/bench_check.py`` runs on it; stdlib only, so importing it
  (this package does not) loads no torch.

Gating: ``TSP_OBS=off`` disables the *optional-overhead* telemetry (span
tracing, the sampler, the sentinels and the rank view: their result
blocks are then None). Plain registry counters stay on regardless:
correctness paths and the stats JSON depend on them, and they cost one
locked dict add per *event* (a save, a restore, a fault), never per
expansion step.
"""

from __future__ import annotations

import os
from typing import Optional

#: env knob: "off"/"0"/"false"/"none" disables tracing, the sampler and the
#: rank view (counters stay on; see module docstring)
ENV_VAR = "TSP_OBS"
_OFF = ("off", "0", "false", "none", "disabled")

_override: Optional[bool] = None


def enabled() -> bool:
    """Is the optional-overhead telemetry (tracing, sampler, rank view) on?"""
    if _override is not None:
        return _override
    return os.environ.get(ENV_VAR, "on").strip().lower() not in _OFF


def set_enabled(value: Optional[bool]) -> None:
    """Programmatic override for benches/tests (None = back to the env)."""
    global _override
    _override = value

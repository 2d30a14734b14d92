"""Process-global self-healing telemetry (the ``health`` counter block).

Every recovery action the resilience subsystem takes — a transient
fault absorbed by a retry, a corrupt checkpoint skipped in favor of an
older valid snapshot, a fault actually injected by the registry —
increments a counter here. ``tools/bnb_solve.py`` surfaces the block in
its JSON line, so a chaos run (or a production incident) leaves a
machine-readable trace of what self-healed, not just a green exit code.

The counters are REGISTRY-BACKED: :class:`HealthCounters` is a view over
the process-global ``obs.metrics.REGISTRY`` series
``health_events_total{event=…}`` / ``health_faults_injected_total{seam=…}``
rather than its own dict, which buys snapshot/delta semantics: a caller
reports :meth:`HealthCounters.delta_since` its own start baseline. The
standard counters keep the JAX package's names (serve and fleet ones
included), so the two packages' blocks read alike.
"""

from __future__ import annotations

from typing import Dict

from ..obs import metrics as _metrics

#: always-present counter names (scrapers see explicit zeros)
STANDARD_COUNTERS = (
    "worker_restarts",
    "stuck_restarts",
    "retries",
    "fallback_restores",
    # fleet self-healing: replica processes restarted by the
    # supervisor, in-flight requests re-dispatched off a dead/wedged
    # replica, and requests the front answered locally (cache / greedy)
    # because the fleet was degraded. Mirrored as the registry metrics
    # ``fleet_replica_restarts_total`` / ``fleet_redispatches_total`` /
    # ``fleet_degraded_answers_total{reason=}`` by fleet.front.
    "fleet_replica_restarts",
    "fleet_redispatches",
    "fleet_degraded_answers",
    # iteration-level serving: B&B rungs preempted at a slice
    # boundary via the donated checkpoint path, those slices resumed
    # bit-identically, and new admissions shed/degraded by the live SLO
    # burn signal. Mirrored as ``serve_bnb_preemptions_total`` /
    # ``serve_bnb_resumes_total`` / ``serve_flushes_total{cause=slo_shed}``
    # by serve.scheduler.
    "bnb_preemptions",
    "bnb_resumes",
    "slo_sheds",
)

EVENTS_METRIC = "health_events_total"
FAULTS_METRIC = "health_faults_injected_total"


class HealthCounters:
    """Named self-healing counters + a per-seam injected-fault tally,
    stored in the obs metrics registry (thread-safe there)."""

    def __init__(self, registry: _metrics.MetricsRegistry = _metrics.REGISTRY):
        self._reg = registry
        registry.declare(
            EVENTS_METRIC, "counter",
            "self-healing actions taken, by event kind",
        )
        registry.declare(
            FAULTS_METRIC, "counter",
            "faults actually injected by the TSP_FAULTS registry, by seam",
        )

    def incr(self, name: str, n: int = 1) -> None:
        self._reg.inc(EVENTS_METRIC, n, event=name)

    def incr_fault(self, seam: str) -> None:
        self._reg.inc(FAULTS_METRIC, 1, seam=seam)

    def get(self, name: str) -> int:
        return int(self._reg.value(EVENTS_METRIC, event=name))

    def snapshot(self) -> Dict:
        """One JSON-ready dict: the standard counters (always present, so
        scrapers see explicit zeros) plus any ad-hoc ones and the per-seam
        injected-fault map."""
        out: Dict = {k: 0 for k in STANDARD_COUNTERS}
        for key, v in self._reg.series(EVENTS_METRIC).items():
            out[dict(key).get("event", "?")] = int(v)
        out["faults_injected"] = {
            dict(key).get("seam", "?"): int(v)
            for key, v in self._reg.series(FAULTS_METRIC).items()
        }
        return out

    def delta_since(self, baseline: Dict) -> Dict:
        """The same shape as :meth:`snapshot`, minus ``baseline`` (a prior
        snapshot). Clamped at zero so a mid-window reset cannot report
        negative healing. This is what a serve session's stats JSON
        carries: the session's OWN recovery actions, not the process's."""
        now = self.snapshot()
        out: Dict = {
            k: max(int(v) - int(baseline.get(k, 0)), 0)
            for k, v in now.items()
            if k != "faults_injected"
        }
        base_faults = baseline.get("faults_injected", {})
        out["faults_injected"] = {
            seam: max(int(v) - int(base_faults.get(seam, 0)), 0)
            for seam, v in now["faults_injected"].items()
        }
        return out

    def reset(self) -> None:
        self._reg.clear_metric(EVENTS_METRIC)
        self._reg.clear_metric(FAULTS_METRIC)

    #: the per-test boundary hook
    reset_for_testing = reset


#: the process-global instance every layer reports into.
HEALTH = HealthCounters()

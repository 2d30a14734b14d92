"""Replica supervision: liveness probing, bounded-backoff restart,
death-driven re-dispatch hand-off.

The port of ``tsp_mpi_reduction_tpu/fleet/supervisor.py``: the serve
scheduler's watchdog generalized from a worker THREAD to a worker
PROCESS. One monitor thread walks the replica set every
``probe_interval_s`` and

- declares a replica **dead** when ``poll()`` returns (crash, injected
  ``replica.kill``, OOM-kill);
- declares it **wedged** when it is alive to ``poll()`` but has carried
  in-flight requests past ``wedge_timeout_s`` with no response flow in
  that window (SIGSTOP via ``replica.hang``, a hung device call) —
  wedged replicas are SIGKILLed and handled as deaths, the scheduler's
  stuck-worker recipe at process granularity;
- scrapes each healthy replica's ``/metrics.json`` (when announced) so
  the fleet stats block always carries fresh per-replica totals, and so
  a stalled HTTP endpoint contributes wedge evidence.

Restarts use the ``resilience/retry.py`` backoff curve per replica:
attempt k waits ``min(base * 2^(k-1), max)`` with the policy's seeded
jitter, so a crash-looping replica cannot spin the host, and a replica
that stays healthy for ``healthy_reset_s`` earns its backoff back. Every
respawn counts into ``HEALTH.fleet_replica_restarts`` and
``fleet_replica_restarts_total``.

On death the supervisor DRAINS the replica's in-flight table and hands
the fleet ids to the front's ``on_death`` callback, which aborts the
affected tickets so their waiting request threads re-dispatch
immediately (deadline-aware — see ``fleet.front``) instead of burning
their hop timeout against a corpse.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..obs.metrics import REGISTRY as _REGISTRY
from ..resilience.health import HEALTH
from ..resilience.retry import RetryPolicy
from .replica import Replica, ReplicaSpec

#: bounded death reasons (metric label cardinality stays fixed)
DEATH_REASONS = ("exit", "wedged", "injected_kill")


@dataclass
class SupervisorConfig:
    probe_interval_s: float = 0.2
    #: in-flight age AND response silence past this = wedged
    wedge_timeout_s: float = 30.0
    #: no wedge verdicts this soon after spawn: a cold replica (torch
    #: import, CUDA context, kernel-library load, warm-up solves) is
    #: legitimately silent for seconds, and killing it re-pays the very
    #: startup that made it slow — the scheduler watchdog's rule (a
    #: long cold start must not cascade phantom restarts) at process
    #: granularity.
    startup_grace_s: float = 30.0
    restart_backoff_base_s: float = 0.5
    restart_backoff_max_s: float = 10.0
    #: a replica alive this long after spawn resets its backoff curve
    healthy_reset_s: float = 30.0
    scrape_timeout_s: float = 0.75
    #: scrape cadence per replica (the probe tick can be much faster —
    #: a wedged replica's probe blocks its whole HTTP timeout, so
    #: scraping every tick would stall fleet-wide death detection)
    scrape_interval_s: float = 1.0


class ReplicaSupervisor:
    """Owns the replica set and the monitor thread."""

    def __init__(
        self,
        specs: List[ReplicaSpec],
        cfg: SupervisorConfig,
        on_response: Callable[[str, Dict, Replica], None],
        on_death: Callable[[Replica, List[str], str], None],
    ) -> None:
        self.cfg = cfg
        self._on_death = on_death
        self.replicas = [
            Replica(i, spec, on_response) for i, spec in enumerate(specs)
        ]
        #: the backoff curve (delay_s only — the supervisor schedules its
        #: own sleeps; RetryPolicy.call would block the monitor thread)
        self._backoff = RetryPolicy(
            max_attempts=1_000_000,
            base_delay_s=cfg.restart_backoff_base_s,
            max_delay_s=cfg.restart_backoff_max_s,
            seed=0,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _REGISTRY.declare(
            "fleet_replica_restarts_total", "counter",
            "replica processes restarted by the fleet supervisor",
        )
        _REGISTRY.declare(
            "fleet_replica_deaths_total", "counter",
            "replica deaths observed by the supervisor, by reason",
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for rep in self.replicas:
            rep.spawn()
        self._thread = threading.Thread(
            target=self._monitor, name="fleet-supervisor", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for rep in self.replicas:
            rep.terminate()

    def alive_count(self) -> int:
        return sum(1 for rep in self.replicas if rep.alive())

    def pick(self, exclude: Optional[Replica] = None) -> Optional[Replica]:
        """Least-loaded alive replica, preferring any over ``exclude``
        (a re-dispatch should land on a DIFFERENT replica when one
        exists — the excluded one just failed this request)."""
        alive = [rep for rep in self.replicas if rep.alive()]
        if not alive:
            return None
        preferred = [rep for rep in alive if rep is not exclude] or alive
        with_load = [(rep.inflight_count(), rep.idx, rep) for rep in preferred]
        return min(with_load)[2]

    def snapshot(self) -> List[Dict]:
        return [rep.snapshot() for rep in self.replicas]

    # -- injected faults (the front's seam translations) ---------------------

    def kill_replica(self, rep: Replica, reason: str = "injected_kill") -> None:
        """SIGKILL now and run death handling immediately — the chaos
        path must not wait a probe interval to start healing."""
        rep.kill()
        self._handle_death(rep, reason)

    def suspend_replica(self, rep: Replica) -> None:
        """SIGSTOP — detected later by the wedge rule, exactly like a
        real hang would be."""
        rep.suspend()

    # -- monitor loop --------------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_s):
            now = time.monotonic()
            for rep in self.replicas:
                self._probe_one(rep, now)

    def _probe_one(self, rep: Replica, now: float) -> None:
        if not rep.running():
            due = rep.restart_due(now)
            if due is None:
                # death not yet handled (a crash the front didn't cause)
                self._handle_death(rep, "exit")
            elif due:
                self._respawn(rep)
            return
        # scrape FIRST (rate-limited): the totals feed the stats block,
        # and the probe's consecutive-failure count is the wedge rule's
        # second signal
        if rep.spec.scrape and rep.scrape_due(now, self.cfg.scrape_interval_s):
            rep.scrape(self.cfg.scrape_timeout_s)
        # wedge rule — in-flight work aged past the threshold AND no
        # response flow in that window (a long exact solve keeps
        # producing OTHER responses; a SIGSTOP produces nothing), with a
        # startup grace so a cold process is never killed for booting.
        # When the replica exposes a metrics endpoint, a RESPONSIVE
        # scrape vetoes the verdict: a replica paying a long first
        # compile still answers HTTP from its daemon thread, while a
        # SIGSTOPped (or truly hung) process times the probe out — so
        # slow stays alive and stuck gets killed, the watchdog's distinction
        # at process granularity.
        oldest = rep.oldest_inflight_age(now)
        wedged = (
            rep.age_since_spawn(now) > self.cfg.startup_grace_s
            and oldest is not None
            and oldest > self.cfg.wedge_timeout_s
            and rep.response_idle_age(now) > self.cfg.wedge_timeout_s
        )
        # the veto needs a KNOWN endpoint: before the replica announces
        # its port, the probe cannot distinguish slow from stuck, so the
        # timing rule stands alone (a replica hung before announcing
        # would otherwise be un-killable — scrape() counts no failures
        # while the port is unknown, and the veto would hold forever)
        if (
            wedged
            and rep.spec.scrape
            and rep.metrics_port_known()
            and rep.consecutive_scrape_failures() < 2
        ):
            wedged = False  # endpoint still answering: slow, not stuck
        if wedged:
            HEALTH.incr("stuck_restarts")
            rep.kill()
            self._handle_death(rep, "wedged")
            return
        rep.maybe_reset_backoff(now, self.cfg.healthy_reset_s)

    def _handle_death(self, rep: Replica, reason: str) -> None:
        """Schedule the backoff respawn and hand the in-flight work back
        to the front. Idempotent per death: a second observer finds the
        restart already scheduled and the in-flight table drained."""
        # jitter RNG seeded per (replica, attempt): deterministic replay
        # (chaos runs) without a monitor/request-thread-shared Random
        attempt = rep.schedule_restart(
            lambda k: self._backoff.delay_s(
                k, random.Random((rep.idx << 16) | k)
            )
        )
        if attempt is None:
            return  # already handled
        _REGISTRY.inc(
            "fleet_replica_deaths_total",
            reason=reason if reason in DEATH_REASONS else "exit",
        )
        fids = rep.drain_in_flight()
        self._on_death(rep, fids, reason)

    def _respawn(self, rep: Replica) -> None:
        rep.spawn()
        rep.note_respawned()
        HEALTH.incr("fleet_replica_restarts")
        _REGISTRY.inc("fleet_replica_restarts_total")

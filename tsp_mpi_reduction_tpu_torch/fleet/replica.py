"""One serve replica: a subprocess speaking the JSONL serve contract.

The port of ``tsp_mpi_reduction_tpu/fleet/replica.py``. A replica is the
port's ``SolveService`` running under its serve CLI
(``python -m tsp_mpi_reduction_tpu_torch serve --in - --out -``): the
front writes request lines to its stdin and a reader thread parses
response lines off its stdout, resolving fleet tickets by fleet-assigned
request id. Stderr is also read: the serve CLI announces its ephemeral
metrics endpoint there (``metrics: http://127.0.0.1:PORT/metrics``, the
JAX package's text), which is how the supervisor learns each replica's
scrape target without port coordination; the last few other stderr lines
are retained for death diagnostics.

Liveness evidence this class maintains (all under one lock — request
threads, the reader threads, and the supervisor's monitor thread all
touch it):

- process state (``proc.poll()``);
- per-request in-flight table (fleet id -> dispatch timestamp) — the
  supervisor drains it on death so the front can re-dispatch;
- response-flow recency (``last_response_at``) — a wedged-but-alive
  process (SIGSTOP, a hung device call) stops producing responses
  while ``poll()`` stays None;
- ``/metrics.json`` scrape totals + consecutive-failure count, and the
  slot's totals over every generation (:meth:`Replica.scrape_lifetime`):
  a killed process takes its counters with it, so a fleet-wide count
  read from the live processes alone misses the work of every replica
  that was restarted.

The command line is injectable (:class:`ReplicaSpec`) so tests can run a
lightweight stub replica without paying a torch import and a CUDA
context per process; the front builds the real serve argv by default.
Plain stdlib: the front process never touches the device.
"""

from __future__ import annotations

import collections
import json
import re
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..resilience.faults import TransientFault

#: the serve CLI's stderr announcement of its bound metrics port
_METRICS_LINE = re.compile(r"metrics: http://127\.0\.0\.1:(\d+)/metrics")


@dataclass
class ReplicaSpec:
    """How to launch one replica process."""

    argv: List[str]
    env: Optional[Dict[str, str]] = None
    #: parse the metrics announcement off stderr and scrape
    #: ``/metrics.json`` as the second liveness probe (the real serve
    #: CLI); False for stub replicas without a metrics endpoint
    scrape: bool = True
    #: extra labels for stats (e.g. the backend) — informational only
    meta: Dict[str, str] = field(default_factory=dict)


def _summarize_metrics(data: Dict) -> Dict[str, int]:
    """Reduce a ``/metrics.json`` snapshot to the per-replica totals the
    fleet stats block (and ``obs_report --fleet``) renders."""

    def total(name: str, **want) -> int:
        out = 0.0
        for entry in data.get(name, {}).get("series", []):
            labels = entry.get("labels", {})
            if all(labels.get(k) == v for k, v in want.items()):
                out += entry.get("value", 0.0)
        return int(out)

    return {
        "responses": total("serve_responses_total"),
        "errors": total("serve_errors_total"),
        "deadline_misses": total("serve_deadline_misses_total"),
        "cache_hits": total("serve_cache_lookups_total", result="hit"),
        "cache_misses": total("serve_cache_lookups_total", result="miss"),
        # disk-tier traffic: a replica's shared hit means ANOTHER process
        # published the entry (its own publishes land in its L1 first) —
        # the cross-replica cache-serving evidence the fleet bench gates
        "shared_cache_hits": total(
            "fleet_shared_cache_ops_total", op="get", outcome="hit"
        ),
        "shared_cache_publishes": total(
            "fleet_shared_cache_ops_total", op="put", outcome="published"
        ),
    }


class Replica:
    """Process handle + pipes + liveness bookkeeping for one replica."""

    def __init__(
        self,
        idx: int,
        spec: ReplicaSpec,
        on_response: Callable[[str, Dict, "Replica"], None],
    ) -> None:
        self.idx = idx
        self.spec = spec
        self._on_response = on_response
        self._lock = threading.Lock()
        #: serializes stdin WRITES only — kept separate from the state
        #: lock because a pipe write can BLOCK (a wedged replica that
        #: stopped draining stdin, OS buffer full), and a blocked writer
        #: holding the state lock would also block the supervisor's
        #: probes, making the very wedge-kill that would unblock the
        #: write impossible (fleet-wide deadlock)
        self._write_lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        self.generation = 0
        #: fleet id -> monotonic dispatch timestamp
        self.in_flight: Dict[str, float] = {}
        self.last_response_at: float = 0.0
        self.started_at: float = 0.0
        self.metrics_port: Optional[int] = None
        self.scrape_totals: Dict[str, int] = {}
        #: the generation ``scrape_totals`` was read from, and the last
        #: totals of every earlier generation, summed
        self._scrape_gen = 0
        self._scrape_carried: Dict[str, int] = {}
        self.scrape_failures = 0
        self._last_scrape_attempt = 0.0
        self.restarts = 0
        self.restart_attempt = 0
        self.restart_due_at: Optional[float] = None
        self.suspected_wedged = False
        self.dispatched = 0
        self.answered = 0
        self._stderr_tail: "collections.deque[str]" = collections.deque(maxlen=8)

    # -- lifecycle -----------------------------------------------------------

    def spawn(self) -> None:
        """Start (or restart) the subprocess and its reader threads."""
        with self._lock:
            self.generation += 1
            gen = self.generation
            # a send() racing the death drain can slip one last entry in
            # (poll() lags a SIGKILL) — nothing will ever answer it, so
            # clear here or it ages into false wedge evidence forever
            self.in_flight.clear()
            self.metrics_port = None
            self.scrape_failures = 0
            self._last_scrape_attempt = 0.0
            self.suspected_wedged = False
            self.started_at = time.monotonic()
            self.last_response_at = self.started_at
            self.restart_due_at = None
            proc = subprocess.Popen(
                self.spec.argv,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                bufsize=1,
                env=self.spec.env,
            )
            self.proc = proc
        threading.Thread(
            target=self._read_stdout, args=(proc, gen),
            name=f"fleet-r{self.idx}-out", daemon=True,
        ).start()
        threading.Thread(
            target=self._read_stderr, args=(proc, gen),
            name=f"fleet-r{self.idx}-err", daemon=True,
        ).start()

    def alive(self) -> bool:
        with self._lock:
            return (
                self.proc is not None
                and self.proc.poll() is None
                and not self.suspected_wedged
            )

    def kill(self) -> None:
        """SIGKILL the current process (also works on a SIGSTOPped one)."""
        with self._lock:
            proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass

    def suspend(self) -> None:
        """SIGSTOP — the injected ``replica.hang``: alive to ``poll()``,
        silent to everything else."""
        with self._lock:
            proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGSTOP)
            except OSError:
                pass

    def terminate(self, grace_s: float = 2.0) -> None:
        """Graceful shutdown: close stdin (EOF ends the serve loop), then
        terminate/kill on a timeout."""
        with self._lock:
            proc = self.proc
        if proc is None:
            return
        try:
            if proc.stdin is not None:
                proc.stdin.close()
        except OSError:
            pass
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            try:
                proc.terminate()
                proc.wait(timeout=1.0)
            except (subprocess.TimeoutExpired, OSError):
                proc.kill()

    # -- dispatch ------------------------------------------------------------

    def send(self, fleet_id: str, line: str) -> None:
        """Write one request line; raises :class:`TransientFault` when the
        pipe is gone (a dead replica — the dispatch retry absorbs it).

        The in-flight entry is recorded under the WRITE lock, just
        before the write: insertion order then equals stdin write order
        — which is the replica's answer order (run_jsonl preserves input
        order), so a null-id error answer attributes to the FIRST
        in-flight entry correctly. Recording before the write (not
        after) means a write that blocks on a wedged replica's full pipe
        leaves aged in-flight evidence for the wedge rule, whose SIGKILL
        then fails this write with EPIPE. A failed write un-records its
        own entry. Lock order is write->state, nowhere reversed."""
        with self._lock:
            proc = self.proc
            if proc is None or proc.poll() is not None or proc.stdin is None:
                raise TransientFault(f"replica {self.idx} is not running")
        with self._write_lock:
            with self._lock:
                self.in_flight[fleet_id] = time.monotonic()
            try:
                proc.stdin.write(line + "\n")
                proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError) as e:
                with self._lock:
                    self.in_flight.pop(fleet_id, None)
                raise TransientFault(f"replica {self.idx} pipe: {e}") from None
        with self._lock:
            self.dispatched += 1

    def running(self) -> bool:
        """Process-level liveness only (a wedged replica still runs)."""
        with self._lock:
            return self.proc is not None and self.proc.poll() is None

    def inflight_count(self) -> int:
        with self._lock:
            return len(self.in_flight)

    def restart_due(self, now: float) -> Optional[bool]:
        """None = no restart scheduled; else whether its backoff elapsed."""
        with self._lock:
            if self.restart_due_at is None:
                return None
            return now >= self.restart_due_at

    def schedule_restart(self, delay_for_attempt) -> Optional[int]:
        """Mark this replica dead and schedule its respawn after the
        backoff ``delay_for_attempt(attempt)``. Returns the attempt
        number, or None when a death is ALREADY being handled (the
        idempotence guard — the front's injected-kill path and the
        monitor can both observe one death)."""
        with self._lock:
            if self.restart_due_at is not None:
                return None
            self.restart_attempt += 1
            self.suspected_wedged = True  # out of the pick set until respawn
            self.restart_due_at = time.monotonic() + delay_for_attempt(
                self.restart_attempt
            )
            return self.restart_attempt

    def maybe_reset_backoff(self, now: float, healthy_after_s: float) -> None:
        """A replica that stayed healthy earns its backoff curve back."""
        with self._lock:
            if (
                self.restart_attempt
                and self.restart_due_at is None
                and now - self.started_at > healthy_after_s
            ):
                self.restart_attempt = 0

    def note_respawned(self) -> None:
        with self._lock:
            self.restarts += 1

    def drain_in_flight(self) -> List[str]:
        """Take every in-flight fleet id (death handling: the front
        re-dispatches or degrades each)."""
        with self._lock:
            fids = list(self.in_flight)
            self.in_flight.clear()
        return fids

    # -- liveness evidence ---------------------------------------------------

    def oldest_inflight_age(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self.in_flight:
                return None
            return now - min(self.in_flight.values())

    def response_idle_age(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return now - self.last_response_at

    def age_since_spawn(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return now - self.started_at

    def consecutive_scrape_failures(self) -> int:
        with self._lock:
            return self.scrape_failures

    def metrics_port_known(self) -> bool:
        with self._lock:
            return self.metrics_port is not None

    def scrape_due(self, now: float, interval_s: float) -> bool:
        """Claim the next scrape slot (rate limiting lives here so the
        monitor stays stateless): True at most once per ``interval_s``.
        A wedged replica's probe blocks its full HTTP timeout, so
        unthrottled per-tick scraping would stretch the whole fleet's
        monitor cycle — and the veto/stats only need ~1 Hz freshness."""
        with self._lock:
            if now - self._last_scrape_attempt < interval_s:
                return False
            self._last_scrape_attempt = now
            return True

    def scrape(self, timeout_s: float = 0.75) -> Optional[Dict[str, int]]:
        """Probe ``/metrics.json``. An unreachable or hanging endpoint —
        a SIGSTOPped replica accepts the TCP connect into the listen
        backlog and then never answers, which the timeout converts into
        probe evidence — returns None and counts a consecutive failure.
        An UNKNOWN port (not yet announced) also returns None but counts
        nothing: the supervisor's wedge veto requires a known endpoint,
        so an unannounced replica is judged by the timing rule alone."""
        with self._lock:
            port, gen = self.metrics_port, self.generation
        if port is None:
            return None
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics.json", timeout=timeout_s
            ) as r:
                data = json.load(r)
            totals = _summarize_metrics(data)
        except Exception:  # noqa: BLE001 — any probe failure is evidence
            with self._lock:
                self.scrape_failures += 1
            return None
        with self._lock:
            if gen != self._scrape_gen:
                # a new generation's first totals: its predecessor's
                # last ones are all that is left of that process
                for key, value in self.scrape_totals.items():
                    self._scrape_carried[key] = self._scrape_carried.get(key, 0) + value
                self._scrape_gen = gen
            self.scrape_totals = totals
            self.scrape_failures = 0
        return totals

    def scrape_lifetime(self) -> Dict[str, int]:
        """The scrape totals of every generation of this slot: each dead
        generation's last scraped totals plus the current one's (work a
        dead process did after its last scrape is not in it)."""
        with self._lock:
            out = dict(self._scrape_carried)
            for key, value in self.scrape_totals.items():
                out[key] = out.get(key, 0) + value
            return out

    def snapshot(self) -> Dict:
        """JSON-ready state row for the front's stats ``fleet`` block."""
        with self._lock:
            proc = self.proc
            return {
                "index": self.idx,
                "pid": None if proc is None else proc.pid,
                "alive": proc is not None
                and proc.poll() is None
                and not self.suspected_wedged,
                "generation": self.generation,
                "restarts": self.restarts,
                "dispatched": self.dispatched,
                "answered": self.answered,
                "in_flight": len(self.in_flight),
                "metrics_port": self.metrics_port,
                "scrape": dict(self.scrape_totals),
                "meta": dict(self.spec.meta),
            }

    # -- reader threads ------------------------------------------------------

    def _read_stdout(self, proc: subprocess.Popen, gen: int) -> None:
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    resp = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(resp, dict):
                    continue
                fid = resp.get("id")
                with self._lock:
                    if self.generation != gen:
                        return  # a restarted replica owns the name now
                    if fid is None and self.in_flight:
                        # a replica-internal error answer (run_jsonl's
                        # catch-all emits {"id": null, "error": ...}).
                        # The serve contract answers in INPUT order and
                        # send() records entries in stdin WRITE order,
                        # so it belongs to the FIRST in-flight entry —
                        # attribute it there, or the entry would sit
                        # forever as false wedge evidence and the
                        # waiting ticket would burn its hop timeout for
                        # an answer that already arrived
                        fid = next(iter(self.in_flight))
                    if fid is not None:
                        self.in_flight.pop(fid, None)
                    self.last_response_at = time.monotonic()
                    self.answered += 1
                self._on_response(fid, resp, self)
        except (OSError, ValueError):
            pass  # torn pipe at death: the monitor handles the process

    def _read_stderr(self, proc: subprocess.Popen, gen: int) -> None:
        try:
            for line in proc.stderr:
                line = line.rstrip("\n")
                m = _METRICS_LINE.search(line) if self.spec.scrape else None
                with self._lock:
                    # same generation guard as the stdout reader: a
                    # killed process's buffered announcement must not
                    # write a DEAD port over the successor's (every
                    # scrape would then fail and disable the slow-vs-
                    # stuck veto for a healthy replica)
                    if self.generation != gen:
                        return
                    if m:
                        self.metrics_port = int(m.group(1))
                    elif line.strip():
                        self._stderr_tail.append(line)
        except (OSError, ValueError):
            pass

    def stderr_tail(self) -> List[str]:
        with self._lock:
            return list(self._stderr_tail)

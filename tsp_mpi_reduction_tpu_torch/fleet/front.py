"""The fleet front: one JSONL endpoint over N supervised serve replicas.

The port of ``tsp_mpi_reduction_tpu/fleet/front.py``. Same line contract
as ``serve/service.py`` (requests in, responses out, input order
preserved — ``run_jsonl`` drives a :class:`FleetFront` exactly like a
:class:`~..serve.service.SolveService`), but each request is DISPATCHED to
a replica subprocess (the port's serve CLI) instead of solved in-process
(Clipper's layered front/worker split). The front solves nothing on the
device: it never creates a CUDA context, and a degraded answer is host
numpy. On one card, each replica holds its own context and the contexts
time-slice the card.

Robustness contract per request:

- **deadline-capped dispatch retry**: every front→replica hop runs under
  one ``resilience/retry.py`` policy whose wall budget is the request's
  REMAINING deadline — a retried hop can never push a response past its
  deadline (the ladder's rung-retry cap at fleet granularity);
- **deadline-aware re-dispatch**: when the dispatched replica dies
  (supervisor death callback aborts the hop immediately) or goes silent
  past ``hop_timeout_s``, the request is re-sent to a DIFFERENT replica
  under the same remaining budget, counted in
  ``fleet_redispatches_total``;
- **first-writer-wins**: the fleet id is stable across re-dispatches, so
  however many replicas eventually answer (a resurrected or un-wedged
  replica may finish the original hop late), exactly ONE response is
  emitted; late answers count into
  ``fleet_duplicate_answers_suppressed_total``;
- **graceful degradation**: with fewer than ``min_alive`` replicas up —
  or the deadline/attempts exhausted — the front answers LOCALLY from
  the shared cache tier (relabeled into the request's city order, the
  serve hit path) or a host greedy tour, counted per reason in
  ``fleet_degraded_answers_total{reason=}``; it never queues unboundedly
  against a dead fleet.

Tracing: the front's ``fleet.request`` root + per-hop ``front.dispatch``
spans carry the request-level ``trace_parent`` token to the replica
(the TSP_TRACE_PARENT encoding, threaded through the request line), and
replicas append to the SAME ``TSP_TRACE`` sink — one stitched span tree
per fleet request, front→replica→rung, with the replica's root span
announced at open so a mid-request kill cannot orphan its children.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs import slo as _slo
from ..obs import tracing as _tracing
from ..obs.metrics import REGISTRY as _REGISTRY
from ..ops.distance import distance_matrix_np
from ..resilience.faults import FaultInjected, TransientFault
from ..resilience.faults import registry as _fault_registry
from ..resilience.health import HEALTH
from ..serve import canonical as canon
from ..serve.cache import CacheEntry
from ..serve.ladder import TIERS
from ..utils import reporting
from .replica import Replica, ReplicaSpec
from .shared_cache import TieredSolutionCache
from .supervisor import ReplicaSupervisor, SupervisorConfig

#: bounded degradation reasons (metric label cardinality stays fixed)
DEGRADED_REASONS = ("no_replicas", "deadline", "dispatch")


@dataclass
class FleetConfig:
    replicas: int = 2
    #: front request-thread pool width (run_jsonl reads this)
    threads: int = 8
    default_deadline_ms: float = 1000.0
    #: the shared disk cache tier every replica (and the front's local
    #: degraded path) reads/publishes; None = a fresh temp dir per fleet
    shared_cache_dir: Optional[str] = None
    #: one root-ascent memo disk tier for the whole fleet
    #: (TSP_COMPILE_CACHE stamped into every replica env unless the caller
    #: already set it) — a restarted replica reads the fleet's ascents
    compile_cache_dir: Optional[str] = None
    cache_capacity: int = 4096
    quant_step: float = canon.DEFAULT_STEP
    #: dispatch attempts per request (1 = no re-dispatch)
    dispatch_attempts: int = 3
    #: per-hop wait before the front gives up on the dispatched replica
    #: and re-dispatches (always additionally capped by the remaining
    #: deadline)
    hop_timeout_s: float = 30.0
    #: fleet is DEGRADED below this many alive replicas
    min_alive: int = 1
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    #: replica launch: None = the real serve CLI (built per index by
    #: :func:`default_replica_spec`); tests inject stub argv here
    replica_specs: Optional[List[ReplicaSpec]] = None
    #: extra argv appended to the default serve CLI (e.g. ["--warm", "8"])
    replica_args: tuple = ()
    backend: str = "auto"
    replica_threads: int = 4
    slos: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {k: dict(v) for k, v in _slo.DEFAULT_SLOS.items()}
    )


def default_replica_spec(
    cfg: FleetConfig,
    idx: int,
    shared_cache_dir: Optional[str] = None,
    compile_cache_dir: Optional[str] = None,
) -> ReplicaSpec:
    """The real thing: one port serve CLI process on the shared cache
    tier, the shared ascent memo, and the front's trace sink. The dir
    arguments are the front's RESOLVED paths (its owned temp dir when
    the config left them None) — cfg is read-only here."""
    shared_cache_dir = shared_cache_dir or cfg.shared_cache_dir
    compile_cache_dir = compile_cache_dir or cfg.compile_cache_dir
    argv = [
        sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "serve",
        "--in", "-", "--out", "-",
        "--backend", cfg.backend,
        "--threads", str(cfg.replica_threads),
        "--default-deadline-ms", str(cfg.default_deadline_ms),
        "--metrics-port", "0",
    ]
    if shared_cache_dir:
        argv += ["--shared-cache", shared_cache_dir]
    argv += list(cfg.replica_args)
    env = dict(os.environ)
    if compile_cache_dir and "TSP_COMPILE_CACHE" not in os.environ:
        env["TSP_COMPILE_CACHE"] = compile_cache_dir
    trace_path = _tracing.TRACER.path
    if trace_path:
        # all replicas append whole flushed lines to the front's sink
        # (parent + child processes share one JSONL file; trace ids do
        # the reconstruction, as in a chunked campaign)
        env["TSP_TRACE"] = trace_path
    return ReplicaSpec(argv=argv, env=env, scrape=True, meta={"backend": cfg.backend})


class _FleetDegraded(Exception):
    """Internal control flow: answer this request locally, now."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason if reason in DEGRADED_REASONS else "dispatch"


class FleetTicket:
    """Per-request rendezvous between the dispatching front thread and
    whichever replica reader thread answers first."""

    def __init__(self, fleet_id: str):
        self.fleet_id = fleet_id
        self._lock = threading.Lock()
        self._hop_event: Optional[threading.Event] = None
        self._hop_aborted = False
        self.done = False
        self.result: Optional[Dict] = None
        self.hops_sent = 0
        self.replica: Optional[Replica] = None
        self.late_answers = 0

    def arm_hop(self, rep: Replica) -> None:
        """Install the hop target + a fresh event BEFORE the send: a
        replica death landing in the send window must find
        ``self.replica`` already pointing at it, or ``abort_hop`` would
        no-op and the request would burn its whole hop timeout against
        a corpse. (A send that then fails just abandons the armed hop —
        the next arm overwrites it.)"""
        with self._lock:
            self.replica = rep
            self._hop_aborted = False
            ev = threading.Event()
            if self.done:
                ev.set()  # answered between hops: wait returns instantly
            self._hop_event = ev

    def note_sent(self) -> None:
        """Count a hop that physically reached a replica (what the
        re-dispatch counter reports — a dead-pipe send is a dispatch
        retry, not a re-dispatch)."""
        with self._lock:
            self.hops_sent += 1

    def wait_hop(self, timeout_s: float) -> str:
        """``answered`` | ``failed`` (hop aborted: replica died) |
        ``timeout`` (silence past the hop budget)."""
        with self._lock:
            ev = self._hop_event
        if ev is not None:
            ev.wait(max(timeout_s, 0.0))
        with self._lock:
            if self.done:
                return "answered"
            return "failed" if self._hop_aborted else "timeout"

    def resolve(self, resp: Dict) -> bool:
        """First writer wins; False = suppressed late answer."""
        with self._lock:
            if self.done:
                self.late_answers += 1
                return False
            self.done = True
            self.result = resp
            if self._hop_event is not None:
                self._hop_event.set()
            return True

    def abort_hop(self, rep: Replica) -> None:
        """Fail the CURRENT hop iff it is on ``rep`` (a late death
        notification from a replica this ticket already left must not
        fail the successor hop)."""
        with self._lock:
            if self.replica is not rep:
                return
            if not self.done:
                self._hop_aborted = True
            if self._hop_event is not None:
                self._hop_event.set()


class FleetFront:
    """Duck-types the ``run_jsonl`` service surface: ``cfg.threads``,
    ``handle``, ``_record_error``, ``stats_json``, ``close``."""

    def __init__(self, cfg: Optional[FleetConfig] = None) -> None:
        self.cfg = cfg or FleetConfig()
        # resolved into FRONT state, never written back into cfg: a
        # caller-owned config reused for a second front must not inherit
        # (and then lose to close()'s rmtree) this front's temp dir
        self._owned_tmp = None
        self.shared_cache_dir = self.cfg.shared_cache_dir
        if self.shared_cache_dir is None:
            import tempfile

            self._owned_tmp = tempfile.mkdtemp(prefix="tsp_fleet_cache_")
            self.shared_cache_dir = self._owned_tmp
        self.compile_cache_dir = self.cfg.compile_cache_dir or os.path.join(
            self.shared_cache_dir, "compile_cache"
        )
        #: the front's own view of the shared tier: a small L1 over the
        #: same disk directory the replicas publish into — the degraded
        #: path answers certified cross-replica work without any replica
        self.cache = TieredSolutionCache(
            self.cfg.cache_capacity, self.shared_cache_dir
        )
        self.canon_cache = canon.CanonicalCache(self.cfg.cache_capacity)
        # None = the real serve CLI; an EXPLICIT empty list is a valid
        # zero-replica fleet (the degraded-mode surface, and the posture
        # a fleet is in after losing every replica)
        specs = (
            self.cfg.replica_specs
            if self.cfg.replica_specs is not None
            else [
                default_replica_spec(
                    self.cfg, i,
                    shared_cache_dir=self.shared_cache_dir,
                    compile_cache_dir=self.compile_cache_dir,
                )
                for i in range(self.cfg.replicas)
            ]
        )
        self.supervisor = ReplicaSupervisor(
            specs,
            self.cfg.supervisor,
            on_response=self._on_replica_response,
            on_death=self._on_replica_death,
        )
        self._lock = threading.Lock()
        self._inflight: Dict[str, FleetTicket] = {}
        self._fleet_seq = 0
        self.responses = 0
        self.errors = 0
        self.deadline_misses = 0
        self.redispatches = 0
        self.duplicates_suppressed = 0
        self.degraded: Dict[str, int] = {r: 0 for r in DEGRADED_REASONS}
        self.tier_counts: Dict[str, int] = {}
        self._health0 = HEALTH.snapshot()
        self._latency0 = _REGISTRY.snapshot(prefix="fleet_request_seconds")
        _REGISTRY.declare(
            "fleet_redispatches_total", "counter",
            "in-flight requests re-dispatched off a dead/wedged replica",
        )
        _REGISTRY.declare(
            "fleet_degraded_answers_total", "counter",
            "requests the front answered locally, by reason",
        )
        _REGISTRY.declare(
            "fleet_duplicate_answers_suppressed_total", "counter",
            "late replica answers dropped by first-writer-wins",
        )
        self.supervisor.start()

    # -- replica callbacks (reader / monitor threads) ------------------------

    def _on_replica_response(self, fid: Optional[str], resp: Dict, rep: Replica) -> None:
        with self._lock:
            ticket = self._inflight.get(fid) if fid is not None else None
        if ticket is None or not ticket.resolve(resp):
            # answered already (re-dispatch raced the original, or a
            # resurrected replica finished a drained hop): suppressed
            with self._lock:
                self.duplicates_suppressed += 1
            _REGISTRY.inc("fleet_duplicate_answers_suppressed_total")

    def _on_replica_death(self, rep: Replica, fids: List[str], reason: str) -> None:
        for fid in fids:
            with self._lock:
                ticket = self._inflight.get(fid)
            if ticket is not None:
                ticket.abort_hop(rep)

    # -- the run_jsonl surface -----------------------------------------------

    def _record_error(self) -> None:
        with self._lock:
            self.errors += 1
        _REGISTRY.inc("serve_errors_total")

    def handle(self, request: Dict) -> Dict:
        t0 = time.monotonic()
        req_id = request.get("id")
        try:
            deadline_ms = float(
                request.get("deadline_ms", self.cfg.default_deadline_ms)
            )
        except (TypeError, ValueError):
            self._record_error()
            return {"id": req_id, "error": "deadline_ms must be a number"}
        with _tracing.span("fleet.request", id=req_id) as root:
            resp = self._handle_traced(request, deadline_ms, t0)
            root.set("tier", resp.get("tier"))
            if "error" in resp:
                root.set("error", resp["error"])
            if resp.get("degraded"):
                root.set("degraded", resp["degraded"])
        if "error" in resp:
            # counted HERE for every producer — a replica's error answer
            # (malformed instance) and the local degraded path's alike —
            # so the front's stats never report a clean fleet while
            # clients receive error lines
            self._record_error()
            return resp
        # front-measured end-to-end accounting (the replica's own
        # latency_ms remains in the response for the hop-local view)
        latency_ms = (time.monotonic() - t0) * 1000.0
        missed = latency_ms > deadline_ms
        resp["fleet_latency_ms"] = round(latency_ms, 3)
        resp["deadline_missed"] = bool(missed)
        resp.setdefault("deadline_ms", deadline_ms)
        tier = resp.get("tier")
        tier = tier if tier in TIERS else "greedy"
        with self._lock:
            self.responses += 1
            if missed:
                self.deadline_misses += 1
            self.tier_counts[tier] = self.tier_counts.get(tier, 0) + 1
        _REGISTRY.inc("fleet_responses_total")
        if missed:
            _REGISTRY.inc("fleet_deadline_misses_total")
        # tier values pass through the fixed ladder set above — never a
        # raw response field (metric label cardinality stays bounded)
        _REGISTRY.observe("fleet_request_seconds", latency_ms / 1000.0, tier=tier)
        return resp

    def _handle_traced(self, request: Dict, deadline_ms: float, t0: float) -> Dict:
        from ..resilience.retry import RetryPolicy

        req_id = request.get("id")

        def remaining() -> float:
            return deadline_ms / 1000.0 - (time.monotonic() - t0)

        with self._lock:
            self._fleet_seq += 1
            fid = f"f{self._fleet_seq}"
            ticket = FleetTicket(fid)
            self._inflight[fid] = ticket
        try:
            policy = RetryPolicy(
                max_attempts=max(self.cfg.dispatch_attempts, 1),
                base_delay_s=0.02,
                max_delay_s=0.5,
                seed=0,
            )
            resp = policy.call(
                lambda: self._dispatch_once(request, fid, ticket, remaining),
                budget_s=max(remaining(), 0.01),
            )
        except _FleetDegraded as e:
            return self._degraded_answer(request, e.reason)
        except TransientFault:
            # attempts or deadline budget exhausted: the request still
            # gets an answer, locally — reason says which ran out
            reason = "deadline" if remaining() <= 0.05 else "dispatch"
            return self._degraded_answer(request, reason)
        finally:
            with self._lock:
                self._inflight.pop(fid, None)
                redispatched = max(ticket.hops_sent - 1, 0)
                if redispatched:
                    self.redispatches += redispatched
            if redispatched:
                HEALTH.incr("fleet_redispatches", redispatched)
                _REGISTRY.inc("fleet_redispatches_total", redispatched)
        resp = dict(resp)
        resp["id"] = req_id  # un-remap the fleet id
        return resp

    def _dispatch_once(self, request, fid, ticket, remaining) -> Dict:
        """One hop: pick a replica, send, cross the chaos seams, wait.
        Raises TransientFault (retryable, deadline-budgeted) on any hop
        failure, _FleetDegraded when the fleet cannot take the request."""
        if self.supervisor.alive_count() < max(self.cfg.min_alive, 1):
            raise _FleetDegraded("no_replicas")
        rep = self.supervisor.pick(exclude=ticket.replica)
        if rep is None:
            raise _FleetDegraded("no_replicas")
        with _tracing.span("front.dispatch", replica=rep.idx, hop=ticket.hops_sent + 1) as hop:
            # the dispatch seam: a raise-mode fault is a failed hop the
            # bounded retry absorbs (counted like every other transient)
            _fault_registry().fire("front.dispatch")
            line = json.dumps(
                dict(
                    request,
                    id=fid,
                    trace_parent=_tracing.format_parent(hop.context),
                )
            )
            ticket.arm_hop(rep)
            rep.send(fid, line)
            ticket.note_sent()
            # chaos: kill/wedge the dispatch target mid-flight — the
            # injected failure is the REPLICA's, so the front translates
            # the seam's raise into the real process action and carries on
            try:
                _fault_registry().fire("replica.kill")
            except FaultInjected:
                self.supervisor.kill_replica(rep, reason="injected_kill")
            try:
                _fault_registry().fire("replica.hang")
            except FaultInjected:
                self.supervisor.suspend_replica(rep)
            outcome = ticket.wait_hop(
                min(max(remaining(), 0.0), self.cfg.hop_timeout_s)
            )
            hop.set("outcome", outcome)
            if outcome == "answered":
                return ticket.result
            # the replica KEEPS its in-flight entry on a timeout: the
            # request's bytes are still physically queued there, and an
            # entry that never resolves is exactly the wedge evidence
            # the supervisor's detector needs (a healthy-but-slow
            # replica eventually answers and its reader pops the entry;
            # first-writer-wins suppresses the late duplicate)
            raise TransientFault(f"hop {outcome} on replica {rep.idx}")

    # -- degraded answers ----------------------------------------------------

    def _degraded_answer(self, request: Dict, reason: str) -> Dict:
        req_id = request.get("id")
        with _tracing.span("fleet.degraded", reason=reason):
            try:
                xy = np.asarray(request["xy"], np.float64)
                ci = canon.canonicalize_cached(
                    xy, self.canon_cache, self.cfg.quant_step
                )
            except (KeyError, TypeError, ValueError) as e:
                # NOT counted here: handle() counts every error response
                # once at the top, whatever path produced it
                return {"id": req_id, "error": str(e)}
            try:
                entry = self.cache.get(ci.key)
            except TransientFault:
                entry = None
            if entry is not None:
                tour = canon.from_canonical_tour(entry.tour, ci)
                cost = canon.tour_length_np(tour, xy)
                tier, gap, provenance = entry.tier, entry.certified_gap, "hit"
            else:
                cost, tour = _greedy_tour_np(xy)
                tier, gap, provenance = "greedy", None, "miss"
                try:
                    self.cache.put(
                        ci.key,
                        CacheEntry(
                            cost=cost,
                            tour=canon.to_canonical_tour(tour, ci),
                            certified_gap=None,
                            tier="greedy",
                        ),
                    )
                except TransientFault:
                    pass
        with self._lock:
            self.degraded[reason] = self.degraded.get(reason, 0) + 1
        HEALTH.incr("fleet_degraded_answers")
        _REGISTRY.inc("fleet_degraded_answers_total", reason=reason)
        return {
            "id": req_id,
            "n": int(xy.shape[0]),
            "cost": float(cost),
            "tour": [int(c) for c in tour],
            "tier": tier,
            "certified_gap": None if gap is None else float(gap),
            "cache": provenance,
            "degraded": reason,
        }

    # -- stats / lifecycle ---------------------------------------------------

    def stats_json(self) -> str:
        with self._lock:
            responses, errors = self.responses, self.errors
            misses = self.deadline_misses
            tier_counts = dict(self.tier_counts)
            fleet_block = {
                "replica_count": len(self.supervisor.replicas),
                "alive": self.supervisor.alive_count(),
                "restarts_total": sum(
                    r.restarts for r in self.supervisor.replicas
                ),
                "redispatches_total": self.redispatches,
                "degraded_answers": dict(self.degraded),
                "duplicates_suppressed": self.duplicates_suppressed,
                "in_flight": len(self._inflight),
            }
        fleet_block["replicas"] = self.supervisor.snapshot()
        fleet_block["shared_cache"] = self.cache.shared.stats()
        lat = _REGISTRY.delta(self._latency0, prefix="fleet_request_seconds")
        hists_by_tier = {
            dict(key).get("tier", "?"): v
            for key, v in lat.data.get(
                "fleet_request_seconds", {}
            ).get("series", {}).items()
            if isinstance(v, dict)
        }
        return reporting.fleet_stats_json(
            responses=responses,
            errors=errors,
            deadline_misses=misses,
            tier_counts=tier_counts,
            fleet=fleet_block,
            cache=self.cache.stats(),
            health=HEALTH.delta_since(self._health0),
            slo=_slo.evaluate(hists_by_tier, self.cfg.slos),
            obs=reporting.obs_block(trace_path=_tracing.TRACER.path),
        )

    def close(self) -> None:
        self.supervisor.close()
        if self._owned_tmp is not None:
            # the front made this cache tree (shared tier + nested
            # compile cache) for its own lifetime — replicas are down
            # now, so reap it; a CALLER-provided dir is never touched
            import shutil

            shutil.rmtree(self._owned_tmp, ignore_errors=True)

    def __enter__(self) -> "FleetFront":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _greedy_tour_np(xy: np.ndarray):
    """Host nearest-neighbor from city 0 over the host float64 distances,
    the JAX front's tour and cost bit for bit (the same correctly-rounded
    distances, first-index argmin, and left-to-right cost sum). Pure
    numpy: the degraded path never touches the device."""
    xy = np.asarray(xy, np.float64)
    n = int(xy.shape[0])
    d = distance_matrix_np(xy)
    if n == 1:
        return 0.0, np.asarray([0, 0], np.int32)
    if n == 2:
        return float(d[0, 1] + d[1, 0]), np.asarray([0, 1, 0], np.int32)
    visited = np.zeros(n, bool)
    visited[0] = True
    tour = [0]
    cur = 0
    cost = 0.0
    for _ in range(n - 1):
        masked = np.where(visited, np.inf, d[cur])
        nxt = int(np.argmin(masked))
        cost += float(d[cur, nxt])
        tour.append(nxt)
        visited[nxt] = True
        cur = nxt
    cost += float(d[cur, 0])
    tour.append(0)
    return cost, np.asarray(tour, np.int32)


# -- CLI -----------------------------------------------------------------------


def fleet_cli(argv: Optional[List[str]] = None) -> int:
    """``python -m tsp_mpi_reduction_tpu_torch fleet`` — see README "Fleet
    serving (PyTorch/CUDA port)". ``--backend`` auto and cuda need a GPU:
    without one the front exits 2 before it spawns a replica (every
    replica would exit 2, and the front would answer every request
    degraded)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="tsp-torch fleet",
        description="front + N supervised serve replicas: JSONL in/out",
    )
    ap.add_argument("--in", dest="inp", default="-", metavar="FILE")
    ap.add_argument("--out", dest="outp", default="-", metavar="FILE")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"],
                    help="every replica's serve --backend; auto and cuda "
                    "need a GPU (exit 2 without one)")
    ap.add_argument("--threads", type=int, default=8,
                    help="front request-thread pool width")
    ap.add_argument("--replica-threads", type=int, default=4)
    ap.add_argument("--default-deadline-ms", type=float, default=1000.0)
    ap.add_argument("--shared-cache", default=None, metavar="DIR",
                    help="shared disk cache tier directory (default: a "
                    "fresh temp dir; pass one to persist across fleets)")
    ap.add_argument("--warm", default="",
                    help="forwarded to every replica's serve --warm")
    ap.add_argument("--min-alive", type=int, default=1)
    ap.add_argument("--hop-timeout-s", type=float, default=30.0)
    ap.add_argument("--dispatch-attempts", type=int, default=3)
    ap.add_argument("--stats", action="store_true",
                    help="print the front stats JSON line to stderr on exit")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="span-trace JSONL sink shared by the front AND "
                    "every replica — one stitched tree per request "
                    "(the JAX package's tools/obs_report.py renders it)")
    args = ap.parse_args(argv)

    from ..utils.backend import resolve_device

    try:
        resolve_device(args.backend)  # torch.cuda.is_available() only
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.trace:
        _tracing.configure(args.trace)
    replica_args = []
    if args.warm.strip():
        replica_args += ["--warm", args.warm]
    cfg = FleetConfig(
        replicas=args.replicas,
        threads=args.threads,
        replica_threads=args.replica_threads,
        default_deadline_ms=args.default_deadline_ms,
        shared_cache_dir=args.shared_cache,
        backend=args.backend,
        min_alive=args.min_alive,
        hop_timeout_s=args.hop_timeout_s,
        dispatch_attempts=args.dispatch_attempts,
        replica_args=tuple(replica_args),
    )
    from contextlib import ExitStack

    from ..serve.service import run_jsonl

    front = FleetFront(cfg)
    try:
        with ExitStack() as stack:
            inp = sys.stdin if args.inp == "-" else stack.enter_context(open(args.inp))
            outp = (
                sys.stdout
                if args.outp == "-"
                # a live JSONL response stream, flushed per line — atomic
                # publish would defeat it (same waiver as serve_cli)
                else stack.enter_context(open(args.outp, "w"))  # graftlint: disable=R6
            )
            try:
                run_jsonl(inp, outp, service=front)
            finally:
                try:
                    outp.flush()
                except (OSError, ValueError):
                    pass
    finally:
        front.close()
    if args.stats:
        print(front.stats_json(), file=sys.stderr)
    return 0

"""The batched solve service: JSONL requests in, JSONL responses out.

The port of ``tsp_mpi_reduction_tpu/serve/service.py``: the same request
and response schema, the same stats line, the same CLI flags, except
``--backend={auto,cuda,cpu}``, where ``auto`` and ``cuda`` need a GPU and
exit 2 without one (no silent CPU fallback). The solver work runs on
``ServiceConfig.device``.

Request schema (one JSON object per line):

    {"id": "r1",                      # optional, echoed back
     "xy": [[x0, y0], [x1, y1], ...], # [n, 2] city coordinates (required)
     "deadline_ms": 250.0}            # optional latency budget

Response schema (one JSON object per line, same order as requests):

    {"id": "r1", "n": 12,
     "cost": 123.4,                  # measured cost of the returned tour
     "tour": [0, 5, ..., 0],         # CLOSED tour in the request's city ids
     "tier": "bnb|pipeline|greedy",  # which ladder rung answered
     "certified_gap": 0.0,           # 0 proven/exact, >0 certified, null none
     "cache": "hit|miss|refresh",    # refresh = cached non-exact answer
                                     #   re-solved by a stronger rung
                                     #   because this budget allowed it
     "latency_ms": 1.9,
     "deadline_ms": 250.0,
     "deadline_missed": false}

or ``{"id": ..., "error": "..."}`` for malformed requests (never for a
tight deadline — the greedy rung answers those).

Per request: canonicalize (``serve.canonical``) -> LRU lookup
(``serve.cache``; a hit relabels the cached canonical tour into this
request's city order and re-measures its true cost) -> on miss, the
deadline ladder (``serve.ladder``) solves it, micro-batching exact
Held-Karp work across concurrent requests (``serve.scheduler``), and the
canonical solution is cached for every future translation/permutation of
the same instance.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, IO, Iterable, List, Optional

import numpy as np

from ..obs import metrics as _metrics
from ..obs import slo as _slo
from ..obs import tracing as _tracing
from ..obs.metrics import REGISTRY as _REGISTRY
from ..perf import ascent_memo as _ascent_memo
from ..resilience.faults import TransientFault
from ..resilience.health import HEALTH
from ..resilience.retry import RetryPolicy
from ..utils import reporting
from ..utils.profiling import PhaseTimer
from . import canonical as canon
from .cache import CacheEntry, SolutionCache
from .ladder import DeadlineLadder, LadderConfig
from .scheduler import MicroBatchScheduler


@dataclass
class ServiceConfig:
    cache_capacity: int = 4096
    quant_step: float = canon.DEFAULT_STEP
    max_batch: int = 64
    max_wait_ms: float = 2.0
    dtype: str = "float32"
    default_deadline_ms: float = 1000.0
    threads: int = 8
    #: scheduler-worker watchdog cadence and the silence threshold past
    #: which an alive-but-wedged worker is abandoned and replaced
    watchdog_interval_s: float = 0.2
    stuck_timeout_s: float = 30.0
    #: block sizes to warm at service start (scheduler.precompile): the
    #: kernel library is loaded and every (n, bucket) shape solved once
    #: before the first request, so no request pays ``nvcc`` or a first
    #: launch inside its flush. Empty = no warmup
    warm_shapes: tuple = ()
    #: the bound metrics endpoint port (set by serve_cli when
    #: --metrics-port is given) — surfaced in the stats ``obs`` block so
    #: a log line names its own scrape target
    metrics_port: Optional[int] = None
    #: shared disk-backed cache tier directory: when set, the
    #: instance cache becomes a two-level tier — the in-proc LRU over
    #: atomic-publish entry files every fleet replica shares, so a
    #: resubmission hits regardless of which replica solved it and a
    #: restarted replica warm-fills from the fleet's collective work
    #: (``fleet.shared_cache.TieredSolutionCache``)
    shared_cache_dir: Optional[str] = None
    #: per-tier latency objectives: tier -> {"target_ms",
    #: "goal"}. Evaluated over THIS session's tier-labeled latency
    #: histograms into the stats ``slo`` block (attainment + error-budget
    #: burn rate — obs.slo). Empty dict = no objectives (block still
    #: present, tiers listed unjudged).
    slos: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {k: dict(v) for k, v in _slo.DEFAULT_SLOS.items()}
    )
    ladder: LadderConfig = field(default_factory=LadderConfig)
    #: where the scheduler's flushes, the B&B slices and the blocked
    #: rung's fold and polish run (``--backend=cpu`` makes it "cpu")
    device: str = "cuda"


class SolveService:
    """Thread-safe request handler; owns the scheduler worker and cache."""

    def __init__(self, cfg: Optional[ServiceConfig] = None) -> None:
        self.cfg = cfg or ServiceConfig()
        # shared across worker + request threads; phases mirror into the
        # obs registry alongside every other serve signal
        self.timer = PhaseTimer(mirror_metric="phase_seconds_total")
        if self.cfg.shared_cache_dir:
            from ..fleet.shared_cache import TieredSolutionCache

            self.cache: SolutionCache = TieredSolutionCache(
                self.cfg.cache_capacity, self.cfg.shared_cache_dir
            )
        else:
            self.cache = SolutionCache(self.cfg.cache_capacity)
        #: the LIVE admission-control signal: windowed per-tier
        #: error-budget burn over recent answers, shared by the scheduler
        #: (burning-tier priority) and the ladder (shed/degrade new
        #: admissions) — not static queue depth
        self.burn = _slo.BurnMeter(self.cfg.slos)
        self.scheduler = MicroBatchScheduler(
            max_batch=self.cfg.max_batch,
            max_wait_ms=self.cfg.max_wait_ms,
            dtype=self.cfg.dtype,
            timer=self.timer,
            watchdog_interval_s=self.cfg.watchdog_interval_s,
            stuck_timeout_s=self.cfg.stuck_timeout_s,
            burn_meter=self.burn,
            device=self.cfg.device,
        )
        self.ladder = DeadlineLadder(
            self.scheduler, self.cfg.ladder, burn_meter=self.burn
        )
        #: canonicalization memo: skips the per-request lexsort for
        #: byte-identical (post-quantization) resubmissions
        #: (see canonical.CanonicalCache)
        self.canon_cache = canon.CanonicalCache(self.cfg.cache_capacity)
        if self.cfg.warm_shapes:
            self.scheduler.precompile(self.cfg.warm_shapes)
        #: health baseline at service start: the stats JSON reports the
        #: DELTA, so back-to-back sessions in one process (tests, bench
        #: legs, embedded services) stop seeing each other's recoveries
        self._health0 = HEALTH.snapshot()
        #: latency-histogram baseline: the SLO window is this session
        #: (same delta discipline as health — a prior session's misses
        #: must not burn this session's error budget)
        self._latency0 = _REGISTRY.snapshot(prefix="serve_request_seconds")
        #: queue-age baseline (same delta discipline): the admission block
        #: reports THIS session's wait-time percentiles
        self._queue_age0 = _REGISTRY.snapshot(prefix="serve_queue_age_seconds")
        self.responses = 0
        self.errors = 0
        self.deadline_misses = 0
        self.refreshes = 0  #: cache entries upgraded by a stronger rung
        # the counters above are read-modify-written from every request
        # thread (and errors from run_jsonl's reader thread too) — same
        # lost-update hazard the PhaseTimer lock exists for
        self._stats_lock = threading.Lock()

    def _record_error(self) -> None:
        with self._stats_lock:
            self.errors += 1
        _REGISTRY.inc("serve_errors_total")

    # a transient cache fault (the cache.get/cache.put seams) must never
    # cost a request its answer: retry briefly, then degrade — a failed
    # lookup becomes a miss (re-solve), a failed insert is dropped (the
    # next request for the instance just misses too)
    _cache_retry = RetryPolicy(max_attempts=2, base_delay_s=0.005, seed=0)

    def _cache_get(self, key: str) -> Optional[CacheEntry]:
        try:
            return self._cache_retry.call(lambda: self.cache.get(key))
        except TransientFault:
            return None

    def _cache_put(self, key: str, entry: CacheEntry) -> None:
        try:
            self._cache_retry.call(lambda: self.cache.put(key, entry))
        except TransientFault:
            pass

    # -- one request ---------------------------------------------------------

    def handle(self, request: Dict) -> Dict:
        # root span of this request's trace: every stage below (cache
        # lookup, ladder rung, queue wait, the worker's flush) parents
        # back to it, so one serve request = one complete span tree —
        # error/degraded paths included (the finally-emitted root closes
        # the tree either way). A fleet front threads its per-request
        # ``trace_parent`` token (the TSP_TRACE_PARENT encoding) through
        # the request line; the root then joins the front's trace, and
        # is ANNOUNCED at open so a replica killed mid-request cannot
        # orphan its already-closed child spans (obs.tracing.span).
        parent = _tracing.parse_parent_token(request.get("trace_parent"))
        with _tracing.span(
            "serve.request",
            parent=parent,
            announce=parent is not None,
            id=request.get("id"),
        ) as root:
            resp = self._handle_traced(request, root)
            root.set("tier", resp.get("tier"))
            if "error" in resp:
                root.set("error", resp["error"])
            return resp

    def _handle_traced(self, request: Dict, root) -> Dict:
        t0 = time.monotonic()
        req_id = request.get("id")
        try:
            xy = np.asarray(request["xy"], np.float64)
            deadline_ms = float(
                request.get("deadline_ms", self.cfg.default_deadline_ms)
            )
            with self.timer.phase("serve.canonicalize"), _tracing.span(
                "canonicalize"
            ):
                ci = canon.canonicalize_cached(
                    xy, self.canon_cache, self.cfg.quant_step
                )
        except (KeyError, TypeError, ValueError) as e:
            self._record_error()
            return {"id": req_id, "error": str(e)}

        with _tracing.span("cache.lookup") as csp:
            entry = self._cache_get(ci.key)
            csp.set("result", "miss" if entry is None else "hit")
        # a non-exact cached answer does not pin the instance forever: a
        # request whose budget fits a STRONGER rung re-solves ("refresh")
        # and the cache's better-entry policy keeps whichever tour wins
        upgrade = entry is not None and self.ladder.upgrade_eligible(
            ci.n, deadline_ms / 1000.0, entry.tier, entry.certified_gap
        )
        if entry is not None and not upgrade:
            tour = canon.from_canonical_tour(entry.tour, ci)
            cost = canon.tour_length_np(tour, xy)
            tier, gap, provenance = entry.tier, entry.certified_gap, "hit"
        else:
            with self.timer.phase("serve.solve"):
                res = self.ladder.solve(xy, deadline_ms / 1000.0)
            tour = res.tour
            # report (and cache) the re-measured f64 length of the actual
            # tour, not the solver's f32 device value — the response cost
            # is then consistent between miss and hit paths
            cost = canon.tour_length_np(tour, xy)
            new_entry = CacheEntry(
                cost=cost,
                tour=canon.to_canonical_tour(tour, ci),
                certified_gap=res.certified_gap,
                tier=res.tier,
            )
            self._cache_put(ci.key, new_entry)
            if entry is not None and entry.better_than(new_entry):
                # the upgrade attempt lost (e.g. bnb timed out worse than
                # the cached tour) — serve the cached answer, honestly
                tour = canon.from_canonical_tour(entry.tour, ci)
                cost = canon.tour_length_np(tour, xy)
                tier, gap, provenance = entry.tier, entry.certified_gap, "hit"
            else:
                tier, gap = res.tier, res.certified_gap
                provenance = "refresh" if upgrade else "miss"
            if upgrade:
                with self._stats_lock:
                    self.refreshes += 1

        latency_ms = (time.monotonic() - t0) * 1000.0
        missed = latency_ms > deadline_ms
        with self._stats_lock:
            self.responses += 1
            if missed:
                self.deadline_misses += 1
        _REGISTRY.inc("serve_responses_total", cache=provenance)
        if missed:
            _REGISTRY.inc("serve_deadline_misses_total")
        # tier-labeled: the SLO evaluator judges each rung against ITS
        # objective (a greedy answer in 40 ms is healthy; a bnb one is
        # suspicious). Tier values come from the fixed ladder set — never
        # from request fields (label cardinality stays bounded).
        _REGISTRY.observe(
            "serve_request_seconds", latency_ms / 1000.0, tier=tier
        )
        # feed the LIVE burn meter: this answer immediately moves the
        # admission/priority signal the scheduler and ladder read
        self.burn.observe(tier, latency_ms / 1000.0)
        with _tracing.span("respond"):
            return {
                "id": req_id,
                "n": int(xy.shape[0]),
                "cost": float(cost),
                "tour": [int(c) for c in tour],
                "tier": tier,
                "certified_gap": None if gap is None else float(gap),
                "cache": provenance,
                "latency_ms": round(latency_ms, 3),
                "deadline_ms": deadline_ms,
                "deadline_missed": bool(missed),
            }

    # -- stats / lifecycle ---------------------------------------------------

    def stats_json(self) -> str:
        with self._stats_lock:
            responses, errors = self.responses, self.errors
            misses, refreshes = self.deadline_misses, self.refreshes
        # the canonicalization memo rides in the cache block: its saved
        # sorts are the host-path half of the serve cache story
        cache_stats = dict(self.cache.stats(), **{
            f"canonical_{k}": v for k, v in self.canon_cache.stats().items()
        })
        # locked snapshots: request threads increment the
        # ladder counts and timer phases while this reporting path runs
        tier_counts, rung_failures = self.ladder.counts_snapshot()
        # SLO verdicts over THIS session's tier-labeled latency
        # histograms (delta vs the service-start snapshot): attainment
        # against each tier's target + error-budget burn rate (obs.slo)
        lat = _REGISTRY.delta(self._latency0, prefix="serve_request_seconds")
        hists_by_tier = {
            dict(key).get("tier", "?"): v
            for key, v in lat.data.get(
                "serve_request_seconds", {}
            ).get("series", {}).items()
            if isinstance(v, dict)
        }
        slo_block = _slo.evaluate(hists_by_tier, self.cfg.slos)
        sched_stats = self.scheduler.stats()
        # admission/preemption block: the live burn signal the
        # scheduler steered by, what it cost (sheds, preemptions), and how
        # long work actually queued — the continuous-batching story in one
        # place
        qage = _REGISTRY.delta(self._queue_age0, prefix="serve_queue_age_seconds")
        qage_hist = None
        for v in qage.data.get(
            "serve_queue_age_seconds", {}
        ).get("series", {}).values():
            if isinstance(v, dict):
                qage_hist = v
                break
        admission = {
            "burn": self.burn.snapshot(),
            "slo_sheds": sched_stats.get("slo_sheds", 0),
            "preemptions": sched_stats.get("bnb_preemptions", 0),
            "resumes": sched_stats.get("bnb_resumes", 0),
            "admit_flushes": sched_stats.get("admit_flushes", 0),
            "queue_age_s": {
                "count": int(qage_hist.get("count", 0)) if qage_hist else 0,
                "p50": _metrics.hist_quantile(qage_hist, 0.50) if qage_hist else None,
                "p90": _metrics.hist_quantile(qage_hist, 0.90) if qage_hist else None,
                "p99": _metrics.hist_quantile(qage_hist, 0.99) if qage_hist else None,
            },
        }
        return reporting.service_stats_json(
            responses=responses,
            errors=errors,
            deadline_misses=misses,
            refreshes=refreshes,
            rung_failures=rung_failures,
            tier_counts=tier_counts,
            cache=cache_stats,
            scheduler=sched_stats,
            admission=admission,
            phases_s=self.timer.snapshot(),
            # THIS session's recoveries, not the process's lifetime count
            # (registry-backed delta; see resilience.health)
            health=HEALTH.delta_since(self._health0),
            # the root-ascent memo's counters: the port's only
            # compile-once cache (no XLA, so no AOT keys)
            compile_cache=_ascent_memo.STATS.snapshot(),
            slo=slo_block,
            obs=reporting.obs_block(
                trace_path=_tracing.TRACER.path,
                metrics_port=self.cfg.metrics_port,
            ),
        )

    def close(self) -> None:
        self.scheduler.close()
        # drop the per-session B&B checkpoint directory (preempted-slice
        # snapshots are worthless once their jobs are resolved)
        self.ladder.cleanup()

    def __enter__(self) -> "SolveService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_jsonl(
    lines: Iterable[str],
    out: IO[str],
    cfg: Optional[ServiceConfig] = None,
    service: Optional[SolveService] = None,
) -> SolveService:
    """Drive a service over a JSONL request stream.

    Requests are submitted to a thread pool as they are read (concurrency
    is what lets the scheduler batch them); a dedicated writer thread
    emits responses in INPUT order, flushed per line, AS they complete —
    an interactive client on a pipe sees each response without waiting
    for the input stream to end, and memory stays bounded (in-flight
    requests are capped, written responses are not retained). Returns the
    (closed) service so callers can read final stats.
    """
    import queue as _queue

    svc = service or SolveService(cfg)
    own = service is None
    #: (future, ready_response) pairs in input order; None = end of stream
    pending: "_queue.Queue" = _queue.Queue()
    # bound the in-flight window so an unbounded input stream cannot pile
    # up futures faster than the workers drain them
    window = threading.Semaphore(max(4 * svc.cfg.threads, 16))

    def _resolve(item) -> Dict:
        fut, ready = item
        if fut is None:
            return ready
        try:
            return fut.result()
        except Exception as e:  # noqa: BLE001 — the stream survives
            return {"id": None, "error": f"internal: {e}"}
        finally:
            window.release()

    def _writer() -> None:
        carried = None  # drained-but-unresolved item: next batch's head
        while True:
            item = carried if carried is not None else pending.get()
            carried = None
            if item is None:
                return
            # batch the JSONL encode: after blocking on the IN-ORDER head
            # response, opportunistically drain every further item whose
            # future is ALREADY resolved, so a burst costs ONE write+flush
            # instead of one syscall pair per response. An unresolved item
            # ends the batch (it becomes the next head) — batching must
            # never hold an already-ready response behind a pending
            # future, and a lone response still flushes immediately, so
            # interactive pipes keep their per-response latency.
            stop = False
            batch = [json.dumps(_resolve(item))]
            while True:
                try:
                    nxt = pending.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                fut, _ready = nxt
                if fut is not None and not fut.done():
                    carried = nxt
                    break
                batch.append(json.dumps(_resolve(nxt)))
            try:
                out.write("\n".join(batch) + "\n")
                out.flush()
            except Exception:  # noqa: BLE001 — broken sink: keep draining
                pass  # the queue must drain or the reader deadlocks on window
            if stop:
                return

    writer = threading.Thread(target=_writer, name="serve-writer", daemon=True)
    writer.start()
    try:
        with ThreadPoolExecutor(
            max_workers=svc.cfg.threads, thread_name_prefix="serve-req"
        ) as pool:
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
                except (json.JSONDecodeError, ValueError) as e:
                    svc._record_error()
                    pending.put((None, {"id": None, "error": f"bad request: {e}"}))
                    continue
                window.acquire()
                pending.put((pool.submit(svc.handle, req), None))
    finally:
        pending.put(None)
        writer.join()
        if own:
            svc.close()
    return svc


def serve_cli(argv: Optional[List[str]] = None) -> int:
    """``python -m tsp_mpi_reduction_tpu_torch serve`` — see README."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="tsp-torch serve",
        description="batched TSP solve service: JSONL requests -> JSONL responses",
    )
    ap.add_argument("--in", dest="inp", default="-", metavar="FILE",
                    help="JSONL request file ('-' = stdin)")
    ap.add_argument("--out", dest="outp", default="-", metavar="FILE",
                    help="JSONL response file ('-' = stdout)")
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"],
                    help="auto and cuda need a GPU (exit 2 without one); cpu "
                    "runs the plain versions of the kernels on the host")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache-size", type=int, default=4096)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--default-deadline-ms", type=float, default=1000.0)
    ap.add_argument("--shared-cache", default=None, metavar="DIR",
                    help="shared disk-backed cache tier directory: "
                    "layers atomic-publish entry files under the "
                    "in-proc LRU so fleet replicas share one instance "
                    "cache and restarts warm-fill from it")
    ap.add_argument("--warm", default="",
                    help="comma-separated block sizes to warm before "
                    "serving (e.g. 8,12,16): the kernel library is loaded "
                    "and every (size, bucket) shape solved once, so no "
                    "request pays a kernel build or a first launch")
    ap.add_argument("--stats", action="store_true",
                    help="print the service stats JSON line to stderr on exit")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="span-trace JSONL sink: every request emits a "
                    "span tree (request -> canonicalize -> cache lookup "
                    "-> queue wait -> flush -> rung -> respond) "
                    "(env: TSP_TRACE)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the obs metrics registry over HTTP on "
                    "127.0.0.1:PORT (/metrics = Prometheus text "
                    "exposition, /metrics.json = structured snapshot)")
    args = ap.parse_args(argv)

    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        warm_shapes = tuple(
            int(tok) for tok in args.warm.split(",") if tok.strip()
        )
    except ValueError:
        print(f"error: --warm expects comma-separated ints, got {args.warm!r}",
              file=sys.stderr)
        return 2
    cfg = ServiceConfig(
        cache_capacity=args.cache_size,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        threads=args.threads,
        default_deadline_ms=args.default_deadline_ms,
        warm_shapes=warm_shapes,
        shared_cache_dir=args.shared_cache,
        device=str(device),
    )
    # ExitStack closes BOTH handles deterministically on every path (a
    # failing open of the output must not leak the open input, and a
    # mid-stream exception must not drop buffered output lines). The flush
    # in the finally covers the stdout case (not closed) AND the error
    # path of a file sink before its close.
    from contextlib import ExitStack

    if args.trace:
        _tracing.configure(args.trace)
    metrics_server = None
    if args.metrics_port is not None:
        from ..obs.metrics import serve_metrics_http

        try:
            # port 0 = ephemeral (multi-instance runs stop colliding);
            # the BOUND port is what the stats obs block reports
            metrics_server = serve_metrics_http(args.metrics_port)
        except OSError as e:
            print(f"error: cannot bind metrics port: {e}", file=sys.stderr)
            return 2
        cfg.metrics_port = metrics_server.port
        print(
            f"metrics: http://127.0.0.1:{cfg.metrics_port}/metrics",
            file=sys.stderr,
        )
    with ExitStack() as stack:
        inp = sys.stdin if args.inp == "-" else stack.enter_context(open(args.inp))
        outp = (
            sys.stdout
            if args.outp == "-"
            # a live JSONL response stream, flushed per line by the writer
            # thread — atomic publish would defeat its purpose
            else stack.enter_context(open(args.outp, "w"))
        )
        try:
            svc = run_jsonl(inp, outp, cfg)
        finally:
            try:
                outp.flush()
            except (OSError, ValueError):
                pass  # broken pipe / already closed: nothing left to save
            if metrics_server is not None:
                # graceful: stop the loop AND release the socket, so a
                # follow-up instance can rebind the port immediately
                metrics_server.close()
    if args.stats:
        print(svc.stats_json(), file=sys.stderr)
    return 0

"""Deadline-aware degradation ladder: certified -> exact-blocked -> greedy.

The port of ``tsp_mpi_reduction_tpu/serve/ladder.py``: the same rungs,
estimator and accounting; the pipeline rung's device work (the Held-Karp
flush, the merge fold, the polish) runs in PyTorch on the scheduler's
device.

Every request carries a latency budget. Rather than a fixed solver (and
either blown deadlines or uniformly weak answers), the service walks a
ladder of rungs from strongest to cheapest and picks the strongest rung
whose *estimated* latency fits the remaining budget:

  ``bnb``      certified branch & bound (``models.branch_bound.solve``,
               time-limited to the budget) — proven optimum or a certified
               gap from the search's global lower bound. Runs PREEMPTIBLY
               through the scheduler's iteration-level loop:
               ``bnb_slice_s``-second slices that yield the device between
               checkpointed continuations, so a long proof coexists with
               the latency-sensitive pipeline traffic;
  ``pipeline`` the exact batched Held-Karp path through the micro-batch
               scheduler: single block for n <= 16 (exact, gap 0), blocked
               decomposition + merge fold + device 2-opt/Or-opt polish for
               larger n (heuristic, no certificate);
  ``greedy``   host nearest-neighbor — microseconds at serving sizes, the
               rung that guarantees a valid closed tour for ANY deadline.

Rung latencies are learned online (per-rung, per-size EWMA seeded with
conservative priors), so the first cold-start hit teaches the ladder to
stop promising that rung under tight budgets. A rung that misses its
budget mid-flight still returns (the response is marked late) — but the
ladder design keeps that rare: ``greedy`` never misses, and ``pipeline``
waits on the scheduler only as long as the budget allows before degrading.

Every result records which rung answered (``tier``) and the achieved
certificate (``certified_gap``) — the cache stores both, so a certified
answer is never clobbered by a later deadline-degraded one.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..obs import tracing as _tracing
from ..obs.metrics import REGISTRY as _REGISTRY
from ..ops.distance import distance_matrix_np
from ..ops.held_karp import MAX_BLOCK_CITIES
from ..resilience.faults import registry as _fault_registry
from ..resilience.retry import RetryPolicy
from .scheduler import MicroBatchScheduler

TIERS = ("bnb", "pipeline", "greedy")
#: strength order for cache-upgrade decisions (higher = stronger rung)
_TIER_RANK = {"greedy": 0, "pipeline": 1, "bnb": 2}


@dataclass
class LadderResult:
    cost: float
    tour: np.ndarray  # [n+1] CLOSED tour in request-space city ids
    tier: str
    #: 0.0 = proven/exact; >0 = certified-but-unproven B&B gap; None = no
    #: certificate (heuristic rung)
    certified_gap: Optional[float]
    lower_bound: float = -np.inf


@dataclass
class LadderConfig:
    #: largest instance the bnb rung will attempt (search is exponential;
    #: past this the rung is skipped regardless of budget)
    bnb_max_n: int = 64
    #: never attempt bnb with less than this many seconds of budget
    bnb_min_budget_s: float = 1.0
    #: fraction of the remaining budget handed to bnb's time_limit_s (the
    #: rest covers setup + response assembly)
    bnb_budget_fraction: float = 0.6
    #: conservative cold-start latency priors, refined by the EWMA
    prior_s: Dict[str, float] = field(
        default_factory=lambda: {"bnb": 5.0, "pipeline": 0.5, "greedy": 0.0}
    )
    #: B&B knobs sized for serving (small instances, bounded memory)
    bnb_capacity: int = 1 << 14
    bnb_k: int = 64
    #: injectable certified solver (tests); signature (d, time_limit_s) ->
    #: (cost, closed_tour, lower_bound, proven). When set, the rung runs
    #: the solver inline; the default rung instead rides the scheduler's
    #: iteration-level loop (``submit_bnb``) in preemptible slices
    bnb_solver: Optional[Callable] = None
    #: preemption granularity of the default bnb rung: each device slice
    #: runs at most this long before yielding to other queued work
    bnb_slice_s: float = 0.25
    #: where between-slice checkpoints live (None: a private temp dir,
    #: removed by ``DeadlineLadder.cleanup``)
    bnb_checkpoint_dir: Optional[str] = None
    #: shed/degrade NEW admissions to a tier whose live error-budget burn
    #: rate (obs.slo.BurnMeter) exceeds this (1.0 = exactly on budget)
    slo_shed_burn: float = 2.0
    #: 2-opt/Or-opt polish rounds for the blocked-pipeline rung
    polish_rounds: int = 6
    #: transient-fault retries per rung attempt (the self-healing knob:
    #: a TransientFault/FaultInjected from a rung is re-tried this many
    #: times with exponential backoff before the ladder degrades)
    rung_retries: int = 1
    #: first-retry backoff; doubles per retry, deterministic jitter
    retry_base_delay_s: float = 0.01


class LatencyEstimator:
    """Per-(tier, n-bucket) EWMA of observed rung latencies."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = alpha
        self._ewma: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(n: int) -> int:
        b = 4
        while b < n:
            b *= 2
        return b

    def observe(self, tier: str, n: int, seconds: float) -> None:
        key = (tier, self._bucket(n))
        with self._lock:
            old = self._ewma.get(key)
            self._ewma[key] = (
                seconds if old is None else (1 - self.alpha) * old + self.alpha * seconds
            )

    def estimate(self, tier: str, n: int, default: float) -> float:
        with self._lock:
            return self._ewma.get((tier, self._bucket(n)), default)

    def observe_partial(
        self,
        tier: str,
        n: int,
        elapsed_s: float,
        progress: float,
        cap_factor: float = 64.0,
    ) -> None:
        """Learn from a PREEMPTED / unfinished rung.

        A rung cut off at its deadline used to be recorded at its capped
        elapsed time — systematically UNDER-estimating the tier's true
        cost, so the ladder kept over-promising it. This projects the
        full cost from the partial evidence: ``elapsed / progress``
        (progress = fraction of the work done, e.g. the B&B gap closure
        from ``ResumeHandle.gap_progress``), clamped to at most
        ``cap_factor`` x elapsed so a rung with no measurable progress
        teaches a strong-but-bounded penalty instead of infinity."""
        if elapsed_s <= 0:
            return
        p = min(max(progress, 1.0 / cap_factor), 1.0)
        self.observe(tier, n, min(elapsed_s / p, elapsed_s * cap_factor))


def _trivial_tour(n: int, d: np.ndarray) -> Tuple[float, np.ndarray]:
    """n < 3: the only closed tours there are."""
    if n == 1:
        return 0.0, np.asarray([0, 0], np.int32)
    return float(d[0, 1] + d[1, 0]), np.asarray([0, 1, 0], np.int32)


def _greedy(d: np.ndarray) -> Tuple[float, np.ndarray]:
    from ..models.branch_bound import nearest_neighbor_tour

    tour = nearest_neighbor_tour(d)
    cost = float(d[tour[:-1], tour[1:]].sum())
    return cost, tour


def _largest_block_divisor(n: int) -> Optional[int]:
    """Largest b in [3, 16] (hard HK cap per SURVEY.md) dividing n."""
    for b in range(min(n, MAX_BLOCK_CITIES, 16), 2, -1):
        if n % b == 0:
            return b
    return None


class DeadlineLadder:
    """Stateful rung dispatcher shared by all request threads."""

    def __init__(
        self,
        scheduler: MicroBatchScheduler,
        cfg: Optional[LadderConfig] = None,
        estimator: Optional[LatencyEstimator] = None,
        burn_meter=None,
    ) -> None:
        self.scheduler = scheduler
        self.cfg = cfg or LadderConfig()
        self.estimator = estimator or LatencyEstimator()
        #: optional obs.slo.BurnMeter shared with the scheduler — the
        #: admission-control signal (None: never shed)
        self.burn_meter = burn_meter
        self.tier_counts: Dict[str, int] = {t: 0 for t in TIERS}
        #: rungs that raised (device OOM, failed batch, solver bug) instead
        #: of answering — each such request still got a greedy tour
        self.rung_failures: Dict[str, int] = {t: 0 for t in TIERS}
        self._count_lock = threading.Lock()
        #: per-request-thread scratch: the scheduler queue wait of the
        #: current rung attempt, so the estimator can learn SERVICE time
        #: (see :meth:`_attempt`)
        self._tls = threading.local()
        self._ckpt_dir: Optional[str] = None
        self._ckpt_dir_owned = False
        self._job_seq = 0

    def _job_checkpoint_path(self) -> str:
        """A unique per-job snapshot path under the (lazily created)
        checkpoint dir — preempted proofs park their donated state here
        between slices."""
        with self._count_lock:
            if self._ckpt_dir is None:
                self._ckpt_dir = self.cfg.bnb_checkpoint_dir
                if self._ckpt_dir is None:
                    self._ckpt_dir = tempfile.mkdtemp(prefix="tsp-serve-bnb-")
                    self._ckpt_dir_owned = True
                else:
                    os.makedirs(self._ckpt_dir, exist_ok=True)
            self._job_seq += 1
            seq = self._job_seq
        return os.path.join(self._ckpt_dir, f"job-{os.getpid()}-{seq}")

    def cleanup(self) -> None:
        """Best-effort removal of the auto-created checkpoint dir (the
        service calls this from ``close``; an explicitly configured
        ``bnb_checkpoint_dir`` is the operator's to manage)."""
        import shutil

        with self._count_lock:
            path, owned = self._ckpt_dir, self._ckpt_dir_owned
            self._ckpt_dir = None
            self._ckpt_dir_owned = False
        if path and owned:
            shutil.rmtree(path, ignore_errors=True)

    def _attempt(
        self, tier: str, n: int, run, budget_s: Optional[float] = None
    ) -> Optional[LadderResult]:
        """Run one rung; None on timeout OR exception (the caller degrades).

        The elapsed time is observed in BOTH cases — a rung that burned its
        budget and failed must teach the estimator, or the ladder will keep
        promising it to every request (the cold-start trap). TRANSIENT
        faults (``resilience.faults``, incl. the ``ladder.rung`` injection
        seam) are absorbed by a bounded backoff retry first — capped by
        ``budget_s`` so a retry can never outspend the request's deadline
        (``run`` must re-read the remaining budget itself, not capture a
        stale value, or the retry re-runs with time that no longer
        exists). Exhausted retries and real exceptions are counted, not
        propagated: the ladder's contract is that a well-formed instance
        always gets a tour from SOME rung.

        The estimator is fed SERVICE time — elapsed minus the scheduler
        queue wait the rung's ticket reported (``_tls.queue_wait``).
        Queueing is transient congestion the iteration-level loop and
        admission control are responsible for; folding it into the EWMA
        would let one head-of-line episode (a long proof slicing through)
        pin every later tight-deadline request to greedy long after the
        queue drained, because greedy answers never update the pipeline
        series again. Timeouts keep the full elapsed: a rung that burned
        its whole budget must still teach the estimator the cost of
        promising it."""
        t0 = time.monotonic()
        self._tls.queue_wait = 0.0

        def attempt_once():
            _fault_registry().fire("ladder.rung")
            return run()

        policy = RetryPolicy(
            max_attempts=1 + max(self.cfg.rung_retries, 0),
            base_delay_s=self.cfg.retry_base_delay_s,
            seed=0,
        )
        with _tracing.span("ladder.rung", tier=tier, n=n) as sp:
            try:
                result = policy.call(attempt_once, budget_s=budget_s)
                sp.set("outcome", "ok" if result is not None else "timeout")
                return result
            except Exception as e:  # noqa: BLE001 — degrade, never error
                sp.set("outcome", "failed")
                sp.set("error", f"{type(e).__name__}: {e}")
                with self._count_lock:
                    self.rung_failures[tier] += 1
                _REGISTRY.inc(
                    "serve_rung_failures_total", tier=tier
                )
                return None
            finally:
                elapsed = time.monotonic() - t0
                service = max(
                    elapsed - getattr(self._tls, "queue_wait", 0.0), 0.0
                )
                self.estimator.observe(tier, n, service)
                _REGISTRY.inc("serve_rung_attempts_total", tier=tier)
                # the wall metric keeps the FULL elapsed (what the
                # request experienced); only the estimator gets the
                # queue-corrected service time
                _REGISTRY.inc(
                    "serve_rung_seconds_total", max(elapsed, 0.0), tier=tier
                )

    def counts_snapshot(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """``(tier_counts, rung_failures)`` copied under the count lock —
        the accessor stats reporting must use instead of reaching into
        the dicts while request threads increment them."""
        with self._count_lock:
            return dict(self.tier_counts), dict(self.rung_failures)

    def _shed(self, tier: str) -> bool:
        """SLO-burn admission control: True when ``tier``'s live error
        budget is burning past ``cfg.slo_shed_burn`` — the request is
        degraded to the next rung DOWN and the shed is accounted
        (``serve_flushes_total{cause=slo_shed}``). Shedding new
        admissions is what lets the burning tier's existing queue drain
        back inside its objective."""
        bm = self.burn_meter
        if bm is None:
            return False
        b = bm.burn(tier)
        if b is None or b <= self.cfg.slo_shed_burn:
            return False
        self.scheduler.note_shed(tier)
        return True

    def upgrade_eligible(
        self, n: int, deadline_s: float, entry_tier: str, certified_gap
    ) -> bool:
        """Should a cached entry be RE-SOLVED for this request instead of
        served as a hit? True when the entry is not already exact/proven
        (``certified_gap == 0.0``) and a STRONGER rung than the one that
        produced it fits this request's budget — so a greedy answer cached
        under a tight deadline doesn't pin the instance to greedy forever.
        (A timed-out bnb certificate with gap > 0 is only re-attempted by
        a request whose budget fits bnb again.)"""
        if certified_gap == 0.0:
            return False
        if n < 3:
            return False
        cfg, est = self.cfg, self.estimator
        rank = _TIER_RANK.get(entry_tier, 0)
        if (
            rank <= _TIER_RANK["bnb"]
            and n <= cfg.bnb_max_n
            and deadline_s >= cfg.bnb_min_budget_s
            and deadline_s >= est.estimate("bnb", n, cfg.prior_s["bnb"])
        ):
            return True
        return rank < _TIER_RANK["pipeline"] and deadline_s >= est.estimate(
            "pipeline", n, cfg.prior_s["pipeline"]
        )

    # -- rung implementations ------------------------------------------------

    def _bnb_result(self, cost, tour, lb, proven: bool) -> LadderResult:
        if proven or cost <= lb:
            gap = 0.0
        else:
            gap = float(max(cost - lb, 0.0) / max(lb, 1e-12)) if np.isfinite(lb) else None
        return LadderResult(
            cost=float(cost),
            tour=np.asarray(tour, np.int32),
            tier="bnb",
            certified_gap=gap,
            lower_bound=float(lb),
        )

    def _run_bnb(self, d: np.ndarray, budget_s: float) -> Optional[LadderResult]:
        """The certified rung. An injected ``bnb_solver`` runs inline
        (tests pin that call shape); the default rung rides the
        scheduler's iteration-level loop in ``bnb_slice_s`` chunks, so a
        long proof yields the device between slices instead of
        monopolizing it. Returns None when the wait outlives the budget
        (the caller degrades; the job keeps slicing until ITS deadline
        and is simply discarded — its partial evidence still teaches the
        estimator)."""
        limit = budget_s * self.cfg.bnb_budget_fraction
        solver = self.cfg.bnb_solver
        if solver is not None:
            cost, tour, lb, proven = solver(d, limit)
            return self._bnb_result(cost, tour, lb, proven)
        job = self.scheduler.submit_bnb(
            d,
            budget_s=max(limit, 0.05),
            slice_s=self.cfg.bnb_slice_s,
            checkpoint_path=self._job_checkpoint_path(),
            solve_kw=dict(
                capacity=self.cfg.bnb_capacity,
                k=self.cfg.bnb_k,
                device_loop=False,  # fine-grained time-limit checks
            ),
        )
        res = job.wait(timeout=max(budget_s, 1e-3))
        n = d.shape[0]
        handle = job.handle
        if res is not None and not res.proven_optimal and handle is not None:
            # the rung finished UNPROVEN at its deadline (after >= 1
            # preemption): project the full proof cost from the partial
            # gap closure so tier selection stops over-promising bnb
            self.estimator.observe_partial(
                "bnb", n, handle.elapsed_s, handle.gap_progress()
            )
        if res is None:
            if handle is not None:
                self.estimator.observe_partial(
                    "bnb", n, handle.elapsed_s, handle.gap_progress()
                )
            return None
        return self._bnb_result(
            res.cost, res.tour, res.lower_bound, bool(res.proven_optimal)
        )

    def _run_pipeline(
        self, xy: np.ndarray, d: np.ndarray, budget_s: float
    ) -> Optional[LadderResult]:
        """Exact HK for one block; blocked HK + merge + polish for larger n.
        Returns None when the scheduler wait outlives the budget (the
        caller degrades to greedy; the batch result is discarded)."""
        n = d.shape[0]
        if n <= MAX_BLOCK_CITIES:
            # the sched.wait span is the queue-wait stage of the request
            # trace; the worker parents its flush span to it (the ticket
            # captures this span's context at submit)
            with _tracing.span("sched.wait", blocks=1) as sp:
                ticket = self.scheduler.submit(d[None])
                got = ticket.wait(timeout=max(budget_s, 1e-3))
                if got is None:
                    sp.set("outcome", "timeout")
                    return None
            self._tls.queue_wait = ticket.queue_age_s or 0.0
            costs, tours = got
            return LadderResult(
                cost=float(costs[0]),
                tour=np.asarray(tours[0], np.int32),
                tier="pipeline",
                certified_gap=0.0,  # Held-Karp is exact for a single block
            )
        return self._run_blocked(xy, d, budget_s)

    def _run_blocked(
        self, xy: np.ndarray, d: np.ndarray, budget_s: float
    ) -> Optional[LadderResult]:
        """n > 16: spatially-sorted blocked decomposition, the batched HK
        kernel per block, the repo's merge fold, then device polish, on the
        scheduler's device. No certificate — the block decomposition is
        heuristic. The fold and the polish add their seconds to the
        scheduler's phase timer (``serve.fold``, ``serve.polish``)."""
        from ..ops.local_search import polish, tour_length
        from ..ops.merge import fold_tours

        n = d.shape[0]
        dev = self.scheduler.device
        t0 = time.monotonic()
        b = _largest_block_divisor(n)
        d32 = torch.as_tensor(d, dtype=torch.float32, device=dev)
        if b is None:
            # prime-ish n: greedy seed + device polish is still a real
            # improvement rung over raw greedy
            seed_cost, seed = _greedy(d)
            order = seed[:-1]
        else:
            # block-major spatial order (sort by x, then y) gives blocks
            # the merge operator can stitch with short splices
            order = np.lexsort((xy[:, 1], xy[:, 0])).astype(np.int64)
            blocks = order.reshape(n // b, b)
            block_d = d[blocks[:, :, None], blocks[:, None, :]]
            with _tracing.span("sched.wait", blocks=int(n // b)) as sp:
                ticket = self.scheduler.submit(block_d)
                got = ticket.wait(timeout=max(budget_s, 1e-3))
                if got is None:
                    sp.set("outcome", "timeout")
                    return None
            self._tls.queue_wait = ticket.queue_age_s or 0.0
            costs, tours = got
            # fold in global (request-space) ids via the resident matrix
            global_tours = np.asarray(blocks)[
                np.arange(blocks.shape[0])[:, None], np.asarray(tours, np.int64)
            ]
            with self.scheduler.timer.phase("serve.fold"):
                ids, length, _cost = fold_tours(
                    torch.as_tensor(global_tours, dtype=torch.int32, device=dev),
                    torch.as_tensor(costs, device=dev),
                    d32,
                )
                order = ids[: int(length)][:-1].cpu().numpy().astype(np.int64)
        remaining = budget_s - (time.monotonic() - t0)
        t = torch.as_tensor(order, dtype=torch.int64, device=dev)[None]
        with self.scheduler.timer.phase("serve.polish"):
            if remaining > 0:
                t, _ = polish(t, d32, max_rounds=self.cfg.polish_rounds)
            cost = float(tour_length(t, d32)[0])
        open_t = t[0].cpu().numpy().astype(np.int64)
        closed = np.concatenate([open_t, open_t[:1]]).astype(np.int32)
        return LadderResult(cost=cost, tour=closed, tier="pipeline", certified_gap=None)

    # -- dispatch ------------------------------------------------------------

    def solve(self, xy: np.ndarray, deadline_s: float) -> LadderResult:
        """Answer one request within ``deadline_s`` (measured from now)."""
        t_start = time.monotonic()
        xy = np.asarray(xy, np.float64)
        n = xy.shape[0]
        d = distance_matrix_np(xy)
        cfg, est = self.cfg, self.estimator

        def budget() -> float:
            return deadline_s - (time.monotonic() - t_start)

        result: Optional[LadderResult] = None
        if n >= 3:
            rem = budget()
            # a rung that throws (device OOM, failed batch, solver bug) must
            # degrade like a rung that timed out — the ladder's contract is
            # that a well-formed instance ALWAYS gets a tour, never an error
            if (
                n <= cfg.bnb_max_n
                and rem >= cfg.bnb_min_budget_s
                and rem >= est.estimate("bnb", n, cfg.prior_s["bnb"])
                and not self._shed("bnb")
            ):
                # budget() is re-read INSIDE the lambda: a retry after a
                # late transient fault must run with the time actually
                # left, not the full original rem (which would land the
                # response at ~2x the deadline)
                result = self._attempt(
                    "bnb", n,
                    lambda: self._run_bnb(d, max(budget(), 0.05)),
                    budget_s=rem,
                )
            elif budget() >= est.estimate(
                "pipeline", n, cfg.prior_s["pipeline"]
            ) and not self._shed("pipeline"):
                result = self._attempt(
                    "pipeline", n,
                    lambda: self._run_pipeline(xy, d, budget()),
                    budget_s=budget(),
                )
        if result is None:
            # the unconditional rung: valid closed tour at ANY deadline
            with _tracing.span("ladder.rung", tier="greedy", n=n) as sp:
                if n < 3:
                    cost, tour = _trivial_tour(n, d)
                else:
                    cost, tour = _greedy(d)
                sp.set("outcome", "ok")
            result = LadderResult(
                cost=cost,
                tour=tour,
                tier="greedy",
                certified_gap=0.0 if n < 3 else None,
            )
        with self._count_lock:
            self.tier_counts[result.tier] += 1
        _REGISTRY.inc("serve_tier_answers_total", tier=result.tier)
        return result

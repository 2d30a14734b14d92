"""Iteration-level micro-batch scheduler: one device loop, preemptible units.

The port of ``tsp_mpi_reduction_tpu/serve/scheduler.py``: the same loop,
queues, watchdog and counters, with the device work in PyTorch on the
scheduler's ``device`` (CUDA unless the caller asks for the CPU). An HK
flush is one ``ops.held_karp.solve_blocks_from_dists`` call, whose
Held-Karp sweep on CUDA is the ``relax_dense_sweep`` kernel; a B&B slice
is one ``models.branch_bound.solve_slice`` call, whose steps on CUDA
launch ``prim_chain`` and ``push_rows``. Nothing here switches to a plain
version or to the CPU when a launch fails: the failure reaches the
ticket or the job.

The ORCA idea (OSDI '22, PAPERS.md) applied to the repo's exact solvers:
the worker thread runs a device LOOP whose unit of scheduling is one
bounded device interaction — a padded batched Held-Karp flush, or one
time-sliced chunk of a B&B proof — never a whole request. Between units
the loop re-reads the queues, so newly arrived work is admitted and
finished work retired at iteration granularity instead of cohort
granularity.

Two lanes feed the loop:

- **HK tickets** (:meth:`~MicroBatchScheduler.submit`): ``[B, n, n]``
  block distance stacks; same-shape groups are concatenated, padded up to
  a power-of-two bucket, and solved in ONE ``solve_blocks_from_dists`` call.
- **B&B jobs** (:meth:`~MicroBatchScheduler.submit_bnb`): certified
  branch & bound proofs, run ``slice_s`` seconds at a time through
  ``models.branch_bound.solve_slice``. A slice that ends unproven with
  budget remaining is **preempted**: the search state persists through
  the crash-safe checkpoint path (``branch_bound.save`` /
  ``restore``, TSPCKPT1 files) and the job re-queues behind its peers
  (round-robin fairness), to be **resumed bit-identically** later — a
  long proof cannot monopolize the device.

Latency discipline (the "max-wait knob"): an HK group flushes as soon as
``max_batch`` blocks are pending, and otherwise no later than
``max_wait_ms`` after the OLDEST pending submission arrived — batching can
add at most ``max_wait_ms`` to any request, never unbounded queueing
delay. While B&B work holds the device, pending HK tickets flush into the
next gap immediately (cause ``admit``) rather than sitting out the knob.

Admission signal: an optional ``obs.slo.BurnMeter`` feeds the loop's
tie-break — when the ``bnb`` tier's error budget burns hot, a ready B&B
slice takes priority over a not-yet-due HK flush (alternation still
bounds either lane's wait to one unit); the ladder uses the same meter to
shed/degrade NEW admissions (:meth:`~MicroBatchScheduler.note_shed`).
Every flush/preempt/shed lands in ``serve_flushes_total{cause=}`` and
every flushed ticket's queue wait in ``serve_queue_age_seconds``, so the
loop's scheduling decisions are diagnosable after the fact.

Shape discipline: batch sizes are padded up to fixed power-of-two
``buckets`` (pad lanes replicate the first real block; the blocks of a
batch are independent, so real lanes are bit-identical to an unpadded
run), as in the JAX package, where every distinct batch size would be a
fresh XLA compile. Here it keeps the set of flush shapes small and
warmable (:meth:`MicroBatchScheduler.precompile`).

Device work and host readbacks of the HK lane happen ONLY in
:meth:`_run_batch`, called once per flush from the worker loop — the loop
body itself stays free of per-iteration device traffic.

Self-healing (the resilience layer): the worker thread is supervised by a
WATCHDOG. A worker that dies (an exception escaping the flush — e.g. the
``sched.flush`` fault seam) or goes silent mid-batch past
``stuck_timeout_s`` is replaced: unresolved in-flight tickets are
re-queued at the FRONT of the queue (arrival order preserved) and a fresh
worker generation takes over; an abandoned-but-alive worker notices its
stale generation at the next queue interaction and exits. Restarts count
into the scheduler stats and the global ``HEALTH`` block — a dead worker
can no longer silently strand every queued request.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import tracing as _tracing
from ..obs.metrics import REGISTRY as _REGISTRY
from ..ops.held_karp import MAX_BLOCK_CITIES
from ..resilience.faults import registry as _fault_registry
from ..resilience.health import HEALTH
from ..utils.backend import parse_dtype
from ..utils.profiling import PhaseTimer

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class Ticket:
    """One pending submission: request threads block on :meth:`wait`.

    Outcomes are FIRST-WRITER-WINS: after a watchdog revive, a ticket can
    be re-solved by the successor generation while the abandoned worker
    still holds a reference — whichever outcome lands first sticks, so a
    stale worker's late failure can never mask a valid replacement result
    (nor vice versa)."""

    __slots__ = (
        "dists", "arrived", "ctx", "queue_age_s", "_event", "_costs",
        "_tours", "_error", "_claim", "_done",
    )

    def __init__(self, dists: np.ndarray) -> None:
        self.dists = dists
        #: the submitting thread's span context (trace_id, span_id) — the
        #: worker parents its flush span here, so the device work a
        #: request waited on lands in that request's own trace
        self.ctx = _tracing.current_context()
        self.arrived = time.monotonic()
        #: queue wait stamped when the worker takes the ticket into a
        #: flush — lets the ladder's latency estimator learn SERVICE time
        #: (queueing is transient congestion, not a property of the rung)
        self.queue_age_s: Optional[float] = None
        self._event = threading.Event()
        self._costs: Optional[np.ndarray] = None
        self._tours: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._claim = threading.Lock()
        self._done = False

    def _take_outcome(self) -> bool:
        with self._claim:
            if self._done:
                return False
            self._done = True
            return True

    def _resolve(self, costs: np.ndarray, tours: np.ndarray) -> None:
        if not self._take_outcome():
            return
        self._costs, self._tours = costs, tours
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._take_outcome():
            return
        self._error = exc
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        """Block until solved. Returns ``(costs [B], tours [B, n+1])`` as
        numpy arrays, raises the worker's exception if the batch failed,
        or returns ``None`` on timeout (the caller degrades to a lower
        ladder rung; the batch still completes and is simply discarded)."""
        if not self._event.wait(timeout):
            return None
        if self._error is not None:
            raise self._error
        return self._costs, self._tours


class BnBJob:
    """One step-sliced B&B proof owned by the scheduler's device loop.

    Request threads block on :meth:`wait` exactly like a :class:`Ticket`;
    the worker runs the proof ``slice_s`` seconds at a time and re-queues
    the job between slices (``handle`` carries the checkpoint-backed
    continuation). Outcomes are first-writer-wins for the same reason as
    tickets: after a watchdog revive, an abandoned worker can race its
    successor on the same job."""

    __slots__ = (
        "dists", "solve_kw", "slice_s", "deadline", "checkpoint_path",
        "arrived", "ctx", "handle", "last_result", "preemptions", "resumes",
        "first_pickup", "_event", "_result", "_error", "_claim", "_done",
    )

    def __init__(
        self,
        dists: np.ndarray,
        slice_s: float,
        budget_s: float,
        checkpoint_path: str,
        solve_kw: Optional[Dict] = None,
    ) -> None:
        self.dists = dists
        self.solve_kw = dict(solve_kw or {})
        self.slice_s = slice_s
        self.deadline = time.monotonic() + budget_s
        self.checkpoint_path = checkpoint_path
        self.arrived = time.monotonic()
        self.ctx = _tracing.current_context()
        self.handle = None  #: branch_bound.ResumeHandle between slices
        self.last_result = None  #: best-so-far BnBResult (deadline answer)
        self.preemptions = 0
        self.resumes = 0
        self.first_pickup: Optional[float] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._claim = threading.Lock()
        self._done = False

    def _take_outcome(self) -> bool:
        with self._claim:
            if self._done:
                return False
            self._done = True
            return True

    def _resolve(self, result) -> None:
        if not self._take_outcome():
            return
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._take_outcome():
            return
        self._error = exc
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the proof finishes or its budget lapses. Returns
        the final ``BnBResult`` (proven, or best-so-far with its certified
        bound at the deadline), raises the worker's exception on failure,
        or returns ``None`` on timeout (the caller degrades)."""
        if not self._event.wait(timeout):
            return None
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatchScheduler:
    def __init__(
        self,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        dtype: str = "float32",
        buckets: Tuple[int, ...] = _BUCKETS,
        timer: Optional[PhaseTimer] = None,
        watchdog_interval_s: float = 0.2,
        stuck_timeout_s: float = 30.0,
        burn_meter=None,
        device="cuda",
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.dtype = dtype
        self._torch_dtype = parse_dtype(dtype)
        #: where every flush and every B&B slice runs
        self.device = torch.device(device)
        self.buckets = tuple(sorted(set(buckets) | {max_batch}))
        self.timer = timer or PhaseTimer()
        self.watchdog_interval_s = watchdog_interval_s
        self.stuck_timeout_s = stuck_timeout_s
        #: optional obs.slo.BurnMeter — the live admission-control signal
        self.burn_meter = burn_meter
        self._cv = threading.Condition()
        self._queue: Deque[Ticket] = deque()
        #: round-robin queue of step-sliced B&B proofs (fairness: one
        #: slice each, preempted jobs go to the back)
        self._bnb_queue: Deque[BnBJob] = deque()
        #: the job the worker is slicing right now — what the watchdog
        #: re-queues alongside ``_inflight`` when that worker dies (the
        #: slice re-runs from the last donated checkpoint: crash-safe)
        self._inflight_bnb: Optional[BnBJob] = None
        #: alternation guard: a burning bnb tier may take priority over a
        #: ready HK flush, but never twice in a row (neither lane starves)
        self._last_was_bnb = False
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = False
        #: tickets popped by the current worker but not yet resolved — what
        #: the watchdog re-queues when that worker dies or wedges
        self._inflight: List[Ticket] = []
        #: worker generation: bumped on every (re)start; a worker whose
        #: generation is stale has been replaced and must stand down
        self._gen = 0
        self._heartbeat = time.monotonic()
        #: current stuck threshold: doubles after every stuck-revive and
        #: resets when a batch completes cleanly. The watchdog cannot
        #: tell a wedged worker from a legitimately long batch (a cold
        #: kernel build blocks _run_batch well past any fixed timeout), so
        #: successive generations get exponentially more patience — a
        #: genuine wedge is still caught fast, while a long first build
        #: costs at most a logarithmic number of duplicate dispatches
        #: (idempotent tickets keep results correct either way)
        self._stuck_allowance = stuck_timeout_s
        # -- counters (reported via utils.reporting.service_stats_json) --
        self.batches = 0  #: device calls made
        self.blocks_solved = 0  #: real (non-padding) blocks solved
        self.padded_blocks = 0  #: total lanes dispatched incl. padding
        self.queue_depth_hwm = 0  #: max pending blocks ever queued
        self.full_flushes = 0  #: flushes triggered by max_batch
        self.wait_flushes = 0  #: flushes triggered by the max-wait knob
        self.worker_restarts = 0  #: dead workers replaced by the watchdog
        self.stuck_restarts = 0  #: wedged workers abandoned + replaced
        self.precompiled_buckets = 0  #: shape buckets warmed by precompile()
        self.precompile_seconds = 0.0  #: wall spent in precompile()
        # -- iteration-level loop counters --
        self.admit_flushes = 0  #: HK flushes pulled forward into a B&B gap
        self.bnb_jobs = 0  #: B&B proofs submitted
        self.bnb_slices = 0  #: device slices run (>= jobs when preempting)
        self.bnb_preemptions = 0  #: slices preempted with budget remaining
        self.bnb_resumes = 0  #: preempted proofs resumed from checkpoint
        self.slo_sheds = 0  #: admissions shed/degraded by the burn signal
        #: one record per B&B slice run (``seconds``, the snapshot
        #: ``save_s`` it wrote, ``resumed``, ``preempted``, ``proven``):
        #: what a slice costs beside its search; not part of stats()
        self.bnb_slice_log: Deque[Dict] = deque(maxlen=4096)

    # -- warmup --------------------------------------------------------------

    def precompile(self, block_sizes, max_blocks: Optional[int] = None) -> int:
        """Warm the block solver for every (block size, bucket) this
        scheduler can dispatch, BEFORE traffic arrives, through
        ``ops.held_karp.warm_blocks``: the kernel library is built and
        loaded, and one throwaway solve of each shape runs on the device,
        so the first flush of a shape pays neither ``nvcc`` nor the first
        launch inside the worker's ``_run_batch``.

        ``block_sizes``: iterable of block city counts n to warm.
        ``max_blocks``: warm buckets up to this many blocks (default
        ``max_batch``). Returns the number of (n, bucket) entries warmed;
        failures are counted and skipped, never raised (warmup must not
        take the service down — a real flush of that shape then fails on
        its own ticket).
        """
        from ..ops.held_karp import MAX_BLOCK_CITIES, warm_blocks

        cap = self.max_batch if max_blocks is None else max_blocks
        buckets = [b for b in self.buckets if b <= cap] or [self.buckets[0]]
        warmed = 0
        t0 = time.monotonic()
        for n in block_sizes:
            n = int(n)
            if not 3 <= n <= MAX_BLOCK_CITIES:
                continue
            for b in buckets:
                try:
                    warm_blocks(n, b, self.dtype, self.device)
                    warmed += 1
                except Exception:  # noqa: BLE001 — warmup is best-effort
                    continue
        with self._cv:  # stats() snapshots these under the same lock
            self.precompiled_buckets += warmed
            self.precompile_seconds += time.monotonic() - t0
        return warmed

    # -- submission ----------------------------------------------------------

    def submit(self, block_dists: np.ndarray) -> Ticket:
        """Enqueue a ``[B, n, n]`` stack of block distance matrices.

        Validation errors raise HERE, synchronously, so a malformed request
        can never poison a shared batch."""
        d = np.asarray(block_dists)
        if d.ndim != 3 or d.shape[1] != d.shape[2]:
            raise ValueError(f"expected [B, n, n] block dists, got {d.shape}")
        n = int(d.shape[1])
        if not 3 <= n <= MAX_BLOCK_CITIES:
            raise ValueError(
                f"block size must be in [3, {MAX_BLOCK_CITIES}], got {n}"
            )
        if d.shape[0] < 1:
            raise ValueError("empty block stack")
        ticket = Ticket(d)
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            self._ensure_threads_locked()
            self._queue.append(ticket)
            depth = sum(t.dists.shape[0] for t in self._queue)
            self.queue_depth_hwm = max(self.queue_depth_hwm, depth)
            self._cv.notify_all()
        _REGISTRY.set_gauge("serve_queue_depth_blocks", depth)
        return ticket

    def submit_bnb(
        self,
        d: np.ndarray,
        *,
        budget_s: float,
        slice_s: float,
        checkpoint_path: str,
        solve_kw: Optional[Dict] = None,
    ) -> BnBJob:
        """Enqueue one certified B&B proof on the iteration-level loop.

        ``d``: dense [n, n] distance matrix. ``budget_s``: wall budget
        from NOW — at the deadline the job resolves with its best-so-far
        result and certified bound. ``slice_s``: preemption granularity
        (a slice that ends unproven re-queues behind other work).
        ``checkpoint_path``: where the between-slice snapshot lives; must
        be unique per job. ``solve_kw`` forwards to
        ``models.branch_bound.solve`` (identical across slices).
        Validation raises here, synchronously, like :meth:`submit`."""
        d = np.asarray(d)
        if d.ndim != 2 or d.shape[0] != d.shape[1]:
            raise ValueError(f"expected [n, n] distance matrix, got {d.shape}")
        if d.shape[0] < 3:
            raise ValueError(f"B&B needs n >= 3 cities, got {d.shape[0]}")
        if not budget_s > 0 or not slice_s > 0:
            raise ValueError(
                f"budget_s and slice_s must be > 0, got {budget_s}, {slice_s}"
            )
        if not checkpoint_path:
            raise ValueError("submit_bnb needs a checkpoint_path")
        job = BnBJob(d, slice_s, budget_s, checkpoint_path, solve_kw)
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            self._ensure_threads_locked()
            self._bnb_queue.append(job)
            self.bnb_jobs += 1
            self._cv.notify_all()
        return job

    def note_shed(self, tier: str) -> None:
        """Record one admission shed/degraded by the SLO burn signal (the
        ladder calls this when it skips a burning tier for a new request
        — scheduling accounting lives here with the other causes)."""
        with self._cv:
            self.slo_sheds += 1
        _REGISTRY.inc("serve_flushes_total", cause="slo_shed")
        _REGISTRY.inc("serve_slo_sheds_total", tier=tier)
        HEALTH.incr("slo_sheds")

    def close(self) -> None:
        """Stop the worker + watchdog; pending tickets are failed, not
        dropped (in-flight tickets the worker abandoned included)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            # snapshot the thread handles UNDER the lock:
            # a concurrent submit()'s revive path swaps them, and a stale
            # handle here would join a replaced worker while the live one
            # keeps running past close
            threads = (self._thread, self._watchdog)
        for th in threads:
            if th is not None:
                th.join(timeout=30.0)
        with self._cv:
            self._thread = None
            self._watchdog = None
            pending = [t for t in self._inflight if not t._event.is_set()]
            pending += list(self._queue)
            self._inflight = []
            self._queue.clear()
            jobs: List[BnBJob] = list(self._bnb_queue)
            if self._inflight_bnb is not None:
                jobs.append(self._inflight_bnb)
            self._bnb_queue.clear()
            self._inflight_bnb = None
        for t in pending:
            t._fail(RuntimeError("scheduler closed before solve"))
        for j in jobs:
            # a job that already ran slices resolves with its best-so-far
            # certified result — closing mid-proof degrades, never errors
            if j.last_result is not None:
                j._resolve(j.last_result)
            else:
                j._fail(RuntimeError("scheduler closed before solve"))
        _REGISTRY.set_gauge("serve_queue_depth_blocks", 0)

    # -- supervision ---------------------------------------------------------

    def _ensure_threads_locked(self) -> None:
        """Under ``self._cv``: make sure a live worker generation and the
        watchdog exist. A dead worker found HERE (between watchdog ticks)
        is revived immediately — submission must never race the interval."""
        if self._thread is not None and not self._thread.is_alive():
            self._revive_locked(stuck=False)
        elif self._thread is None:
            self._spawn_worker_locked()
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog", daemon=True
            )
            self._watchdog.start()

    def _spawn_worker_locked(self) -> None:
        self._gen += 1
        self._heartbeat = time.monotonic()
        self._thread = threading.Thread(
            target=self._worker,
            args=(self._gen,),
            name=f"serve-microbatch-g{self._gen}",
            daemon=True,
        )
        self._thread.start()

    def _revive_locked(self, stuck: bool) -> None:
        """Replace the current worker generation: re-queue its unresolved
        in-flight tickets at the FRONT (arrival order preserved) and spawn
        a successor. For a STUCK (alive but silent) worker the old thread
        is abandoned — it exits at its next queue interaction when it sees
        its stale generation; any late result it still resolves is
        harmless (tickets resolve idempotently)."""
        live = [t for t in self._inflight if not t._event.is_set()]
        self._inflight = []
        self._queue.extendleft(reversed(live))
        # the slice the dead worker held re-runs from the last donated
        # checkpoint — deterministic search makes the re-run bit-identical,
        # so a crash mid-slice costs at most one slice of wall time
        job = self._inflight_bnb
        self._inflight_bnb = None
        if job is not None and not job._event.is_set():
            self._bnb_queue.appendleft(job)
        if stuck:
            self.stuck_restarts += 1
            HEALTH.incr("stuck_restarts")
            # see __init__: build-vs-wedge. Capped so a PERSISTENTLY
            # wedging backend can't grow the allowance until stuck
            # detection is effectively disabled
            self._stuck_allowance = min(
                self._stuck_allowance * 2, 8 * self.stuck_timeout_s
            )
        else:
            self.worker_restarts += 1
            HEALTH.incr("worker_restarts")
        self._spawn_worker_locked()
        self._cv.notify_all()

    def _watchdog_loop(self) -> None:
        with self._cv:
            while not self._stop:
                self._cv.wait(self.watchdog_interval_s)
                if self._stop:
                    return
                worker = self._thread
                if worker is None:
                    continue
                if not worker.is_alive():
                    if (
                        self._queue
                        or self._inflight
                        or self._bnb_queue
                        or self._inflight_bnb is not None
                    ):
                        self._revive_locked(stuck=False)
                elif (
                    (self._inflight or self._inflight_bnb is not None)
                    and time.monotonic() - self._heartbeat > self._stuck_allowance
                ):
                    self._revive_locked(stuck=True)

    def __enter__(self) -> "MicroBatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker --------------------------------------------------------------

    def _prefer_bnb_locked(self) -> bool:
        """Under ``self._cv``: should a ready B&B slice jump a ready HK
        flush? Only when the burn meter says the bnb tier is eating its
        error budget faster than allowed AND faster than pipeline, and
        the PREVIOUS unit wasn't bnb (alternation bounds the HK lane's
        extra wait to one slice)."""
        if self.burn_meter is None or self._last_was_bnb:
            return False
        b = self.burn_meter.burn("bnb")
        if b is None or b <= 1.0:
            return False
        return b > (self.burn_meter.burn("pipeline") or 0.0)

    def _take_hk_locked(self, n: int, cause: str):
        """Under ``self._cv``: count the flush cause, pop the same-shape
        group, mark it in flight, and record each ticket's queue age."""
        if cause == "full":
            self.full_flushes += 1
        elif cause == "admit":
            self.admit_flushes += 1
        else:
            self.wait_flushes += 1
        _REGISTRY.inc("serve_flushes_total", cause=cause)
        group = self._pop_group(n)
        self._inflight = list(group)
        self._last_was_bnb = False
        now = time.monotonic()
        for t in group:
            t.queue_age_s = now - t.arrived
            _REGISTRY.observe("serve_queue_age_seconds", t.queue_age_s)
        return ("hk", group)

    def _collect(self, gen: int):
        """Under the condition lock: wait for the next schedulable unit.

        Returns ``("hk", [Ticket, ...])`` — the oldest submission plus
        every later pending ticket of the same block size, up to
        ``max_batch`` total blocks — or ``("bnb", BnBJob)`` — the next
        proof slice in round-robin order; None when shutting down with
        empty queues, or when this worker's generation has been
        superseded by the watchdog (stand down).

        An HK group is due on the classic conditions (full / max-wait /
        shutdown) and ADDITIONALLY whenever B&B work holds the loop —
        waiting out the knob while proof slices own the device would add
        a slice of latency for nothing (cause ``admit``). A due group
        normally goes first (HK units are the latency-sensitive lane);
        a burning bnb tier may take one slice of priority
        (:meth:`_prefer_bnb_locked`)."""
        with self._cv:
            while True:
                if self._gen != gen:
                    return None
                self._heartbeat = time.monotonic()
                bnb_pending = bool(self._bnb_queue)
                hk_cause = None
                waited = 0.0
                if self._queue:
                    head = self._queue[0]
                    pending = sum(
                        t.dists.shape[0]
                        for t in self._queue
                        if t.dists.shape[1] == head.dists.shape[1]
                    )
                    waited = time.monotonic() - head.arrived
                    if pending >= self.max_batch:
                        hk_cause = "full"
                    elif self._stop or waited >= self.max_wait_s:
                        hk_cause = "wait"
                    elif bnb_pending:
                        hk_cause = "admit"
                if bnb_pending and (
                    hk_cause is None or self._prefer_bnb_locked()
                ):
                    job = self._bnb_queue.popleft()
                    self._inflight_bnb = job
                    self._last_was_bnb = True
                    self.bnb_slices += 1
                    return ("bnb", job)
                if hk_cause is not None:
                    return self._take_hk_locked(
                        self._queue[0].dists.shape[1], hk_cause
                    )
                if self._stop:
                    return None
                if self._queue:
                    # batch still filling: sleep until the oldest request's
                    # wait budget lapses (or a new submission wakes us)
                    self._cv.wait(self.max_wait_s - waited)
                else:
                    self._cv.wait()

    def _pop_group(self, n: int) -> List[Ticket]:
        group: List[Ticket] = []
        total = 0
        keep: Deque[Ticket] = deque()
        while self._queue:
            t = self._queue.popleft()
            fits = total + t.dists.shape[0] <= self.max_batch
            # the head ticket is taken even when it alone exceeds max_batch
            # (an oversized submission must flush, not starve the queue)
            if t.dists.shape[1] == n and (fits or not group):
                group.append(t)
                total += t.dists.shape[0]
            else:
                keep.append(t)
        self._queue.extendleft(reversed(keep))
        # keep the depth gauge honest on the DRAIN side too: submit()
        # alone would leave the last pre-flush depth standing forever on
        # an idle service (phantom backlog on every dashboard)
        _REGISTRY.set_gauge(
            "serve_queue_depth_blocks",
            sum(t.dists.shape[0] for t in self._queue),
        )
        return group

    def _worker(self, gen: int) -> None:
        while True:
            work = self._collect(gen)
            if work is None:
                return
            kind, item = work
            if kind == "hk":
                self._run_batch(item)
            else:
                self._run_bnb_slice(item, gen)
            with self._cv:
                if self._gen == gen:
                    if kind == "hk":
                        self._inflight = []
                    elif self._inflight_bnb is item:
                        self._inflight_bnb = None
                    # a clean unit proves the worker healthy: restore
                    # the base stuck threshold for future batches
                    self._stuck_allowance = self.stuck_timeout_s

    def _run_bnb_slice(self, job: BnBJob, gen: int) -> None:
        """One preemptible slice of a certified proof, outside the lock.

        Runs at most ``job.slice_s`` seconds of ``branch_bound.solve`` on
        the scheduler's device through the checkpoint continuation
        (``solve_slice``). A
        slice that PROVES optimality (or exhausts the job's budget)
        resolves the job with its final/best-so-far certified result; a
        slice that ends unproven with budget remaining is a PREEMPTION —
        the job re-queues at the back (round-robin fairness) and its next
        pickup is a RESUME. Every outcome lands in the counters, the
        ``serve_flushes_total{cause=preempt}`` series, the ``HEALTH``
        block, and a ``bnb.slice`` span parented to the submitting
        request's trace."""
        from ..models.branch_bound import solve_slice

        now = time.monotonic()
        if job.first_pickup is None:
            job.first_pickup = now
            _REGISTRY.observe("serve_queue_age_seconds", now - job.arrived)
        remaining = job.deadline - now
        if remaining <= 0 and job.last_result is not None:
            # budget lapsed while queued: answer with the certified
            # best-so-far rather than spending device time past deadline
            job._resolve(job.last_result)
            return
        slice_s = min(job.slice_s, max(remaining, 0.05))
        resumed = job.handle is not None
        if resumed:
            job.resumes += 1
            with self._cv:
                self.bnb_resumes += 1
            _REGISTRY.inc("serve_bnb_resumes_total")
            HEALTH.incr("bnb_resumes")
        t0, ts0 = time.perf_counter(), time.time()
        error: Optional[str] = None
        preempted = proven = False
        save_s = 0.0
        try:
            res, handle = solve_slice(
                job.dists, slice_s, job.handle,
                checkpoint_path=job.checkpoint_path, device=self.device,
                **job.solve_kw,
            )
            job.last_result = res
            job.handle = handle
            save_s = float(sum(res.checkpoint_save_s))
            proven = handle is None
            if proven or job.deadline - time.monotonic() <= 0:
                job._resolve(res)
            else:
                preempted = True
                job.preemptions += 1
                with self._cv:
                    self.bnb_preemptions += 1
                    if self._gen == gen and not self._stop:
                        self._bnb_queue.append(job)
                        self._cv.notify_all()
                _REGISTRY.inc("serve_flushes_total", cause="preempt")
                _REGISTRY.inc("serve_bnb_preemptions_total")
                HEALTH.incr("bnb_preemptions")
        except BaseException as exc:  # noqa: BLE001 — jobs must not hang
            error = f"{type(exc).__name__}: {exc}"
            job._fail(exc)
        finally:
            self.bnb_slice_log.append({
                "seconds": time.perf_counter() - t0, "save_s": save_s,
                "resumed": resumed, "preempted": preempted, "proven": proven,
            })
            events = _tracing.drain_pending()
            if _tracing.TRACER.active:
                attrs = {
                    "slice_s": round(slice_s, 4),
                    "resumed": resumed,
                    "preempted": preempted,
                    "proven": proven,
                    "slices": job.resumes + 1,
                }
                if job.last_result is not None:
                    attrs["incumbent"] = float(job.last_result.cost)
                    attrs["lower_bound"] = float(job.last_result.lower_bound)
                if error is not None:
                    attrs["error"] = error
                _tracing.emit_span(
                    "bnb.slice", job.ctx, ts0,
                    time.perf_counter() - t0, attrs, events,
                )

    def _bucket(self, total: int) -> int:
        for b in self.buckets:
            if b >= total:
                return b
        return total  # above every bucket: dispatch exact (rare by config)

    def _run_batch(self, group: List[Ticket]) -> None:
        """ONE device call for the whole same-shape group, then scatter the
        results back to each ticket. The stack goes to the device once and
        costs and tours come back in one host read each."""
        from ..ops.held_karp import solve_blocks_from_dists

        # the sched.flush fault seam sits OUTSIDE the main try: an
        # injected raise escapes and kills the worker thread with the
        # group still in flight — exactly the failure the watchdog must
        # recover from. The injection EVENT must still reach the traces:
        # this thread has no active span (worker spans are emitted
        # retrospectively), so the event parks in the tracing pending
        # buffer and is attached to the flush span — including a
        # zero-duration tombstone flush when the injection kills us.
        try:
            _fault_registry().fire("sched.flush")
        except BaseException:
            evs = _tracing.drain_pending()
            ts = time.time()
            for t in group:
                _tracing.emit_span(
                    "sched.flush", t.ctx, ts, 0.0,
                    {"error": "fault: sched.flush"}, evs,
                )
            raise
        fault_events = _tracing.drain_pending()  # delay-mode injections
        t_flush0, ts_flush0 = time.perf_counter(), time.time()
        dev_s = 0.0
        error: Optional[str] = None
        try:
            stacked = np.concatenate([t.dists for t in group], axis=0)
            total = stacked.shape[0]
            bucket = self._bucket(total)
            if bucket > total:
                pad = np.broadcast_to(
                    stacked[:1], (bucket - total,) + stacked.shape[1:]
                )
                stacked = np.concatenate([stacked, pad], axis=0)
            dtype = self._torch_dtype
            t_dev0 = time.perf_counter()
            with self.timer.phase("serve.batch_solve"):
                costs, tours = solve_blocks_from_dists(
                    torch.as_tensor(stacked, dtype=dtype, device=self.device), dtype
                )
                costs_np = costs.cpu().numpy()
                tours_np = tours.cpu().numpy()
            dev_s = time.perf_counter() - t_dev0
            # counter updates take the lock: after a stuck-revive an
            # abandoned generation can run _run_batch concurrently with
            # its successor, and stats() snapshots under the same lock
            with self._cv:
                self.batches += 1
                self.blocks_solved += total
                self.padded_blocks += bucket
            _REGISTRY.inc("serve_batches_total")
            _REGISTRY.inc("serve_blocks_solved_total", total)
            _REGISTRY.inc("serve_padded_lanes_total", bucket)
            off = 0
            for t in group:
                b = t.dists.shape[0]
                t._resolve(costs_np[off : off + b], tours_np[off : off + b])
                off += b
        except BaseException as exc:  # noqa: BLE001 — tickets must not hang
            error = f"{type(exc).__name__}: {exc}"
            for t in group:
                t._fail(exc)
        finally:
            self._emit_flush_spans(
                group, ts_flush0, t_flush0, dev_s, error, fault_events
            )

    def _emit_flush_spans(
        self, group, ts0: float, t0: float, dev_s: float, error,
        events=None,
    ) -> None:
        """One ``sched.flush`` span (+ a ``device.dispatch`` child) per
        ticket that carried a trace context — the flush is shared device
        work, but each request's trace must stand alone, so it is
        recorded once per participating trace (attrs carry the shared
        batch shape so a reader can re-correlate them)."""
        if not _tracing.TRACER.active:
            return
        dur_s = time.perf_counter() - t0
        total = sum(t.dists.shape[0] for t in group)
        for t in group:
            attrs = {
                "batch_blocks": total,
                "batch_tickets": len(group),
                "ticket_blocks": int(t.dists.shape[0]),
            }
            if error is not None:
                attrs["error"] = error
            fctx = _tracing.emit_span(
                "sched.flush", t.ctx, ts0, dur_s, attrs, events
            )
            if fctx is not None and dev_s > 0.0:
                _tracing.emit_span(
                    "device.dispatch", fctx, ts0 + (dur_s - dev_s), dev_s,
                    {"seconds": round(dev_s, 6)},
                )

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        # snapshot under the condition lock: every counter
        # below is mutated by the worker/watchdog/request threads holding
        # ``_cv`` — an unlocked read here races those updates
        with self._cv:
            return {
                "batches": self.batches,
                "blocks_solved": self.blocks_solved,
                "padded_blocks": self.padded_blocks,
                # occupancy: real blocks per dispatched lane (1.0 = none)
                "batch_occupancy": (
                    self.blocks_solved / self.padded_blocks
                    if self.padded_blocks
                    else 0.0
                ),
                # mean real blocks per device call (the micro-batching win)
                "mean_batch_blocks": (
                    self.blocks_solved / self.batches if self.batches else 0.0
                ),
                "queue_depth_hwm": self.queue_depth_hwm,
                "full_flushes": self.full_flushes,
                "wait_flushes": self.wait_flushes,
                "admit_flushes": self.admit_flushes,
                "bnb_jobs": self.bnb_jobs,
                "bnb_slices": self.bnb_slices,
                "bnb_preemptions": self.bnb_preemptions,
                "bnb_resumes": self.bnb_resumes,
                "slo_sheds": self.slo_sheds,
                "worker_restarts": self.worker_restarts,
                "stuck_restarts": self.stuck_restarts,
                "precompiled_buckets": self.precompiled_buckets,
                "precompile_seconds": round(self.precompile_seconds, 3),
            }

"""StepSampler-fed solver anomaly sentinels.

Counterpart of ``tsp_mpi_reduction_tpu/obs/anomaly.py``.

The B&B host loops already sample one telemetry row per dispatch
(``obs.timeseries.StepSampler``); this module watches that stream *live*
and fires health events when the search goes pathological:

``nodes_rate_collapse``
    the median nodes/sec of the newest ``window`` dispatches fell below
    ``collapse_ratio`` x the median of the preceding windows — the shape
    of a degraded device or host, a wedged backend, or a frontier
    thrashing against its spill headroom.

``lb_stagnation``
    over the last ``lb_window`` dispatches the certified lower-bound
    floor gained less than ``lb_min_gain`` AND the incumbent did not
    improve AND the total open work (frontier + host reservoir) did not
    shrink — zero progress on both ends of the gap while the search is
    NOT draining toward a proof. The drain condition is load-bearing:
    within one solve the certified floor is clamped once at setup and
    cannot move, and the incumbent is legitimately flat for the entire
    prove-the-incumbent endgame — without it the detector fired on
    every healthy proof run longer than ``lb_window`` dispatches
    (as the JAX package found on its proof runs). A draining frontier IS
    gap progress; only a search holding/growing its open set while both
    bounds sit still is stalled. This is the run-to-exhaustion signal
    the chunked driver's stall rule sees only at chunk granularity;
    here it fires mid-chunk, per dispatch.

Events go three places, all pre-existing consumer surfaces: the health
counter block (``resilience.health`` → ``health_events_total{event=…}`` —
the serve watchdog and the chunked driver already read health blocks),
the metrics registry (``bnb_anomalies_total{kind=…}``), and the active
span as a trace event (a campaign trace shows WHERE the collapse
happened). Each detector fires once per episode (re-arming only after
the signal recovers), so a long degraded stretch is one event, not one
per dispatch.

Overhead discipline: the sentinel exists only when obs is enabled
(``maybe()``, mirroring ``StepSampler.maybe``), and the per-dispatch
path is two list appends and a counter compare — ALL analysis (medians,
window anchors, stagnation spans) runs once per ``window`` samples. The
telemetry's <= 2% budget prices this in; the JAX package rewrote the
sentinel to this amortized shape after its first wiring measurably
pushed its bench over it.
"""

from __future__ import annotations

from collections import deque
from statistics import median as _median
from typing import Any, Dict, List, Optional

from . import enabled as _obs_enabled
from .metrics import REGISTRY

#: window medians kept as the collapse baseline (current window judged
#: against the median of the previous up-to-this-many window medians)
_BASELINE_WINDOWS = 4


def fire_anomaly(
    events: List[Dict[str, Any]], kind: str, step: int, **detail: Any
) -> Dict[str, Any]:
    """Record one anomaly event on every consumer surface at once: the
    caller's event list (-> ``BnBResult.anomalies``), the metrics
    registry (``bnb_anomalies_total{kind=…}``), the health counter block
    (the serve watchdog and the chunked driver already parse it), and
    the active trace span. Shared by every sentinel in this module so a
    new anomaly kind cannot silently miss a surface."""
    event = {"kind": kind, "step": int(step), **detail}
    events.append(event)
    REGISTRY.inc("bnb_anomalies_total", kind=kind)
    from ..resilience.health import HEALTH

    HEALTH.incr(f"anomaly_{kind}")
    from . import tracing as _tracing

    _tracing.add_event(f"anomaly_{kind}", **{"step": int(step), **detail})
    return event


def merge_summaries(*sentinels: Optional[Any]) -> Optional[Dict[str, Any]]:
    """One ``anomalies`` block from several sentinels (stall + rank
    starvation): events merged onto one step-ordered timeline. None when
    every sentinel is None (``TSP_OBS=off`` — the solver result's
    contract is that the whole block is absent, not empty)."""
    alive = [s for s in sentinels if s is not None]
    if not alive:
        return None
    events = sorted(
        (e for s in alive for e in s.events),
        key=lambda e: (e.get("step", 0), e.get("kind", "")),
    )
    return {"events": events, "fired": len(events)}


class StallSentinel:
    """Streaming detector over (nodes/sec, certified-LB-floor, incumbent)
    samples. Hot path: buffer the sample; every ``window`` samples, run
    both checks on the buffered window."""

    __slots__ = (
        "window", "collapse_ratio", "lb_window", "lb_min_gain", "min_rate",
        "_buf", "_count", "_last", "_medians", "_anchors",
        "_rate_alarmed", "_lb_alarmed", "events", "consumed",
    )

    def __init__(
        self,
        *,
        window: int = 16,
        collapse_ratio: float = 0.25,
        lb_window: int = 256,
        lb_min_gain: float = 1e-9,
        min_rate: float = 0.0,
    ) -> None:
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.collapse_ratio = collapse_ratio
        self.lb_window = lb_window
        self.lb_min_gain = lb_min_gain
        #: rates at/below this never enter a window median (a dispatch
        #: that popped nothing is a refill boundary, not a healthy rate)
        self.min_rate = min_rate
        self._buf: List[float] = []  # current window's rates (hot append)
        self._count = 0  # samples in the current window (hot compare)
        #: newest sample: (step, lb_floor, incumbent, open_nodes)
        self._last: tuple = (0, float("-inf"), float("inf"), 0)
        self._medians: deque = deque(maxlen=_BASELINE_WINDOWS)
        #: one (step, lb_floor, incumbent) anchor per completed window;
        #: stagnation compares the oldest vs newest anchor, so the span
        #: covers ~lb_window dispatches at window-granular anchors
        self._anchors: deque = deque(maxlen=max(2, lb_window // window))
        self._rate_alarmed = False
        self._lb_alarmed = False
        #: fired events, newest-last: [{"kind", "step", ...detail}]
        self.events: List[Dict[str, Any]] = []
        #: sampler-ring rows already consumed (see :meth:`consume`)
        self.consumed = 0

    @classmethod
    def maybe(cls, **kw) -> Optional["StallSentinel"]:
        """A sentinel when obs is enabled, else None (one is-None check
        per dispatch under ``TSP_OBS=off`` — same contract as the
        sampler it rides next to)."""
        return cls(**kw) if _obs_enabled() else None

    # -- the per-dispatch feed ----------------------------------------------

    def feed(
        self,
        step: int,
        nodes_per_s: float,
        lb_floor: float,
        incumbent: float,
        open_nodes: int = 0,
    ) -> Optional[List[Dict[str, Any]]]:
        """Positional hot-path feed (direct callers / :meth:`observe`):
        returns None except at a window boundary, where it returns the
        events fired by the flush. ``open_nodes`` = total open work
        (frontier + reservoir) — the stagnation check's drain signal.
        All analysis (medians, anchors, stagnation spans) is amortized
        into that once-per-``window`` flush."""
        if nodes_per_s > self.min_rate:
            self._buf.append(nodes_per_s)
        self._count += 1
        if self._count < self.window:
            return None
        self._last = (step, lb_floor, incumbent, open_nodes)
        return self._flush_window()

    def consume(self, sampler) -> Optional[List[Dict[str, Any]]]:
        """Ring-fed batch path (what ``StepSampler.sample`` uses): pull
        every row appended to the sampler's ring since the last consume
        and run the window checks. The sampler calls this only when a
        full window has accrued, so the PER-DISPATCH sentinel cost is
        one attribute load + one integer compare — the second Python
        call per dispatch that :meth:`feed` used to be was about half
        the telemetry budget. Semantics match
        feed(): same min-rate filter, same window cadence, and the
        window's newest row provides the (step, lb_floor, incumbent,
        open-work) anchor."""
        total, cap, rows = sampler._total, sampler.capacity, sampler._rows
        # rows older than the ring still holds cannot be replayed
        start = max(self.consumed, total - cap)
        wrapped = len(rows) == cap
        mr = self.min_rate
        buf = self._buf
        r = None
        for i in range(start, total):
            r = rows[i % cap] if wrapped else rows[i]
            rate = r[3]  # timeseries.COLUMNS: nodes_per_s
            if rate > mr:
                buf.append(rate)
        self._count += total - start
        self.consumed = total
        if self._count < self.window or r is None:
            return None
        # step, lb_floor, incumbent, frontier + reservoir (open work)
        self._last = (r[0], r[8], r[7], r[4] + r[9])
        return self._flush_window()

    def observe(
        self,
        *,
        step: int,
        nodes_per_s: float,
        lb_floor: float,
        incumbent: float = float("inf"),
        open_nodes: int = 0,
    ) -> List[Dict[str, Any]]:
        """Keyword wrapper over :meth:`feed` (tests / direct callers);
        returns the events fired by this sample (usually empty)."""
        return self.feed(step, nodes_per_s, lb_floor, incumbent, open_nodes) or []

    def _flush_window(self) -> List[Dict[str, Any]]:
        self._count = 0
        fired: List[Dict[str, Any]] = []
        step = self._last[0]
        if self._buf:
            cur = _median(self._buf)
            self._buf = []
            if len(self._medians) == self._medians.maxlen:
                fired.extend(self._check_rate(step, cur))
            self._medians.append(cur)
        self._anchors.append(self._last)
        if len(self._anchors) == self._anchors.maxlen:
            fired.extend(self._check_lb(step))
        return fired

    def _fire(self, kind: str, step: int, **detail: Any) -> Dict[str, Any]:
        return fire_anomaly(self.events, kind, step, **detail)

    def _check_rate(self, step: int, cur: float) -> List[Dict[str, Any]]:
        baseline = _median(self._medians)
        collapsed = baseline > 0 and cur < self.collapse_ratio * baseline
        if collapsed and not self._rate_alarmed:
            self._rate_alarmed = True
            return [self._fire(
                "nodes_rate_collapse", step,
                recent_median=round(cur, 3),
                baseline_median=round(baseline, 3),
                ratio=round(cur / baseline, 4),
            )]
        if not collapsed:
            self._rate_alarmed = False  # episode over: re-arm
        return []

    def _check_lb(self, step: int) -> List[Dict[str, Any]]:
        step0, lb0, inc0, open0 = self._anchors[0]
        step1, lb1, inc1, open1 = self._anchors[-1]
        span_steps = step1 - step0
        # total stagnation only: a flat certified floor is NORMAL mid-DFS
        # (within one solve it CANNOT move — it is clamped once at setup),
        # and a flat incumbent is the entire prove-the-incumbent endgame.
        # The verdict therefore also needs the open work (frontier +
        # reservoir) to be holding/growing: a draining open set IS gap
        # progress, and without this condition the detector fired on
        # every healthy proof run longer than lb_window dispatches.
        floor_flat = (
            lb0 > float("-inf") and (lb1 - lb0) < self.lb_min_gain
        )
        inc_flat = not (inc1 < inc0 - self.lb_min_gain)
        not_draining = open1 >= open0
        stagnant = span_steps > 0 and floor_flat and inc_flat and not_draining
        if stagnant and not self._lb_alarmed:
            self._lb_alarmed = True
            return [self._fire(
                "lb_stagnation", step,
                lb_floor=round(lb1, 6),
                gain=round(lb1 - lb0, 9),
                over_steps=int(span_steps),
                open_nodes=int(open1),
            )]
        if not stagnant:
            self._lb_alarmed = False
        return []

    def summary(self) -> Dict[str, Any]:
        """JSON-ready tail for the solver result / driver payload."""
        return {
            "events": list(self.events),
            "fired": len(self.events),
        }


class RankStarvationSentinel:
    """Per-rank starvation-episode detector over the rank-resolved
    telemetry windows.

    Fed once per ``obs.rankview.RankSampler`` window with the per-rank
    occupancy snapshot and the per-rank nodes expanded IN that window. A
    rank is *starving* in a window when the mesh as a whole expanded
    work but that rank's share fell below ``starve_ratio`` x its fair
    share (total / num_ranks) — every rank runs the
    same dispatches, so under-expansion can only mean the rank HAD no
    work: the stranded-rank shape the JAX package's ring-balance record
    shows (12,554x max/min node imbalance, one rank pinned at 7
    nodes for a 238k-node run).

    Episode semantics match the stall sentinel: ``rank_starvation``
    fires once per rank per episode, after ``patience`` consecutive
    starving windows, and re-arms only when the rank recovers — a rank
    stranded for an hour is one event, not one per window. Events go
    through :func:`fire_anomaly` (health counters, registry, live
    span), with the rank id in the event detail (bounded label: ranks
    come from ``range(num_ranks)``).

    A drained mesh (zero nodes everywhere — the proof endgame or the
    terminal window) is not starvation: nobody is being starved when
    there is nothing to eat; streaks hold but never grow across such
    windows.
    """

    __slots__ = (
        "num_ranks", "starve_ratio", "patience",
        "_streak", "_alarmed", "episodes_per_rank", "events",
    )

    def __init__(
        self,
        num_ranks: int,
        *,
        starve_ratio: float = 0.1,
        patience: int = 2,
    ) -> None:
        if num_ranks < 1:
            raise ValueError(f"num_ranks must be >= 1, got {num_ranks}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.num_ranks = num_ranks
        self.starve_ratio = starve_ratio
        self.patience = patience
        self._streak = [0] * num_ranks
        self._alarmed = [False] * num_ranks
        #: fired-episode count per rank (rank_balance's starvation column)
        self.episodes_per_rank = [0] * num_ranks
        #: fired events, newest-last (merge_summaries folds them into the
        #: solver's anomalies block beside the stall sentinel's)
        self.events: List[Dict[str, Any]] = []

    @classmethod
    def maybe(cls, num_ranks: int, **kw) -> Optional["RankStarvationSentinel"]:
        """A sentinel when obs is enabled, else None — same contract as
        the samplers it rides next to."""
        return cls(num_ranks, **kw) if _obs_enabled() else None

    def observe_window(
        self, step: int, occupancy, nodes
    ) -> List[Dict[str, Any]]:
        """One completed sampling window: per-rank occupancy (current
        rows) and per-rank nodes expanded within the window. Returns the
        events fired by this window (usually empty). Called once per
        window by ``RankSampler.sample`` — never per dispatch."""
        fired: List[Dict[str, Any]] = []
        if self.num_ranks < 2:
            return fired  # a 1-rank mesh cannot starve anyone
        total = float(sum(nodes))
        if total <= 0:
            return fired  # drained/idle mesh: hold streaks, fire nothing
        fair = total / self.num_ranks
        cut = self.starve_ratio * fair
        for r in range(self.num_ranks):
            if float(nodes[r]) < cut:
                self._streak[r] += 1
                if self._streak[r] >= self.patience and not self._alarmed[r]:
                    self._alarmed[r] = True
                    self.episodes_per_rank[r] += 1
                    fired.append(fire_anomaly(
                        self.events, "rank_starvation", step,
                        rank=r,
                        window_nodes=int(nodes[r]),
                        fair_share=round(fair, 1),
                        mesh_nodes=int(total),
                        windows=self._streak[r],
                        occupancy=int(occupancy[r]),
                    ))
            else:
                self._streak[r] = 0
                self._alarmed[r] = False  # episode over: re-arm
        return fired

    def summary(self) -> Dict[str, Any]:
        """JSON-ready tail (same shape as the stall sentinel's)."""
        return {
            "events": list(self.events),
            "fired": len(self.events),
        }

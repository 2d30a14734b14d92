"""Rank-resolved telemetry for the sharded search.

Counterpart of ``tsp_mpi_reduction_tpu/obs/rankview.py``. The
``StepSampler`` samples global aggregates, ``SpillStats`` folds bytes
across ranks, and the stall sentinel watches one pooled series; this
module says *which rank* is starved, spilling, or straggling, and makes
every sharded run a load-balance report:

- :class:`RankSampler` — a ring of per-window ``[R]`` vectors: frontier
  occupancy, alive (incumbent-open) rows, nodes expanded, host reservoir
  depth, spill events/bytes each way, and each rank's best open bound.
  The device-side columns arrive as ONE small ``[R, K]`` float32 row
  from ``parallel.reduce.make_rank_stats``: with the ranks stacked on one
  device, the sharded round's tail makes it and the dispatch's one read
  brings it (the host's own spill writes patched in from the rows it
  wrote); over a rank-process group, each process's rows and one
  ``all_gather`` a window. Everything else is host-side arithmetic the
  sharded loop already owns. A sample is taken once per ``window``
  host-loop dispatches (default 8, ``TSP_RANK_WINDOW``), so the
  per-dispatch cost is one counter compare; ``METER_NS`` prices the
  whole hook.
- :class:`~.anomaly.RankStarvationSentinel` (obs.anomaly) — attached as
  ``.watch``; each completed window feeds it, and a rank whose share of
  the window's expansion work collapses fires ``rank_starvation`` once
  per episode.
- :func:`rank_balance` — the imbalance accounting block stamped into
  the driver payload as ``obs.rank_balance``: per-rank totals plus
  occupancy coefficient-of-variation, straggler rank/score, starved
  ranks and episode counts.
- :func:`fold_rank_view` — end-of-solve registry export as
  rank-labeled gauges/counters. Rank labels are drawn from
  ``range(num_ranks)`` — a bounded set.

The root ``tools/obs_report.py --ranks`` renders the series as a per-rank
occupancy heatmap + totals table.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from . import anomaly as _anomaly
from . import enabled as _obs_enabled
from .metrics import REGISTRY

#: row layout of :meth:`RankSampler.series` rows — ``step`` is a scalar,
#: every other column is a per-rank [R] list
RANK_COLUMNS = (
    "step",             # cumulative expansion-step counter at sample time
    "occupancy",        # live frontier rows per rank (post spill/refill)
    "alive",            # rows the incumbent has not closed, per rank
    "nodes",            # nodes expanded by THIS window, per rank
    "reservoir",        # host reservoir depth per rank
    "spill_events",     # spill/refill exchange events this window, per rank
    "spill_to_host",    # bytes spilled host-ward this window, per rank
    "spill_to_device",  # bytes refilled device-ward this window, per rank
    "best_bound",       # per-rank best open bound (null when drained)
)

#: env knob for the sampling window (host-loop dispatches per sample)
ENV_WINDOW = "TSP_RANK_WINDOW"
_DEFAULT_WINDOW = 8


class RankSampler:
    """Ring-buffered per-rank sampler for the sharded host loop.

    Hot-path contract mirrors ``StepSampler``: the solver guards every
    call on the handle (``maybe()`` returns None under ``TSP_OBS=off``),
    calls :meth:`due` once per dispatch (one increment + compare), and
    only on a True verdict pays for the ``[R, K]`` device gather +
    :meth:`sample`. Cumulative inputs (nodes, spill counters) are
    differenced against the previous sample internally, so the solver
    hands over the arrays it already maintains.
    """

    __slots__ = (
        "num_ranks", "capacity", "window", "_rows", "_total", "_since",
        "_prev", "watch",
    )

    #: native self-meter accumulator handle (class-level, None = off):
    #: a caller that prices the hook sets this to a one-element ``[ns]``
    #: list and the SOLVER bills the whole rank hook into it — the
    #: due() compare, the [R, K] stats-row gather/readback, and the
    #: sample() body — at its own call site (the expensive part, the
    #: collective dispatch, lives outside this class, so in-method
    #: self-timing would systematically under-count)
    METER_NS: Optional[List[int]] = None

    def __init__(
        self, num_ranks: int, capacity: int = 256, window: int = _DEFAULT_WINDOW
    ) -> None:
        if num_ranks < 1:
            raise ValueError(f"num_ranks must be >= 1, got {num_ranks}")
        if capacity < 1:
            raise ValueError(f"sampler capacity must be >= 1, got {capacity}")
        if window < 1:
            raise ValueError(f"sampling window must be >= 1, got {window}")
        self.num_ranks = num_ranks
        self.capacity = capacity
        self.window = window
        self._rows: List[tuple] = []
        self._total = 0
        self._since = 0  # dispatches since the last recorded sample
        #: previous CUMULATIVE (nodes, spill_events, to_host, to_device)
        zeros = (0,) * num_ranks
        self._prev = [zeros, zeros, zeros, zeros]
        #: attached starvation sentinel (``maybe()`` wires one); fed once
        #: per completed window from :meth:`sample`
        self.watch: Optional[_anomaly.RankStarvationSentinel] = None

    @classmethod
    def maybe(
        cls,
        num_ranks: int,
        capacity: int = 256,
        window: Optional[int] = None,
    ) -> Optional["RankSampler"]:
        """A sampler (with its starvation watch) when obs is enabled,
        else None — ``TSP_OBS=off`` costs one is-None check per dispatch,
        the same contract as ``StepSampler.maybe``."""
        if not _obs_enabled():
            return None
        if window is None:
            try:
                window = int(os.environ.get(ENV_WINDOW, "") or _DEFAULT_WINDOW)
            except ValueError:
                window = _DEFAULT_WINDOW
        s = cls(num_ranks, capacity, max(window, 1))
        s.watch = _anomaly.RankStarvationSentinel(num_ranks)
        return s

    # -- cadence -------------------------------------------------------------

    def due(self) -> bool:
        """Advance the per-dispatch tick; True when this dispatch should
        pay for a sample (the first dispatch, then every ``window``-th).
        The caller performs the device gather and calls :meth:`sample`
        only on True — this split keeps the collective out of the
        per-dispatch path."""
        self._since += 1
        return self._total == 0 or self._since >= self.window

    def pending(self) -> bool:
        """Dispatches have passed since the last sample — the solver
        flushes one final sample at loop exit so the series' tail (and
        the window deltas) cover the whole run."""
        return self._since > 0

    # -- recording -----------------------------------------------------------

    def sample(
        self,
        step: int,
        occupancy: Sequence,
        alive: Sequence,
        nodes_total: Sequence,
        reservoir: Sequence,
        spill_events_total: Sequence,
        spill_to_host_total: Sequence,
        spill_to_device_total: Sequence,
        best_bound: Sequence,
    ) -> None:
        """Record one window. ``occupancy``/``alive``/``best_bound`` are
        current snapshots (the ``[R, K]`` device row + host reservoir
        state); ``*_total`` are CUMULATIVE per-rank counters — the delta
        against the previous sample is what lands in the row, so each
        row reads "what happened in this window"."""
        occ = tuple(int(v) for v in occupancy)
        alv = tuple(int(v) for v in alive)
        res = tuple(int(v) for v in reservoir)
        bb = tuple(float(v) for v in best_bound)
        cum = [
            tuple(int(v) for v in nodes_total),
            tuple(int(v) for v in spill_events_total),
            tuple(int(v) for v in spill_to_host_total),
            tuple(int(v) for v in spill_to_device_total),
        ]
        prev = self._prev
        deltas = [
            tuple(c - p for c, p in zip(cur, prv))
            for cur, prv in zip(cum, prev)
        ]
        self._prev = cum
        row = (int(step), occ, alv, deltas[0], res,
               deltas[1], deltas[2], deltas[3], bb)
        rows = self._rows
        if len(rows) < self.capacity:
            rows.append(row)
        else:
            rows[self._total % self.capacity] = row
        self._total += 1
        self._since = 0
        w = self.watch
        if w is not None:
            w.observe_window(step, occ, deltas[0])

    def __len__(self) -> int:
        return len(self._rows)

    def series(self) -> Dict[str, Any]:
        """JSON-ready artifact: rows oldest-first plus ring/window
        accounting — the driver payload's ``rank_series`` block."""
        if self._total <= self.capacity:
            raw = list(self._rows)
        else:
            pivot = self._total % self.capacity
            raw = self._rows[pivot:] + self._rows[:pivot]

        rows = [
            [
                r[0], list(r[1]), list(r[2]), list(r[3]), list(r[4]),
                list(r[5]), list(r[6]), list(r[7]),
                # +inf = drained rank: null is the strict-JSON encoding
                [round(b, 6) if -1e308 < b < 1e308 else None for b in r[8]],
            ]
            for r in raw
        ]
        return {
            "columns": list(RANK_COLUMNS),
            "ranks": self.num_ranks,
            "window": self.window,
            "rows": rows,
            "samples_total": self._total,
            "samples_dropped": max(self._total - self.capacity, 0),
        }


# -- imbalance accounting ------------------------------------------------------


def _cv(values: Sequence[float]) -> float:
    """Population coefficient of variation (std/mean); 0 for an empty or
    all-zero vector — a drained mesh is balanced, not undefined."""
    vals = [float(v) for v in values]
    if not vals:
        return 0.0
    mean = sum(vals) / len(vals)
    if mean == 0:
        return 0.0
    var = sum((v - mean) ** 2 for v in vals) / len(vals)
    return (var ** 0.5) / abs(mean)


def rank_balance(
    series: Optional[Dict[str, Any]],
    nodes_per_rank: Sequence,
    *,
    spill_events: Optional[Sequence] = None,
    spill_bytes_to_host: Optional[Sequence] = None,
    spill_bytes_to_device: Optional[Sequence] = None,
    reservoir: Optional[Sequence] = None,
    events: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The imbalance accounting block (``obs.rank_balance``).

    ``nodes_per_rank`` and the spill vectors are the solver's
    authoritative whole-run totals (the series' window deltas only cover
    what the ring still holds); occupancy statistics come from the
    series rows. The *straggler* is the rank carrying the most work:
    every dispatch runs the ranks in lockstep, so the overloaded rank
    is the one everyone else idles behind — ``straggler_score`` is its
    node count over the mesh mean (1.0 = perfectly balanced). Starved
    ranks are read from the ``rank_starvation`` events.
    """
    nodes = [int(v) for v in nodes_per_rank]
    ranks = len(nodes)
    total = sum(nodes)
    mean = total / ranks if ranks else 0.0
    occ_mean: List[float] = [0.0] * ranks
    if series and series.get("rows"):
        idx = series["columns"].index("occupancy")
        cols = [r[idx] for r in series["rows"]]
        occ_mean = [
            round(sum(c[r] for c in cols) / len(cols), 2)
            for r in range(ranks)
        ]
    starve_events = [
        e for e in (events or []) if e.get("kind") == "rank_starvation"
    ]
    starved = sorted({int(e["rank"]) for e in starve_events})
    straggler = max(range(ranks), key=lambda r: nodes[r]) if ranks else 0
    out: Dict[str, Any] = {
        "ranks": ranks,
        "nodes_per_rank": nodes,
        "nodes_total": total,
        "nodes_cv": round(_cv(nodes), 4),
        "nodes_max_min_ratio": (
            round(max(nodes) / max(min(nodes), 1), 2) if nodes else 0.0
        ),
        "occupancy_mean": occ_mean,
        "occupancy_cv": round(_cv(occ_mean), 4),
        "straggler_rank": int(straggler),
        "straggler_score": round(nodes[straggler] / mean, 3) if mean else 0.0,
        "starved_ranks": starved,
        "starvation_episodes": len(starve_events),
    }
    if spill_events is not None:
        out["spill_events_per_rank"] = [int(v) for v in spill_events]
    if spill_bytes_to_host is not None:
        out["spill_bytes_to_host_per_rank"] = [
            int(v) for v in spill_bytes_to_host
        ]
    if spill_bytes_to_device is not None:
        out["spill_bytes_to_device_per_rank"] = [
            int(v) for v in spill_bytes_to_device
        ]
    if reservoir is not None:
        out["reservoir_per_rank"] = [int(v) for v in reservoir]
    return out


def fold_rank_view(balance: Dict[str, Any]) -> None:
    """Fold one finished sharded solve's rank view into the registry —
    called once per solve from ``models.branch_bound``, never per
    dispatch. Rank labels come from ``range(num_ranks)``: bounded
    cardinality by construction (the set can never outgrow the mesh)."""
    num_ranks = int(balance["ranks"])
    for r in range(num_ranks):
        REGISTRY.inc(
            "bnb_rank_nodes_total", balance["nodes_per_rank"][r], rank=r
        )
        REGISTRY.set_gauge(
            "bnb_rank_occupancy_mean", balance["occupancy_mean"][r], rank=r
        )
        if "spill_bytes_to_host_per_rank" in balance:
            REGISTRY.inc(
                "bnb_rank_spill_bytes_total",
                balance["spill_bytes_to_host_per_rank"][r],
                rank=r, direction="to_host",
            )
        if "spill_bytes_to_device_per_rank" in balance:
            REGISTRY.inc(
                "bnb_rank_spill_bytes_total",
                balance["spill_bytes_to_device_per_rank"][r],
                rank=r, direction="to_device",
            )
        if "spill_events_per_rank" in balance:
            REGISTRY.inc(
                "bnb_rank_spill_events_total",
                balance["spill_events_per_rank"][r], rank=r,
            )
    REGISTRY.set_gauge("bnb_rank_occupancy_cv", balance["occupancy_cv"])
    REGISTRY.set_gauge("bnb_rank_nodes_cv", balance["nodes_cv"])
    REGISTRY.set_gauge("bnb_rank_straggler_score", balance["straggler_score"])

"""Ring-buffered per-dispatch sampler for the B&B host loops.

Counterpart of ``tsp_mpi_reduction_tpu/obs/timeseries.py``. One row per
host-loop iteration, i.e. per dispatch: a reservoir exchange or refill,
a checkpoint, the int32 cap or the end of the search ends one (never per
expansion step, which would add a row per device-loop step that the JAX
package does not have): expansion progress, nodes/sec, frontier
occupancy, spill bytes each way, and the incumbent / certified-floor
trajectory. The ring keeps the newest ``capacity`` rows
(``samples_dropped`` counts the older ones that rolled off), so a
multi-hour campaign costs bounded memory.

The series flushes into ``BnBResult.series`` and the JSON lines of
``tools/bnb_solve.py`` / ``tools/bnb_chunked.py``; the root
``tools/obs_report.py --series`` renders it.

This series is mesh-GLOBAL (one row per dispatch, aggregates summed over
the ranks). Its rank-resolved sibling, one row of ``[R]`` vectors per
sampling window, is ``obs.rankview.RankSampler`` (``BnBResult.rank_series``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import enabled as _obs_enabled

#: row layout, in order — kept in the JSON artifact so readers can zip
COLUMNS = (
    "step",            # cumulative expansion-step counter (solver `it`)
    "wall_s",          # seconds since the search loop started
    "nodes",           # nodes expanded by THIS dispatch
    "nodes_per_s",     # this dispatch's expansion rate
    "frontier",        # live frontier rows after the dispatch (+ spill)
    "spill_to_host",   # bytes spilled host-ward by this iteration
    "spill_to_device", # bytes refilled device-ward by this iteration
    "incumbent",       # best tour cost so far
    "lb_floor",        # certified lower-bound floor (root/resume clamp)
    "reservoir",       # rows parked in the host spill reservoir — with
                       # `frontier` this is the TOTAL open work, the
                       # signal that separates a draining proof phase
                       # from a wedged search (obs.anomaly)
)


class StepSampler:
    #: slotted: the per-dispatch hot path touches five attributes; slot
    #: access keeps its in-situ footprint (the hook runs cold-cache
    #: between device dispatches) at the floor
    __slots__ = (
        "capacity", "_rows", "_total", "row_bytes", "frontier_layout",
        "sentinel",
    )

    #: native self-meter (class-level, None = off): a caller that prices
    #: the telemetry sets this to a one-element ``[ns]`` list
    #: and ``sample`` accumulates its own inclusive time into it. A
    #: wrapper-based meter is NOT equivalent here: the wrapping frame +
    #: argument re-packing costs ~1.5 us per call in situ — most of the
    #: budget it is supposed to measure — while this is one is-None
    #: check when off and two ``perf_counter_ns`` calls when on.
    METER_NS: Optional[List[int]] = None

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"sampler capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rows: List[List[Any]] = []
        self._total = 0
        #: bytes per packed frontier node row, set once by the solver —
        #: the spill_to_host/spill_to_device columns count ACTUAL packed
        #: bytes (they shrank ~3x with the v2 int8-packed layout), so the
        #: series records the divisor that converts them to node counts
        self.row_bytes: Optional[int] = None
        #: engine row-layout version the bytes were measured under
        self.frontier_layout: Optional[int] = None
        #: optional attached ``obs.anomaly.StallSentinel``: when set,
        #: sample() hands it the ring to batch-consume once per full
        #: window (``StallSentinel.consume``) — per dispatch the
        #: sentinel costs one compare, not a second Python call
        #: (the telemetry's <= 2% budget)
        self.sentinel: Optional[Any] = None

    @classmethod
    def maybe(cls, capacity: int = 512) -> Optional["StepSampler"]:
        """A sampler when obs is enabled, else None (the solver guards
        each sample call on the returned handle, so ``TSP_OBS=off`` pays
        one `is None` check per dispatch)."""
        return cls(capacity) if _obs_enabled() else None

    def sample(
        self,
        step: int,
        wall_s: float,
        nodes: int,
        nodes_per_s: float,
        frontier: int,
        spill_to_host: int = 0,
        spill_to_device: int = 0,
        incumbent: float = float("inf"),
        lb_floor: float = float("-inf"),
        reservoir: int = 0,
    ) -> None:
        # hot path (once per host-loop iteration): store raw values only;
        # all rounding/JSON-sanitizing happens once, in series(). The
        # solver calls this POSITIONALLY — a 9-kwarg call costs ~1 us
        # more than positional in situ (dict build + unpack, cold-cache),
        # which is real money against the telemetry's <= 2% budget.
        m = StepSampler.METER_NS
        if m is not None:
            t_meter = time.perf_counter_ns()
        rows = self._rows
        row = (
            step, wall_s, nodes, nodes_per_s, frontier,
            spill_to_host, spill_to_device, incumbent, lb_floor, reservoir,
        )
        if len(rows) < self.capacity:
            rows.append(row)
        else:
            rows[self._total % self.capacity] = row
        total = self._total + 1
        self._total = total
        # sentinel rides the ring this sampler already keeps: one compare
        # per dispatch here, one batch consume per full window there — a
        # second per-dispatch Python call was ~half the telemetry budget
        sn = self.sentinel
        if sn is not None and total - sn.consumed >= sn.window:
            sn.consume(self)
        if m is not None:
            m[0] += time.perf_counter_ns() - t_meter

    def __len__(self) -> int:
        return len(self._rows)

    def series(self) -> Dict[str, Any]:
        """JSON-ready artifact: rows oldest-first plus ring accounting."""
        if self._total <= self.capacity:
            raw = list(self._rows)
        else:
            pivot = self._total % self.capacity
            raw = self._rows[pivot:] + self._rows[:pivot]

        def _finite(x: float) -> Optional[float]:
            # ±inf (no incumbent yet / no certified floor) would emit
            # non-strict JSON (`Infinity`); null is the honest encoding
            x = float(x)
            return x if -1e308 < x < 1e308 else None

        rows = [
            [
                int(r[0]), round(float(r[1]), 6), int(r[2]),
                round(float(r[3]), 3), int(r[4]), int(r[5]), int(r[6]),
                _finite(r[7]), _finite(r[8]), int(r[9]),
            ]
            for r in raw
        ]
        return {
            "columns": list(COLUMNS),
            "rows": rows,
            "samples_total": self._total,
            "samples_dropped": max(self._total - self.capacity, 0),
            # packed-row provenance: spill byte columns / row_bytes =
            # rows moved; None when the producer never set it
            "row_bytes": self.row_bytes,
            "frontier_layout": self.frontier_layout,
        }

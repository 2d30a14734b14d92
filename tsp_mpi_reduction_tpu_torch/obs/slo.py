"""Serve latency SLOs: windowed attainment + burn rate from histograms.

The port's copy of ``tsp_mpi_reduction_tpu/obs/slo.py`` (standard library
only, so it is copied as it is).

Clipper (PAPERS.md) frames serving as *meeting explicit latency
objectives*, not just reporting latencies. This module closes that gap:
``ServiceConfig.slos`` declares one objective per answering tier
(``{"target_ms": …, "goal": …}`` — e.g. "99% of greedy answers inside
50 ms"), and :func:`evaluate` computes, from the tier-labeled
``serve_request_seconds`` histograms the service already records, the
session-window attainment and the error-budget burn rate:

    attainment = P(latency <= target)           (bucket-interpolated)
    burn_rate  = (1 - attainment) / (1 - goal)  (1.0 = exactly on budget,
                                                 >1 = burning faster than
                                                 the objective allows)

The window is the serve session (the stats JSON's existing delta
semantics): ``SolveService`` snapshots the histograms at start and
evaluates the delta, so back-to-back sessions in one process judge their
OWN traffic. Attainment inside the bucket containing the target is
linearly interpolated — precise enough for objectives that sit between
bucket edges, and honest about it (``interpolated: true`` in the block).

The block rides ``service_stats_json`` (``slo`` key) so deadline-ladder
tuning, the ORCA-style scheduler work (ROADMAP), and fleet-level health
checks all read verdicts, not raw histograms.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

#: default per-tier objectives: generous enough that a healthy CPU serve
#: session passes, tight enough that a wedged worker or a cold-compile
#: stampede shows up as burn > 1. Tiers answer different budgets, so the
#: objectives scale with the rung.
DEFAULT_SLOS: Dict[str, Dict[str, float]] = {
    "greedy": {"target_ms": 50.0, "goal": 0.999},
    "pipeline": {"target_ms": 1000.0, "goal": 0.99},
    "bnb": {"target_ms": 10_000.0, "goal": 0.95},
}


def hist_attainment(hist: Dict[str, Any], target_s: float) -> Optional[float]:
    """Fraction of observations at or under ``target_s``, from a
    bucket-counts histogram dict (``obs.metrics._Hist.as_dict`` shape).
    Linear interpolation inside the bucket the target falls in; None when
    the histogram is empty (no verdict without traffic)."""
    count = int(hist.get("count", 0))
    if count <= 0:
        return None
    buckets = list(hist.get("buckets", ()))
    counts = list(hist.get("counts", ()))
    attained = 0.0
    lo = 0.0
    for edge, c in zip(buckets, counts):
        if target_s >= edge:
            attained += c
            lo = edge
            continue
        # target inside (lo, edge]: assume uniform spread in the bucket
        width = edge - lo
        frac = (target_s - lo) / width if width > 0 else 0.0
        attained += c * max(0.0, min(1.0, frac))
        break
    else:
        # target beyond the last finite edge: the +Inf bucket's
        # observations are all ABOVE it — conservatively not attained
        # unless the target is infinite
        pass
    return min(attained / count, 1.0)


class BurnMeter:
    """LIVE windowed burn-rate estimator — the admission-control signal.

    :func:`evaluate` judges a whole serve session retrospectively from
    histograms; admission control needs the burn rate NOW, over recent
    traffic only, so a bad first minute doesn't shed requests an hour
    later. This keeps a bounded deque of the last ``window`` latencies
    per answering tier and computes the same burn definition over it:

        burn = (fraction of recent answers over target) / (1 - goal)

    ``burn() is None`` until ``min_count`` answers have landed in a
    tier's window — no shedding on no evidence. The serve scheduler
    reads :meth:`burn` to prioritize a burning tier's queue and the
    ladder reads it to shed/degrade new admissions to that tier
    (``LadderConfig.slo_shed_burn``); :meth:`snapshot` rides the stats
    JSON ``admission`` block. Thread-safe; O(window) reads on arrays of
    ~tens of floats."""

    def __init__(
        self,
        slos: Optional[Dict[str, Dict[str, float]]] = None,
        window: int = 64,
        min_count: int = 8,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.slos = DEFAULT_SLOS if slos is None else slos
        self.window = window
        self.min_count = max(int(min_count), 1)
        self._lock = threading.Lock()
        self._lat: Dict[str, deque] = {}

    def observe(self, tier: str, latency_s: float) -> None:
        with self._lock:
            dq = self._lat.get(tier)
            if dq is None:
                dq = self._lat[tier] = deque(maxlen=self.window)
            dq.append(float(latency_s))

    def burn(self, tier: str) -> Optional[float]:
        """Live error-budget burn rate for ``tier``; None without an
        objective or with fewer than ``min_count`` windowed answers."""
        obj = self.slos.get(tier)
        if obj is None:
            return None
        with self._lock:
            dq = self._lat.get(tier)
            if dq is None or len(dq) < self.min_count:
                return None
            lat = list(dq)
        target_s = float(obj["target_ms"]) / 1000.0
        missed = sum(1 for v in lat if v > target_s)
        budget = max(1.0 - float(obj["goal"]), 1e-9)
        return (missed / len(lat)) / budget

    def snapshot(self) -> Dict[str, Any]:
        """Per-tier ``{requests, burn_rate}`` over the live window (the
        stats JSON ``admission.burn`` block)."""
        with self._lock:
            sizes = {t: len(dq) for t, dq in self._lat.items()}
        out: Dict[str, Any] = {}
        for tier in sorted(set(self.slos) | set(sizes)):
            b = self.burn(tier)
            out[tier] = {
                "requests": sizes.get(tier, 0),
                "burn_rate": round(b, 4) if b is not None else None,
            }
        return out


def evaluate(
    hists_by_tier: Dict[str, Dict[str, Any]],
    slos: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Any]:
    """Per-tier SLO verdicts from tier-labeled latency histograms.

    ``hists_by_tier``: tier -> histogram dict (the session-window delta).
    Tiers with an objective but no traffic report ``requests: 0`` and no
    verdict; tiers with traffic but no objective are listed unjudged, so
    a new rung never silently escapes accounting."""
    slos = DEFAULT_SLOS if slos is None else slos
    out: Dict[str, Any] = {}
    for tier in sorted(set(slos) | set(hists_by_tier)):
        obj = slos.get(tier)
        hist = hists_by_tier.get(tier)
        requests = int(hist.get("count", 0)) if hist else 0
        row: Dict[str, Any] = {"requests": requests}
        if obj is None:
            row["objective"] = None
            out[tier] = row
            continue
        target_s = float(obj["target_ms"]) / 1000.0
        goal = float(obj["goal"])
        row["target_ms"] = float(obj["target_ms"])
        row["goal"] = goal
        attainment = hist_attainment(hist, target_s) if hist else None
        if attainment is None:
            row.update(attainment=None, burn_rate=None, ok=None)
        else:
            budget = max(1.0 - goal, 1e-9)
            burn = (1.0 - attainment) / budget
            row.update(
                attainment=round(attainment, 6),
                burn_rate=round(burn, 4),
                ok=attainment >= goal,
                interpolated=True,
            )
        out[tier] = row
    return out

"""Output compatibility surface and the metrics line.

The reference's final stdout line is its machine interface (``test.sh``
scrapes cost and time from it), so these lines are byte-compatible:

- banner:    ``We have %i cities for each of our %i blocks`` (tsp.cpp:307)
- dims line: ``%i blocks in X %i in Y``                      (tsp.cpp:377)
- final:     ``TSP ran in %llu ms for %lu cities and the trip cost %f``
                                                              (tsp.cpp:363)
"""

from __future__ import annotations

import json
from typing import Dict, Optional


def banner_line(num_cities_per_block: int, num_blocks: int) -> str:
    return f"We have {num_cities_per_block} cities for each of our {num_blocks} blocks"


def dims_line(rows: int, cols: int) -> str:
    return f"{rows} blocks in X {cols} in Y"


def final_line(elapsed_ms: int, num_cities: int, cost: float) -> str:
    # printf "%f" == fixed 6 decimals
    return f"TSP ran in {elapsed_ms} ms for {num_cities} cities and the trip cost {cost:f}"


def usage_line() -> str:
    # argv[0]-independent replica of tsp.cpp:282
    return "Usage:  ./tsp numCitiesPerBlock numBlocks gridDimX gridDimY"


def too_many_cities_line() -> str:
    return (
        "Come on... We don't want to wait forever so lets just have you "
        "retry that with less than 16 cities per block..."
    )


CSV_HEADER = "numCities,numBlocks,numProcs,time,cost"  # test.sh:4


def csv_row(num_cities: int, num_blocks: int, num_procs: int, time_ms: int, cost: float) -> str:
    return f"{num_cities},{num_blocks},{num_procs},{time_ms},{cost:f}"


def metrics_json(
    *,
    config: Dict,
    elapsed_ms: float,
    cost: float,
    phase_seconds: Optional[Dict[str, float]] = None,
    dp_states: int = 0,
    dp_transitions: int = 0,
) -> str:
    """One JSON line: config, elapsed time, cost, phases, DP counts."""
    payload = {
        "config": config,
        "elapsed_ms": elapsed_ms,
        "cost": cost,
        "phases_s": phase_seconds or {},
        "dp_states": dp_states,
        "dp_transitions": dp_transitions,
    }
    if elapsed_ms > 0 and dp_transitions:
        payload["dp_transitions_per_sec"] = dp_transitions / (elapsed_ms / 1000.0)
    return json.dumps(payload)


def obs_block(
    *,
    trace_path: Optional[str] = None,
    metrics_port: Optional[int] = None,
) -> Dict:
    """The ``obs`` sub-block of the driver and serve stats JSON: whether
    the optional-overhead telemetry is on, where spans go, the bound
    metrics port, and ``device_costs``: the hand kernels' analytic cost
    and roofline records (``obs.costs``), one per kernel and shape
    launched in this process. The JAX block also carries XLA compile
    phases; the port compiles no XLA, so that key is absent."""
    from ..obs import costs as obs_costs
    from ..obs import enabled as obs_enabled

    return {"enabled": obs_enabled(), "trace": trace_path, "metrics_port": metrics_port,
            "device_costs": obs_costs.device_costs_block()}


def service_stats_json(
    *,
    responses: int,
    errors: int,
    deadline_misses: int,
    tier_counts: Dict[str, int],
    cache: Dict[str, int],
    scheduler: Dict[str, float],
    phases_s: Optional[Dict[str, float]] = None,
    refreshes: int = 0,
    rung_failures: Optional[Dict[str, int]] = None,
    health: Optional[Dict] = None,
    compile_cache: Optional[Dict] = None,
    slo: Optional[Dict] = None,
    obs: Optional[Dict] = None,
    admission: Optional[Dict] = None,
) -> str:
    """The serve layer's one-line stats JSON, with the JAX package's keys
    (``tsp_mpi_reduction_tpu/utils/reporting.py:109-152``): answers per
    tier, rung failures, the cache counters and hit rate, the scheduler's
    batching and slicing counters, phase seconds, the session's health
    delta, ``compile_cache`` (here the root-ascent memo's counters), the
    per-tier SLO verdicts, the admission block and ``obs``."""
    lookups = cache.get("hits", 0) + cache.get("misses", 0)
    payload = {
        "responses": responses,
        "errors": errors,
        "deadline_misses": deadline_misses,
        "refreshes": refreshes,
        "rung_failures": rung_failures or {},
        "tiers": tier_counts,
        "cache": dict(cache, hit_rate=(cache.get("hits", 0) / lookups) if lookups else 0.0),
        "scheduler": scheduler,
        "phases_s": phases_s or {},
        "health": health or {},
        "compile_cache": compile_cache or {},
        "slo": slo or {},
        "admission": admission or {},
        "obs": obs or {},
    }
    return json.dumps(payload)


def fleet_stats_json(
    *,
    responses: int,
    errors: int,
    deadline_misses: int,
    tier_counts: Dict[str, int],
    fleet: Dict,
    cache: Dict,
    health: Optional[Dict] = None,
    slo: Optional[Dict] = None,
    obs: Optional[Dict] = None,
) -> str:
    """The fleet front's stats line, with the JAX package's keys in its
    order (``tsp_mpi_reduction_tpu/utils/reporting.py:154``): the serve
    stats shape without the per-process scheduler internals, plus the
    ``fleet`` block — per-replica state rows (pid, liveness, restarts,
    dispatched/answered, the last ``/metrics.json`` scrape totals),
    supervision totals (restarts, re-dispatches, degraded answers by
    reason, suppressed duplicates) and the shared disk tier's counters."""
    lookups = cache.get("hits", 0) + cache.get("misses", 0)
    payload = {
        "responses": responses,
        "errors": errors,
        "deadline_misses": deadline_misses,
        "tiers": tier_counts,
        "fleet": fleet,
        "cache": dict(cache, hit_rate=(cache.get("hits", 0) / lookups) if lookups else 0.0),
        "health": health or {},
        "slo": slo or {},
        "obs": obs or {},
    }
    return json.dumps(payload)

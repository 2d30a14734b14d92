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

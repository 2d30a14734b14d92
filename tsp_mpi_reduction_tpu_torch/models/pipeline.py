"""The blocked TSP pipeline: generate -> per-block Held-Karp -> merge fold.

Counterpart of ``tsp_mpi_reduction_tpu/models/pipeline.py`` and of the
reference's single-rank ``main()`` (tsp.cpp:270-368):

- the instance is born blocked as dense arrays (no scatter);
- all blocks are solved exactly in one batched Held-Karp solve;
- the rank-local sequential fold (tsp.cpp:348-352) merges block tours,
  gathering distances from the resident ``[N, N]`` matrix.

float64 reproduces the single-rank oracle bit for bit: the distance matrix
is computed on the host and every later op keeps the oracle's rounding and
tie-break order. float32 (the CUDA default) computes distances on the device.

Deviations from the reference (SURVEY.md quirks #6/#8): blocks of 1-2
cities raise ``ValueError`` instead of an INT_MAX cost or a hang; block
counts are validated up front.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.generator import generate_instance
from ..ops.held_karp import build_plan, solve_blocks_from_dists
from ..ops.merge import fold_tours
from ..utils.backend import default_dtype, parse_dtype
from ..utils.profiling import PhaseTimer
from ..utils.state import instance_from_numpy


@dataclass
class PipelineResult:
    """Final solution plus per-phase seconds and DP counts."""

    cost: float
    tour_ids: np.ndarray  # [final_len] global city ids, closed
    num_cities: int
    block_costs: np.ndarray  # [B]
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    dp_states: int = 0
    dp_transitions: int = 0
    #: the resident [N, N] distance matrix on the run's device
    dist: Optional[torch.Tensor] = None


def block_distance_slices(dist: torch.Tensor, num_blocks: int, n: int) -> torch.Tensor:
    """``[N, N]`` global matrix -> ``[B, n, n]`` diagonal blocks (block b
    owns the ids ``[b*n, (b+1)*n)``, tsp.cpp:390,398)."""
    r = dist.reshape(num_blocks, n, num_blocks, n)
    return torch.diagonal(r, dim1=0, dim2=2).permute(2, 0, 1).contiguous()


def validate(n: int, num_blocks: int) -> None:
    """Refuse degenerate configurations before any compute."""
    if n < 3:
        raise ValueError(
            f"blocks need >= 3 cities (got {n}): the reference yields an "
            "INT_MAX sentinel for 1 and hangs for 2 (SURVEY.md quirk #6)"
        )
    if num_blocks < 1:
        raise ValueError(f"need >= 1 block, got {num_blocks}")
    build_plan(n)  # checks the block-size cap


def run_pipeline(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    seed: int = 0,
    dtype=None,
    xy: Optional[np.ndarray] = None,
    device="cuda",
) -> PipelineResult:
    """Run the blocked pipeline for one configuration on ``device``.

    ``dtype`` defaults to float64 on the CPU and float32 on CUDA. ``xy``:
    optional pre-generated ``[B, n, 2]`` coordinates (skips the generator).
    """
    n = num_cities_per_block
    validate(n, num_blocks)
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)

    timer = PhaseTimer(device)
    with timer.phase("generate"):
        if xy is None:
            _, xy = generate_instance(n, num_blocks, grid_dim_x, grid_dim_y, seed)

    with timer.phase("distances"):
        _, dist = instance_from_numpy(xy, dtype, device)
        block_d = block_distance_slices(dist, num_blocks, n)

    with timer.phase("solve"):
        costs, local_tours = solve_blocks_from_dists(block_d, dtype)

    with timer.phase("merge_fold"):
        offsets = (torch.arange(num_blocks, dtype=torch.int32, device=device) * n)[:, None]
        ids, length, cost = fold_tours(local_tours + offsets, costs, dist)

    plan = build_plan(n)
    final_len = int(length)
    return PipelineResult(
        cost=float(cost),
        tour_ids=ids[:final_len].cpu().numpy(),
        num_cities=num_blocks * n,
        block_costs=costs.cpu().numpy(),
        phase_seconds=timer.snapshot(),
        dp_states=plan.dp_states * num_blocks,
        dp_transitions=plan.dp_transitions * num_blocks,
        dist=dist,
    )

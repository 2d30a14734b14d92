"""Multi-rank runs: emulated on one device (``--ranks=P``) or over a rank group.

Counterpart of ``tsp_mpi_reduction_tpu/models/distributed.py``: what the
reference does across P MPI processes — scatter blocks (tsp.cpp:159-195),
solve and fold locally (tsp.cpp:348-352), reduce through its binary tree
(tsp.cpp:52-134). :func:`run_pipeline_ranks` computes it on one device;
:func:`run_pipeline_sharded` runs it over a rank group
(``parallel/mesh.py``), each rank solving its own blocks. Both use the
same block assignment and the same merge order, hence the same final tour.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.generator import generate_instance
from ..ops.held_karp import build_plan, solve_blocks_from_dists
from ..parallel.reduce import (compat_capacity, rank_block_counts, reduce_tours_on_mesh,
                               tree_reduce_single_device)
from ..utils.backend import default_dtype, parse_dtype, synchronize
from ..utils.state import instance_from_numpy
from .pipeline import PipelineResult, block_distance_slices, validate


def _rank_block_layout(num_blocks: int, num_ranks: int):
    """The reference's block assignment padded into ``[P*K]`` slots.

    Returns (order, valid): ``order[slot]`` is the block owned by slot
    ``rank*K + j`` (padding slots alias block 0), ``valid`` marks real
    blocks. Assignment as in tsp.cpp:167-191.
    """
    counts = rank_block_counts(num_blocks, num_ranks)
    k = max(max(counts), 1)
    order, start = [], 0
    for c in counts:
        order.extend(list(range(start, start + c)) + [-1] * (k - c))
        start += c
    order = np.asarray(order, dtype=np.int32)
    valid = order >= 0
    return np.where(valid, order, 0), valid


def run_pipeline_ranks(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    num_ranks: int,
    seed: int = 0,
    dtype=None,
    xy: Optional[np.ndarray] = None,
    compat_bugs: bool = False,
    device="cuda",
) -> PipelineResult:
    """Rank-emulated ``num_ranks``-rank run on one device.

    ``compat_bugs``: reproduce the reference's reduce-side corruption
    (SURVEY.md quirk #5) so the result matches a real p-rank MPI run of the
    unmodified reference; see ``parallel.reduce``.
    """
    n = num_cities_per_block
    validate(n, num_blocks)
    if num_ranks < 1:
        raise ValueError(f"need >= 1 rank, got {num_ranks}")
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)

    if xy is None:
        _, xy = generate_instance(n, num_blocks, grid_dim_x, grid_dim_y, seed)
    _, dist = instance_from_numpy(xy, dtype, device)

    safe, valid = _rank_block_layout(num_blocks, num_ranks)
    safe_t = torch.as_tensor(safe, device=device).long()
    valid_t = torch.as_tensor(valid, device=device)
    block_d = block_distance_slices(dist, num_blocks, n)[safe_t]
    offsets = (safe_t * n).to(torch.int32)
    if compat_bugs:
        capacity = compat_capacity(num_blocks, n, num_ranks)
    else:
        capacity = num_blocks * n + 1

    t0 = time.perf_counter()
    costs, local_tours = solve_blocks_from_dists(block_d, dtype)
    global_tours = local_tours + offsets[:, None]
    costs = torch.where(valid_t, costs, torch.zeros((), dtype=costs.dtype, device=device))
    ids, length, cost = tree_reduce_single_device(
        global_tours, costs, valid_t, dist, capacity, num_ranks, compat_bugs=compat_bugs
    )
    synchronize(device)
    seconds = time.perf_counter() - t0
    plan = build_plan(n)
    final_len = int(length)
    return PipelineResult(
        cost=float(cost),
        tour_ids=ids[:final_len].cpu().numpy(),
        num_cities=num_blocks * n,
        block_costs=costs.cpu().numpy()[valid],
        phase_seconds={"solve_reduce": seconds},
        dp_states=plan.dp_states * num_blocks,
        dp_transitions=plan.dp_transitions * num_blocks,
        dist=dist,
    )


def run_pipeline_sharded(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    ranks,
    seed: int = 0,
    dtype=None,
    xy: Optional[np.ndarray] = None,
    device="cuda",
) -> Optional[PipelineResult]:
    """The blocked pipeline over a rank group (``models/distributed.py:74``).

    Every rank makes the instance from ``seed`` itself (blocks are born
    sharded: nothing is scattered), solves the K block slots it owns in
    the reference's assignment with :func:`solve_blocks_from_dists`, and
    the group reduces them with ``reduce_tours_on_mesh``. With P ranks this
    is the reference's ``mpirun -np P`` run; P = 1 is the oracle-parity
    single-rank pipeline. Returns the result on rank 0's process (its
    ``phase_seconds`` hold ``solve_reduce``), None on the others.
    """
    n = num_cities_per_block
    validate(n, num_blocks)
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)
    num_ranks = ranks.num_ranks

    if xy is None:
        _, xy = generate_instance(n, num_blocks, grid_dim_x, grid_dim_y, seed)
    _, dist = instance_from_numpy(xy, dtype, device)

    safe, valid = _rank_block_layout(num_blocks, num_ranks)
    k = safe.shape[0] // num_ranks
    mine = np.concatenate([np.arange(r * k, (r + 1) * k) for r in ranks.ids])
    safe_t = torch.as_tensor(safe[mine], device=device).long()
    valid_t = torch.as_tensor(valid[mine], device=device)
    block_d = block_distance_slices(dist, num_blocks, n)[safe_t]
    offsets = (safe_t * n).to(torch.int32)
    capacity = num_blocks * n + 1

    t0 = time.perf_counter()
    costs, local_tours = solve_blocks_from_dists(block_d, dtype)
    global_tours = local_tours + offsets[:, None]
    costs = torch.where(valid_t, costs, torch.zeros((), dtype=costs.dtype, device=device))
    ids, length, cost = reduce_tours_on_mesh(ranks, global_tours, costs, valid_t, dist, capacity)
    synchronize(device)
    seconds = time.perf_counter() - t0
    all_costs = ranks.all_gather(costs.reshape(ranks.local, k)).reshape(-1)
    if not ranks.is_root:
        return None
    plan = build_plan(n)
    final_len = int(length)
    return PipelineResult(
        cost=float(cost),
        tour_ids=ids[:final_len].cpu().numpy(),
        num_cities=num_blocks * n,
        block_costs=all_costs.cpu().numpy()[valid],
        phase_seconds={"solve_reduce": seconds},
        dp_states=plan.dp_states * num_blocks,
        dp_transitions=plan.dp_transitions * num_blocks,
        dist=dist,
    )

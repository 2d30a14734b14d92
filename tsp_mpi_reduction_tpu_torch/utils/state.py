"""State carried into the port from numpy: instances, plans, tours, B&B.

The system has no weights; its state is the instance (coordinates and the
``[N, N]`` distance matrix), the Held-Karp plan's fixed tables, padded
tours, and the branch-and-bound search state (the packed frontier and the
bound tables). These functions turn numpy arrays — for example ones
produced by the JAX package — into the port's tensors, so both packages
can be fed the same inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.branch_bound import BoundData, Frontier
from ..ops.distance import distance_matrix, distance_matrix_np
from ..ops.held_karp import HeldKarpPlan
from ..ops.merge import PaddedTour


def instance_from_numpy(
    xy: np.ndarray, dtype: torch.dtype, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., 2]`` coordinates -> (``xy`` ``[N, 2]``, ``dist`` ``[N, N]``).

    In float64 the distances are the host numpy matrix (bit-exact against
    the oracle, as the JAX pipeline does); in float32 they are computed on
    ``device`` from the float32 coordinates.
    """
    flat = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
    xy_t = torch.as_tensor(flat, device=device).to(dtype)
    if dtype == torch.float64:
        dist = torch.as_tensor(distance_matrix_np(flat), device=device)
    else:
        dist = distance_matrix(xy_t)
    return xy_t, dist


def plan_from_numpy(
    n: int,
    scatter_idx: np.ndarray,
    prev_idx: np.ndarray,
    member: np.ndarray,
    dp_states: int,
    dp_transitions: int,
) -> HeldKarpPlan:
    """A port plan from another plan's numpy arrays (copied)."""
    return HeldKarpPlan(
        int(n),
        np.array(scatter_idx, dtype=np.int32),
        np.array(prev_idx, dtype=np.int32),
        np.array(member, dtype=bool),
        int(dp_states),
        int(dp_transitions),
    )


def plan_to_torch(plan: HeldKarpPlan, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scatter_idx, prev_idx, member)`` as int64/int64/bool tensors on
    ``device`` (int64 because PyTorch indexes with it)."""
    return (
        torch.as_tensor(plan.scatter_idx, device=device).long(),
        torch.as_tensor(plan.prev_idx, device=device).long(),
        torch.as_tensor(plan.member, device=device),
    )


def padded_tour_from_numpy(ids, length: int, cost: float, device, dtype=torch.float64) -> PaddedTour:
    """A :class:`PaddedTour` from a numpy id buffer (already padded)."""
    return PaddedTour(
        torch.as_tensor(np.asarray(ids, dtype=np.int32), device=device),
        torch.tensor(int(length), dtype=torch.int32, device=device),
        torch.tensor(float(cost), dtype=dtype, device=device),
    )


def frontier_from_numpy(nodes, count, overflow, device) -> Frontier:
    """A B&B :class:`Frontier` from numpy: packed int32 rows ``[F, C]``
    (uint32 mask words keep their bits), the stack height and the
    overflow flag."""
    rows = np.ascontiguousarray(np.asarray(nodes)).view(np.int32)
    return Frontier(
        torch.as_tensor(rows.copy(), device=device),
        torch.tensor(int(count), dtype=torch.int32, device=device),
        torch.tensor(bool(overflow), device=device),
    )


def bound_data_from_numpy(min_out, bound_adj, dbar, pi, slack, ascent_step, lam_budget,
                          root_lb, integral, device) -> BoundData:
    """A B&B :class:`BoundData` from numpy arrays (float32 on ``device``)."""

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return BoundData(f32(min_out), f32(bound_adj), f32(dbar), f32(pi), f32(slack),
                     f32(ascent_step), f32(lam_budget), float(root_lb), bool(integral))

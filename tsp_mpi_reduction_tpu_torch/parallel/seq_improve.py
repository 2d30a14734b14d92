"""Polish of the merged tour (``--improve``), on one device or over a ring of ranks.

Counterpart of ``tsp_mpi_reduction_tpu/parallel/seq_improve.py``.
:func:`improve_tour` runs the local search's ``polish`` (2-opt and Or-opt
until neither improves) on the whole tour and re-measures its length; on a
rank group of more than one rank it runs :func:`ring_two_opt`, the ring
improver: the tour is cut into one contiguous segment a rank, each segment
is swept with its endpoints pinned, then the cyclic tour is rotated by half
a segment (each rank sends its head to the previous rank) so every
boundary becomes some segment's interior on a later round. A group of
``BatchedRanks`` sweeps its R segments as R lanes of one call.

The cost never increases: sweeps apply improving reversals only, and a
rotation relabels the same cyclic tour.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.local_search import polish, tour_length, two_opt_sweep

#: Above this tour length the final polish of the assembled tour is
#: skipped: an O(N^2) full-tour sweep would dominate exactly the long-tour
#: regime the ring decomposition exists to shard.
FINAL_POLISH_MAX = 4096


def ring_two_opt(tour: torch.Tensor, d: torch.Tensor, ranks, rounds: Optional[int] = None,
                 max_iters_per_sweep: int = 256, final_polish_max: int = FINAL_POLISH_MAX) -> torch.Tensor:
    """Improve a closed tour (its ``[N]`` open order, the same on every rank)
    over the ranks of ``ranks`` (``seq_improve.py:35-97``).

    ``N`` must be divisible by the rank count, in segments of >= 4 cities.
    Each of ``rounds`` (default 2R) rounds sweeps every segment with
    :func:`two_opt_sweep` (``closed=False``), then each rank sends its
    first ``seg // 2`` cities to rank r-1 and appends what rank r+1 sent.
    The segments are then gathered in rank order and, up to
    ``final_polish_max`` cities, polished once as a closed tour (on rank 0,
    broadcast). Returns the improved ``[N]`` order on every rank,
    cyclically shifted (the start city is not kept).
    """
    n = int(tour.shape[0])
    num_ranks = ranks.num_ranks
    if n % num_ranks:
        raise ValueError(f"tour length {n} not divisible by {num_ranks} ranks")
    seg_len = n // num_ranks
    if seg_len < 4:
        raise ValueError(f"segments of {seg_len} cities are too short to sweep")
    shift = seg_len // 2
    if rounds is None:
        rounds = 2 * num_ranks
    seg = tour.long().reshape(num_ranks, seg_len)[ranks.rank_ids(tour.device)]
    for _ in range(rounds):
        seg, _ = two_opt_sweep(seg, d, closed=False, max_iters=max_iters_per_sweep)
        # rotate the cyclic tour left by `shift`: my head goes to the
        # previous rank; I append my successor's head
        seg = torch.cat([seg[:, shift:], ranks.shift_back(seg[:, :shift])], 1)
    assembled = ranks.all_gather(seg).reshape(-1)
    if n > final_polish_max:
        return assembled
    # one closed polish (2-opt + Or-opt) of the assembled tour catches any
    # remaining cross-boundary move
    if ranks.is_root:
        assembled = polish(assembled[None, :], d)[0][0]
    return ranks.broadcast(assembled)


def improve_tour(tour: torch.Tensor, d: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polish a closed tour given as its ``[N]`` open order on ``d`` ``[N, N]``
    -> (order', length'): by the ring improver when ``mesh`` is a rank group
    of more than one rank whose segments fit (N divisible by R, >= 4 cities
    a rank), else on one device.

    The length is re-measured from ``d``: unlike the reference's formulaic
    merge cost (SURVEY.md quirk #4) it is the true cost of the returned
    tour.
    """
    if mesh is not None and not hasattr(mesh, "num_ranks"):
        raise TypeError(f"improve_tour: mesh must be a rank group (parallel.mesh), got {type(mesh).__name__}")
    r = 1 if mesh is None else mesh.num_ranks
    if r > 1 and tour.shape[0] % r == 0 and tour.shape[0] // r >= 4:
        order = ring_two_opt(tour, d, mesh)
    else:
        order = polish(tour.long()[None, :], d)[0][0]
    return order, tour_length(order[None, :], d, closed=True)[0]

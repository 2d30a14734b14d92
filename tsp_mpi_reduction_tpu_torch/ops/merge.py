"""Tour-merge operator: the reference's 2-opt edge swap on padded tours.

Counterpart of ``tsp_mpi_reduction_tpu/ops/merge.py``. The reference's
``mergeBlocks`` (tsp.cpp:202-269) scans every edge pair of two closed tours,
picks the reconnection with the least ``swapPairCost`` (tsp.cpp:197-200)
and splices tour 2, reversed, into tour 1. Here that is one ``[L1, L2]``
swap-cost matrix gathered from a resident distance matrix, a flat argmin
and an index-based splice, all on the device with fixed shapes: lengths
and costs stay 0-dim device tensors, so a fold never waits for the host.

Replicated semantics (bit-exact against the goldens; quirks intentional):

- edge lists include the zero-length wrap edge ``(tour[L-1], tour[0])``
  of the closed representation (tsp.cpp:212-227);
- ties go to the first (i, j) in i-major, j-minor order (strict ``<`` in
  the scan; ``argmin`` returns the first minimum);
- the merged cost is formulaic, ``(cost1 + cost2) + bestSwapCost``
  (tsp.cpp:263), never re-measured (SURVEY.md quirk #4);
- tour 2 goes in reversed after the first city of tour 1 matching either
  end of the chosen left edge, rotated so the chosen right-edge head lands
  at the boundary (tsp.cpp:236-259).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class PaddedTour(NamedTuple):
    """A closed tour in a fixed-size buffer.

    ids:    [P] int32 global city ids; entries past ``length`` are 0.
    length: 0-dim int32, valid entries INCLUDING the closing duplicate.
    cost:   0-dim float, the accumulated (formulaic) tour cost.
    """

    ids: torch.Tensor
    length: torch.Tensor
    cost: torch.Tensor


def _tour_edges(t1: PaddedTour, t2: PaddedTour):
    """Edge endpoint ids (a, b) of tour 1 and (r1, r2) of tour 2 as int64,
    with the successor of the last valid lane (and of padding) at 0."""
    i1 = torch.arange(t1.ids.shape[0], device=t1.ids.device)
    i2 = torch.arange(t2.ids.shape[0], device=t2.ids.device)
    nxt1 = torch.where(i1 + 1 >= t1.length, 0, i1 + 1)
    nxt2 = torch.where(i2 + 1 >= t2.length, 0, i2 + 1)
    ids1, ids2 = t1.ids.long(), t2.ids.long()
    return ids1, ids1[nxt1], ids2, ids2[nxt2]


def _merge_from_sc(t1: PaddedTour, t2: PaddedTour, sc: torch.Tensor) -> PaddedTour:
    """Mask invalid lanes of the ``[P1, P2]`` swap costs, take the first
    minimum in i-major order, splice, and apply the formulaic cost."""
    p1, p2 = t1.ids.shape[0], t2.ids.shape[0]
    dev = sc.device
    i1 = torch.arange(p1, device=dev)
    i2 = torch.arange(p2, device=dev)
    valid = (i1[:, None] < t1.length) & (i2[None, :] < t2.length)
    sc = torch.where(valid, sc, torch.tensor(float("inf"), dtype=sc.dtype, device=dev))

    flat_sc = sc.reshape(-1)
    flat = flat_sc.argmin()  # first minimum in i-major, j-minor order
    i_star = flat // p2
    j_star = flat - i_star * p2
    best_swap = flat_sc[flat]

    out, out_len = _splice(t1.ids, t1.length, t2.ids, t2.length, i_star, j_star)
    return PaddedTour(out, out_len, (t1.cost + t2.cost) + best_swap)


def merge_tours(t1: PaddedTour, t2: PaddedTour, dist: torch.Tensor) -> PaddedTour:
    """Merge ``t2`` into ``t1``; the result lives in a ``t1``-sized buffer.

    The caller guarantees ``t1.length + t2.length - 1 <= P1`` and that both
    tours hold >= 3 cities (2-city tours hang the reference, quirk #6).
    """
    a, b, r1, r2 = _tour_edges(t1, t2)
    # swapPairCost (tsp.cpp:197-200) in its order of additions:
    # ((d(a, r2) + d(b, r1)) - d(a, b)) - d(r1, r2)
    d_ab = dist[a, b]
    d_r = dist[r1, r2]
    sc = (dist[a[:, None], r2[None, :]] + dist[b[:, None], r1[None, :]] - d_ab[:, None]) - d_r[None, :]
    return _merge_from_sc(t1, t2, sc)


def _splice(ids1, len1, ids2, len2, i_star, j_star) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's splice (tsp.cpp:229-259) in tour 1's buffer size.

    - Tour 2 is rotated until its HEAD VALUE equals the chosen right-edge
      head ``ids2[j_star]`` (tsp.cpp:236-239): the first occurrence of that
      id in tour 2 with its closing duplicate popped. That equals the
      position on duplicate-free tours; it differs only on the corrupted
      operands of ``--compat-bugs`` (quirk #5).
    - If the value is absent the reference spins forever (quirk #6); the
      positional index is used instead.
    """
    p1, p2 = ids1.shape[0], ids2.shape[0]
    dev = ids1.device
    i1 = torch.arange(p1, device=dev)
    i2 = torch.arange(p2, device=dev)
    l2p = len2 - 1  # tour 2 with its closing duplicate popped
    vj = ids2[j_star]
    match2 = (ids2 == vj) & (i2 < l2p)
    first = match2.to(torch.int32).argmax()  # CUDA has no argmax over bool
    p2_rot = torch.where(match2.any(), first, torch.where(j_star >= l2p, 0, j_star))
    a_id = ids1[i_star]
    b_id = ids1[torch.where(i_star + 1 >= len1, 0, i_star + 1)]

    match = ((ids1 == a_id) | (ids1 == b_id)) & (i1 < len1)
    q = match.to(torch.int32).argmax()  # first matching position

    out_len = len1 + l2p
    # tour-2 positions walk backwards from the right-edge head:
    # rr[u] = ids2[(p2_rot - u) mod l2p], a floor modulo (p2_rot - u < 0)
    u = i1 - q - 1
    src2 = torch.remainder(p2_rot - u, torch.clamp(l2p, min=1))
    from_t1_head = i1 <= q
    from_t2 = (~from_t1_head) & (i1 <= q + l2p)
    idx1 = torch.where(from_t1_head, i1, torch.clamp(i1 - l2p, min=0))
    out = torch.where(
        from_t2, ids2[torch.clamp(src2, 0, p2 - 1)], ids1[torch.clamp(idx1, 0, p1 - 1)]
    )
    out = torch.where(i1 < out_len, out, 0).to(torch.int32)
    return out, out_len.to(torch.int32)


def make_padded(ids, length, cost, capacity: int, device=None) -> PaddedTour:
    """Place a tour (global ids, valid ``length``) into a ``capacity`` buffer."""
    ids = torch.as_tensor(ids, device=device).to(torch.int32)
    dev = ids.device
    pad = capacity - ids.shape[0]
    if pad < 0:
        raise ValueError(f"tour of size {ids.shape[0]} exceeds capacity {capacity}")
    buf = torch.nn.functional.pad(ids, (0, pad))
    length = torch.as_tensor(length, device=dev).to(torch.int32)
    buf = torch.where(torch.arange(capacity, device=dev) < length, buf, 0).to(torch.int32)
    return PaddedTour(buf, length, torch.as_tensor(cost, device=dev))


def fold_tours(
    tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor, capacity: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential left fold of per-block tours, as a rank's local merge
    does (tsp.cpp:348-352): merge the accumulated tour with each next
    block's tour, in block order, in a fixed ``capacity`` buffer.

    Args:
      tours: ``[B, L]`` closed tours of global city ids (L = n+1).
      costs: ``[B]`` per-tour costs.
      dist: ``[N, N]`` global distance matrix to gather from.
      capacity: buffer size; defaults to the final length ``B*(L-1)+1``.

    Returns (ids ``[capacity]``, length, cost) as device tensors.
    """
    tours = tours.to(torch.int32)
    b, l = tours.shape
    if capacity is None:
        capacity = b * (l - 1) + 1
    acc = make_padded(tours[0], l, costs[0], capacity)
    length = torch.tensor(l, dtype=torch.int32, device=tours.device)
    for i in range(1, b):
        acc = merge_tours(acc, PaddedTour(tours[i], length, costs[i]), dist)
    return acc.ids, acc.length, acc.cost

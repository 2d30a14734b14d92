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

from ..analysis import contracts
from ..perf import compile_cache
from .distance import edge_length


class PaddedTour(NamedTuple):
    """A closed tour in a fixed-size buffer, or a batch of them.

    ids:    [..., P] int32 global city ids; entries past ``length`` are 0.
    length: [...] int32, valid entries INCLUDING the closing duplicate.
    cost:   [...] float, the accumulated (formulaic) tour cost.

    Every operator below takes any leading batch shape (none for one tour):
    the tree fold merges a round's pairs as one batch.
    """

    ids: torch.Tensor
    length: torch.Tensor
    cost: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[...]]``: one index per batch entry of ``x`` ``[..., P]``."""
    return x.gather(-1, idx[..., None])[..., 0]


def _tour_edges(t1: PaddedTour, t2: PaddedTour):
    """Edge endpoint ids (a, b) of tour 1 and (r1, r2) of tour 2 as int64,
    with the successor of the last valid lane (and of padding) at 0."""
    i1 = torch.arange(t1.ids.shape[-1], device=t1.ids.device)
    i2 = torch.arange(t2.ids.shape[-1], device=t2.ids.device)
    nxt1 = torch.where(i1 + 1 >= t1.length[..., None], 0, i1 + 1)
    nxt2 = torch.where(i2 + 1 >= t2.length[..., None], 0, i2 + 1)
    ids1, ids2 = t1.ids.long(), t2.ids.long()
    return ids1, ids1.gather(-1, nxt1), ids2, ids2.gather(-1, nxt2)


def _merge_from_sc(t1: PaddedTour, t2: PaddedTour, sc: torch.Tensor) -> PaddedTour:
    """Mask invalid lanes of the ``[..., P1, P2]`` swap costs, take the
    first minimum in i-major order, splice, and apply the formulaic cost."""
    p1, p2 = t1.ids.shape[-1], t2.ids.shape[-1]
    dev = sc.device
    i1 = torch.arange(p1, device=dev)
    i2 = torch.arange(p2, device=dev)
    valid = (i1[:, None] < t1.length[..., None, None]) & (i2[None, :] < t2.length[..., None, None])
    sc = torch.where(valid, sc, float("inf"))  # a Python scalar: no host-to-device copy

    flat_sc = sc.flatten(-2)
    flat = flat_sc.argmin(dim=-1)  # first minimum in i-major, j-minor order
    i_star = flat // p2
    j_star = flat - i_star * p2
    best_swap = _take(flat_sc, flat)

    out, out_len = _splice(t1.ids, t1.length, t2.ids, t2.length, i_star, j_star)
    return PaddedTour(out, out_len, (t1.cost + t2.cost) + best_swap)


def merge_tours(t1: PaddedTour, t2: PaddedTour, dist: torch.Tensor) -> PaddedTour:
    """Merge ``t2`` into ``t1``; the result lives in a ``t1``-sized buffer.

    The caller guarantees ``t1.length + t2.length - 1 <= P1`` and that both
    tours hold >= 3 cities (2-city tours hang the reference, quirk #6).
    """
    contracts.check_padded_tour(t1, where="merge_tours.t1")
    contracts.check_padded_tour(t2, where="merge_tours.t2")
    return _merge(t1, t2, dist)


def _merge(t1: PaddedTour, t2: PaddedTour, dist: torch.Tensor) -> PaddedTour:
    """:func:`merge_tours` without its boundary checks."""
    a, b, r1, r2 = _tour_edges(t1, t2)
    # swapPairCost (tsp.cpp:197-200) in its order of additions:
    # ((d(a, r2) + d(b, r1)) - d(a, b)) - d(r1, r2)
    d_ab = dist[a, b]
    d_r = dist[r1, r2]
    sc = (dist[a[..., :, None], r2[..., None, :]] + dist[b[..., :, None], r1[..., None, :]]
          - d_ab[..., :, None]) - d_r[..., None, :]
    return _merge_from_sc(t1, t2, sc)


def merge_tours_xy(t1: PaddedTour, t2: PaddedTour, xy: torch.Tensor) -> PaddedTour:
    """:func:`merge_tours` with the swap costs computed from the ``[N, 2]``
    coordinates ``xy`` (in the cost dtype) instead of gathered from a
    resident ``[N, N]`` matrix: each tour's coordinates are gathered once
    and the four distance blocks are broadcast norms.

    ``edge_length`` squares, adds and takes the root as separate
    elementwise ops, as :func:`ops.distance.distance_matrix` does, so every
    distance equals the matrix entry bit for bit and the merge equals
    :func:`merge_tours` on that matrix.
    """
    a, b, r1, r2 = _tour_edges(t1, t2)
    xa, xb = xy[a], xy[b]  # [..., P1, 2]: one row gather per tour position
    x1, x2 = xy[r1], xy[r2]  # [..., P2, 2]
    d_ab = edge_length(xa, xb)
    d_r = edge_length(x1, x2)
    sc = (edge_length(xa[..., :, None, :], x2[..., None, :, :])
          + edge_length(xb[..., :, None, :], x1[..., None, :, :])
          - d_ab[..., :, None]) - d_r[..., None, :]
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
    p1, p2 = ids1.shape[-1], ids2.shape[-1]
    dev = ids1.device
    i1 = torch.arange(p1, device=dev)
    i2 = torch.arange(p2, device=dev)
    l2p = len2 - 1  # tour 2 with its closing duplicate popped
    vj = _take(ids2, j_star)
    match2 = (ids2 == vj[..., None]) & (i2 < l2p[..., None])
    first = match2.to(torch.int32).argmax(dim=-1)  # CUDA has no argmax over bool
    p2_rot = torch.where(match2.any(dim=-1), first, torch.where(j_star >= l2p, 0, j_star))
    a_id = _take(ids1, i_star)
    b_id = _take(ids1, torch.where(i_star + 1 >= len1, 0, i_star + 1))

    match = ((ids1 == a_id[..., None]) | (ids1 == b_id[..., None])) & (i1 < len1[..., None])
    q = match.to(torch.int32).argmax(dim=-1)  # first matching position

    out_len = len1 + l2p
    # tour-2 positions walk backwards from the right-edge head:
    # rr[u] = ids2[(p2_rot - u) mod l2p], a floor modulo (p2_rot - u < 0)
    u = i1 - q[..., None] - 1
    src2 = torch.remainder(p2_rot[..., None] - u, torch.clamp(l2p, min=1)[..., None])
    from_t1_head = i1 <= q[..., None]
    from_t2 = (~from_t1_head) & (i1 <= (q + l2p)[..., None])
    idx1 = torch.where(from_t1_head, i1, torch.clamp(i1 - l2p[..., None], min=0))
    out = torch.where(from_t2, ids2.gather(-1, torch.clamp(src2, 0, p2 - 1)),
                      ids1.gather(-1, torch.clamp(idx1, 0, p1 - 1)))
    out = torch.where(i1 < out_len[..., None], out, 0).to(torch.int32)
    return out, out_len.to(torch.int32)


def make_padded(ids, length, cost, capacity: int, device=None) -> PaddedTour:
    """Place a tour (global ids, valid ``length``) into a ``capacity`` buffer."""
    ids = torch.as_tensor(ids, device=device).to(torch.int32)
    dev = ids.device
    pad = capacity - ids.shape[0]
    if pad < 0:
        raise ValueError(f"tour of size {ids.shape[0]} exceeds capacity {capacity}")
    buf = torch.nn.functional.pad(ids, (0, pad))
    if isinstance(length, torch.Tensor):
        length = length.to(device=dev, dtype=torch.int32)
    else:  # a device fill, not a host-to-device copy
        length = torch.full((), int(length), dtype=torch.int32, device=dev)
    buf = torch.where(torch.arange(capacity, device=dev) < length, buf, 0).to(torch.int32)
    return contracts.check_padded_tour(PaddedTour(buf, length, torch.as_tensor(cost, device=dev)),
                                       capacity=capacity, where="make_padded")


def _fold_step(acc_ids: torch.Tensor, acc_len: torch.Tensor, acc_cost: torch.Tensor,
               tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor,
               step: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One merge of the sequential fold, in place: tour ``step`` of the
    ``[B, L]`` ``tours`` (cost ``costs[step]``) goes into the accumulator
    (``acc_ids [capacity]``, 0-d ``acc_len`` and ``acc_cost``), and the 0-d
    int64 device index ``step`` advances by one. Counterpart of ``step`` in
    ``tsp_mpi_reduction_tpu/ops/merge.py:203-208``, the body of its
    ``lax.scan``.

    It reads nothing on the host and uploads nothing, so the graph store
    captures it once and replays it: the tour is gathered by the device
    index, the accumulator written over in place. Only the contracts'
    metadata checks run here (at capture, on CUDA); :func:`fold_tours`
    checks values at its boundary. Returns the accumulator buffers."""
    idx = step.view(1)
    t2 = PaddedTour(tours.index_select(0, idx)[0],
                    torch.full((), tours.shape[1], dtype=torch.int32, device=tours.device),
                    costs.index_select(0, idx)[0])
    acc = PaddedTour(acc_ids, acc_len, acc_cost)
    contracts.check_padded_tour(acc, where="merge_tours.t1", values=False)
    contracts.check_padded_tour(t2, where="merge_tours.t2", values=False)
    out = _merge(acc, t2, dist)
    acc_ids.copy_(out.ids)
    acc_len.copy_(out.length)
    acc_cost.copy_(out.cost)
    step.add_(1)
    return acc_ids, acc_len, acc_cost


#: the fold's entry in the graph store: ``_fold_step`` captured once per
#: key (shapes, dtypes, device) and replayed B-1 times a fold
FOLD = compile_cache.GraphEntry("fold_tours", _fold_step)


def _fold_eager(acc: PaddedTour, tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor,
                step: torch.Tensor, merges: int) -> None:  # graftlint: hot
    """The fold's steps issued one by one from Python, into ``acc`` in
    place: the CPU path, and the one ``TSP_COMPILE_CACHE=off`` asks for on
    CUDA."""
    for _ in range(merges):  # no graph on the CPU or by request  # graftlint: disable=R4
        _fold_step(acc.ids, acc.length, acc.cost, tours, costs, dist, step)


def fold_tours(
    tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor, capacity: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential left fold of per-block tours, as a rank's local merge
    does (tsp.cpp:348-352): merge the accumulated tour with each next
    block's tour, in block order, in a fixed ``capacity`` buffer.

    On CUDA the B-1 merges are replays of :func:`_fold_step`'s graph from
    the store (``perf/compile_cache.py``), captured on the first fold of
    these shapes: no host read until the fold returns. On the CPU, and on
    CUDA under ``TSP_COMPILE_CACHE=off``, the same step runs eagerly in a
    Python loop. Both issue the same kernels in the same order, so their
    results are equal bit for bit.

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
    cost_dtype = torch.promote_types(costs.dtype, dist.dtype)
    acc = make_padded(tours[0], l, costs[0].to(cost_dtype, copy=True), capacity)
    if b > 1:
        step = torch.ones((), dtype=torch.int64, device=tours.device)
        graph = FOLD.graph(acc.ids, acc.length, acc.cost, tours, costs, dist, step)
        if graph is None:
            _fold_eager(acc, tours, costs, dist, step, b - 1)
        else:
            acc = PaddedTour(*graph(acc.ids, acc.length, acc.cost, tours, costs, dist, step, replays=b - 1))
    contracts.check_padded_tour(acc, capacity=capacity, where="fold_tours")
    return acc.ids, acc.length, acc.cost


def fold_tours_tree(
    tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree-shaped fold: ceil(log2 B) rounds, each merging the pairs
    (2i, 2i+1) of the surviving tours as ONE batched merge.

    The alternative to :func:`fold_tours`'s B-1 dependent merges. A round's
    buffers are sized for its merged tours (``P_left + P_right - 1``), so
    early rounds stay small; an odd tour is carried to the next round
    unmerged. The merge is not associative, so the result differs from the
    sequential fold's: the reference folds sequentially inside a rank
    (tsp.cpp:348-352) and by a binary tree across ranks (tsp.cpp:52-134).
    Byte parity with the oracle needs :func:`fold_tours`.

    Args and returns as :func:`fold_tours`, except that the ids buffer is
    sized ``2^ceil(log2 B) * (L-1) + 1``; slice it by the returned length.
    """
    return _fold_tree(tours, costs, dist, merge_tours)


def fold_tours_tree_xy(
    tours: torch.Tensor, costs: torch.Tensor, xy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fold_tours_tree` on :func:`merge_tours_xy`: swap costs from
    the ``[N, 2]`` coordinates ``xy`` (cost dtype), no ``[N, N]`` matrix."""
    return _fold_tree(tours, costs, xy, merge_tours_xy)


def _fold_tree(tours, costs, ctx, merge_fn):
    """The rounds of the tree fold; the surviving tours are one stacked
    ``PaddedTour`` of shape ``[m, P]``."""
    tours = tours.to(torch.int32)
    b, l = tours.shape
    cur = PaddedTour(tours, torch.full((b,), l, dtype=torch.int32, device=tours.device), costs)
    while cur.ids.shape[0] > 1:
        m, p = cur.ids.shape
        pairs = m // 2
        out_cap = 2 * p - 1
        pad = out_cap - p
        left = PaddedTour(torch.nn.functional.pad(cur.ids[0 : 2 * pairs : 2], (0, pad)),
                          cur.length[0 : 2 * pairs : 2], cur.cost[0 : 2 * pairs : 2])
        right = PaddedTour(cur.ids[1 : 2 * pairs : 2], cur.length[1 : 2 * pairs : 2],
                           cur.cost[1 : 2 * pairs : 2])
        merged = merge_fn(left, right, ctx)
        if m % 2:
            odd = torch.nn.functional.pad(cur.ids[-1:], (0, pad))
            merged = PaddedTour(torch.cat([merged.ids, odd]), torch.cat([merged.length, cur.length[-1:]]),
                                torch.cat([merged.cost, cur.cost[-1:]]))
        cur = merged
    return cur.ids[0], cur.length[0], cur.cost[0]

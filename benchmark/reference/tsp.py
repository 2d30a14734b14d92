"""Plain reference of the two benchmarked paths.

- TSPLIB EUC_2D distances and tour lengths (``euc_2d``, ``tour_length``).
- Held-Karp over a batch of blocks (``held_karp``): the exact cycle from
  city 0, by subset cardinality, in any float dtype, with the tours
  backtracked on request.
- The reference program's merge (``mergeBlocks``, tsp.cpp:197-269), its
  rank-local sequential fold (tsp.cpp:348-352) and its binary reduce tree
  (``MPI_ManualReduce``, tsp.cpp:52-134), on closed tours of global ids.

The merge keeps the reference program's semantics: the edge lists hold
the zero-length wrap edge of the closed tour, the first least swap cost in
i-major order wins, the swap cost is ``((d(a, r2) + d(b, r1)) - d(a, b)) -
d(r1, r2)`` in that order, tour 2 goes in reversed after the first city of
tour 1 that matches an end of the chosen edge, and the merged cost is
``(cost1 + cost2) + swap``, never measured again.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# TSPLIB distances and tours
# ---------------------------------------------------------------------------


def euc_2d(xy: np.ndarray) -> np.ndarray:
    """TSPLIB95 EUC_2D: ``nint(sqrt(dx^2 + dy^2))`` in float64, as int64."""
    xy = np.asarray(xy, np.float64)
    diff = xy[:, None, :] - xy[None, :, :]
    return np.floor(np.sqrt((diff * diff).sum(-1)) + 0.5).astype(np.int64)


def euclidean(xy: np.ndarray) -> np.ndarray:
    """Float64 Euclidean distances of ``[n, 2]`` or ``[B, n, 2]`` points."""
    xy = np.asarray(xy, np.float64)
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    return np.sqrt((diff * diff).sum(-1))


def tour_length(d: np.ndarray, tour: Sequence[int]) -> float:
    """Length of a closed tour (first city repeated last) in float64."""
    t = np.asarray(tour, np.int64)
    return float(np.asarray(d, np.float64)[t[:-1], t[1:]].sum())


def closed_tour_ok(tour: Sequence[int], cities: np.ndarray, start: Optional[int] = None) -> bool:
    """Is ``tour`` a closed tour that visits each of ``cities`` once
    (and starts at ``start``, when given)?"""
    t = np.asarray(tour, np.int64)
    if t.ndim != 1 or t.shape[0] != len(cities) + 1 or t[0] != t[-1]:
        return False
    if start is not None and t[0] != start:
        return False
    return bool(np.array_equal(np.sort(t[:-1]), np.sort(np.asarray(cities, np.int64))))


# ---------------------------------------------------------------------------
# Held-Karp
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _levels(m: int) -> List[List[Tuple[int, np.ndarray, np.ndarray]]]:
    """For each cardinality c = 2..m and each city j < m: the masks of
    cardinality c that hold j, and the same masks without j."""
    masks = np.arange(1 << m, dtype=np.int64)
    pop = np.zeros(1 << m, dtype=np.int64)
    for j in range(m):
        pop += (masks >> j) & 1
    out = []
    for c in range(2, m + 1):
        level = []
        at_c = masks[pop == c]
        for j in range(m):
            s = at_c[(at_c >> j) & 1 == 1]
            level.append((j, s, s ^ (1 << j)))
        out.append(level)
    return out


def held_karp(d: torch.Tensor, dtype: torch.dtype = torch.float64, tours: bool = False,
              chunk: int = 128) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
    """Exact shortest cycles of ``[B, n, n]`` distance matrices, each from
    city 0, computed in ``dtype`` on ``d``'s device, ``chunk`` blocks at a
    time.

    ``dp[S, j]`` is the shortest path from city 0 through the cities of
    ``S`` (bits for cities 1..n-1) that ends at ``j``; a level adds one
    city, ``dp[S, j] = min_k dp[S - j, k] + d[k, j]``, the first least
    ``k`` on ties. Returns the costs ``[B]`` (in ``dtype``) and, with
    ``tours``, the closed tours ``[B, n+1]`` (int64, numpy)."""
    bsz, n, _ = d.shape
    m = n - 1
    dev = d.device
    levels = [[(j, torch.as_tensor(s, device=dev), torch.as_tensor(p, device=dev)) for j, s, p in lvl]
              for lvl in _levels(m)]
    costs, all_tours = [], []
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    for b0 in range(0, bsz, chunk):
        dd = d[b0:b0 + chunk].to(dtype)
        nb = dd.shape[0]
        inner = dd[:, 1:, 1:]  # [nb, m, m]: k -> j among cities 1..m
        dp = inf.expand(nb, 1 << m, m).clone()
        par = torch.zeros((nb, 1 << m, m), dtype=torch.int8, device=dev) if tours else None
        for j in range(m):
            dp[:, 1 << j, j] = dd[:, 0, j + 1]
        for lvl in levels:
            for j, s, prev in lvl:
                cand = dp[:, prev, :] + inner[:, None, :, j]  # [nb, |s|, m]
                val, arg = cand.min(dim=-1)
                dp[:, s, j] = val
                if tours:
                    par[:, s, j] = arg.to(torch.int8)
        full = (1 << m) - 1
        total = dp[:, full, :] + dd[:, 1:, 0]
        best, last = total.min(dim=-1)
        costs.append(best)
        if tours:
            all_tours.append(_backtrack(par, last, m))
        del dp, par
    cost = torch.cat(costs)
    return cost, (np.concatenate(all_tours) if tours else None)


def _backtrack(par: torch.Tensor, last: torch.Tensor, m: int) -> np.ndarray:
    """Closed tours ``[nb, m+2]`` from the parent table and each block's
    last city (0-based among cities 1..m)."""
    nb = par.shape[0]
    rows = torch.arange(nb, device=par.device)
    mask = torch.full((nb,), (1 << m) - 1, dtype=torch.int64, device=par.device)
    j = last.to(torch.int64)
    rev = []
    for _ in range(m):
        rev.append(j + 1)
        k = par[rows, mask, j].to(torch.int64)
        mask = mask ^ (torch.ones_like(j) << j)
        j = k
    path = torch.stack(rev[::-1], dim=1).cpu().numpy()
    zero = np.zeros((nb, 1), np.int64)
    return np.concatenate([zero, path, zero], axis=1)


# ---------------------------------------------------------------------------
# The merge, the fold and the reduce tree
# ---------------------------------------------------------------------------


def distances(xy: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """``[N, N]`` Euclidean distances of ``[N, 2]`` points in ``dtype`` on
    ``device``: the points rounded to ``dtype`` once, then ``dx*dx``,
    ``+ dy*dy`` and the square root, each rounded to ``dtype`` (the
    reference's ``sqrt(pow(dx,2) + pow(dy,2))``, assignment2.h:196)."""
    p = torch.as_tensor(np.asarray(xy, np.float64).reshape(-1, 2), device=device).to(dtype)
    dx = p[:, None, 0] - p[None, :, 0]
    out = dx * dx
    del dx
    dy = p[:, None, 1] - p[None, :, 1]
    out += dy * dy
    del dy
    return out.sqrt_()


def merge(ids1: np.ndarray, cost1: float, ids2: np.ndarray, cost2: float,
          dist: torch.Tensor) -> Tuple[np.ndarray, float]:
    """``mergeBlocks``: splice closed tour 2 into closed tour 1.

    Both tours are closed (first city repeated last); the merged tour is
    closed too. The swap costs are computed in ``dist``'s dtype on its
    device; the merged cost adds in float64."""
    l1, l2 = len(ids1), len(ids2)
    a = ids1
    b = np.concatenate([ids1[1:], ids1[:1]])  # the wrap edge (last, first) is zero-length
    r1 = ids2
    r2 = np.concatenate([ids2[1:], ids2[:1]])
    dev = dist.device
    ta, tb, t1, t2 = (torch.as_tensor(x, device=dev) for x in (a, b, r1, r2))
    sc = (dist[ta[:, None], t2[None, :]] + dist[tb[:, None], t1[None, :]]
          - dist[ta, tb][:, None]) - dist[t1, t2][None, :]
    flat = int(sc.reshape(-1).argmin())
    i_star, j_star = divmod(flat, l2)
    swap = float(sc.reshape(-1)[flat])
    # tour 2 without its closing city, rotated to the chosen right-edge head
    body2 = ids2[:-1]
    head = ids2[j_star]
    p2 = int(np.flatnonzero(body2 == head)[0])
    rev2 = body2[(p2 - np.arange(len(body2))) % len(body2)]
    a_id, b_id = ids1[i_star], ids1[(i_star + 1) % l1]
    q = int(np.flatnonzero((ids1 == a_id) | (ids1 == b_id))[0])
    out = np.concatenate([ids1[:q + 1], rev2, ids1[q + 1:]])
    return out, (cost1 + cost2) + swap


def fold(tours: Sequence[np.ndarray], costs: Sequence[float], dist: torch.Tensor) -> Tuple[np.ndarray, float]:
    """A rank's sequential fold: merge each next tour into the accumulator,
    in order (tsp.cpp:348-352)."""
    acc, acc_cost = np.asarray(tours[0], np.int64), float(costs[0])
    for t, c in zip(tours[1:], costs[1:]):
        acc, acc_cost = merge(acc, acc_cost, np.asarray(t, np.int64), float(c), dist)
    return acc, acc_cost


def rank_block_counts(num_blocks: int, num_ranks: int) -> List[int]:
    """Blocks a rank gets: ``blocksToSend[blocksLeft % numProcs]++`` for
    ``blocksLeft`` = 1..B (tsp.cpp:167-171); each rank's blocks follow the
    previous rank's in block order (tsp.cpp:173-191)."""
    counts = [0] * num_ranks
    for b in range(1, num_blocks + 1):
        counts[b % num_ranks] += 1
    return counts


def reduce_tree(num_ranks: int) -> List[List[Tuple[int, int]]]:
    """``MPI_ManualReduce``'s rounds as (sender, receiver) pairs: ranks
    from ``lastpower = 2^floor(log2 P)`` up first send to ``rank -
    lastpower``; then round d pairs receiver ``k`` with sender ``k + 2^d``
    for ``k`` a multiple of ``2^(d+1)`` below ``lastpower``."""
    lastpower = 1 << int(math.floor(math.log2(num_ranks)))
    rounds = []
    if num_ranks > lastpower:
        rounds.append([(r, r - lastpower) for r in range(lastpower, num_ranks)])
    d = 0
    while (1 << d) < lastpower:
        rounds.append([(k + (1 << d), k) for k in range(0, lastpower, 1 << (d + 1))])
        d += 1
    return rounds


def blocked_ranks(tours: Sequence[np.ndarray], costs: Sequence[float], dist: torch.Tensor,
                  num_ranks: int) -> Tuple[np.ndarray, float]:
    """The reference's P-rank run: each rank folds its blocks, then the
    reduce tree merges (mine, received) at every receiver; rank 0 holds the
    answer. A rank with no blocks holds no tour, and a merge with an empty
    side keeps the other."""
    counts = rank_block_counts(len(tours), num_ranks)
    held: List[Optional[Tuple[np.ndarray, float]]] = []
    start = 0
    for c in counts:
        held.append(fold(tours[start:start + c], costs[start:start + c], dist) if c else None)
        start += c
    for pairs in reduce_tree(num_ranks):
        for src, dst in pairs:
            mine, got = held[dst], held[src]
            if got is None:
                continue
            held[dst] = got if mine is None else merge(mine[0], mine[1], got[0], got[1], dist)
    return held[0]

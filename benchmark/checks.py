"""What decides ``correct``: the program's answers judged by the plain
reference (``benchmark/reference``), each number beside its limit.

Every function returns ``[(name, value, limit), ...]``; a run is correct
when no value is over its limit. The limits live in the configuration's
file (``limits``), each set from two readings: the largest that sound runs
of the program give, and the smallest that the control gives.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import tsp as ref

Check = Tuple[str, float, float]


def proofs(answers: Sequence[dict], copies: Sequence, optimum: float, limits: Dict[str, float]) -> List[Check]:
    """B&B proofs of copies of one instance with a published optimum.

    - ``bad_tour``: answers whose tour is not a closed tour of all the
      copy's cities from city 0;
    - ``cost_err``: the widest gap between a reported cost and the tour's
      length, recomputed from the copy's coordinates (EUC_2D, float64);
    - ``opt_gap``: the widest excess of a recomputed length over the
      published optimum;
    - ``unproven``: answers not proven optimal;
    - ``lb_gap``: the widest shortfall of a certified lower bound under the
      optimum;
    - ``lb_over``: the widest excess of a certified or root lower bound over
      the optimum, 0 where none passes it (a valid bound never does)."""
    bad = unproven = 0
    cost_err = opt_gap = lb_gap = lb_over = 0.0
    for ans, cp in zip(answers, copies):
        n = cp.d.shape[0]
        tour = np.asarray(ans["tour"], np.int64)
        if not ref.closed_tour_ok(tour, np.arange(n), start=0):
            bad += 1
            continue
        length = ref.tour_length(ref.euc_2d(cp.xy), tour)
        cost_err = max(cost_err, abs(float(ans["cost"]) - length))
        opt_gap = max(opt_gap, length - optimum)
        unproven += 0 if ans["proven"] else 1
        lb_gap = max(lb_gap, optimum - float(ans["lower_bound"]))
        lb_over = max(lb_over, float(ans["lower_bound"]) - optimum, float(ans["root_lower_bound"]) - optimum)
    if not answers:
        bad = 1
    return [("bad_tour", float(bad), limits["bad_tour"]), ("cost_err", cost_err, limits["cost_err"]),
            ("opt_gap", opt_gap, limits["opt_gap"]), ("unproven", float(unproven), limits["unproven"]),
            ("lb_gap", lb_gap, limits["lb_gap"]), ("lb_over", lb_over, limits["lb_over"])]


def slot_blocks(num_blocks: int, num_ranks: int) -> np.ndarray:
    """Block of each slot of a P-rank run's ``[P*K]`` layout (-1: a padding
    slot): rank r holds slots ``r*K .. r*K + c_r - 1``, its blocks in order."""
    counts = ref.rank_block_counts(num_blocks, num_ranks)
    k = max(max(counts), 1)
    out, start = [], 0
    for c in counts:
        out.extend(list(range(start, start + c)) + [-1] * (k - c))
        start += c
    return np.asarray(out, np.int64)


def pipelines(answers: Sequence[dict], xys: Sequence[np.ndarray], num_ranks: int,
              limits: Dict[str, float], device) -> List[Check]:
    """Blocked pipelines, one answer a city set ``[B, n, 2]``.

    An answer holds ``block_tours [B, n+1]`` (block-local ids, block order),
    ``block_costs [B]``, the final closed ``tour`` of global ids and its
    ``cost``. Judged by the reference:

    - ``block_bad``: block tours that are not closed tours of the block
      from its city 0;
    - ``block_cost_gap``: the widest relative gap between a block's
      reported cost and its exact optimum (Held-Karp in float64);
    - ``block_tour_gap``: the widest relative excess of a block tour's
      float64 length over that optimum;
    - ``block_tour_diff``: block tours that are neither the reference's
      optimal tour nor that tour reversed;
    - ``final_bad``: final tours that are not closed tours of all cities;
    - ``final_diff``: positions at which the final tour differs from the
      reference's fold (or, with ranks, its fold and reduce tree) of the
      reference's block tours, over float32 distances;
    - ``final_cost_gap``: the widest relative gap between the reported cost
      and the reference's, which adds the exact block optima and the swap
      costs in float64.

    A block's two directions have one length, and which of them float32
    Held-Karp keeps falls to rounding; the fold's choices depend on it. So
    each reference tour goes into the fold in the direction of the
    answer's tour. A block tour that is neither (a float32 near-tie of
    two tours, counted in ``block_tour_diff`` and held to the optimum's
    length by ``block_tour_gap``) goes in as the answer has it."""
    block_bad = final_bad = final_diff = tour_diff = 0
    cost_gap = tour_gap = final_gap = 0.0
    for ans, xy in zip(answers, xys):
        bsz, n, _ = xy.shape
        d64 = ref.euclidean(xy)
        opt, ref_tours = ref.held_karp(torch.as_tensor(d64, device=device), torch.float64, tours=True)
        opt = opt.cpu().numpy()
        tours = np.asarray(ans["block_tours"], np.int64)
        costs = np.asarray(ans["block_costs"], np.float64)
        lengths = opt.copy()  # a bad block is counted once, in block_bad, not in the gap
        folded = ref_tours.copy()
        bad = 0
        for b in range(bsz):
            if not ref.closed_tour_ok(tours[b], np.arange(n), start=0):
                bad += 1
                continue
            lengths[b] = ref.tour_length(d64[b], tours[b])
            if np.array_equal(tours[b], ref_tours[b][::-1]):
                folded[b] = ref_tours[b][::-1]
            elif not np.array_equal(tours[b], ref_tours[b]):
                tour_diff += 1
                folded[b] = tours[b]
        block_bad += bad
        cost_gap = max(cost_gap, float(np.max(np.abs(costs - opt) / opt)))
        tour_gap = max(tour_gap, float(np.max((lengths - opt) / opt)))
        got = np.asarray(ans["tour"], np.int64)
        if not ref.closed_tour_ok(got, np.arange(bsz * n)):
            final_bad += 1
        if bad:  # no fold to follow from broken block tours
            final_diff += len(got)
            continue
        glob = folded + (np.arange(bsz) * n)[:, None]
        dist = ref.distances(xy.reshape(-1, 2), torch.float32, device)
        if num_ranks == 1:
            want, want_cost = ref.fold(list(glob), list(opt), dist)
        else:
            want, want_cost = ref.blocked_ranks(list(glob), list(opt), dist, num_ranks)
        del dist
        if got.shape != want.shape:
            final_diff += max(len(got), len(want))
        else:
            final_diff += int((got != want).sum())
        final_gap = max(final_gap, abs(float(ans["cost"]) - want_cost) / want_cost)
    if not answers:
        final_bad = 1
    return [("block_bad", float(block_bad), limits["block_bad"]),
            ("block_cost_gap", cost_gap, limits["block_cost_gap"]),
            ("block_tour_gap", tour_gap, limits["block_tour_gap"]),
            ("block_tour_diff", float(tour_diff), limits["block_tour_diff"]),
            ("final_bad", float(final_bad), limits["final_bad"]),
            ("final_diff", float(final_diff), limits["final_diff"]),
            ("final_cost_gap", final_gap, limits["final_cost_gap"])]


def control_pipeline(xy: np.ndarray, num_ranks: int, dtype: torch.dtype, device) -> dict:
    """The reference put in the program's place, computed in ``dtype``:
    Held-Karp for every block, then the fold (and with ranks the reduce
    tree) over distances in ``dtype``. Returns an answer as the program's
    driver records one."""
    bsz, n, _ = xy.shape
    d = torch.as_tensor(ref.euclidean(xy), device=device).to(dtype)
    costs, tours = ref.held_karp(d, dtype, tours=True)
    glob = tours + (np.arange(bsz) * n)[:, None]
    dist = ref.distances(xy.reshape(-1, 2), dtype, device)
    c = costs.double().cpu().numpy()
    if num_ranks == 1:
        tour, cost = ref.fold(list(glob), list(c), dist)
    else:
        tour, cost = ref.blocked_ranks(list(glob), list(c), dist, num_ranks)
    return {"block_tours": tours, "block_costs": c, "tour": tour, "cost": cost}

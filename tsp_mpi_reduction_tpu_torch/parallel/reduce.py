"""The reference's merge-tree reduction, on one device or over ranks.

The reference hand-rolls a binary-tree reduce over MPI ranks because its
operator (``mergeBlocks``) is neither commutative nor associative and its
operands vary in length (tsp.cpp:52-134):

- phase 1 ("downshift", tsp.cpp:72-100): ranks >= lastpower =
  2^floor(log2 p) send their solution to ``rank - lastpower``;
- phase 2 (tsp.cpp:102-132): log2(lastpower) rounds, receiver ``k``,
  sender ``k + 2^d``, stride ``2^(d+1)``; the receiver merges
  (mine, received).

Counterpart of the single-device parts of
``tsp_mpi_reduction_tpu/parallel/reduce.py``: the same tree, the same
per-rank folds and the same "zero length means no data" rule, so a P-rank
result is exactly what P MPI ranks compute. ``compat_bugs=True``
reproduces the reference's never-cleared receive buffer (SURVEY.md
quirk #5). Ranks and rounds are host loops over device merges; all
lengths and costs stay on the device. :func:`reduce_tours_on_mesh` runs the
same tree over a rank group (``parallel/mesh.py``), each round a
``ppermute`` of fixed-width padded tours, as the JAX package's mesh path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..analysis import contracts
from ..ops.merge import PaddedTour, merge_tours


def tree_schedule(num_ranks: int):
    """The reference's tree as ``[(round_name, [(src, dst), ...]), ...]``."""
    lastpower = 1 << (num_ranks.bit_length() - 1)
    if lastpower > num_ranks:
        lastpower >>= 1
    rounds = []
    if num_ranks > lastpower:
        rounds.append(
            ("downshift", [(i, i - lastpower) for i in range(lastpower, num_ranks)])
        )
    for d in range(int(math.log2(lastpower))):
        pairs = [(k + (1 << d), k) for k in range(0, lastpower, 1 << (d + 1))]
        rounds.append((f"tree_d{d}", pairs))
    return rounds


def _select(keep: torch.Tensor, take: torch.Tensor, mine: PaddedTour, alone: PaddedTour, grown: PaddedTour) -> PaddedTour:
    """Per field: ``mine`` where ``keep``, else ``alone`` where ``take``,
    else ``grown``."""
    return PaddedTour(
        *(torch.where(keep, m, torch.where(take, a, g)) for m, a, g in zip(mine, alone, grown))
    )


def _combine(mine: PaddedTour, recv: PaddedTour, dist: torch.Tensor) -> PaddedTour:
    """Merge ``recv`` into ``mine``; zero-length operands mean "no data"."""
    merged = merge_tours(mine, recv, dist)
    keep_mine = recv.length == 0
    take_recv = (mine.length == 0) & (recv.length > 0)
    return _select(keep_mine, take_recv, mine, recv, merged)


def _local_fold(
    tours: torch.Tensor, costs: torch.Tensor, valid: torch.Tensor, dist: torch.Tensor, capacity: int
) -> PaddedTour:
    """A rank's sequential fold over its (possibly padded-out) blocks
    (tsp.cpp:348-352); ``valid`` masks the padding slots."""
    k, l = tours.shape
    dev = tours.device
    tours = tours.to(torch.int32)
    zero_i = torch.tensor(0, dtype=torch.int32, device=dev)
    l_t = torch.tensor(l, dtype=torch.int32, device=dev)
    zero_c = torch.zeros((), dtype=costs.dtype, device=dev)

    def embed(ids, ok):
        return torch.nn.functional.pad(ids, (0, capacity - l)) * ok.to(torch.int32)

    acc = PaddedTour(
        embed(tours[0], valid[0]),
        torch.where(valid[0], l_t, zero_i),
        torch.where(valid[0], costs[0], zero_c),
    )
    for i in range(1, k):
        ok = valid[i]
        # merge with the [l]-sized operand; the empty/invalid selects
        # happen at carry size
        t2 = PaddedTour(tours[i], torch.where(ok, l_t, zero_i), costs[i])
        merged = merge_tours(acc, t2, dist)
        take_t2 = (acc.length == 0) & ok  # first valid block on this rank
        alone = PaddedTour(embed(tours[i], ok), l_t, costs[i])
        acc = _select(~ok, take_t2, acc, alone, merged)
    return acc


def compat_capacity(num_blocks: int, n: int, num_ranks: int) -> int:
    """Buffer size the ``compat_bugs`` reduce needs: under quirk #5 a
    receiver merges its ACCUMULATED receive buffer, so lengths grow past
    ``num_blocks*n + 1``; this walks the tree with integers to bound them."""
    counts = rank_block_counts(num_blocks, num_ranks)
    sol = [c * n + 1 if c else 0 for c in counts]
    acc = [0] * num_ranks
    peak = max(sol)
    for _name, pairs in tree_schedule(num_ranks):
        for s, dd in pairs:
            acc[dd] += sol[s]
            rb = acc[dd]
            if rb and sol[dd]:
                sol[dd] = sol[dd] + rb - 1
            elif rb:
                sol[dd] = rb
            peak = max(peak, sol[dd], acc[dd])
    return peak


def tree_reduce_single_device(
    tours: torch.Tensor,
    costs: torch.Tensor,
    valid: torch.Tensor,
    dist: torch.Tensor,
    capacity: int,
    num_ranks: int,
    compat_bugs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-emulated reduction on one device: per-rank folds, then the tree.

    ``tours`` ``[P*K, L]``: rank r owns rows ``[r*K, (r+1)*K)``; ``costs``
    ``[P*K]``; ``valid`` ``[P*K]`` bool. Returns rank 0's (ids
    ``[capacity]``, length, cost), the only meaningful one (tsp.cpp:133).

    ``compat_bugs``: each receiver merges its accumulated, never-cleared
    receive buffer instead of the operand, with the latest received cost
    (tsp.cpp:67,93-95,114-117); ``capacity`` must come from
    :func:`compat_capacity`.
    """
    pk, l = tours.shape
    if pk % num_ranks:
        # a hard precondition of the slicing below, not an optional
        # contract: it holds under TSP_CONTRACTS=off too
        raise ValueError(f"{pk} block slots not divisible by {num_ranks} ranks")
    _check_reduce_inputs(tours, costs, valid, dist, capacity, num_ranks)
    if capacity < l:
        raise ValueError(f"capacity {capacity} below block tour length {l}")
    k = pk // num_ranks
    dev = tours.device
    folds = [
        _local_fold(tours[r * k:(r + 1) * k], costs[r * k:(r + 1) * k],
                    valid[r * k:(r + 1) * k], dist, capacity)
        for r in range(num_ranks)
    ]
    if compat_bugs:
        lanes = torch.arange(capacity, device=dev)
        acc_ids = [torch.zeros(capacity + 1, dtype=torch.int32, device=dev) for _ in range(num_ranks)]
        acc_len = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(num_ranks)]
    for _name, pairs in tree_schedule(num_ranks):
        # within a round senders and receivers are disjoint, so merging
        # pair by pair equals merging all pairs of the round at once
        new = {}
        for src, dst in pairs:
            recv = folds[src]
            if compat_bugs:
                # append the sender's cities to the receiver's buffer; lanes
                # past the sender's length (or past capacity) go to the
                # scratch slot at index ``capacity``, which is dropped
                dest = torch.where(lanes < recv.length, acc_len[dst] + lanes, capacity)
                dest = torch.clamp(dest, max=capacity)
                acc_ids[dst] = acc_ids[dst].index_put((dest,), recv.ids)
                acc_ids[dst][capacity] = 0
                acc_len[dst] = acc_len[dst] + recv.length
                recv = PaddedTour(acc_ids[dst][:capacity], acc_len[dst], recv.cost)
            new[dst] = _combine(folds[dst], recv, dist)
        for dst, t in new.items():
            folds[dst] = t
    return folds[0].ids, folds[0].length, folds[0].cost


def reduce_tours_on_mesh(ranks, tours: torch.Tensor, costs: torch.Tensor, valid: torch.Tensor,
                         dist: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold and tree-reduce the block tours of a rank group
    (``parallel/reduce.py:137-183``).

    ``tours`` ``[L*K, L_tour]``: the group's local ranks' block slots, K a
    rank in rank order (every rank of a ``BatchedRanks`` group, this
    process's one of a ``ProcessRanks`` group); ``costs`` and ``valid``
    ``[L*K]``; ``dist`` the whole ``[N, N]`` matrix on every rank. Each rank
    folds its blocks, then each round of :func:`tree_schedule` sends every
    sender's fixed-width ``PaddedTour`` (ids ``[capacity]`` int32, length,
    cost) to its receiver, which merges (mine, received) with the
    zero-length rule of :func:`_combine`. Returns the first local rank's
    (ids, length, cost): rank 0's result, the only meaningful one
    (tsp.cpp:133), on rank 0's process; bit for bit what
    :func:`tree_reduce_single_device` gives for the same rank count.
    """
    num_ranks, local = ranks.num_ranks, ranks.local
    _check_reduce_inputs(tours, costs, valid, dist, capacity, local)
    lk, l = tours.shape
    if lk % local or costs.shape != (lk,) or valid.shape != (lk,):
        raise ValueError(f"reduce: tours {tuple(tours.shape)}, costs {tuple(costs.shape)} and valid "
                         f"{tuple(valid.shape)} must hold {local} local ranks' block slots")
    if capacity < l:
        raise ValueError(f"capacity {capacity} below block tour length {l}")
    k = lk // local
    folds = [_local_fold(tours[j * k:(j + 1) * k], costs[j * k:(j + 1) * k], valid[j * k:(j + 1) * k],
                         dist, capacity) for j in range(local)]
    for _name, pairs in tree_schedule(num_ranks):
        acc = PaddedTour(*(torch.stack(f) for f in zip(*folds)))
        recv = PaddedTour(*(ranks.ppermute(x, pairs) for x in acc))
        dsts = {dst for _, dst in pairs}
        # a rank that receives nothing this round keeps its tour (JAX's
        # ppermute hands it zeros, which _combine keeps past)
        folds = [_combine(folds[j], PaddedTour(*(x[j] for x in recv)), dist) if r in dsts else folds[j]
                 for j, r in enumerate(ranks.ids)]
    return folds[0].ids, folds[0].length, folds[0].cost


def _check_reduce_inputs(tours, costs, valid, dist, capacity: int, num_ranks: int) -> None:
    """Boundary contract of the reductions (``reduce.py:186-217``): the
    slot layout below is silent corruption when violated (rows land on the
    wrong rank; a short capacity truncates the splice). Metadata only."""
    if contracts.level() == "off":
        return
    if tours.ndim != 2:
        raise contracts.ContractError(f"reduce: tours must be [P*K, L] block tours, got {tuple(tours.shape)}")
    pk, l = tours.shape
    if tuple(costs.shape) != (pk,) or tuple(valid.shape) != (pk,):
        raise contracts.ContractError(
            f"reduce: costs {tuple(costs.shape)} / valid {tuple(valid.shape)} must both be [{pk}] to "
            f"match the {pk} block rows")
    if pk % num_ranks:
        raise contracts.ContractError(f"reduce: {pk} block rows not divisible by {num_ranks} ranks")
    if dist.ndim != 2 or dist.shape[0] != dist.shape[1]:
        raise contracts.ContractError(f"reduce: dist must be a square [N, N] matrix, got {tuple(dist.shape)}")
    if valid.dtype != torch.bool:
        raise contracts.ContractError(f"reduce: valid must be bool, got {valid.dtype}")
    if capacity < l:
        raise contracts.ContractError(f"reduce: capacity {capacity} below block tour length {l}")


def rank_block_counts(num_blocks: int, num_ranks: int) -> list[int]:
    """Blocks per rank by the reference's round-robin countdown
    (``blocksToSend[blocksLeft % numProcs]++``, tsp.cpp:167-171)."""
    counts = [0] * num_ranks
    for b in range(1, num_blocks + 1):
        counts[b % num_ranks] += 1
    return counts


def assign_blocks_to_ranks(num_blocks: int, num_ranks: int) -> list[list[int]]:
    """Contiguous block ranges per rank in the reference's send order
    (tsp.cpp:173-191)."""
    counts = rank_block_counts(num_blocks, num_ranks)
    out, start = [], 0
    for c in counts:
        out.append(list(range(start, start + c)))
        start += c
    return out


# ---------------------------------------------------------------------------
# Rank collectives of the sharded branch-and-bound, ranks stacked on dim 0
# ---------------------------------------------------------------------------


def pmin_incumbent(values: torch.Tensor) -> torch.Tensor:
    """The best (minimum) incumbent broadcast to every rank (``reduce.py:220``,
    ``lax.pmin`` over the rank axis): ``[R]`` -> ``[R]``."""
    return values.amin(0).expand(values.shape)


def _rank_alive(nodes: torch.Tensor, counts: torch.Tensor, inc, integral: bool):
    """Per-rank alive mask ``[R, F]`` and bounds: row j of rank r is open
    when ``j < counts[r]`` and its bound (the float32 bits of column
    ``cols - 2``) is under the incumbent (``bound <= inc - 1`` on an
    integer metric, the engine's ceil-aware pruning)."""
    b = nodes[..., -2].view(torch.float32)
    inc = torch.as_tensor(inc, dtype=torch.float32, device=nodes.device)
    pos = torch.arange(nodes.shape[1], dtype=torch.int32, device=nodes.device)
    alive = pos[None, :] < counts[:, None]
    alive = alive & ((b <= inc - 1.0) if integral else (b < inc))
    return alive, b


def rank_alive_min(nodes: torch.Tensor, counts: torch.Tensor, inc, integral: bool = False) -> torch.Tensor:
    """Each rank's minimum bound over its open rows (``reduce.py:230``,
    ``make_rank_alive_min``): ``(nodes [R, F, C], counts [R], inc) -> [R]``
    float32, +inf for a rank with no open row."""
    alive, b = _rank_alive(nodes, counts, inc, integral)
    return torch.where(alive, b, float("inf")).amin(dim=1)


def rank_alive_counts(nodes: torch.Tensor, counts: torch.Tensor, inc, integral: bool = False) -> torch.Tensor:
    """Each rank's number of open rows (``reduce.py:287``,
    ``make_rank_alive_counts``): ``(nodes [R, F, C], counts [R], inc) ->
    [R]`` int32."""
    alive, _ = _rank_alive(nodes, counts, inc, integral)
    return alive.sum(dim=1, dtype=torch.int32)


#: column order of the ``[R, K]`` row :func:`make_rank_stats` returns
#: (``reduce.py:337``), shared with ``obs.rankview.RankSampler``
RANK_STAT_COLUMNS = ("count", "alive", "best_bound")


def make_rank_stats(nodes: torch.Tensor, counts: torch.Tensor, inc, integral: bool = False) -> torch.Tensor:
    """Each rank's frontier stats as one ``[R, K]`` float32 row
    (``make_rank_stats``, ``reduce.py:340-393``): the rows it holds
    (``count``), how many of those the incumbent has not closed (``alive``)
    and its best open bound (``best_bound``, +inf for a rank with no open
    row), K = ``len(RANK_STAT_COLUMNS)``. ``(nodes [R, F, C] packed rows,
    counts [R], inc) -> [R, 3]``; the bound column is read as the float32
    bits of column ``C - 2`` and the alive predicate is the integral one
    (``bound <= inc - 1``) or the float one. The caller reads the small
    row back once, never the buffer; over a rank-process group each
    process computes its own ranks' rows and gathers them."""
    alive, b = _rank_alive(nodes, counts, inc, integral)
    return torch.stack([counts.to(torch.float32), alive.sum(dim=1).to(torch.float32),
                        torch.where(alive, b, float("inf")).amin(dim=1)], dim=1)

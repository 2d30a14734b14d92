"""Tour local search on a batch of tours: 2-opt and Or-opt sweeps.

Counterpart of ``tsp_mpi_reduction_tpu/ops/local_search.py:29-232``. The
JAX package ``vmap``s one tour's ``while_loop``; here the batch is a
leading dimension ``[B, n]`` and every tour carries its own ``go`` flag
and iteration count. A tour whose loop has ended is frozen, exactly as the
vmapped ``while_loop`` freezes finished lanes, so each tour follows the
trajectory it would follow alone. Every candidate move is scored at once
as an ``[n, n]`` delta matrix per tour, and the best one (first index on
ties, as ``jnp.argmin``) is applied by an index remap.

Used by the branch-and-bound incumbent (``models/branch_bound``). There is
no Pallas kernel here, so plain torch is the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

INF = float("inf")


def _improve_threshold(d: torch.Tensor) -> torch.Tensor:
    """Accept-move threshold scaled to the distance magnitude: moves that
    gain less than ~32 ulp of the largest edge are noise and skipped."""
    finite = torch.where(torch.isfinite(d), d, 0.0)
    return -(32.0 * torch.finfo(d.dtype).eps * finite.max() + 1e-9)


def _pair_gather(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[t, i, j] = d[a[t, i], b[t, j]]`` for ``a``, ``b`` ``[B, n]``."""
    return d[a[:, :, None], b[:, None, :]]


def _reversal_deltas(t: torch.Tensor, d: torch.Tensor, closed: bool) -> torch.Tensor:
    """Delta of reversing ``t[i+1..j]`` for every edge pair (i < j), per
    tour: ``d(a_i,a_j) + d(b_i,b_j) - (d(a_i,b_i) + d(a_j,b_j))`` with
    edge i = (t[i], t[i+1]) and edge n-1 the wrap edge. Invalid pairs are
    +inf."""
    n = t.shape[1]
    nxt = torch.roll(t, -1, dims=1)
    daa = _pair_gather(d, t, t)
    dbb = torch.roll(daa, (-1, -1), (1, 2))
    da = daa + dbb
    dab = d[t, nxt]
    db = dab[:, :, None] + dab[:, None, :]
    delta = da - db
    i_ = torch.arange(n, device=t.device)[:, None]
    j_ = torch.arange(n, device=t.device)[None, :]
    valid = j_ >= i_ + 2  # adjacent edges -> no-op reversal
    if closed:
        valid = valid & ~((i_ == 0) & (j_ == n - 1))  # (0, n-1) is the identity
    else:
        valid = valid & (j_ <= n - 2)  # open path: no wrap edge
    return torch.where(valid, delta, INF)


def _run_lanes(t: torch.Tensor, dtype: torch.dtype, max_iters: int, body) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drive ``body(t, acc) -> (t', improve, acc')`` over the lanes whose
    ``go & (it < max_iters)`` holds, until none does; finished lanes stay
    frozen, as under a vmapped ``while_loop``. Returns (tours, acc)."""
    b = t.shape[0]
    go = torch.ones(b, dtype=torch.bool, device=t.device)
    it = torch.zeros(b, dtype=torch.int64, device=t.device)
    acc = torch.zeros(b, dtype=dtype, device=t.device)
    while True:
        active = torch.nonzero(go & (it < max_iters))[:, 0]
        if active.numel() == 0:
            return t, acc
        t_new, improve, acc_new = body(t[active], acc[active])
        t = t.index_copy(0, active, t_new)
        go = go.index_copy(0, active, improve)
        it = it.index_copy(0, active, it[active] + 1)
        acc = acc.index_copy(0, active, acc_new)


def two_opt_sweep(
    t: torch.Tensor, d: torch.Tensor, closed: bool = True, max_iters: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement 2-opt until converged, per tour -> (tours', deltas).

    ``t`` ``[B, n]`` int64 tour orders (open layout; the closing edge
    ``t[-1] -> t[0]`` is implied when ``closed``, else the endpoints are
    pinned); ``d`` ``[n, n]``.
    """
    n = t.shape[1]
    ar = torch.arange(n, device=t.device)[None, :]
    thr = _improve_threshold(d)

    def body(tb, acc):
        delta = _reversal_deltas(tb, d, closed).reshape(tb.shape[0], -1)
        flat = delta.argmin(dim=1)
        i, j = (flat // n)[:, None], (flat % n)[:, None]
        dbest = delta.gather(1, flat[:, None])[:, 0]
        improve = dbest < thr
        in_seg = (ar >= i + 1) & (ar <= j) & improve[:, None]
        src = torch.where(in_seg, j - ar + i + 1, ar)
        return tb.gather(1, src), improve, acc + torch.where(improve, dbest, 0.0)

    return _run_lanes(t, d.dtype, max_iters, body)


def _relocation_deltas(t: torch.Tensor, d: torch.Tensor, L: int) -> torch.Tensor:
    """Delta of moving the length-``L`` segment at position i to after
    position j, for every (i, j) on each closed tour: (bridge the gap left
    behind) + (splice into edge j) - (removed edges). Segments may not wrap
    the linear layout (i + L <= n). Invalid pairs are +inf."""
    n = t.shape[1]
    ar = torch.arange(n, device=t.device)
    pred = t[:, (ar - 1) % n]
    seg_end = t[:, (ar + L - 1) % n]
    succ = t[:, (ar + L) % n]
    jnxt = t[:, (ar + 1) % n]
    remove = d[pred, succ] - d[pred, t] - d[seg_end, succ]
    d_tt = _pair_gather(d, t, t)
    splice = (
        d_tt.transpose(1, 2)
        + torch.roll(d_tt, (-(L - 1), -1), (1, 2))
        - d[t, jnxt][:, None, :]
    )
    delta = remove[:, :, None] + splice
    i_ = ar[:, None]
    j_ = ar[None, :]
    valid = ((j_ - (i_ - 1)) % n > L) & (i_ + L <= n)
    return torch.where(valid, delta, INF)


def _apply_relocation(t: torch.Tensor, i: torch.Tensor, L: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Move segment ``t[i:i+L]`` to sit after position ``j``, per tour
    (``i``, ``L``, ``j`` ``[B, 1]``)."""
    n = t.shape[1]
    ar = torch.arange(n, device=t.device)[None, :]
    # forward (j >= i+L): the gap closes leftward, block lands at j-L+1..j
    src_f = torch.where((ar >= i) & (ar <= j - L), ar + L, ar)
    src_f = torch.where((ar >= j - L + 1) & (ar <= j), i + (ar - (j - L + 1)), src_f)
    # backward (j <= i-2): block lands at j+1..j+L, the gap closes rightward
    src_b = torch.where((ar >= j + 1) & (ar <= j + L), i + (ar - j - 1), ar)
    src_b = torch.where((ar >= j + L + 1) & (ar <= i + L - 1), ar - L, src_b)
    # the clamp only touches lanes whose move is not applied
    return t.gather(1, torch.where(j >= i, src_f, src_b).clamp(0, n - 1))


def or_opt_sweep(
    t: torch.Tensor, d: torch.Tensor, max_iters: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement Or-opt (relocate segments of length 1-3) on each
    closed tour until converged -> (tours', deltas)."""
    n = t.shape[1]
    thr = _improve_threshold(d)

    def body(tb, acc):
        deltas = torch.stack([_relocation_deltas(tb, d, L) for L in (1, 2, 3)], dim=1)
        deltas = deltas.reshape(tb.shape[0], -1)
        flat = deltas.argmin(dim=1)
        dbest = deltas.gather(1, flat[:, None])[:, 0]
        li = flat // (n * n)
        i = (flat // n) % n
        j = flat % n
        improve = dbest < thr
        moved = _apply_relocation(tb, i[:, None], li[:, None] + 1, j[:, None])
        moved = torch.where(improve[:, None], moved, tb)
        return moved, improve, acc + torch.where(improve, dbest, 0.0)

    return _run_lanes(t, d.dtype, max_iters, body)


def polish(t: torch.Tensor, d: torch.Tensor, max_rounds: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternate 2-opt and Or-opt sweeps on each tour until neither
    improves -> (tours', deltas). Each sweep is monotone, so the loop
    terminates."""

    def body(tb, acc):
        tb, d1 = two_opt_sweep(tb, d, closed=True)
        tb, d2 = or_opt_sweep(tb, d)
        # each applied move cleared the threshold, so progress shows as a
        # strictly negative sum (exact 0.0 otherwise)
        return tb, (d1 + d2) < 0, acc + d1 + d2

    return _run_lanes(t, d.dtype, max_rounds, body)


def tour_length(t: torch.Tensor, d: torch.Tensor, closed: bool = True) -> torch.Tensor:
    """Length of each tour order in ``t`` ``[B, n]`` under ``d``."""
    seg = d[t[:, :-1], t[:, 1:]].sum(dim=1)
    return seg + d[t[:, -1], t[:, 0]] if closed else seg

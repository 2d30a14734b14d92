"""Tour local search on a batch of tours: 2-opt and Or-opt sweeps.

Counterpart of ``tsp_mpi_reduction_tpu/ops/local_search.py:29-232``. The
JAX package ``vmap``s one tour's ``while_loop``; here the batch is a
leading dimension ``[B, n]`` and every tour carries its own ``go`` flag
and iteration count. A tour whose loop has ended is frozen, exactly as the
vmapped ``while_loop`` freezes finished lanes, so each tour follows the
trajectory it would follow alone. Every candidate move is scored at once
as an ``[n, n]`` delta matrix per tour, and the best one (first index on
ties, as ``jnp.argmin``) is applied by an index remap.

Used by the branch-and-bound incumbent (``models/branch_bound``), serve's
blocked rung, the ``--improve`` polish and the ring's open segments
(``parallel/seq_improve``). There is no Pallas kernel here, so plain torch
is the port.

The JAX package jits each sweep and :func:`polish` into one
``lax.while_loop`` program. The counterpart on CUDA is one captured graph:
:func:`_polish_step` is the nested loops flattened into one predicated
step, in which every lane makes one move of the sweep it is in (2-opt,
Or-opt, or none once it is done). The graph store
(``perf/compile_cache.py``, entry ``polish``) captures it once per key and
the caller replays it in runs of :data:`POLISH_READ_STEPS` steps, with
one host read of the lanes' counters a run. On the CPU, and on CUDA under
``TSP_COMPILE_CACHE=off``, the nested loops run eagerly
(:func:`_run_lanes`). Both paths make the same moves with the same float
adds in the same order, so their tours and sums are equal bit for bit.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from ..perf import compile_cache

INF = float("inf")

#: the sweeps' iteration caps (``two_opt_sweep``'s and ``or_opt_sweep``'s
#: defaults), which :func:`polish` runs each round
TWO_OPT_ITERS = 512
OR_OPT_ITERS = 256

#: replayed steps between two host reads of the lanes' counters: a polish
#: issues at most this many steps minus one past its last lane's stop.
#: On the H100 a 16 x 51 step replays in ~0.47 ms and an eil51 ILS polish
#: needs ~11 steps (PERF.md): a no-op step costs more than a read
POLISH_READ_STEPS = 4

#: a lane's phase in :func:`_polish_step`
_TWO_OPT, _OR_OPT, _DONE = 0, 1, 2
#: the step's int64 counters a lane: phase, the sweep's iteration, the
#: round, and the steps the lane moved in (its own, not the no-ops)
_PHASE, _IT, _ROUND, _STEPS = range(4)
#: the step's float sums a lane: the 2-opt sweep's, the Or-opt sweep's,
#: and the polish's (the JAX loops' ``acc`` carries)
_D1, _D2, _ACC = range(3)

#: the replayed polish's counts in this process: calls, steps issued,
#: steps the slowest lane of each call moved in (summed), host reads
POLISH_STATS = {"calls": 0, "steps": 0, "lane_steps": 0, "reads": 0}
_STATS_LOCK = threading.Lock()  # serve's request threads polish at once


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


def _two_opt_move(t: torch.Tensor, d: torch.Tensor, thr: torch.Tensor,
                  closed: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One best-improvement 2-opt iteration on every tour -> (tours',
    improve, gain): the body of ``two_opt_sweep``'s loop
    (``local_search.py:82-91``); the gain is 0.0 where nothing improves."""
    n = t.shape[1]
    ar = torch.arange(n, device=t.device)[None, :]
    delta = _reversal_deltas(t, d, closed).reshape(t.shape[0], -1)
    flat = delta.argmin(dim=1)
    i, j = (flat // n)[:, None], (flat % n)[:, None]
    dbest = delta.gather(1, flat[:, None])[:, 0]
    improve = dbest < thr
    in_seg = (ar >= i + 1) & (ar <= j) & improve[:, None]
    src = torch.where(in_seg, j - ar + i + 1, ar)
    return t.gather(1, src), improve, torch.where(improve, dbest, 0.0)


def _run_lanes(t: torch.Tensor, dtype: torch.dtype, max_iters: int, body) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drive ``body(t, acc) -> (t', improve, acc')`` over the lanes whose
    ``go & (it < max_iters)`` holds, until none does; finished lanes stay
    frozen, as under a vmapped ``while_loop``. Returns (tours, acc).

    The eager path: the CPU's, and the one ``TSP_COMPILE_CACHE=off`` asks
    for on CUDA. It reads the active lanes back after every iteration."""
    b = t.shape[0]
    go = torch.ones(b, dtype=torch.bool, device=t.device)
    it = torch.zeros(b, dtype=torch.int64, device=t.device)
    acc = torch.zeros(b, dtype=dtype, device=t.device)
    while True:
        # a read an iteration: eager by request or on the CPU; on CUDA the
        # flattened step replays (_stepped)  # graftlint: disable=R1
        active = torch.nonzero(go & (it < max_iters))[:, 0]
        if active.numel() == 0:
            return t, acc
        t_new, improve, acc_new = body(t[active], acc[active])
        t = t.index_copy(0, active, t_new)
        go = go.index_copy(0, active, improve)
        it = it.index_copy(0, active, it[active] + 1)
        acc = acc.index_copy(0, active, acc_new)


def two_opt_sweep(
    t: torch.Tensor, d: torch.Tensor, closed: bool = True, max_iters: int = TWO_OPT_ITERS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement 2-opt until converged, per tour -> (tours', deltas).

    ``t`` ``[B, n]`` int64 tour orders (open layout; the closing edge
    ``t[-1] -> t[0]`` is implied when ``closed``, else the endpoints are
    pinned); ``d`` ``[n, n]``. On CUDA a replayed graph (module docstring).
    """
    out = _replayed(t, d, closed=closed, two_iters=max_iters, or_iters=0, max_rounds=1)
    if out is not None:
        return out
    thr = _improve_threshold(d)

    def body(tb, acc):
        moved, improve, gain = _two_opt_move(tb, d, thr, closed)
        return moved, improve, acc + gain

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
    t: torch.Tensor, d: torch.Tensor, max_iters: int = OR_OPT_ITERS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement Or-opt (relocate segments of length 1-3) on each
    closed tour until converged -> (tours', deltas). On CUDA a replayed
    graph (module docstring)."""
    out = _replayed(t, d, closed=True, two_iters=0, or_iters=max_iters, max_rounds=1)
    if out is not None:
        return out
    thr = _improve_threshold(d)

    def body(tb, acc):
        moved, improve, gain = _or_opt_move(tb, d, thr)
        return moved, improve, acc + gain

    return _run_lanes(t, d.dtype, max_iters, body)


def _or_opt_move(t: torch.Tensor, d: torch.Tensor,
                 thr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One best-improvement Or-opt iteration on every closed tour ->
    (tours', improve, gain): the body of ``or_opt_sweep``'s loop
    (``local_search.py:177-189``); the gain is 0.0 where nothing improves."""
    n = t.shape[1]
    deltas = torch.stack([_relocation_deltas(t, d, L) for L in (1, 2, 3)], dim=1)
    deltas = deltas.reshape(t.shape[0], -1)
    flat = deltas.argmin(dim=1)
    dbest = deltas.gather(1, flat[:, None])[:, 0]
    li = flat // (n * n)
    i = (flat // n) % n
    j = flat % n
    improve = dbest < thr
    moved = _apply_relocation(t, i[:, None], li[:, None] + 1, j[:, None])
    moved = torch.where(improve[:, None], moved, t)
    return moved, improve, torch.where(improve, dbest, 0.0)


def polish(t: torch.Tensor, d: torch.Tensor, max_rounds: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternate 2-opt and Or-opt sweeps on each tour until neither
    improves -> (tours', deltas). Each sweep is monotone, so the loop
    terminates. On CUDA a replayed graph (module docstring)."""
    out = _replayed(t, d, closed=True, two_iters=TWO_OPT_ITERS, or_iters=OR_OPT_ITERS,
                    max_rounds=max_rounds)
    if out is not None:
        return out

    def body(tb, acc):
        tb, d1 = two_opt_sweep(tb, d, closed=True)
        tb, d2 = or_opt_sweep(tb, d)
        # each applied move cleared the threshold, so progress shows as a
        # strictly negative sum (exact 0.0 otherwise)
        return tb, (d1 + d2) < 0, acc + d1 + d2

    return _run_lanes(t, d.dtype, max_rounds, body)


def _polish_step(t: torch.Tensor, ctr: torch.Tensor, sums: torch.Tensor, d: torch.Tensor,
                 thr: torch.Tensor, *, closed: bool, two_iters: int, or_iters: int,
                 max_rounds: int) -> torch.Tensor:  # graftlint: hot
    """One predicated step of the flattened sweeps, in place on every lane
    of ``t`` ``[B, n]`` (int64), its counters ``ctr`` ``[B, 4]`` (int64,
    ``_PHASE``, ``_IT``, ``_ROUND``, ``_STEPS``) and its sums ``sums``
    ``[B, 3]`` (``d``'s dtype, ``_D1``, ``_D2``, ``_ACC``), with no host
    read: the counterpart of the JAX ``polish`` program's nested
    ``while_loop``s (``local_search.py:199-226``) on one lane each.

    A lane makes one move of the phase it is in: a 2-opt iteration (as
    :func:`two_opt_sweep`'s) or an Or-opt one (as :func:`or_opt_sweep`'s),
    adding its gain to the sweep's sum. A sweep stops, as its
    ``while_loop`` does, when the move did not improve or its iteration
    count reached its cap (``two_iters``, ``or_iters``); that step is its
    last and ends the phase (the loops' ``go`` flag). A 2-opt sweep is
    followed by an Or-opt sweep, whose end closes the round as
    :func:`polish`'s body does: ``improved = (d1 + d2) < 0``, ``acc = acc +
    d1 + d2``, one more round; the lane starts a new round if it improved
    and the count is under ``max_rounds``, else it is done, and a done
    lane's step is a no-op. A cap of 0 leaves that sweep out: ``two_iters``
    alone is one 2-opt sweep (``max_rounds`` 1; ``closed=False`` the ring's
    open segments), ``or_iters`` alone one Or-opt sweep; ``acc`` is then
    that sweep's sum, bit for bit (``0.0 + d1 + 0.0``). The threshold
    ``thr`` is :func:`_improve_threshold`'s, computed once by the caller.
    Returns ``ctr``."""
    phase = ctr[:, _PHASE]
    live = phase != _DONE
    it = ctr[:, _IT] + live.long()
    d1, d2, acc = sums[:, _D1], sums[:, _D2], sums[:, _ACC]
    moved = t
    no = torch.zeros_like(live)
    end2 = end_or = no
    if two_iters:
        in2 = phase == _TWO_OPT
        t2, imp2, gain2 = _two_opt_move(t, d, thr, closed)
        moved = torch.where(in2[:, None], t2, moved)
        d1 = torch.where(in2, d1 + gain2, d1)
        end2 = in2 & ~(imp2 & (it < two_iters))
    if or_iters:
        in_or = phase == _OR_OPT
        t_or, imp_or, gain_or = _or_opt_move(t, d, thr)
        moved = torch.where(in_or[:, None], t_or, moved)
        d2 = torch.where(in_or, d2 + gain_or, d2)
        end_or = in_or & ~(imp_or & (it < or_iters))
    # the round closes where its last sweep stops
    end_round = end_or if or_iters else end2
    to_or = end2 if (two_iters and or_iters) else no
    improved = (d1 + d2) < 0
    acc = torch.where(end_round, acc + d1 + d2, acc)
    rounds = ctr[:, _ROUND] + end_round.long()
    again = end_round & improved & (rounds < max_rounds)
    first = _TWO_OPT if two_iters else _OR_OPT
    phase = torch.where(to_or, _OR_OPT, phase)
    phase = torch.where(end_round, torch.where(again, first, _DONE), phase)
    # a new sweep starts at iteration 0 from a sum of 0.0
    d1 = torch.where(again, 0.0, d1)
    d2 = torch.where(again | to_or, 0.0, d2)
    it = torch.where(end2 | end_or, 0, it)
    t.copy_(moved)
    sums.copy_(torch.stack([d1, d2, acc], dim=1))
    ctr.copy_(torch.stack([phase, it, rounds, ctr[:, _STEPS] + live.long()], dim=1))
    return ctr


#: the polish's entry in the graph store: :func:`_polish_step` captured
#: once per key (``[B, n]``, ``d``'s dtype, device, ``closed``, the sweeps'
#: caps, ``max_rounds``, the torch/CUDA versions), the counterpart of the
#: JAX package's jitted sweeps and its ``_vpolish`` program
POLISH = compile_cache.GraphEntry("polish", _polish_step)


def _read_lanes(ctr: torch.Tensor) -> list:  # graftlint: hot
    """The lanes' counters (a row a lane) in one device-to-host read."""
    # the one read a run of POLISH_READ_STEPS steps, by design  # graftlint: disable=R1
    return ctr.tolist()


def _initial_state(t: torch.Tensor, d: torch.Tensor, two_iters: int, max_rounds: int):
    """The step's inputs at a polish's start: the tours as int64, every
    lane in its first phase (done when ``max_rounds`` is 0) at iteration
    and round 0, zero sums, and the threshold."""
    b = t.shape[0]
    ctr = torch.zeros((b, 4), dtype=torch.int64, device=t.device)
    first = (_TWO_OPT if two_iters else _OR_OPT) if max_rounds > 0 else _DONE
    ctr[:, _PHASE] = first
    sums = torch.zeros((b, 3), dtype=d.dtype, device=t.device)
    return t.to(torch.int64, copy=True), ctr, sums, d, _improve_threshold(d)


def _stepped(t: torch.Tensor, d: torch.Tensor, *, closed: bool, two_iters: int, or_iters: int,
             max_rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flattened sweeps run to the end on every lane -> (tours in
    ``t``'s dtype, ``acc``): steps in runs of :data:`POLISH_READ_STEPS`
    (read at the call), one read of the lanes' counters after each, until
    every lane is done. On CUDA with the store on each step is a replay of
    :data:`POLISH`'s graph, whose buffers the call adopts (a second call of
    the key waits); on the CPU the same step runs eagerly. Counted in
    :data:`POLISH_STATS`."""
    if two_iters <= 0 and or_iters <= 0:
        raise ValueError("the flattened polish needs a 2-opt or an Or-opt sweep")
    read_every = POLISH_READ_STEPS
    statics = dict(closed=closed, two_iters=two_iters, or_iters=or_iters, max_rounds=max_rounds)
    args = _initial_state(t, d, two_iters, max_rounds)
    g = POLISH.graph(*args, **statics)
    if g is None:
        state = args
    else:
        g.acquire()
        state = g.inputs
    try:
        if g is not None:
            for s, a in zip(state, args):
                s.copy_(a)
        issued, reads = 0, 0
        while True:
            if g is None:
                for _ in range(read_every):  # on the CPU
                    _polish_step(*state, **statics)
            else:
                g.replay(read_every)
            issued += read_every
            vals = _read_lanes(state[1])
            reads += 1
            if all(v[_PHASE] == _DONE for v in vals):
                break
        tours, acc = state[0].to(t.dtype), state[2][:, _ACC]
        if g is not None:
            tours, acc = tours.clone(), acc.clone()
    finally:
        if g is not None:
            g.release()
    with _STATS_LOCK:
        POLISH_STATS["calls"] += 1
        POLISH_STATS["steps"] += issued
        POLISH_STATS["lane_steps"] += max(v[_STEPS] for v in vals)
        POLISH_STATS["reads"] += reads
    return tours, acc


def _replayed(t: torch.Tensor, d: torch.Tensor, *, closed: bool, two_iters: int, or_iters: int,
              max_rounds: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`_stepped` on replays of the stored graph, or None where the
    eager loops run instead: on the CPU, with the store off, or for a
    polish with nothing to run."""
    if t.device.type != "cuda" or not compile_cache.store_enabled():
        return None
    if max_rounds <= 0 or two_iters + or_iters <= 0 or t.shape[0] == 0:
        return None
    return _stepped(t, d, closed=closed, two_iters=two_iters, or_iters=or_iters, max_rounds=max_rounds)


def tour_length(t: torch.Tensor, d: torch.Tensor, closed: bool = True) -> torch.Tensor:
    """Length of each tour order in ``t`` ``[B, n]`` under ``d``."""
    seg = d[t[:, :-1], t[:, 1:]].sum(dim=1)
    return seg + d[t[:, -1], t[:, 0]] if closed else seg

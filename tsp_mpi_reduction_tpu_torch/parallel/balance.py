"""Load balance for the sharded branch-and-bound search.

Counterpart of ``tsp_mpi_reduction_tpu/parallel/balance.py``. The JAX
package runs one frontier per device inside ``shard_map`` and moves rows
with ``ppermute``/``all_gather``. Here the steps take a rank group
(``parallel/mesh.py``) and ``nodes [L, F, C]`` with ``count [L]``, the
group's local ranks: all R stacked in one process (``BatchedRanks``, the
default, whose collectives are tensor ops over dim 0) or this process's
one rank (``ProcessRanks``). Every rank computes the assignment from the
all-gathered ``[R]`` counts, donates from its own rows, and receives by
its global rank id, so both groups run the same code.

Three layers, as in the JAX module:

- the assignment math (:func:`pair_assignment`, :func:`steal_assignment`):
  who donates how many rows to whom, a function of the ``[R]`` counts;
- the balance steps (:func:`ring_step`, :func:`pair_step`,
  :func:`steal_step`, dispatched by :func:`apply`) over the local rows,
  each returning ``(nodes, count [L], m_out [L])``; ``nodes`` is updated
  in place;
- the host-side controller (:class:`BalanceController`, numpy only), which
  picks each dispatch's action from the per-rank occupancy counts with
  hysteresis: ``skip``, the base ``ring``/``pair``, or ``steal``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..obs.metrics import REGISTRY as _REGISTRY
from .mesh import BatchedRanks

#: every balance action the controller can pick
ACTIONS = ("skip", "ring", "pair", "steal")


# -- assignment math -----------------------------------------------------------


def pair_assignment(all_c: torch.Tensor, round_i, num_ranks: int, t_slots: int):
    """The pair matching (``balance.py:71-87``): richest donates to
    poorest, 2nd-richest to 2nd-poorest, ..., ties broken by a rotation
    that advances with ``round_i``. ``all_c`` is the ``[R]`` int32 count
    vector. Returns ``(m_of, partner_of)``: per-rank donation size and
    mirror partner, ``[R]`` each."""
    dev = all_c.device
    ar = torch.arange(num_ranks, dtype=torch.int32, device=dev)
    rot = (ar + round_i) % num_ranks
    # jnp.lexsort((rot, -all_c)): the count descending is the primary key,
    # the rotation breaks ties; torch has no lexsort, so two stable sorts
    # (secondary key first) give the same order
    by_rot = torch.argsort(rot, stable=True)
    order = by_rot[torch.argsort(-all_c[by_rot], stable=True)]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(num_ranks, device=dev)  # rank r's position in that order
    partner_of = order[num_ranks - 1 - pos]
    donor = pos < (num_ranks // 2)  # odd R: the middle rank pairs itself
    gap = all_c - all_c[partner_of]
    m_of = torch.where(donor, torch.clamp(gap // 2, 0, t_slots), 0)
    return m_of, partner_of


def steal_assignment(all_c: torch.Tensor, t_slots: int):
    """The steal repartition plan (``balance.py:90-131``): ranks above the
    mean donate their surplus into a pool, ranks below it take their
    deficit, both capped at ``t_slots``. Donor r owns pool positions
    ``[pool_off[r], pool_off[r] + m_out[r])``, receiver r takes
    ``[take_off[r], take_off[r] + m_in[r])``; both partition the moved
    total. Returns ``(m_out, m_in, pool_off, take_off)``, ``[R]`` int32."""
    num_ranks = all_c.shape[0]
    # int32 throughout: torch's sum/cumsum of int32 return int64 unless
    # given a dtype, and the counts must stay int32 (the snapshot's dtype)
    dt = torch.int32
    mean = all_c.sum(dtype=dt) // num_ranks
    don = torch.clamp(all_c - mean, 0, t_slots)
    need = torch.clamp(mean - all_c, 0, t_slots)
    moved = torch.minimum(don.sum(dtype=dt), need.sum(dtype=dt))
    don_off = torch.cumsum(don, 0, dtype=dt) - don  # exclusive prefix
    need_off = torch.cumsum(need, 0, dtype=dt) - need
    zero = torch.zeros_like(don)
    m_out = torch.minimum(torch.maximum(moved - don_off, zero), don)
    m_in = torch.minimum(torch.maximum(moved - need_off, zero), need)
    pool_off = torch.minimum(don_off, moved)
    take_off = torch.minimum(need_off, moved)
    return m_out, m_in, pool_off, take_off


# -- balance steps over the stacked buffer -----------------------------------------


def _donor_slabs(nodes: torch.Tensor, cnt: torch.Tensor, m_out: torch.Tensor, t_slots: int,
                 capacity: int) -> torch.Tensor:
    """Each rank's top ``t_slots`` rows from ``cnt - m_out`` on, ``[R, t, C]``.

    In-place aliasing: a rank donates rows ``cnt - m_out .. cnt`` and
    receives at ``base = cnt - m_out``, the same slots. The JAX steps are
    functional and gather every slab before any write; advanced indexing
    here returns a copy, so every slab is gathered before the first write.
    """
    r = nodes.shape[0]
    lanes = torch.arange(t_slots, dtype=torch.int32, device=nodes.device)
    src = torch.clamp(cnt[:, None] - m_out[:, None] + lanes, 0, capacity - 1)
    ranks = torch.arange(r, device=nodes.device)[:, None]
    return nodes[ranks, src.long()]


def _receive(nodes: torch.Tensor, cnt: torch.Tensor, m_out: torch.Tensor, m_in: torch.Tensor,
             recv: torch.Tensor, phys_rows: int):
    """Write lane j of ``recv [R, t, C]`` at row ``cnt - m_out + j`` of its
    rank for ``j < m_in`` only, in place; returns ``(nodes, new count,
    m_out)``.

    ``mode="drop"``: the JAX steps park dead lanes at ``phys_rows`` and
    drop them (``balance.py:162``, ``:190``, ``:228``). Here only the live
    lanes are selected, so no dead lane is clamped onto a real row.
    """
    r, t = recv.shape[:2]
    dev = nodes.device
    lanes = torch.arange(t, dtype=torch.int32, device=dev)
    base = cnt - m_out
    dest = base[:, None] + lanes
    live = (lanes[None, :] < m_in[:, None]) & (dest < phys_rows)
    ranks = torch.arange(r, device=dev)[:, None].expand(r, t)
    nodes[ranks[live], dest[live].long()] = recv[live]
    return nodes, base + m_in, m_out


def _group(ranks, nodes):
    """The rank group of a step: the stacked ranks of ``nodes`` by default."""
    return ranks if ranks is not None else BatchedRanks(nodes.shape[0])


def ring_step(nodes, cnt, round_i=0, *, t_slots: int, capacity: int, phys_rows: int, ranks=None):
    """Diffuse work around the ring (``balance.py:138-162``): each rank
    donates top-of-stack rows to its successor while it holds more,
    capped so the receiver cannot overflow. ``round_i`` is unused."""
    ranks = _group(ranks, nodes)
    me = ranks.rank_ids(nodes.device)
    all_c = ranks.all_gather(cnt)
    m_all = torch.clamp((all_c - torch.roll(all_c, -1, 0)) // 2, 0, t_slots)
    m_out = m_all[me]
    m_in = torch.roll(m_all, 1, 0)[me]  # what my predecessor donates
    slabs = _donor_slabs(nodes, cnt, m_out, t_slots, capacity)
    return _receive(nodes, cnt, m_out, m_in, ranks.shift_fwd(slabs), phys_rows)


def pair_step(nodes, cnt, round_i, *, num_ranks: int, t_slots: int, capacity: int,
              phys_rows: int, ranks=None):
    """Pair the richest rank with the poorest and donate half the gap
    (``balance.py:165-190``); the matching rotates its tie-break with
    ``round_i``."""
    ranks = _group(ranks, nodes)
    me = ranks.rank_ids(nodes.device)
    m_of, partner_of = pair_assignment(ranks.all_gather(cnt), round_i, num_ranks, t_slots)
    m_in = m_of[partner_of][me]  # 0 unless my partner donates (to me)
    slabs = _donor_slabs(nodes, cnt, m_of[me], t_slots, capacity)
    recv = ranks.all_gather(slabs)[partner_of[me]]
    return _receive(nodes, cnt, m_of[me], m_in, recv, phys_rows)


def steal_step(nodes, cnt, round_i=0, *, num_ranks: int, t_slots: int, capacity: int,
               phys_rows: int, ranks=None):
    """Global repartition for starvation (``balance.py:193-231``): ranks
    above the mean donate their surplus into a pool, ranks below it take
    their deficit out of it. Receiver lane j holds pool position
    ``take_off + j``; its donor is the last rank whose slab starts at or
    before it (a right-side search over the donor offsets, robust to
    zero-width donors). ``round_i`` is unused."""
    ranks = _group(ranks, nodes)
    me = ranks.rank_ids(nodes.device)
    m_out, m_in, pool_off, take_off = steal_assignment(ranks.all_gather(cnt), t_slots)
    slabs = ranks.all_gather(_donor_slabs(nodes, cnt, m_out[me], t_slots, capacity))
    lanes = torch.arange(t_slots, dtype=torch.int32, device=nodes.device)
    pos = take_off[me][:, None] + lanes  # [local, t] global pool positions
    # jnp.searchsorted(side="right") is torch.searchsorted(right=True)
    donor = torch.clamp(torch.searchsorted(pool_off, pos, right=True) - 1, 0, num_ranks - 1)
    row = torch.clamp(pos - pool_off[donor], 0, t_slots - 1)
    return _receive(nodes, cnt, m_out[me], m_in[me], slabs[donor, row.long()], phys_rows)


def apply(action: str, nodes, cnt, round_i, *, num_ranks: int, t_slots: int, capacity: int,
          phys_rows: int, ranks=None):
    """One balance step by action name (``balance.py:234-263``). ``skip``
    returns the frontier untouched with zero moved rows. ``ranks``: the
    rank group whose local rows ``nodes`` holds (default: all ranks stacked
    in this process)."""
    if action == "skip":
        return nodes, cnt, torch.zeros_like(cnt)
    if action == "ring":
        return ring_step(nodes, cnt, round_i, t_slots=t_slots, capacity=capacity,
                         phys_rows=phys_rows, ranks=ranks)
    if action == "pair":
        return pair_step(nodes, cnt, round_i, num_ranks=num_ranks, t_slots=t_slots,
                         capacity=capacity, phys_rows=phys_rows, ranks=ranks)
    if action == "steal":
        return steal_step(nodes, cnt, round_i, num_ranks=num_ranks, t_slots=t_slots,
                          capacity=capacity, phys_rows=phys_rows, ranks=ranks)
    raise ValueError(f"unknown balance action {action!r} (one of {ACTIONS})")


# -- the host-side controller -------------------------------------------------------


@dataclass
class BalanceController:
    """Picks the next dispatch's balance action from the per-rank ``[R]``
    occupancy counts, with hysteresis (``balance.py:266-464``, copied).

    The dead-band has two gates: the occupancy CV under ``dead_band``, or
    a worthwhile-transfer floor (the donatable surplus above ``k`` per
    rank, capped at ``t_slots``, matched against the hungry ranks'
    deficit must reach ``max(1, k // 2)`` rows). Starvation (a rank at or
    below ``starve_frac`` of the mean, or a CV past ``escalate_cv``)
    escalates to ``steal``, confirmed against the ALIVE counts when a
    probe is given: on entry into ``steal`` and every ``probe_every``-th
    consecutive steal round. Entering ``skip`` from an active action takes
    ``settle`` consecutive calm decisions; leaving it is immediate.

    ``adaptive=False`` is the static policy: the fixed ``base`` action,
    skipping only on a drained mesh (the explicit ring/pair/steal modes).
    """

    num_ranks: int
    k: int
    t_slots: int
    base: str = "pair"
    adaptive: bool = True
    dead_band: float = 0.25
    escalate_cv: float = 1.25
    starve_frac: float = 0.10
    settle: int = 2
    probe_every: int = 16
    max_rows: int = 512
    row_bytes: int = 0

    _last: str = "skip"
    _calm: int = 0
    _steal_streak: int = 0
    _switches: int = 0
    _degraded: int = 0
    _probes: int = 0
    _cv_last: float = 0.0
    _cv_max: float = 0.0
    _actions: Dict[str, int] = field(default_factory=dict)
    _moved_rows: int = 0
    _rows: List[list] = field(default_factory=list)
    _rows_dropped: int = 0

    @property
    def last_action(self) -> str:
        """The action committed by the most recent decision."""
        return self._last

    @property
    def cv(self) -> float:
        """Occupancy CV seen by the most recent decision."""
        return self._cv_last

    def decide(self, counts: np.ndarray, alive_probe: Optional[Callable[[], np.ndarray]] = None) -> str:
        """Pick the action for the NEXT dispatch from the per-rank
        occupancy ``counts``. ``alive_probe``, when given, is called only to
        confirm an escalation and returns the per-rank ALIVE row counts."""
        c = np.asarray(counts, np.float64)
        total = float(c.sum())
        mean = total / max(self.num_ranks, 1)
        cv = float(c.std() / mean) if mean > 0 else 0.0
        self._cv_last = cv
        self._cv_max = max(self._cv_max, cv)
        if self.num_ranks <= 1 or total <= 0:
            # a 1-rank mesh and a drained frontier skip in every mode
            return self._commit("skip", forced=True)
        if not self.adaptive:
            return self._commit(self.base)
        pool = float(np.minimum(np.maximum(c - self.k, 0), self.t_slots).sum())
        need = float(np.maximum(self.k - c, 0).sum())
        worth = min(pool, need)
        if cv < self.dead_band or worth < max(1, self.k // 2):
            return self._commit("skip")
        starved = float(c.min()) <= self.starve_frac * mean
        if starved or cv >= self.escalate_cv:
            due = self._last != "steal" or (
                self.probe_every > 0 and self._steal_streak % self.probe_every == 0
            )
            if alive_probe is not None and due:
                alive = np.asarray(alive_probe(), np.float64)
                self._probes += 1
                # donors whose rows are all incumbent-closed have nothing
                # worth routing: the next pop prunes them for free
                if float(alive[c > mean].sum()) < 1.0:
                    return self._commit(self.base)
            return self._commit("steal")
        return self._commit(self.base)

    def _commit(self, action: str, forced: bool = False) -> str:
        if not forced and action == "skip" and self._last != "skip":
            # flap damping: an active collective stands down only after
            # `settle` consecutive calm decisions
            self._calm += 1
            if self._calm < self.settle:
                action = self.base
        elif action == "skip":
            self._calm += 1
        else:
            self._calm = 0
        if action != self._last:
            self._switches += 1
        self._steal_streak = self._steal_streak + 1 if action == "steal" else 0
        self._last = action
        return action

    def degrade(self) -> str:
        """An injected ``balance.steal`` fault: fall back to the base action
        for this round (the search stays exact; balance only moves rows)."""
        self._degraded += 1
        return self._commit(self.base)

    def record(self, step: int, action: str, moved_per_rank) -> None:
        """Account one dispatch: the action that ran and the per-rank
        donated-row counts the balance steps reported."""
        moved = int(np.asarray(moved_per_rank).sum())
        self._actions[action] = self._actions.get(action, 0) + 1
        self._moved_rows += moved
        if len(self._rows) >= self.max_rows:
            # bounded trajectory: totals stay exact, per-round rows are capped
            self._rows.pop(0)
            self._rows_dropped += 1
        self._rows.append([int(step), action, round(self._cv_last, 4), moved])

    def participation(self, counts: np.ndarray) -> Dict[str, list]:
        """Donor/receiver rank sets implied by the counts (the
        ``bnb.balance`` span's event)."""
        c = np.asarray(counts, np.float64)
        mean = c.mean() if c.size else 0.0
        return {
            "donors": [int(r) for r in np.flatnonzero(c > mean)],
            "receivers": [int(r) for r in np.flatnonzero(c < mean)],
        }

    def count_action(self, action: str) -> None:
        """Registry counter, one per dispatch decision."""
        _REGISTRY.inc("bnb_balance_actions_total", action=action)

    def collective_dispatches(self) -> int:
        return sum(v for a, v in self._actions.items() if a != "skip")

    def summary(self) -> dict:
        """The ``obs.balance`` block: configuration, decision mix, moved
        rows and bytes, and the bounded per-round decision/CV trajectory."""
        return {
            "mode": "adaptive" if self.adaptive else self.base,
            "base": self.base,
            "ranks": self.num_ranks,
            "k": self.k,
            "t_slots": self.t_slots,
            "dead_band": self.dead_band,
            "escalate_cv": self.escalate_cv,
            "starve_frac": self.starve_frac,
            "settle": self.settle,
            "actions": dict(self._actions),
            "collective_dispatches": self.collective_dispatches(),
            "switches": self._switches,
            "steal_degraded": self._degraded,
            "alive_probes": self._probes,
            "moved_rows_total": self._moved_rows,
            "moved_bytes_total": self._moved_rows * self.row_bytes,
            "cv_last": round(self._cv_last, 4),
            "cv_max": round(self._cv_max, 4),
            "rows": [list(r) for r in self._rows],
            "rows_dropped": self._rows_dropped,
        }

"""Held-Karp 1-tree lower bound: the device ascent and the host float64 half.

Counterpart of ``tsp_mpi_reduction_tpu/ops/one_tree.py``. The host half
(``*_np``, plain numpy) is what the branch-and-bound setup runs by default
(``ascent="host"``); :func:`held_karp_potentials` is the same ascent in
torch ops on the solve's device (``ascent="device"``, float32 there), with
the JAX package's float adds and first-index ties, and no host read
inside its loop. For node potentials pi the reduced costs
``dbar[i,j] = d[i,j] + pi[i] + pi[j]`` give, for every tour,
``tour_d = tour_dbar - 2*sum(pi)``, and every tour is a 1-tree, so

    w(pi) = onetree(dbar) - 2*sum(pi)  <=  optimal tour cost.

``held_karp_potentials_np`` maximises ``w`` by subgradient ascent; the
branch-and-bound setup (``models/branch_bound._bound_setup``) quantises
the potentials and re-evaluates the root bound with ``one_tree_value_np``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INF = float("inf")


def mst_cost_degrees(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prim's MST of a dense symmetric ``[m, m]`` matrix (+inf on the
    diagonal and on forbidden edges), rooted at vertex 0 -> (0-d cost in
    ``d``'s dtype, int32 degrees ``[m]``); ties to the first index, the
    cost accumulated in step order (``one_tree.py:32-64``)."""
    m = d.shape[0]
    ar = torch.arange(m, device=d.device)
    in_tree = ar == 0
    mindist = d[0]
    closest = torch.zeros(m, dtype=torch.int64, device=d.device)
    deg = torch.zeros(m, dtype=torch.int32, device=d.device)
    cost = torch.zeros((), dtype=d.dtype, device=d.device)
    for _ in range(m - 1):
        cand = torch.where(in_tree, INF, mindist)
        u = cand.argmin()
        deg = deg + (ar == u).to(torch.int32) + (ar == closest[u]).to(torch.int32)
        in_tree = in_tree | (ar == u)
        du = d[u]
        better = ~in_tree & (du < mindist)
        mindist = torch.where(better, du, mindist)
        closest = torch.where(better, u, closest)
        cost = cost + cand[u]
    return cost, deg


def one_tree_cost_degrees(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-tree value and degrees: the MST over vertices 1..n-1 plus the two
    cheapest edges at vertex 0 (``lax.top_k``'s order: ascending value,
    lower index first on ties). ``d`` ``[n, n]`` with an inf diagonal."""
    n = d.shape[0]
    mst_cost, mst_deg = mst_cost_degrees(d[1:, 1:])
    row = d[0, 1:]
    i1 = row.argmin()
    i2 = torch.where(torch.arange(n - 1, device=d.device) == i1, INF, row).argmin()
    ar = torch.arange(n, device=d.device)
    deg = torch.cat([torch.full((1,), 2, dtype=torch.int32, device=d.device), mst_deg])
    deg = deg + (ar == i1 + 1).to(torch.int32) + (ar == i2 + 1).to(torch.int32)
    return mst_cost + (row[i1] + row[i2]), deg


def held_karp_potentials(d: torch.Tensor, steps: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subgradient ascent on the 1-tree bound on ``d``'s device and dtype
    -> (pi, best_bound), the twin of :func:`held_karp_potentials_np`: step
    ``t0 * decay^i`` with ``t0 = max(w0, 1) / (2n)`` and a decay that
    shrinks the step by 1e-3 over the horizon; the best (pi, w) seen is
    kept. Every step stays on the device: no host read in the loop."""
    n = d.shape[0]
    if n < 3:
        raise ValueError(f"1-tree bound needs n >= 3 cities, got {n}")
    d = torch.where(torch.eye(n, dtype=torch.bool, device=d.device), INF, d)
    pi = torch.zeros(n, dtype=d.dtype, device=d.device)
    best_pi = pi
    best_w = torch.tensor(-INF, dtype=d.dtype, device=d.device)
    w0, _ = one_tree_cost_degrees(d)
    t0 = torch.clamp(w0, min=1.0) / (2.0 * n)
    decay = torch.tensor(1e-3, dtype=d.dtype, device=d.device) ** (1.0 / max(steps, 1))
    for i in range(steps):
        w, deg = one_tree_cost_degrees(d + (pi[:, None] + pi[None, :]))
        w = w - 2.0 * pi.sum()
        best_pi = torch.where(w > best_w, pi, best_pi)
        best_w = torch.maximum(best_w, w)
        pi = pi + (t0 * decay**i) * (deg - 2).to(d.dtype)
    return best_pi, best_w


def one_tree_np(d64, pi64):
    """Float64 1-tree -> (w(pi), degrees): Prim over vertices 1..n-1 plus
    the two cheapest edges at vertex 0, minus ``2*sum(pi)``."""
    d64 = np.asarray(d64, np.float64)
    pi64 = np.asarray(pi64, np.float64)
    n = d64.shape[0]
    dbar = d64 + pi64[:, None] + pi64[None, :]
    np.fill_diagonal(dbar, np.inf)
    sub = dbar[1:, 1:]
    m = n - 1
    in_tree = np.zeros(m, bool)
    in_tree[0] = True
    mindist = sub[0].copy()
    closest = np.zeros(m, np.int64)
    deg = np.zeros(n, np.int64)
    cost = 0.0
    for _ in range(m - 1):
        cand = np.where(in_tree, np.inf, mindist)
        u = int(np.argmin(cand))
        cost += cand[u]
        deg[u + 1] += 1
        deg[closest[u] + 1] += 1
        in_tree[u] = True
        better = ~in_tree & (sub[u] < mindist)
        mindist = np.where(better, sub[u], mindist)
        closest = np.where(better, u, closest)
    ends = np.argsort(dbar[0, 1:], kind="stable")[:2]
    e0 = dbar[0, 1:][ends].sum()
    deg[0] += 2
    deg[ends + 1] += 1
    return float(cost + e0 - 2.0 * pi64.sum()), deg


def held_karp_potentials_np(d64, steps: int = 400):
    """Float64 subgradient ascent -> (pi, best_w).

    Step ``t_k = t0 * decay^k`` with ``t0 = max(w0, 1) / (2n)`` and a decay
    that shrinks the step by 1e-3 over the whole horizon; keeps the best
    (pi, w) seen, since ``w`` is not monotone along the ascent.
    """
    d64 = np.asarray(d64, np.float64)
    n = d64.shape[0]
    if n < 3:
        raise ValueError(f"1-tree bound needs n >= 3 cities, got {n}")
    pi = np.zeros(n)
    w0, _ = one_tree_np(d64, pi)
    t0 = max(w0, 1.0) / (2.0 * n)
    decay = 1e-3 ** (1.0 / max(steps, 1))
    best_pi, best_w = pi.copy(), -np.inf
    t = t0
    for _ in range(steps):
        w, deg = one_tree_np(d64, pi)
        if w > best_w:
            best_w = w
            best_pi = pi.copy()
        pi = pi + t * (deg - 2)
        t *= decay
    return best_pi, best_w


def one_tree_value_np(d64, pi64) -> float:
    """Float64 re-evaluation of ``w(pi)`` for given potentials: the
    certified root bound (Prim's O(n^2) over vertices 1..n-1)."""
    d64 = np.asarray(d64, np.float64)
    pi64 = np.asarray(pi64, np.float64)
    n = d64.shape[0]
    dbar = d64 + pi64[:, None] + pi64[None, :]
    np.fill_diagonal(dbar, np.inf)
    sub = dbar[1:, 1:]
    m = n - 1
    in_tree = np.zeros(m, bool)
    in_tree[0] = True
    mindist = sub[0].copy()
    cost = 0.0
    for _ in range(m - 1):
        cand = np.where(in_tree, np.inf, mindist)
        u = int(np.argmin(cand))
        cost += cand[u]
        in_tree[u] = True
        mindist = np.minimum(mindist, sub[u])
    e0 = np.sort(dbar[0, 1:])[:2].sum()
    return float(cost + e0 - 2.0 * pi64.sum())

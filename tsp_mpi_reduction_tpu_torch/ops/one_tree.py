"""Held-Karp 1-tree lower bound, host float64 half.

Counterpart of ``tsp_mpi_reduction_tpu/ops/one_tree.py:120-217``: plain
numpy, the functions the branch-and-bound setup runs by default
(``ascent="host"``). For node potentials pi the reduced costs
``dbar[i,j] = d[i,j] + pi[i] + pi[j]`` give, for every tour,
``tour_d = tour_dbar - 2*sum(pi)``, and every tour is a 1-tree, so

    w(pi) = onetree(dbar) - 2*sum(pi)  <=  optimal tour cost.

``held_karp_potentials_np`` maximises ``w`` by subgradient ascent; the
branch-and-bound setup (``models/branch_bound._bound_setup``) quantises
the potentials and re-evaluates the root bound with ``one_tree_value_np``.
"""

from __future__ import annotations

import numpy as np


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

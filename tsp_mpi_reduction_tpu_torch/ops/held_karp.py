"""Batched exact Held-Karp DP over blocks.

Counterpart of ``tsp_mpi_reduction_tpu/ops/held_karp.py``. The reference
solves each block with a ``std::map`` keyed by (visited mask, endpoint)
(tsp.cpp:405-508); here the table is a dense tensor indexed by mask, masks
are processed by popcount (a mask depends only on masks with one bit
fewer), and the blocks are a batch dimension.

Two layouts, four impls (same names as the JAX package):

- ``compact`` — masks compacted by popcount: gather the predecessor costs,
  relax with min/argmin in plain PyTorch, scatter; parent pointers stored;
- ``pallas`` — compact layout with the relaxation in the CUDA kernel
  ``relax_minplus``;
- ``dense`` — the full ``[B, m, 2^m]`` table updated by plain PyTorch each
  step (predecessor lookup as a reshape+flip); parents recomputed in the
  backtrack;
- ``fused`` — dense layout with the CUDA kernel ``relax_dense_sweep``
  running every cardinality in one tiled sweep, in place;
- ``auto`` — ``fused`` on CUDA (a hand kernel always), ``compact`` on the
  CPU. ``jnp`` is accepted as an alias of ``compact``.

On a CPU tensor the kernel impls run the kernels' plain versions.

Semantics for oracle parity: ties go to the smallest predecessor city (the
reference's strict ``<`` over ascending ``m``, tsp.cpp:457-471), which is
``argmin``'s first-occurrence rule; float64 additions occur in the oracle's
dependency order, so costs are bit-exact.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .distance import distance_matrix
from .held_karp_kernels import relax_dense_reference, relax_dense_sweep, relax_minplus, relax_minplus_reference


@dataclass(frozen=True)
class HeldKarpPlan:
    """Static schedule for one block size ``n`` (host numpy, as in JAX):

      scatter_idx  [S, maxNc]     row to write per mask lane (scratch if pad)
      prev_idx     [S, maxNc, M]  row of the predecessor state per (mask, m)
      member       [S, maxNc, M]  whether city m is in the mask

    where S = n-2 cardinality steps, M = n-1, maxNc = max_c C(M, c).
    """

    n: int
    scatter_idx: np.ndarray
    prev_idx: np.ndarray
    member: np.ndarray
    dp_states: int  # number of (mask, endpoint) states computed
    dp_transitions: int  # number of candidate relaxations


#: Largest supported block size. The reference refuses n > 16
#: (tsp.cpp:289-295); beyond 18 the 2^n tables reach many GB.
MAX_BLOCK_CITIES = 18

_IMPL = "auto"
_IMPLS = ("auto", "compact", "dense", "fused", "jnp", "pallas")


def set_impl(impl: str) -> None:
    """Select the DP impl: auto, compact, dense, fused, pallas (jnp = compact)."""
    global _IMPL
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    _IMPL = "compact" if impl == "jnp" else impl


@contextlib.contextmanager
def use_impl(impl: str):
    """Scoped :func:`set_impl`: restores the previous selection on exit."""
    global _IMPL
    prev = _IMPL
    set_impl(impl)
    try:
        yield
    finally:
        _IMPL = prev


def effective_impl(device) -> str:
    """The impl a solve on ``device`` runs: ``auto`` is ``fused`` on CUDA."""
    if _IMPL != "auto":
        return _IMPL
    return "fused" if torch.device(device).type == "cuda" else "compact"


@functools.lru_cache(maxsize=None)
def build_plan(n: int) -> HeldKarpPlan:
    if not 3 <= n <= MAX_BLOCK_CITIES:
        raise ValueError(
            f"Held-Karp block size must be in [3, {MAX_BLOCK_CITIES}], got {n}"
        )
    m = n - 1
    scratch = 1 << m
    by_card: dict[int, list[int]] = {c: [] for c in range(1, m)}
    for mask in range(1, 1 << m):
        c = bin(mask).count("1")
        if c < m:
            by_card[c].append(mask)
    max_nc = max(len(v) for v in by_card.values()) if by_card else 1

    steps = m - 1
    scatter_idx = np.full((steps, max_nc), scratch, dtype=np.int32)
    prev_idx = np.full((steps, max_nc, m), scratch, dtype=np.int32)
    member = np.zeros((steps, max_nc, m), dtype=bool)
    states = transitions = 0
    for s, c in enumerate(range(1, m)):
        masks = by_card[c]
        for j, mask in enumerate(masks):
            scatter_idx[s, j] = mask
            for bit in range(m):
                if mask & (1 << bit):
                    prev_idx[s, j, bit] = mask ^ (1 << bit)
                    member[s, j, bit] = True
        states += len(masks) * (m - c)
        transitions += len(masks) * (m - c) * c
    # closing pass: m states, one relaxation each (tsp.cpp:483-499)
    states += m
    transitions += m
    return HeldKarpPlan(n, scatter_idx, prev_idx, member, states, transitions)


@functools.lru_cache(maxsize=None)
def _plan_tensors(n: int, device: str):
    from ..utils.state import plan_to_torch

    return plan_to_torch(build_plan(n), device)


def _close_rows(m: int, device) -> torch.Tensor:
    """Masks ``FULL \\ {b}`` of the tour-closing states, b = 0..m-1."""
    full = (1 << m) - 1
    return torch.tensor([full ^ (1 << b) for b in range(m)], device=device)


def _assemble_tour(ends: list) -> torch.Tensor:
    """Endpoints newest->oldest (``m`` tensors ``[B]``) -> closed tours
    ``[B, n+1]`` int32 ``[0, .., 0]``; ``+1`` turns a DP endpoint into a
    city number (city 0 anchors the tour, tsp.cpp:501-505)."""
    body = torch.stack(ends[::-1], dim=1).to(torch.int32) + 1
    zero = torch.zeros((body.shape[0], 1), dtype=torch.int32, device=body.device)
    return torch.cat([zero, body, zero], dim=1)


def _solve_one(d: torch.Tensor, n: int, use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact-layout solve of ``[B, n, n]`` blocks -> (costs [B], tours [B, n+1])."""
    scatter_idx, prev_idx, member = _plan_tensors(n, str(d.device))
    bsz, dtype, dev = d.shape[0], d.dtype, d.device
    m = n - 1
    scratch = 1 << m
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    d_t = d[:, 1:, 1:].transpose(1, 2).contiguous()  # d_t[b, k, m'] = d(m'+1, k+1)
    cost = torch.full((bsz, scratch + 1, m), float("inf"), dtype=dtype, device=dev)
    cost[:, 0] = d[:, 0, 1:]  # state (visited = {}, endpoint i)
    parent = torch.full((bsz, scratch + 1, m), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(m, device=dev)
    relax = relax_minplus if use_kernel else relax_minplus_reference

    for s in range(m - 1):
        # g[b, j, m'] = cost of predecessor state (mask \ {m'}, m')
        g = torch.where(member[s], cost[:, prev_idx[s], cols], inf)
        new_cost, new_parent = relax(g, d_t)
        # padded lanes all land on the scratch row, which is only ever
        # read where ``member`` is False
        cost[:, scatter_idx[s]] = new_cost
        parent[:, scatter_idx[s]] = new_parent

    bidx = torch.arange(bsz, device=dev)
    totals = cost[:, _close_rows(m, dev), cols] + d[:, 1:, 0]
    best = totals.argmin(dim=1)
    final_cost = totals[bidx, best]

    full = (1 << m) - 1
    mask, end = full ^ (1 << best), best
    ends = [end]
    for _ in range(m - 1):
        p = parent[bidx, mask, end].long()
        mask, end = mask & ~(1 << p), p
        ends.append(end)
    return final_cost, _assemble_tour(ends)


def _backtrack_recompute(
    cost: torch.Tensor, d_sub: torch.Tensor, m: int, best: torch.Tensor
) -> torch.Tensor:
    """Tours from the finished ``[B, m, 2^m]`` table.

    The parent of state (mask, e) is re-derived as ``argmin over b in mask
    of cost[b, mask ^ (1<<b)] + d_sub[b, e]`` — the same finalized values
    and first-occurrence tie-break as the forward step, so the tour equals
    the stored-parent one.
    """
    bsz, dev = cost.shape[0], cost.device
    inf = torch.tensor(float("inf"), dtype=cost.dtype, device=dev)
    bidx = torch.arange(bsz, device=dev)[:, None]
    bvec = torch.arange(m, device=dev)[None, :]
    full = (1 << m) - 1
    mask, e = full ^ (1 << best), best
    ends = [e]
    for _ in range(m - 1):
        vals = cost[bidx, bvec, mask[:, None] ^ (1 << bvec)] + d_sub[bidx, bvec, e[:, None]]
        cand = torch.where(((mask[:, None] >> bvec) & 1) == 1, vals, inf)
        p = cand.argmin(dim=1)
        mask, e = mask & ~(1 << p), p
        ends.append(e)
    return _assemble_tour(ends)


def _solve_one_dense(d: torch.Tensor, n: int, use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-layout solve: the whole ``[B, m, 2^m]`` table, no parent table."""
    bsz, dtype, dev = d.shape[0], d.dtype, d.device
    m = n - 1
    d_sub = d[:, 1:, 1:].contiguous()
    cost = torch.full((bsz, m, 1 << m), float("inf"), dtype=dtype, device=dev)
    cost[:, :, 0] = d[:, 0, 1:]
    if use_kernel:
        relax_dense_sweep(cost, d_sub)
    else:
        for c in range(1, m):
            cost = relax_dense_reference(cost, d_sub, c)

    cols = torch.arange(m, device=dev)
    totals = cost[:, cols, _close_rows(m, dev)] + d[:, 1:, 0]
    best = totals.argmin(dim=1)
    final_cost = totals[torch.arange(bsz, device=dev), best]
    return final_cost, _backtrack_recompute(cost, d_sub, m, best)


def solve_blocks_from_dists(
    dists: torch.Tensor, dtype: torch.dtype = torch.float64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly solve ``[B, n, n]`` distance matrices on their device.

    For bit-exact oracle parity pass host-computed float64 matrices
    (:func:`..distance.distance_matrix_np`). Returns costs ``[B]`` and
    closed tours ``[B, n+1]`` int32 of block-local indices
    (``tour[0] == tour[-1] == 0``, tsp.cpp:501-505).
    """
    if dists.ndim != 3 or dists.shape[1] != dists.shape[2]:
        raise ValueError(f"expected [B, n, n] distance matrices, got {tuple(dists.shape)}")
    n = int(dists.shape[1])
    if not 3 <= n <= MAX_BLOCK_CITIES:
        raise ValueError(
            f"Held-Karp block size must be in [3, {MAX_BLOCK_CITIES}], got {n}"
        )
    d = dists.to(dtype)
    impl = effective_impl(d.device)
    if impl in ("dense", "fused"):
        return _solve_one_dense(d, n, use_kernel=impl == "fused")
    return _solve_one(d, n, use_kernel=impl == "pallas")


def solve_blocks(xy: torch.Tensor, dtype: torch.dtype = torch.float64):
    """Exactly solve ``[B, n, 2]`` coordinates; distances on the device."""
    if xy.ndim != 3 or xy.shape[-1] != 2:
        raise ValueError(f"expected [B, n, 2] coords, got {tuple(xy.shape)}")
    return solve_blocks_from_dists(distance_matrix(xy.to(dtype)), dtype)


def warm_blocks(n: int, batch: int, dtype=torch.float32, device="cuda") -> float:
    """Warm the block solver for one ``[batch, n, n]`` shape before traffic
    arrives -> the wall seconds spent (``held_karp.py:438-457`` of the JAX
    package, which AOT-compiles the shape). There is no XLA compile here,
    so on a CUDA device it loads the kernel library (``nvcc`` on a cold
    build directory) and runs one throwaway solve of that shape: the first
    real flush then pays neither the build nor the first launch."""
    from ..utils.backend import parse_dtype, synchronize

    dtype = parse_dtype(dtype)
    device = torch.device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        from ..kernels import _build

        _build.library()
    eye = torch.ones((n, n), dtype=dtype, device=device) - torch.eye(n, dtype=dtype, device=device)
    solve_blocks_from_dists(eye.expand(batch, n, n).contiguous(), dtype)
    synchronize(device)
    return time.perf_counter() - t0

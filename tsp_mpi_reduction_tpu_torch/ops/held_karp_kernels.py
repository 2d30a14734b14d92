"""The Held-Karp min-plus relaxation: CUDA kernels and their plain versions.

Counterpart of ``tsp_mpi_reduction_tpu/ops/held_karp_pallas.py``. Each
wrapper launches its hand-written kernel (``kernels/csrc/held_karp_relax.cu``)
on a CUDA tensor and raises on anything the kernel does not take; a tensor
on the CPU goes to the plain PyTorch version beside it. There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are
not counted), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..kernels import _build

MAX_M = 17  # n - 1 for MAX_BLOCK_CITIES = 18; the kernels' register arrays
_MAX_GRID_Y = 65535  # blocks ride gridDim.y

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"relax_minplus": 0, "relax_dense": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64 only, got {dtype}")


# ---------------------------------------------------------------------------
# Compact layout: one cardinality step over gathered predecessor costs.
# ---------------------------------------------------------------------------


def relax_minplus_reference(
    g: torch.Tensor, d_t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: broadcast add, then min and first-index argmin.

    ``g`` ``[..., J, M]``, ``d_t`` ``[..., M, M]`` -> cost ``[..., J, M]``
    and int32 parent ``[..., J, M]`` (column k: min/argmin over m' of
    ``g[j, m'] + d_t[k, m']``). The jnp ``relax_reference`` it mirrors is
    ``held_karp_pallas.py:94-97``.
    """
    cand = g[..., :, None, :] + d_t[..., None, :, :]
    return cand.amin(dim=-1), cand.argmin(dim=-1).to(torch.int32)


def relax_minplus(g: torch.Tensor, d_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compact Held-Karp step for a batch of blocks.

    ``g`` ``[B, J, M]`` gathered predecessor costs (+inf where the
    predecessor is not in the mask), ``d_t`` ``[B, M, M]`` with
    ``d_t[b, k, m'] = d(m'+1, k+1)``. Returns cost ``[B, J, M]`` and int32
    parent ``[B, J, M]``; ties go to the first m', an all-inf row gives inf
    and parent 0. Replaces ``held_karp_pallas.relax_minplus``.
    """
    if g.device.type == "cpu":
        return relax_minplus_reference(g, d_t)
    _check_cuda("relax_minplus", g.dtype, g, d_t)
    if g.ndim != 3 or d_t.shape != (g.shape[0], g.shape[2], g.shape[2]):
        raise ValueError(f"relax_minplus: g {tuple(g.shape)} / d_t {tuple(d_t.shape)}")
    if d_t.dtype != g.dtype:
        raise ValueError("relax_minplus: g and d_t must share a dtype")
    b, j, m = g.shape
    if not 1 <= m <= MAX_M or b > _MAX_GRID_Y:
        raise ValueError(f"relax_minplus: need 1 <= M <= {MAX_M}, B <= {_MAX_GRID_Y}")
    cost = torch.empty_like(g)
    parent = torch.empty(g.shape, dtype=torch.int32, device=g.device)
    if b and j:
        lib = _build.library()
        code = lib.hk_relax_minplus(
            g.data_ptr(), d_t.data_ptr(), cost.data_ptr(), parent.data_ptr(),
            b, j, m, int(g.dtype == torch.float64),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
        _build.check(code, "relax_minplus")
        LAUNCHES["relax_minplus"] += 1
    return cost, parent


# ---------------------------------------------------------------------------
# Dense layout: the [B, m, 2^m] table, one step per cardinality c.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense_tables(m: int, device: str):
    """Popcount ``[S]`` and bit membership ``[m, S]`` of every mask."""
    masks = torch.arange(1 << m, device=device)
    bit_in = torch.stack([((masks >> b) & 1).bool() for b in range(m)])
    return bit_in.sum(dim=0), bit_in


@functools.lru_cache(maxsize=None)
def masks_by_popcount(m: int, device: str):
    """All masks over m bits as int32, grouped by popcount in ascending
    order, and ``offsets[c]`` where popcount c starts (``offsets[m+1]`` is
    the end) — the dense kernel's index list of one cardinality."""
    by_c = [[] for _ in range(m + 1)]
    for mask in range(1 << m):
        by_c[bin(mask).count("1")].append(mask)
    flat, offsets = [], [0]
    for group in by_c:
        flat.extend(group)
        offsets.append(len(flat))
    return torch.tensor(flat, dtype=torch.int32, device=device), tuple(offsets)


def _bitswap(rows: torch.Tensor, b: int) -> torch.Tensor:
    """``out[..., mask] = rows[..., mask ^ (1 << b)]`` as a reshape+flip."""
    s = rows.shape[-1]
    lead = rows.shape[:-1]
    return rows.reshape(*lead, s >> (b + 1), 2, 1 << b).flip(-2).reshape(*lead, s)


def relax_dense_reference(cost: torch.Tensor, d_sub: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of one dense step (the jnp form at held_karp.py:355-359).

    ``cost`` ``[B, m, 2^m]``, ``d_sub`` ``[B, m, m]`` with
    ``d_sub[b, i, k] = d(i+1, k+1)``. Returns a new table where every
    popcount-``c`` mask and endpoint k outside it holds
    ``min_{i in mask} cost[i, mask ^ (1<<i)] + d_sub[i, k]``; every other
    entry is copied. Loops over k so the temporary stays ``[B, m, 2^m]``.
    """
    bsz, m, s = cost.shape
    popc, bit_in = _dense_tables(m, str(cost.device))
    inf = torch.tensor(float("inf"), dtype=cost.dtype, device=cost.device)
    g = torch.stack([_bitswap(cost[:, b], b) for b in range(m)], dim=1)
    gm = torch.where(bit_in, g, inf)  # predecessor i must be in the mask
    del g
    new = torch.empty_like(cost)
    for k in range(m):
        new[:, k] = (gm + d_sub[:, :, k, None]).amin(dim=1)
    upd = (popc == c)[None, :] & ~bit_in  # popcount-c masks, k outside
    return torch.where(upd, new, cost)


def relax_dense(cost: torch.Tensor, d_sub: torch.Tensor, c: int) -> torch.Tensor:
    """One dense Held-Karp step at cardinality ``c`` for a batch of blocks.

    Updates ``cost`` ``[B, m, 2^m]`` IN PLACE (race-free: the step reads
    only popcount c-1 masks and writes only popcount c masks) and returns
    it. ``d_sub`` ``[B, m, m]``. No parents are kept; the backtrack
    recomputes them. Replaces ``held_karp_pallas.relax_dense``.
    """
    if cost.device.type == "cpu":
        return cost.copy_(relax_dense_reference(cost, d_sub, c))
    _check_cuda("relax_dense", cost.dtype, cost, d_sub)
    if cost.ndim != 3 or d_sub.shape != (cost.shape[0], cost.shape[1], cost.shape[1]):
        raise ValueError(f"relax_dense: cost {tuple(cost.shape)} / d_sub {tuple(d_sub.shape)}")
    if d_sub.dtype != cost.dtype:
        raise ValueError("relax_dense: cost and d_sub must share a dtype")
    b, m, s = cost.shape
    if not 1 <= m <= MAX_M or s != 1 << m or b > _MAX_GRID_Y:
        raise ValueError(f"relax_dense: need S = 2^m, m <= {MAX_M}, B <= {_MAX_GRID_Y}")
    if not 1 <= c < m:
        raise ValueError(f"relax_dense: cardinality {c} outside [1, {m - 1}]")
    masks, offsets = masks_by_popcount(m, str(cost.device))
    count = offsets[c + 1] - offsets[c]
    if b:
        lib = _build.library()
        code = lib.hk_relax_dense(
            cost.data_ptr(), d_sub.data_ptr(), masks[offsets[c]:].data_ptr(),
            count, b, m, int(cost.dtype == torch.float64),
            torch.cuda.current_stream(cost.device).cuda_stream,
        )
        _build.check(code, "relax_dense")
        LAUNCHES["relax_dense"] += 1
    return cost

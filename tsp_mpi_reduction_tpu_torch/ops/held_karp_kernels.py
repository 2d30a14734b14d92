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
from ..obs import costs as _costs

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
        dt = str(g.dtype).removeprefix("torch.")
        _costs.record_launch("relax_minplus", (f"B{b}", f"J{j}", f"M{m}", dt),
                             lambda: _minplus_costs(b, j, m, g.element_size(), dt), g.device)
    return cost, parent


def _minplus_costs(b: int, j: int, m: int, elt: int, dt: str) -> dict:
    """The raw ``obs.costs`` record of one ``relax_minplus`` launch."""
    nbytes, ops = _costs.relax_minplus_counts(b, j, m, elt)
    return {"flops": ops, "bytes_accessed": nbytes,
            "argument_bytes": elt * b * (j * m + m * m), "output_bytes": (elt + 4) * b * j * m,
            "dtype": dt, "shape": {"B": b, "J": j, "M": m}}


#: the relax_minplus kernel's schedule: at most 256 threads a block, P =
#: 256 // M rows a pass, NT = P * M threads, 16 passes (outputs a thread) a
#: tile of P * 16 rows
MINPLUS_MAX_THREADS = 256
MINPLUS_PASSES = 16


def minplus_tile_rows(m: int) -> int:
    """The rows of one relax_minplus tile (one CUDA block) for M = m."""
    return (MINPLUS_MAX_THREADS // m) * MINPLUS_PASSES


def minplus_copy_split(count: int, sh: int, v: int) -> Tuple[int, int, int]:
    """How the kernel copies a tile's run of ``count`` elements whose first
    lies ``sh`` elements past a 16-byte boundary, with vectors of ``v``
    elements: ``head`` scalars, ``nvec`` vectors, then scalars from
    ``tail`` to ``count``."""
    head = min((v - sh) % v, count)
    nvec = (count - head) // v
    return head, nvec, head + nvec * v


# the kernel's tile schedule mirrored on the CPU for its tests, on no device path
def relax_minplus_tiles_reference(g: torch.Tensor, d_t: torch.Tensor,  # graftlint: disable=R1
                                  sh0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of the relax_minplus kernel's schedule (tests only).

    Returns what :func:`relax_minplus_reference` returns, computed the way
    the kernel is: block b's ``[J, M]`` slab cut into tiles of
    :func:`minplus_tile_rows` rows; each tile's contiguous run copied in
    head scalars, 16-byte vectors and tail scalars (:func:`minplus_copy_split`,
    the run's offset from a 16-byte boundary taken from ``sh0``, that of
    ``g``'s first element, plus the run's start), every element exactly
    once; then thread t of NT computes output o = t + s*NT, row t // M +
    s*P and column k = t % M, for each pass s, as M adds and a strict-<
    scan over ascending m'.
    """
    bsz, j, m = g.shape
    p = MINPLUS_MAX_THREADS // m
    nt, tj = p * m, minplus_tile_rows(m)
    v = 16 // g.element_size()
    flat = g.reshape(bsz, j * m)
    cost = torch.empty_like(flat)
    parent = torch.empty(flat.shape, dtype=torch.int32, device=g.device)
    t = torch.arange(nt, device=g.device)
    ks, r0 = t % m, t // m
    for b in range(bsz):
        dk = d_t[b, ks]  # [NT, M]: each thread's distance row
        for j0 in range(0, j, tj):
            rows = min(tj, j - j0)
            count = rows * m
            e0 = j0 * m
            sh = (sh0 + b * j * m + e0) % v
            head, _, tail = minplus_copy_split(count, sh, v)
            # NaN where the copy missed an element: it would reach the result
            gs = torch.full((tj * m + v,), float("nan"), dtype=g.dtype, device=g.device)
            gs[sh:sh + head] = flat[b, e0:e0 + head]
            gs[sh + head:sh + tail] = flat[b, e0 + head:e0 + tail]  # the 16-byte vectors
            gs[sh + tail:sh + count] = flat[b, e0 + tail:e0 + count]
            for s in range(MINPLUS_PASSES):
                r = r0 + s * p
                ok = r < rows
                gr = gs[sh + (r[ok] * m)[:, None] + torch.arange(m, device=g.device)[None, :]]
                best = gr[:, 0] + dk[ok, 0]
                arg = torch.zeros_like(best, dtype=torch.int32)
                for i in range(1, m):
                    val = gr[:, i] + dk[ok, i]
                    lt = val < best
                    best = torch.where(lt, val, best)
                    arg = torch.where(lt, torch.tensor(i, dtype=torch.int32), arg)
                o = e0 + t[ok] + s * nt
                cost[b, o] = best
                parent[b, o] = arg
    return cost.reshape(g.shape), parent.reshape(g.shape)


# ---------------------------------------------------------------------------
# Dense layout: the [B, m, 2^m] table; the plain version steps one
# cardinality c at a time, the kernel sweeps all of them in tiles.
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
    the end) — the sweep kernel's lists of high parts H (one launch per
    popcount) and of low parts L (one tile level per popcount)."""
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


# the kernel's tile schedule mirrored on the CPU for its tests, on no device path
def relax_dense_tiles_reference(  # graftlint: disable=R1
        cost: torch.Tensor, d_sub: torch.Tensor, l: int) -> torch.Tensor:
    """Plain mirror of the sweep kernel's tile schedule (tests only).

    Runs the whole DP the way ``relax_dense_sweep``'s kernel does and returns
    a new table equal to the per-level loop of :func:`relax_dense_reference`
    over c = 1 .. m-1. A mask splits into h = m - l high bits H and l low
    bits L (l = m when m is smaller); for p = popcount(H) = 0 .. h, every
    tile ``[m, 2^l]`` of that popcount takes the min over its high-bit
    predecessors (tiles of popcount p-1) in a pre-pass, the H = 0 tile
    loads the init row, then it sweeps popcount(L) = 1 .. l over its
    low-bit predecessors, and writes its valid states (k outside M, M not
    empty).
    """
    bsz, m, s = cost.shape
    l = min(l, m)
    h = m - l
    dev = cost.device
    out = cost.clone()
    lows = torch.arange(1 << l, device=dev)
    lpop = torch.stack([(lows >> b) & 1 for b in range(l)]).sum(dim=0)
    highs, hoff = masks_by_popcount(h, str(dev))
    ks = torch.arange(m, device=dev)
    for p in range(h + 1):
        hs = highs[hoff[p]:hoff[p + 1]].long()  # [T] tiles of this launch
        idx = (hs[:, None] << l) | lows[None, :]  # [T, 2^l] their masks M
        tile = torch.full((bsz, m, hs.shape[0], 1 << l), float("inf"), dtype=cost.dtype, device=dev)
        for j in range(h):  # high bit j is city l + j
            has = ((hs >> j) & 1).bool()[None, None, :, None]
            pred = out[:, l + j][:, idx ^ (1 << (l + j))]  # [B, T, 2^l]
            cand = pred[:, None] + d_sub[:, l + j, :, None, None]  # [B, m, T, 2^l]
            tile = torch.where(has, torch.minimum(tile, cand), tile)
        if p == 0:
            tile[:, :, 0, 0] = out[:, :, 0]  # the init row, M = 0
        for q in range(1, l + 1):
            lq = lows[lpop == q]  # [Q]
            for i in range(l):
                has = ((lq >> i) & 1).bool()[None, None, None, :]
                pred = tile[:, i][:, :, lq ^ (1 << i)]  # [B, T, Q]
                cand = pred[:, None] + d_sub[:, i, :, None, None]  # [B, m, T, Q]
                cur = tile[:, :, :, lq]
                tile[:, :, :, lq] = torch.where(has, torch.minimum(cur, cand), cur)
        valid = (((idx[None] >> ks[:, None, None]) & 1) == 0) & (idx[None] != 0)  # [m, T, 2^l]
        out[:, :, idx] = torch.where(valid, tile, out[:, :, idx])
    return out


#: the sweep kernel's low bits, in float32 and float64: a tile [m, 2^9] in
#: shared memory is 30 KB at m = 15 in float32 and 68 KB at m = 17 in
#: float64, so six (float32) or three (float64) blocks of 128 threads share
#: an SM; the fastest of l = 8, 9, 10 on the H100 at m = 15
SWEEP_LOW_BITS = 9


def sweep_low_bits(m: int) -> int:
    """The l the sweep kernel uses for an m-city table."""
    return min(SWEEP_LOW_BITS, m)


def sweep_launches(m: int) -> int:
    """Kernel launches of one :func:`relax_dense_sweep` on CUDA: one per
    popcount of the high bits, h + 1 with h = m - l (0 when m < 2)."""
    return m - sweep_low_bits(m) + 1 if m >= 2 else 0


def relax_dense_sweep(cost: torch.Tensor, d_sub: torch.Tensor) -> torch.Tensor:
    """The whole dense Held-Karp DP for a batch of blocks, in place.

    ``cost`` ``[B, m, 2^m]`` holds the init row ``cost[:, :, 0]`` (+inf
    elsewhere) and ends as the per-level loop of
    :func:`relax_dense_reference` over c = 1 .. m-1 leaves it; entries that
    are not states are left as they are. ``d_sub`` ``[B, m, m]``. Returns
    ``cost``. No parents are kept; the backtrack recomputes them. Replaces
    ``held_karp_pallas.relax_dense``, one call for all cardinalities.

    On CUDA it launches the tiled sweep kernel :func:`sweep_launches` times
    (l = :func:`sweep_low_bits`); a CPU tensor runs the per-level plain loop.
    """
    if cost.device.type == "cpu":
        for c in range(1, cost.shape[1]):
            cost.copy_(relax_dense_reference(cost, d_sub, c))
        return cost
    _check_cuda("relax_dense_sweep", cost.dtype, cost, d_sub)
    if cost.ndim != 3 or d_sub.shape != (cost.shape[0], cost.shape[1], cost.shape[1]):
        raise ValueError(f"relax_dense_sweep: cost {tuple(cost.shape)} / d_sub {tuple(d_sub.shape)}")
    if d_sub.dtype != cost.dtype or d_sub.device != cost.device:
        raise ValueError("relax_dense_sweep: cost and d_sub must share a dtype and a device")
    b, m, s = cost.shape
    if not 1 <= m <= MAX_M or s != 1 << m or b > _MAX_GRID_Y:
        raise ValueError(f"relax_dense_sweep: need S = 2^m, m <= {MAX_M}, B <= {_MAX_GRID_Y}")
    if m < 2 or not b:
        return cost
    l = sweep_low_bits(m)
    highs, hoff = masks_by_popcount(m - l, str(cost.device))
    lows, _ = masks_by_popcount(l, str(cost.device))
    lib = _build.library()
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    for p in range(m - l + 1):
        code = lib.hk_relax_dense_sweep(
            cost.data_ptr(), d_sub.data_ptr(), highs[hoff[p]:].data_ptr(), hoff[p + 1] - hoff[p],
            lows.data_ptr(), b, m, l, int(cost.dtype == torch.float64), stream,
        )
        _build.check(code, "relax_dense_sweep")
        LAUNCHES["relax_dense"] += 1
    dt = str(cost.dtype).removeprefix("torch.")
    _costs.record_launch("relax_dense_sweep", (f"B{b}", f"m{m}", dt),
                         lambda: _sweep_costs(b, m, cost.element_size(), dt), cost.device)
    return cost


def _sweep_costs(b: int, m: int, elt: int, dt: str) -> dict:
    """The raw ``obs.costs`` record of one whole sweep (its h + 1
    launches; the table is updated in place)."""
    nbytes, ops = _costs.relax_dense_counts(b, m, elt)
    table = elt * b * m * (1 << m)
    return {"flops": ops, "bytes_accessed": nbytes, "argument_bytes": table + elt * b * m * m,
            "output_bytes": table, "alias_bytes": table, "dtype": dt,
            "shape": {"B": b, "m": m, "launches": sweep_launches(m)}}

"""The fused branch-and-bound push: CUDA kernel and its plain version.

Counterpart of ``tsp_mpi_reduction_tpu/ops/expand_pallas.py``. An
expansion step pops k parent rows of the packed frontier and decides, for
each (parent p, child city c), whether the child is pushed and to which
frontier row ``dest[p, c]``. :func:`push_rows` builds each pushed child's
packed row from its parent row and stores it at that row, in place; the
``[k*n, C]`` candidate block the reference push materialises never exists.
A child row is the parent's path words with the byte at prefix position
``min(depth, n-1)`` set to c, the parent's mask words with bit c set,
``depth + 1``, and the bit patterns of ``ccost/cbound/csum[p, c]``.

:func:`push_rows` launches the hand-written kernel
(``kernels/csrc/push_rows.cu``) on CUDA tensors and raises on anything the
kernel does not take; CPU tensors go to :func:`push_rows_reference`. There
is no fallback from one to the other. ``LAUNCHES`` counts kernel launches
(plain-version calls are not counted).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import _build
from ..obs import costs as _costs

#: city ids packed per int32 path word (``branch_bound.PATH_PACK``)
PATH_PACK = 4

MAX_N = 200  # MAX_BNB_CITIES: a row of at most 61 words, two per thread of a warp

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"push_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def row_width(n: int) -> int:
    """Packed row width C = P + W + 4 for ``n`` cities."""
    return (n + PATH_PACK - 1) // PATH_PACK + (n + 31) // 32 + 4


def _set_bit_words(n: int) -> np.ndarray:
    """[n, W] int32 words: OR-ing row j into a visited mask visits city j."""
    w = (n + 31) // 32
    out = np.zeros((n, w), np.uint32)
    out[np.arange(n), np.arange(n) // 32] = np.uint32(1) << (np.arange(n) % 32).astype(np.uint32)
    return out.view(np.int32)


@functools.lru_cache(maxsize=None)
def _set_bit(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_set_bit_words(n), device=device)


def child_rows(parents: torch.Tensor, ccost: torch.Tensor, cbound: torch.Tensor,
               csum: torch.Tensor, n: int) -> torch.Tensor:
    """The ``[k, n, C]`` packed child rows of ``k`` parent rows, every child
    of every parent (the reference push's candidate block). The float
    columns enter as their int32 bit patterns."""
    k = parents.shape[0]
    dev = parents.device
    pw = (n + PATH_PACK - 1) // PATH_PACK
    w = (n + 31) // 32
    p_pathw = parents[:, :pw]
    p_mask = parents[:, pw : pw + w]
    p_depth = parents[:, pw + w]
    dpos = torch.clamp(p_depth, max=n - 1)
    wsel = (dpos // PATH_PACK)[:, None, None]
    shift = ((dpos % PATH_PACK) * 8)[:, None, None]
    cities = torch.arange(n, dtype=torch.int32, device=dev)
    pwb = p_pathw[:, None, :].expand(k, n, pw)
    widx = torch.arange(pw, dtype=torch.int32, device=dev)[None, None, :]
    # int32 shifts wrap, so ids >= 128 at shift 24 land on the sign bit as
    # the uint32 arithmetic of the kernel does
    neww = (pwb & ~(0xFF << shift)) | (cities[None, :, None] << shift)
    child_pathw = torch.where(widx == wsel, neww, pwb)
    child_mask = p_mask[:, None, :] | _set_bit(n, str(dev))[None, :, :]
    return torch.cat(
        [
            child_pathw,
            child_mask,
            (p_depth + 1)[:, None, None].expand(k, n, 1),
            ccost[:, :, None],
            cbound[:, :, None],
            csum[:, :, None],
        ],
        dim=2,
    )


def _check(nodes, parents, dest, ccost, cbound, csum, n: int) -> None:
    """Raise on what neither version takes: dtypes, shapes, row width."""
    if nodes.dtype != torch.int32 or parents.dtype != torch.int32 or dest.dtype != torch.int32:
        raise ValueError("push_rows: nodes, parents and dest must be int32")
    for t in (ccost, cbound, csum):
        if t.dtype != torch.float32:
            raise ValueError(f"push_rows: ccost/cbound/csum must be float32, got {t.dtype}")
    k = parents.shape[0]
    cols = row_width(n)
    if not 1 <= n <= MAX_N or nodes.dim() != 2 or nodes.shape[1] != cols:
        raise ValueError(f"push_rows: frontier row width {tuple(nodes.shape)[1:]} does not match "
                         f"n={n} (expected {cols}, 1 <= n <= {MAX_N})")
    if parents.shape != (k, cols) or any(t.shape != (k, n) for t in (dest, ccost, cbound, csum)):
        raise ValueError(f"push_rows: need parents [k, {cols}] and dest/ccost/cbound/csum [k, {n}]")


def push_rows_reference(nodes: torch.Tensor, parents: torch.Tensor, dest: torch.Tensor,
                        ccost: torch.Tensor, cbound: torch.Tensor, csum: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Plain version: build every child row (:func:`child_rows`) and store
    the ones whose ``dest`` lies in ``[0, F)``. Updates ``nodes`` in place
    and returns it."""
    _check(nodes, parents, dest, ccost, cbound, csum, n)
    cand = child_rows(parents, ccost.view(torch.int32), cbound.view(torch.int32),
                      csum.view(torch.int32), n).reshape(-1, nodes.shape[1])
    flat = dest.reshape(-1)
    sel = ((flat >= 0) & (flat < nodes.shape[0])).nonzero()[:, 0]
    nodes[flat[sel].long()] = cand[sel]
    return nodes


#: the push_rows kernel's schedule: PUSH_SPLIT warps a (parent, chunk of
#: 32 children), warp s storing the chunk's pushed children of rank s mod
#: PUSH_SPLIT; 8 warps a block
PUSH_SPLIT = 2
PUSH_WARPS_PER_BLOCK = 8


def push_blocks(k: int, n: int) -> int:
    """CUDA blocks of one push_rows launch: k * ceil(n/32) * PUSH_SPLIT
    warps, 8 a block."""
    return -(-k * ((n + 31) // 32) * PUSH_SPLIT // PUSH_WARPS_PER_BLOCK)


def push_rows_chunked_reference(nodes: torch.Tensor, parents: torch.Tensor, dest: torch.Tensor,
                                ccost: torch.Tensor, cbound: torch.Tensor, csum: torch.Tensor,
                                n: int) -> torch.Tensor:
    """Plain mirror of the push_rows kernel's schedule (tests only; CPU).

    Updates ``nodes`` in place as :func:`push_rows_reference` does, the way
    the kernel does: block by block (:func:`push_blocks`), warp gw of k *
    ceil(n/32) * PUSH_SPLIT takes task gw // PUSH_SPLIT, i.e. parent
    task // chunks and children chunk*32 .. +31, and of them the pushed
    ones of rank gw % PUSH_SPLIT mod PUSH_SPLIT; its lanes read the parent
    row (column l and l + 32) and their child's ``dest``, a warp with no
    child of its own leaves, its children's lanes read their three float
    columns, and the warp stores each of its children's rows in ascending
    lane order, built word by word in uint32 arithmetic.
    """
    _check(nodes, parents, dest, ccost, cbound, csum, n)
    f_rows, cols = nodes.shape
    k = parents.shape[0]
    out = nodes.numpy()
    par = parents.numpy().view(np.uint32)
    dst_all = dest.numpy()
    floats = [f.numpy().view(np.uint32) for f in (ccost, cbound, csum)]
    pw, w = (n + PATH_PACK - 1) // PATH_PACK, (n + 31) // 32
    dcol = pw + w
    chunks = (n + 31) // 32
    lanes = np.arange(32)
    j = np.arange(64)  # column lane (lo) and lane + 32 (hi)
    for blk in range(push_blocks(k, n)):
        for gw in range(blk * PUSH_WARPS_PER_BLOCK, (blk + 1) * PUSH_WARPS_PER_BLOCK):
            if gw >= k * chunks * PUSH_SPLIT:
                break
            task, part = divmod(gw, PUSH_SPLIT)
            p, c0 = task // chunks, (task % chunks) * 32
            c = c0 + lanes
            my_dst = np.where(c < n, dst_all[p, np.minimum(c, n - 1)], -1)
            pushed = (my_dst >= 0) & (my_dst < f_rows)
            rank = np.cumsum(pushed) - pushed  # pushed lanes below each lane
            pushed &= rank % PUSH_SPLIT == part
            if not pushed.any():
                continue
            row = np.where(j < cols, par[p, np.minimum(j, cols - 1)], np.uint32(0))  # lo | hi
            depth = int(row[dcol].view(np.int32))
            dpos = min(depth, n - 1)
            wsel = dpos >> 2 if dpos >= 0 else -1
            shift = np.uint32(8 * (dpos & 3))
            keep = ~(np.uint32(0xFF) << shift)
            src = np.flatnonzero(pushed)  # ascending lanes
            cu = (c0 + src).astype(np.uint32)[:, None]
            vals = np.broadcast_to(row, (src.size, 64)).copy()
            vals = np.where(j == wsel, (vals & keep) | (cu << shift), vals)
            is_mask = (j >= pw) & (j < pw + w) & ((j - pw) == (cu >> np.uint32(5)).astype(np.int64))
            vals = np.where(is_mask, vals | (np.uint32(1) << (cu & np.uint32(31))), vals)
            vals[:, dcol] = np.uint32((depth + 1) & 0xFFFFFFFF)
            for off, f in enumerate(floats, start=1):
                vals[:, dcol + off] = f[p, c0 + src]
            for q, lane in enumerate(src):
                out[my_dst[lane]] = vals[q, :cols].view(np.int32)
    return nodes


def push_rows(nodes: torch.Tensor, parents: torch.Tensor, dest: torch.Tensor,
              ccost: torch.Tensor, cbound: torch.Tensor, csum: torch.Tensor,
              n: int) -> torch.Tensor:
    """Fused in-place push: every child whose ``dest`` row lies in
    ``[0, F)`` is written there as a freshly built packed row; returns
    ``nodes``.

    ``nodes [F, C]`` int32 (updated in place), ``parents [k, C]`` int32,
    ``dest [k, n]`` int32, ``ccost/cbound/csum [k, n]`` float32 (stored as
    their bits), C = ceil(n/4) + ceil(n/32) + 4, 1 <= n <= 200. On CUDA all
    contiguous on one device, else it raises. Replaces
    ``expand_pallas.push_rows``.
    """
    tensors = (nodes, parents, dest, ccost, cbound, csum)
    if all(t.device.type == "cpu" for t in tensors):
        return push_rows_reference(nodes, parents, dest, ccost, cbound, csum, n)
    for t in tensors:
        if t.device != nodes.device or t.device.type != "cuda":
            raise ValueError("push_rows: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("push_rows: tensors must be contiguous")
    _check(nodes, parents, dest, ccost, cbound, csum, n)
    k = parents.shape[0]
    if k and nodes.shape[0]:
        lib = _build.push_library()
        code = lib.push_rows_launch(
            nodes.data_ptr(), parents.data_ptr(), dest.data_ptr(), ccost.data_ptr(),
            cbound.data_ptr(), csum.data_ptr(), nodes.shape[0], nodes.shape[1], k, n,
            torch.cuda.current_stream(nodes.device).cuda_stream,
        )
        if code != 0:
            msg = lib.push_error_string(code).decode()
            raise RuntimeError(f"push_rows: CUDA error {code}: {msg}")
        LAUNCHES["push_rows"] += 1
        key = (f"F{nodes.shape[0]}", f"k{k}", f"n{n}")
        _costs.record_launch("push_rows", key, lambda: _launch_costs(nodes, dest, n), nodes.device)
    return nodes


def _launch_costs(nodes: torch.Tensor, dest: torch.Tensor, n: int) -> dict:
    """The raw ``obs.costs`` record of one ``push_rows`` launch (the pushed
    children counted from ``dest``)."""
    f_rows, cols = nodes.shape
    k = dest.shape[0]
    n_push = int(((dest >= 0) & (dest < f_rows)).sum())
    nbytes, ops = _costs.push_rows_counts(k, n, cols, n_push)
    buf = 4 * f_rows * cols  # updated in place: an argument and the output
    return {"flops": ops, "bytes_accessed": nbytes,
            "argument_bytes": buf + 4 * k * cols + 4 * 4 * k * n, "output_bytes": buf,
            "alias_bytes": buf, "dtype": "int32",
            "shape": {"rows": f_rows, "cols": cols, "k": k, "n": n, "n_push": n_push}}

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
    return nodes

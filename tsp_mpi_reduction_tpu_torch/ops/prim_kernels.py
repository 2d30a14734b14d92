"""The branch-and-bound Prim MST chain: CUDA kernel and its plain version.

Counterpart of ``tsp_mpi_reduction_tpu/ops/prim_pallas.py``. For each of
k B&B nodes (lanes) the chain runs the n-1 steps of Prim's MST over that
node's unvisited set on the reduced costs ``dbar`` (plus optional per-lane
potentials ``lam``) and returns the tree total ``tot [k]`` (float32,
accumulated in step order) and the degrees ``deg [k, n]`` (int32), ties to
the first index. Both versions are bit-identical to the fori loop of
``branch_bound._mst_conn`` in the JAX package.

:func:`prim_chain` launches the hand-written kernel
(``kernels/csrc/prim_chain.cu``) on CUDA tensors and raises on anything
the kernel does not take; CPU tensors go to :func:`prim_chain_reference`.
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches (plain-version calls are not counted).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import _build

MAX_N = 200  # MAX_BNB_CITIES: at most 7 cities per thread of a warp

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"prim_chain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def edge_rows(dbar: torch.Tensor, u: torch.Tensor, lam: Optional[torch.Tensor]) -> torch.Tensor:
    """``[k, n]`` reduced costs from each lane's vertex ``u``:
    ``(dbar[u] + lam[u]) + lam``, added in that order."""
    base = dbar[u]
    if lam is None:
        return base
    return base + lam.gather(1, u[:, None]) + lam


def prim_chain_reference(
    dbar: torch.Tensor, unvis: torch.Tensor, n: int, lam: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the chain of ``branch_bound.py:848-877`` in torch ops.

    ``dbar`` ``[n, n]``, ``unvis`` ``[k, n]`` bool, ``lam`` ``[k, n]`` or
    None -> (``tot [k]``, ``deg [k, n]`` int32).
    """
    k = unvis.shape[0]
    dev = unvis.device
    big = float("inf")
    cities = torch.arange(n, device=dev)[None, :]
    # first unvisited city; argmax of an all-zero row is 0, as jnp's is
    start = unvis.to(torch.int32).argmax(dim=1)
    intree = cities == start[:, None]
    mind = torch.where(unvis, edge_rows(dbar, start, lam), big)
    closest = start[:, None].expand(k, n)
    deg = torch.zeros((k, n), dtype=torch.int32, device=dev)
    tot = torch.zeros(k, dtype=dbar.dtype, device=dev)
    for _ in range(n - 1):
        cand = torch.where(intree, big, mind)
        u = cand.argmin(dim=1)
        wu = cand.gather(1, u[:, None])[:, 0]
        fin = torch.isfinite(wu)
        tot = tot + torch.where(fin, wu, 0.0)
        par = closest.gather(1, u[:, None])
        oh_u = cities == u[:, None]
        deg = deg + (oh_u.to(torch.int32) + (cities == par).to(torch.int32)) * fin[:, None].to(torch.int32)
        intree = intree | oh_u
        row = torch.where(unvis, edge_rows(dbar, u, lam), big)
        closest = torch.where(row < mind, u[:, None], closest)
        mind = torch.minimum(mind, row)
    return tot, deg


def _float_keys(v: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 keys of float32 values (no
    NaN), as int64: -0.0 becomes +0.0 first, then a < b iff key(a) < key(b)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def _key_floats(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_float_keys` (``-0.0`` comes back as ``+0.0``)."""
    bits = torch.where(key >= 0x80000000, key ^ 0x80000000, key ^ 0xFFFFFFFF)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def prim_chain_early_exit_reference(
    dbar: torch.Tensor, unvis: torch.Tensor, n: int, lam: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of the kernel's schedule (tests only), float32.

    The chain of :func:`prim_chain_reference`, except that a lane stops
    (its state frozen) once every city of its U is in its tree, and the
    argmin is taken as the kernel takes it: the least order-preserving key
    of each candidate, the first city holding it, and ``wu`` read back from
    the key. Equal to :func:`prim_chain_reference` bit for bit.
    """
    k = unvis.shape[0]
    dev = unvis.device
    big = float("inf")
    cities = torch.arange(n, device=dev)[None, :]
    start = unvis.to(torch.int32).argmax(dim=1)
    intree = cities == start[:, None]
    mind = torch.where(unvis, edge_rows(dbar, start, lam), big)
    closest = start[:, None].expand(k, n)
    deg = torch.zeros((k, n), dtype=torch.int32, device=dev)
    tot = torch.zeros(k, dtype=dbar.dtype, device=dev)
    for _ in range(n - 1):
        live = (unvis & ~intree).any(dim=1)  # lanes whose U is not yet spanned
        if not bool(live.any()):
            break
        key = _float_keys(torch.where(intree, big, mind))
        u = key.argmin(dim=1)  # first index of the least key
        wu = _key_floats(key.gather(1, u[:, None])[:, 0])
        fin = torch.isfinite(wu) & live
        tot = torch.where(fin, tot + wu, tot)
        par = closest.gather(1, u[:, None])
        oh_u = (cities == u[:, None]) & live[:, None]
        deg = deg + (oh_u.to(torch.int32) + (cities == par).to(torch.int32)) * fin[:, None].to(torch.int32)
        intree = intree | oh_u
        row = torch.where(unvis, edge_rows(dbar, u, lam), big)
        better = (row < mind) & live[:, None]
        closest = torch.where(better, u[:, None], closest)
        mind = torch.where(live[:, None], torch.minimum(mind, row), mind)
    return tot, deg


def prim_chain(
    dbar: torch.Tensor, unvis: torch.Tensor, n: int, lam: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``tot [k]``, ``deg [k, n]``) of MST(U) for every lane.

    On CUDA: float32 ``dbar [n, n]``, bool ``unvis [k, n]`` and float32
    ``lam [k, n]`` (or None), all contiguous on one device, 1 <= n <= 200;
    anything else raises. Replaces ``prim_pallas.prim_chain``.
    """
    tensors = (dbar, unvis) if lam is None else (dbar, unvis, lam)
    if all(t.device.type == "cpu" for t in tensors):
        return prim_chain_reference(dbar, unvis, n, lam)
    for t in tensors:
        if t.device != unvis.device or t.device.type != "cuda":
            raise ValueError("prim_chain: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("prim_chain: tensors must be contiguous")
    if dbar.dtype != torch.float32 or (lam is not None and lam.dtype != torch.float32):
        raise ValueError(f"prim_chain: float32 dbar/lam only, got {dbar.dtype}")
    if unvis.dtype != torch.bool:
        raise ValueError(f"prim_chain: unvis must be bool, got {unvis.dtype}")
    k = unvis.shape[0]
    if not 1 <= n <= MAX_N or dbar.shape != (n, n) or unvis.shape != (k, n) or (
        lam is not None and lam.shape != (k, n)
    ):
        raise ValueError(
            f"prim_chain: need 1 <= n <= {MAX_N}, dbar [n, n], unvis/lam [k, n]; got n={n} "
            f"dbar {tuple(dbar.shape)} unvis {tuple(unvis.shape)}"
        )
    tot = torch.empty(k, dtype=torch.float32, device=unvis.device)
    deg = torch.empty((k, n), dtype=torch.int32, device=unvis.device)
    if k:
        lib = _build.prim_library()
        code = lib.prim_chain_launch(
            dbar.data_ptr(), unvis.data_ptr(), None if lam is None else lam.data_ptr(),
            tot.data_ptr(), deg.data_ptr(), k, n,
            torch.cuda.current_stream(unvis.device).cuda_stream,
        )
        if code != 0:
            msg = lib.prim_error_string(code).decode()
            raise RuntimeError(f"prim_chain: CUDA error {code}: {msg}")
        LAUNCHES["prim_chain"] += 1
    return tot, deg

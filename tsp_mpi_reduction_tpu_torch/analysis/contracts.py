"""Runtime contracts: boundary shape/dtype/device checks.

Counterpart of ``tsp_mpi_reduction_tpu/analysis/contracts.py:1-260``.
``Frontier`` and ``PaddedTour`` are bare NamedTuples of tensors: nothing
stops a caller from handing a float64 buffer, a transposed node matrix, a
row width that inverts to no valid ``(n, W)`` layout, or fields on two
devices. The checks here catch that at the boundary.

Levels (``TSP_CONTRACTS``):

- ``on`` (the default): METADATA ONLY — shape, dtype, device and the
  row-width layout. No check reads a tensor's values, so none waits for
  the device (no ``.item()``, ``.cpu()`` or ``int(tensor)``), and they stay
  on in production: the merge fold runs two per merge.
- ``strict``: adds the value checks (count within the buffer, length
  within capacity, the packed path bytes), which copy tensors to the host.
- ``off``: every check returns its argument untouched.

The JAX package's ``check_donated`` asks whether a donated buffer was
consumed; torch has no donation, and the port promises in-place writes
instead. Here it checks that the frontier's node buffer is the same
allocation (``data_ptr``) after a dispatch as before it.

The JAX package's ``RecompilationGuard`` guards ``jax.jit`` caches, which
the port does not have.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


class ContractError(ValueError):
    """A structural invariant on a kernel boundary was violated.

    Subclasses ValueError, so callers that wrap entry points in ``except
    ValueError`` (the CLIs' clean exit 2) treat it like any other input
    error."""


def level() -> str:
    """Contract level: "off", "on" (default; metadata checks only), or
    "strict" (adds value checks that read tensors on the host)."""
    val = os.environ.get("TSP_CONTRACTS", "on").strip().lower()
    return val if val in ("off", "on", "strict") else "on"


def _shape(x: Any) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _dtype(x: Any) -> torch.dtype:
    """dtype of a tensor, mapping plain Python scalars to torch's defaults
    (a bare float cost is a legal scalar leaf)."""
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int64
    return torch.float64


def _is_integer(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def _device(x: Any) -> Optional[torch.device]:
    return getattr(x, "device", None)


def _frontier_layout(cols: int) -> Optional[Tuple[int, int]]:
    """Invert the packed-row width ``cols = ceil(n/4) + ceil(n/32) + 4`` to
    the inclusive ``(n_lo, n_hi)`` range of consistent city counts, or None
    if no n fits (the engine's ``_layout``, repeated so this module imports
    nothing of the engine). Byte packing makes n ambiguous within one
    path-word cell; the cell itself is unique."""
    lo = hi = None
    for n in range(1, min((cols - 5) * 4, 32 * (cols - 5)) + 1):
        if (n + 3) // 4 + (n + 31) // 32 + 4 == cols:
            lo = n if lo is None else lo
            hi = n
    return None if lo is None else (lo, hi)


def _fail(where: str, msg: str) -> None:
    prefix = f"{where}: " if where else ""
    raise ContractError(f"contract violation: {prefix}{msg}")


def _same_device(where: str, what: str, *tensors) -> None:
    first = None
    for t in tensors:
        dev = _device(t)
        if dev is None:
            continue
        if first is None:
            first = dev
        elif dev != first:
            _fail(where, f"{what} fields live on more than one device: {first} and {dev}")


def check_frontier(fr, *, n: Optional[int] = None, where: str = ""):
    """Validate a Frontier's structural invariants; returns ``fr``.

    Accepts single-device ``[F, cols]`` node buffers and the sharded
    stacked ``[R, F, cols]`` ones. Metadata only unless strict.
    """
    lv = level()
    if lv == "off":
        return fr
    nodes, count, overflow = fr.nodes, fr.count, fr.overflow
    if nodes.ndim not in (2, 3):
        _fail(where, f"Frontier.nodes must be [F, cols] or [R, F, cols], got {tuple(nodes.shape)}")
    if nodes.dtype != torch.int32:
        _fail(where, f"Frontier.nodes must be int32 packed rows, got {nodes.dtype}")
    cols = nodes.shape[-1]
    rng = _frontier_layout(cols)
    if rng is None:
        _fail(where, f"Frontier row width {cols} inverts to no valid (n, W) layout")
    if n is not None and not rng[0] <= n <= rng[1]:
        _fail(where, f"Frontier row width {cols} encodes n in [{rng[0]}, {rng[1]}], expected n={n}")
    want_count_shape = () if nodes.ndim == 2 else tuple(nodes.shape[:1])
    if _shape(count) != want_count_shape:
        _fail(where, f"Frontier.count shape {_shape(count)}, expected {want_count_shape}")
    if not _is_integer(_dtype(count)):
        _fail(where, f"Frontier.count must be integer, got {_dtype(count)}")
    if _dtype(overflow) != torch.bool:
        _fail(where, f"Frontier.overflow must be bool, got {_dtype(overflow)}")
    _same_device(where, "Frontier", nodes, count, overflow)
    if lv == "strict":
        cnt = np.asarray(torch.as_tensor(count).cpu())
        rows = nodes.shape[-2]
        if (cnt < 0).any() or (cnt > rows).any():
            _fail(where, f"Frontier.count {cnt} outside [0, {rows}] buffer rows")
    return fr


def check_frontier_packed(fr, n: int, *, where: str = ""):
    """Value-level contract on the int8-packed row layout: every LIVE row's
    packed path must be well-formed for instance size ``n`` — city-id bytes
    < n at prefix positions below ``depth``, and pad lanes past n all zero.
    Runs :func:`check_frontier` first; the byte checks are strict only
    (they copy the live rows to the host). Returns ``fr``."""
    lv = level()
    if lv == "off":
        return fr
    check_frontier(fr, n=n, where=where)
    if lv != "strict":
        return fr
    nodes = fr.nodes.cpu().numpy()
    counts = np.atleast_1d(torch.as_tensor(fr.count).cpu().numpy())
    rows2d = nodes.reshape(-1, nodes.shape[-2], nodes.shape[-1])
    pw = (n + 3) // 4
    for r in range(rows2d.shape[0]):
        live = rows2d[r, : int(counts[r])]
        if not live.size:
            continue
        words = np.ascontiguousarray(live[:, :pw]).view(np.uint32)
        shifts = np.arange(4, dtype=np.uint32) * 8
        lanes = ((words[:, :, None] >> shifts) & np.uint32(0xFF)).reshape(live.shape[0], -1)
        depth = live[:, -4]
        pos = np.arange(lanes.shape[1])[None, :]
        in_prefix = pos < depth[:, None]
        if (lanes[in_prefix & (pos < n)] >= n).any():
            _fail(where, f"packed path carries a city id >= n={n} inside a live prefix "
                  "(corrupt byte-packed row)")
        if lanes[:, n:].any():
            _fail(where, f"packed path pad lanes past n={n} are non-zero "
                  "(byte-set wrote outside the prefix)")
    return fr


def check_exchange_count(count, capacity: int, *, where: str = ""):
    """The kept (on-device) row count of a reservoir exchange or refill must
    lie in ``[0, capacity // 2]``, the best-half invariant every reservoir
    path promises. Host ints only, so it stays on at the default level."""
    if level() == "off":
        return count
    lim = max(capacity // 2, 0)
    if not 0 <= int(count) <= lim:
        _fail(where, f"exchange kept {int(count)} rows, outside [0, {lim}] (capacity {capacity})")
    return count


def check_donated(buf, prev_ptr: Optional[int], *, where: str = ""):
    """In-place contract on the frontier's node buffer: ``buf`` (the buffer
    after a dispatch) must be the allocation the dispatch was handed
    (``prev_ptr``, its ``data_ptr()`` before). Failing here means a path
    reallocated the multi-hundred-MB frontier per dispatch instead of
    writing it in place. Metadata only; ``prev_ptr`` None skips the check
    (the caller read no pointer under ``TSP_CONTRACTS=off``). Returns
    ``buf``."""
    if prev_ptr is None or level() == "off":
        return buf
    if buf.data_ptr() != prev_ptr:
        _fail(where, "frontier buffer was reallocated by the dispatch — the in-place write did not "
              "alias (per-dispatch full-buffer copy)")
    return buf


def donation_ptr(buf) -> Optional[int]:
    """``buf.data_ptr()`` when contracts are on, else None: what a caller
    reads before a dispatch and hands to :func:`check_donated` after it."""
    return None if level() == "off" else buf.data_ptr()


def check_padded_tour(t, *, capacity: Optional[int] = None, where: str = ""):
    """Validate a PaddedTour's structural invariants; returns ``t``.

    Accepts one tour (``ids [P]``) and batches (``ids [..., P]`` with
    length and cost of the batch shape), as the tree folds produce.
    """
    lv = level()
    if lv == "off":
        return t
    ids, length, cost = t.ids, t.length, t.cost
    shape = _shape(ids)
    if len(shape) < 1:
        _fail(where, f"PaddedTour.ids must have a capacity axis, got shape {shape}")
    if _dtype(ids) != torch.int32:
        _fail(where, f"PaddedTour.ids must be int32 city ids, got {_dtype(ids)}")
    batch = shape[:-1]
    if _shape(length) != batch:
        _fail(where, f"PaddedTour.length shape {_shape(length)} != batch {batch}")
    if _shape(cost) != batch:
        _fail(where, f"PaddedTour.cost shape {_shape(cost)} != batch {batch}")
    if not _is_integer(_dtype(length)):
        _fail(where, f"PaddedTour.length must be integer, got {_dtype(length)}")
    if not _dtype(cost).is_floating_point:
        _fail(where, f"PaddedTour.cost must be floating, got {_dtype(cost)}")
    if capacity is not None and shape[-1] != capacity:
        _fail(where, f"PaddedTour capacity {shape[-1]}, expected {capacity}")
    _same_device(where, "PaddedTour", ids, length, cost)
    if lv == "strict":
        ln = np.asarray(torch.as_tensor(length).cpu())
        if (ln < 0).any() or (ln > shape[-1]).any():
            _fail(where, f"PaddedTour.length {ln} outside [0, {shape[-1]}]")
    return t

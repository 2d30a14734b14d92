"""Analytic device costs of the port's hand kernels.

Counterpart of ``tsp_mpi_reduction_tpu/obs/costs.py``, with the same record
schema (``SCHEMA_VERSION``, the roofline fields, the ``xla_entry_*``
gauges, ``obs.device_costs``). The JAX package reads each compiled entry's
flops and bytes from XLA's ``cost_analysis()``; the port's kernels are
hand-written CUDA, so the counts are worked out analytically from the
arguments of a launch. The count functions below are the ones
``tools/kernel_times.py`` uses for its bounds, and the peak row is the one
it divides by, so the roofline here and the bounds there read the same
work.

Each kernel wrapper (``ops/prim_kernels.prim_chain``,
``ops/expand_kernels.push_rows``, ``ops/held_karp_kernels.relax_minplus``
and ``relax_dense_sweep``) calls :func:`record_launch` after it launches.
The first launch at a shape computes the counts (reading the data the
counts depend on, such as the unvisited cities of the Prim lanes, which
waits for the device once) and stores one entry; every later launch at
that shape costs one dict lookup. Nothing is recorded for the plain
versions the wrappers run on CPU tensors, nor while a CUDA graph is being
captured.

The peak row is the data-sheet figure of the NVIDIA H100 SXM5 80GB at 700
W (HBM3 bandwidth, non-tensor-core float32 and float64 rates), not a
measurement; ``TSP_PEAK_FLOPS`` / ``TSP_PEAK_BYTES_PER_S`` override it. A
record names the card it was launched on beside it.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Callable, Dict, Hashable, Optional, Set, Tuple

from .metrics import REGISTRY

#: NVIDIA H100 SXM5 80GB data sheet (700 W): HBM3 bandwidth and the
#: non-tensor-core float32 / float64 rates
PEAK_CARD = "NVIDIA H100 SXM5 80GB (data sheet, 700 W)"
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

#: the peak row per backend for the roofline estimate; the port records
#: kernel launches on the GPU only: the H100 data-sheet row above (float32;
#: a float64 record uses the float64 rate)
BACKEND_PEAKS: Dict[str, Dict[str, float]] = {
    "gpu": {"flops_per_s": PEAK_OPS_PER_S["float32"], "bytes_per_s": PEAK_BYTES_PER_S},
}

#: schema version stamped into every record; bump on any field change
SCHEMA_VERSION = 1

_GAUGES = (
    ("flops", "xla_entry_flops"),
    ("bytes_accessed", "xla_entry_bytes_accessed"),
    ("peak_memory_bytes", "xla_entry_peak_memory_bytes"),
    ("arithmetic_intensity", "xla_entry_arithmetic_intensity"),
    ("roofline_utilization_est", "xla_entry_roofline_utilization"),
)

_lock = threading.Lock()
#: entry -> cost record (JSON-ready); process-global like the launch counts
_COSTS: Dict[str, Dict[str, Any]] = {}
#: (kernel, shape key) pairs already recorded: the per-launch lookup
_SEEN: Set[Tuple[str, Hashable]] = set()


# -- the kernels' work, shared with tools/kernel_times.py --------------------


def prim_chain_counts(unvis, has_lam: bool) -> Tuple[float, float]:
    """Bytes and operations one ``prim_chain`` launch needs on these lanes:
    unvis (1 B), lam (4 B, when given) and dbar read once, tot and deg
    written once; per lane |U|-1 steps over |U| cities, each city one
    argmin compare, one relaxation compare and, with lam, two adds.
    Reads ``unvis`` (a bool ``[k, n]`` tensor)."""
    k, n = unvis.shape
    u = unvis.sum(dim=1).double()
    nbytes = k * n * (1 + 4 + (4 if has_lam else 0)) + 4 * n * n + 4 * k
    ops = float(((u - 1.0).clamp(min=0.0) * u).sum()) * (2 + (2 if has_lam else 0))
    return nbytes, ops


def push_rows_counts(k: int, n: int, cols: int, n_push: float) -> Tuple[float, float]:
    """Bytes and operations of one ``push_rows`` launch pushing ``n_push``
    children: the k parent rows and ``dest`` [k, n] read once, the three
    float columns read only at the pushed children (4 B each, not charged
    per 32 B sector), the pushed rows written once; one operation per
    written word."""
    nbytes = 4 * (k * cols + k * n) + 4 * 3 * n_push + 4 * n_push * cols
    return nbytes, n_push * cols


def relax_minplus_counts(bsz: int, j: int, m: int, elt: int) -> Tuple[float, float]:
    """Bytes and operations of one compact Held-Karp step: g, d_t in;
    cost, int32 parent out; M adds and M-1 compares per output."""
    nbytes = bsz * (elt * (2 * j * m + m * m) + 4 * j * m)
    ops = bsz * j * m * (2 * m - 1)
    return nbytes, ops


def relax_dense_counts(bsz: int, m: int, elt: int) -> Tuple[float, float]:
    """Bytes and operations of the whole dense DP (one sweep): every
    computed state (popcount 1..m-1, endpoint outside the mask) written
    once, the init row and ``d_sub`` read once; c adds and c-1 mins per
    state of popcount c."""
    states = sum(math.comb(m, c) * (m - c) for c in range(1, m))
    nbytes = bsz * elt * (states + m + m * m)
    ops = bsz * sum(math.comb(m, c) * (m - c) * (2 * c - 1) for c in range(1, m))
    return nbytes, ops


def bound_ms(nbytes: float, ops: float, dtype_name: str) -> Tuple[float, str]:
    """The least time for the work on the data-sheet card: bytes over HBM
    bandwidth or operations over the peak rate, whichever is larger, and
    which one it is. Integer work (``push_rows`` moves int32 words) is
    charged at the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S.get(dtype_name, PEAK_OPS_PER_S["float32"])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- the record store ----------------------------------------------------------


def backend_peaks(backend: str, dtype: Optional[str] = None) -> Dict[str, float]:
    """The peak row for ``backend`` (the float64 rate for a float64 record
    on the GPU) with the env overrides applied."""
    row = dict(BACKEND_PEAKS.get(backend, BACKEND_PEAKS["gpu"]))
    if dtype in PEAK_OPS_PER_S:
        row["flops_per_s"] = PEAK_OPS_PER_S[dtype]
    for env, key in (("TSP_PEAK_FLOPS", "flops_per_s"), ("TSP_PEAK_BYTES_PER_S", "bytes_per_s")):
        val = os.environ.get(env, "").strip()
        if val:
            try:
                row[key] = float(val)
            except ValueError:
                pass  # a bad override must not take cost capture down
    return row


def _roofline(record: Dict[str, Any]) -> Dict[str, Any]:
    """Derive intensity + attainable-fraction fields from a raw record."""
    peaks = backend_peaks(record.get("backend", "gpu"), record.get("dtype"))
    flops = float(record.get("flops", 0.0))
    bytes_accessed = float(record.get("bytes_accessed", 0.0))
    intensity = flops / bytes_accessed if bytes_accessed > 0 else 0.0
    ridge = peaks["flops_per_s"] / peaks["bytes_per_s"]
    attainable = min(peaks["flops_per_s"], intensity * peaks["bytes_per_s"])
    record.update(
        arithmetic_intensity=round(intensity, 4),
        ridge_intensity=round(ridge, 4),
        roofline_utilization_est=(
            round(attainable / peaks["flops_per_s"], 6) if peaks["flops_per_s"] > 0 else 0.0
        ),
        bound="compute" if intensity >= ridge else "memory",
        peak_flops_per_s=peaks["flops_per_s"],
        peak_bytes_per_s=peaks["bytes_per_s"],
    )
    return record


def ingest(entry: str, record: Dict[str, Any]) -> Dict[str, Any]:
    """Store a cost record for ``entry`` (deriving the roofline fields when
    it lacks them) and mirror its headline numbers as registry gauges."""
    if record.get("schema") != SCHEMA_VERSION or "roofline_utilization_est" not in record:
        record = _roofline(dict(record, schema=SCHEMA_VERSION))
    with _lock:
        _COSTS[entry] = record
    for key, gauge in _GAUGES:
        if key in record:
            REGISTRY.set_gauge(gauge, float(record[key]), entry=entry)
    return record


def get(entry: str) -> Optional[Dict[str, Any]]:
    with _lock:
        rec = _COSTS.get(entry)
    return dict(rec) if rec is not None else None


def device_costs_block() -> Dict[str, Any]:
    """The ``obs.device_costs`` block: every recorded entry plus the peak
    rows its roofline estimates were computed against (the GPU row with
    the card it stands for). Empty ``entries`` when no kernel launched in
    this process yet (a CPU run launches none)."""
    with _lock:
        entries = {k: dict(v) for k, v in sorted(_COSTS.items())}
    backends = sorted({v.get("backend", "gpu") for v in entries.values()})
    peaks = {b: dict(backend_peaks(b), card=PEAK_CARD) for b in backends}
    return {"schema": SCHEMA_VERSION, "entries": entries, "peaks": peaks}


def reset_for_testing() -> None:
    with _lock:
        _COSTS.clear()
        _SEEN.clear()
    for _key, gauge in _GAUGES:
        REGISTRY.clear_metric(gauge)


# -- capture at a kernel launch ------------------------------------------------


def _card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device)


def record_launch(kernel: str, key: Hashable, counts: Callable[[], Dict[str, Any]], device) -> None:
    """Record ``kernel``'s costs the first time it launches at ``key`` (its
    shape and dtype) on ``device``. ``counts()`` returns the record's raw
    fields: ``flops``, ``bytes_accessed``, ``argument_bytes``,
    ``output_bytes``, ``alias_bytes`` (an in-place output), ``dtype`` and
    ``shape``. After the first launch at a shape this is one dict lookup;
    while a CUDA graph is being captured nothing is recorded."""
    if (kernel, key) in _SEEN:
        return
    import torch

    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        return  # the counts may read the device, which capture forbids
    raw = counts()
    arg_b, out_b, alias_b = (int(raw.pop(f, 0)) for f in ("argument_bytes", "output_bytes", "alias_bytes"))
    entry = f"{kernel}@" + ".".join(str(x) for x in key)
    record = {
        "schema": SCHEMA_VERSION,
        "backend": "gpu",
        "card": _card_name(device),
        "kernel": kernel,
        "flops": float(raw.pop("flops")),
        "bytes_accessed": float(raw.pop("bytes_accessed")),
        "transcendentals": 0.0,
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": 0,
        "alias_bytes": alias_b,
        # live at once: arguments + outputs, the in-place overlap once
        "peak_memory_bytes": max(arg_b + out_b - alias_b, 0),
        **raw,
    }
    b_ms, b_by = bound_ms(record["bytes_accessed"], record["flops"], record.get("dtype", "float32"))
    record.update(bound_ms=b_ms, bound_by=b_by)
    ingest(entry, _roofline(record))
    with _lock:
        _SEEN.add((kernel, key))

"""Frozen operation and byte counts of the program's hand kernels, and the
peak row they are read against.

A copy of the count functions of the port's ``obs/costs.py``
(``prim_chain_counts``, ``push_rows_counts``, ``relax_dense_counts``,
``bound_ms``) as they stand when the benchmark was written, so that a later
change to the program cannot change the yardstick. ``benchmark/tests``
holds them equal to the port's.

Peaks: NVIDIA's H100 SXM data sheet at 700 W, dense rates: HBM3 at 3.35
TB/s, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores.
A run records the card's power limit beside every share.

The shares the benchmark reports divide the least time these counts
allow by the kernel's summed device time in the trace. Where the work
depends on the data the trace does not carry (the unvisited cities of a
``prim_chain`` lane, the children a ``push_rows`` launch writes), only the
terms the launch's shape fixes are counted: the bound is then a lower
bound, and the share can read low but never high.
"""

from __future__ import annotations

import math
from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, 700 W: 3.35 TB/s HBM3, 67 TFLOP/s float32, 34 TFLOP/s float64"

PATH_PACK = 4


def prim_chain_counts(k: int, n: int, unvisited: "list[int] | None", has_lam: bool) -> Tuple[float, float]:
    """Bytes and operations of one ``prim_chain`` launch over ``k`` lanes of
    ``n`` cities: unvis (1 B), lam (4 B, when given) and dbar read once,
    tot and deg written once; a lane with ``u`` unvisited cities takes
    ``u - 1`` steps over ``u`` cities, each one argmin compare and one
    relaxation compare, two adds more with lam. ``unvisited`` None counts
    no operations (the trace does not carry the lanes' sets)."""
    nbytes = k * n * (1 + 4 + (4 if has_lam else 0)) + 4 * n * n + 4 * k
    if unvisited is None:
        return float(nbytes), 0.0
    ops = float(sum(max(u - 1, 0) * u for u in unvisited)) * (2 + (2 if has_lam else 0))
    return float(nbytes), ops


def push_rows_counts(k: int, n: int, cols: int, n_push: float) -> Tuple[float, float]:
    """Bytes and operations of one ``push_rows`` launch pushing ``n_push``
    children: the k parent rows and ``dest [k, n]`` read once, the three
    float columns read only at the pushed children, the pushed rows
    written once; one operation per written word."""
    nbytes = 4 * (k * cols + k * n) + 4 * 3 * n_push + 4 * n_push * cols
    return float(nbytes), float(n_push * cols)


def relax_dense_counts(bsz: int, m: int, elt: int) -> Tuple[float, float]:
    """Bytes and operations of the whole dense Held-Karp DP of ``bsz``
    blocks of ``m + 1`` cities (one sweep): every computed state written
    once, the init row and ``d_sub`` read once; c adds and c-1 mins per
    state of popcount c."""
    states = sum(math.comb(m, c) * (m - c) for c in range(1, m))
    nbytes = bsz * elt * (states + m + m * m)
    ops = bsz * sum(math.comb(m, c) * (m - c) * (2 * c - 1) for c in range(1, m))
    return float(nbytes), float(ops)


def bound_s(nbytes: float, ops: float, dtype_name: str = "float32") -> float:
    """The least seconds for the work: bytes over the bandwidth or
    operations over the peak rate, whichever is larger. Integer work is
    charged at the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S.get(dtype_name, PEAK_OPS_PER_S["float32"]))


def frontier_cols(n: int) -> int:
    """Width of a packed frontier row: ceil(n/4) path words, ceil(n/32)
    mask words, depth, cost, bound and sum_min."""
    return (n + PATH_PACK - 1) // PATH_PACK + (n + 31) // 32 + 4


def bnb_step_prim_bytes(lanes: int, n: int, node_ascent: int) -> float:
    """Bytes the ``prim_chain`` launches of one B&B step need at their
    least: the bound's chain without lam, then one chain with lam a node
    ascent step."""
    first, _ = prim_chain_counts(lanes, n, None, False)
    more, _ = prim_chain_counts(lanes, n, None, True)
    return first + node_ascent * more

"""ctypes binding to the native C++ runtime (``native/libtsp_native.so``).

The port's own copy of ``tsp_mpi_reduction_tpu/native.py`` (the port
imports nothing of the JAX package). The native layer (``native/src/``) is
the repo's C++ host runtime: the bit-exact instance generator, dense
Held-Karp, the merge operator and the rank-emulated pipeline with the
reference's tree-reduction shape, all in float64. This module loads it,
building it with the in-tree Makefile (``make -C native``) when the
library is missing or older than its sources. ``--backend=native`` of the
pipeline CLI runs :func:`run_pipeline`.

All functions return numpy arrays and Python scalars.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtsp_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    src = list((_NATIVE_DIR / "src").glob("*")) + [_NATIVE_DIR / "Makefile"]
    return any(p.stat().st_mtime > lib_mtime for p in src)


def build(force: bool = False) -> pathlib.Path:
    """Build the shared library if missing or out of date."""
    if force or _stale():
        proc = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed (exit {proc.returncode}):\n{proc.stderr}"
            )
    return _LIB_PATH


def load() -> ctypes.CDLL:
    """Load (building if needed) and memoize the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(_LIB_PATH))

        lib.tsp_rand_stream.argtypes = [ctypes.c_uint32, ctypes.c_int64, _i32p]
        lib.tsp_rand_stream.restype = None
        lib.tsp_blocks_per_dim.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tsp_blocks_per_dim.restype = None
        lib.tsp_generate.argtypes = [ctypes.c_int32] * 4 + [ctypes.c_uint32, _f64p]
        lib.tsp_generate.restype = ctypes.c_int32
        lib.tsp_distance_matrix.argtypes = [ctypes.c_int32, _f64p, _f64p]
        lib.tsp_distance_matrix.restype = None
        lib.tsp_solve_block.argtypes = [ctypes.c_int32, _f64p, _i32p]
        lib.tsp_solve_block.restype = ctypes.c_double
        lib.tsp_merge_tours.argtypes = [
            _f64p,
            _i32p,
            ctypes.c_int32,
            ctypes.c_double,
            _i32p,
            ctypes.c_int32,
            ctypes.c_double,
            _i32p,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tsp_merge_tours.restype = ctypes.c_double
        lib.tsp_run_pipeline.argtypes = [ctypes.c_int32] * 4 + [
            ctypes.c_uint32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            _i32p,
            ctypes.POINTER(ctypes.c_int32),
            _f64p,
        ]
        lib.tsp_run_pipeline.restype = ctypes.c_int32

        _lib = lib
        return lib


def rand_stream(seed: int, count: int) -> np.ndarray:
    """First ``count`` glibc ``rand()`` outputs after ``srand(seed)``."""
    out = np.empty(count, np.int32)
    load().tsp_rand_stream(seed, count, out)
    return out


def blocks_per_dim(num_blocks: int) -> Tuple[int, int]:
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    load().tsp_blocks_per_dim(num_blocks, ctypes.byref(rows), ctypes.byref(cols))
    return rows.value, cols.value


def generate(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    seed: int = 0,
) -> np.ndarray:
    """Instance coordinates ``[B, n, 2]`` float64, bit-exact vs the oracle."""
    xy = np.empty((num_blocks, num_cities_per_block, 2), np.float64)
    rc = load().tsp_generate(
        num_cities_per_block, num_blocks, grid_dim_x, grid_dim_y, seed,
        xy.reshape(-1),
    )
    if rc:
        raise ValueError("tsp_generate: bad arguments")
    return xy


def solve_block(dist: np.ndarray) -> Tuple[float, np.ndarray]:
    """Exact tour for one block from its ``[n, n]`` distance matrix."""
    dist = np.ascontiguousarray(dist, np.float64)
    n = dist.shape[0]
    tour = np.empty(n + 1, np.int32)
    cost = load().tsp_solve_block(n, dist.reshape(-1), tour)
    if cost < 0:
        raise ValueError(f"tsp_solve_block: unsupported n={n}")
    return float(cost), tour


def merge_tours(
    xy: np.ndarray,
    ids1: np.ndarray,
    cost1: float,
    ids2: np.ndarray,
    cost2: float,
) -> Tuple[float, np.ndarray]:
    """Merge closed tour 2 into tour 1 (global ids, coords ``[N, 2]``)."""
    xy = np.ascontiguousarray(xy, np.float64)
    ids1 = np.ascontiguousarray(ids1, np.int32)
    ids2 = np.ascontiguousarray(ids2, np.int32)
    if len(ids1) < 4 or len(ids2) < 4:
        # closed tour of k cities has length k+1; the merge's rotate-splice
        # needs >= 3 distinct cities per operand (SURVEY.md quirk #6)
        raise ValueError(
            f"both operands need >= 3 cities (closed length >= 4), got "
            f"{len(ids1)} and {len(ids2)}"
        )
    out = np.empty(len(ids1) + len(ids2) - 1, np.int32)
    out_len = ctypes.c_int32()
    cost = load().tsp_merge_tours(
        xy.reshape(-1), ids1, len(ids1), cost1, ids2, len(ids2), cost2,
        out, ctypes.byref(out_len),
    )
    return float(cost), out[: out_len.value]


def run_pipeline(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    seed: int = 0,
    ranks: int = 1,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Full native pipeline. Returns (cost, closed global tour, block costs)."""
    n, nb = num_cities_per_block, num_blocks
    tour = np.empty(nb * n + 1, np.int32)
    block_costs = np.empty(nb, np.float64)
    cost = ctypes.c_double()
    tour_len = ctypes.c_int32()
    rc = load().tsp_run_pipeline(
        n, nb, grid_dim_x, grid_dim_y, seed, ranks,
        ctypes.byref(cost), tour, ctypes.byref(tour_len), block_costs,
    )
    if rc:
        raise ValueError("tsp_run_pipeline: bad arguments")
    return float(cost.value), tour[: tour_len.value], block_costs

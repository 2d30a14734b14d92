"""Memo of the branch-and-bound root ascent's potentials.

The port's own copy of the host-setup memo of
``tsp_mpi_reduction_tpu/perf/compile_cache.py:566-656``. The float64 root
Held-Karp ascent (``ops.one_tree.held_karp_potentials_np``, 400 steps by
default) is deterministic in (distance matrix, bound mode, steps), so its
potentials are memoized: a resumed chunk or a later slice of the same
instance pays a lookup instead of the ascent. A hit returns the bytes the
same computation wrote, so no result can change.

Two tiers:

- an in-process LRU of 32 entries, always on;
- a disk tier of ``.npy`` files under ``<cache dir>/setup/``, on once a
  driver calls :func:`enable` (``tools/bnb_solve``, ``tools/bnb_chunked``'s
  chunks). The cache dir is ``TSP_COMPILE_CACHE`` when set (``off``, ``0``,
  ``none`` or ``disabled`` turn the disk tier off), else
  ``build/torch_cache`` in the repo. The key bytes are the JAX package's
  (``ascent-v1``), so with one ``TSP_COMPILE_CACHE`` either package reads
  the other's files.

``STATS`` counts ``ascent_memo_hits`` and ``ascent_memo_misses`` (a miss is
counted when the disk tier is on and holds no valid entry, as in the JAX
package).
"""

from __future__ import annotations

import hashlib
import io
import os
import pathlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

#: the cache directory setting shared with the JAX package
ENV_VAR = "TSP_COMPILE_CACHE"
_DISABLED = ("off", "0", "none", "disabled")

_ASCENT_MEM_CAP = 32
_ascent_mem: "OrderedDict[str, np.ndarray]" = OrderedDict()
_lock = threading.Lock()
_enabled_dir: Optional[str] = None


class _Stats:
    """Hit and miss counters (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.ascent_memo_hits = 0
        self.ascent_memo_misses = 0

    def incr(self, counter: str) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"ascent_memo_hits": self.ascent_memo_hits,
                    "ascent_memo_misses": self.ascent_memo_misses}


STATS = _Stats()


def default_cache_dir() -> str:
    return str(pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_cache")


def resolve_cache_dir() -> Optional[str]:
    """The configured cache dir, or None when the disk tier is disabled."""
    val = os.environ.get(ENV_VAR)
    if val is None:
        return default_cache_dir()
    val = val.strip()
    if not val or val.lower() in _DISABLED:
        return None
    return val


def enable() -> Optional[str]:
    """Turn the disk tier on (idempotent) -> its directory, or None when
    disabled or the directory cannot be created."""
    global _enabled_dir
    with _lock:
        if _enabled_dir is None:
            cache_dir = resolve_cache_dir()
            if cache_dir is None:
                return None
            try:
                os.makedirs(cache_dir, exist_ok=True)
            except OSError:
                return None
            _enabled_dir = cache_dir
        return _enabled_dir


def enabled_dir() -> Optional[str]:
    return _enabled_dir


def _ascent_path(key: str) -> str:
    return os.path.join(_enabled_dir or "", "setup", f"{key}.npy")


def ascent_key(d: np.ndarray, bound: str, steps: int) -> str:
    h = hashlib.blake2b(digest_size=16)
    a = np.ascontiguousarray(np.asarray(d, np.float64))
    h.update(f"ascent-v1:{bound}:{steps}:{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def ascent_memo_reset_memory() -> None:
    """Drop the in-process LRU (a test fixture calls it, so the always-on
    tier leaks no hits across tests)."""
    with _lock:
        _ascent_mem.clear()


def _mem_get(key: str) -> Optional[np.ndarray]:
    with _lock:
        pi = _ascent_mem.get(key)
        if pi is not None:
            _ascent_mem.move_to_end(key)
    return pi


def _mem_put(key: str, pi: np.ndarray) -> None:
    with _lock:
        _ascent_mem[key] = pi
        _ascent_mem.move_to_end(key)
        while len(_ascent_mem) > _ASCENT_MEM_CAP:
            _ascent_mem.popitem(last=False)


def ascent_memo_get(d: np.ndarray, bound: str, steps: int) -> Optional[np.ndarray]:
    """Memoized float64 root-ascent potentials, or None: the LRU first,
    then the disk tier when it is on."""
    key = ascent_key(d, bound, steps)
    pi = _mem_get(key)
    if pi is not None:
        STATS.incr("ascent_memo_hits")
        return pi.copy()
    if _enabled_dir is None:
        return None
    path = _ascent_path(key)
    try:
        pi = np.load(path)
    except (OSError, ValueError):
        STATS.incr("ascent_memo_misses")
        return None
    if pi.shape != (np.asarray(d).shape[0],):
        STATS.incr("ascent_memo_misses")  # a key collision: recompute
        return None
    STATS.incr("ascent_memo_hits")
    pi = np.asarray(pi, np.float64)
    _mem_put(key, pi.copy())
    return pi


def ascent_memo_put(d: np.ndarray, bound: str, steps: int, pi: np.ndarray) -> None:
    """Store the potentials in the LRU and, when on, atomically on disk."""
    pi = np.asarray(pi, np.float64)
    key = ascent_key(d, bound, steps)
    _mem_put(key, pi.copy())
    if _enabled_dir is None:
        return
    buf = io.BytesIO()
    np.save(buf, pi)
    path = _ascent_path(key)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        pass  # the memo is an optimization; a solve never fails over it

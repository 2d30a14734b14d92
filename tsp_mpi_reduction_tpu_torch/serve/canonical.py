"""Canonical instance keys: dedupe resubmitted TSP instances.

The port's copy of ``tsp_mpi_reduction_tpu/serve/canonical.py`` (numpy and
the standard library only): the same steps give the same keys, byte for
byte, so either package's cache entries are keyed alike.

A serving cache (Clipper's prediction cache, PAPERS.md) is only as good as
its key function. Raw coordinate bytes miss the two resubmission patterns
that actually occur: the same instance *translated* in the plane (Euclidean
TSP is translation-invariant) and the same instance with its cities listed
in a different *order* (the tour relabels trivially). This module maps an
instance to a canonical form that is invariant under both, plus float
jitter below half the quantization step:

1. quantize: ``q = rint(xy / step)`` snaps coordinates to an integer grid,
   absorbing sub-step noise (invariance holds for jitter strictly below
   ``step/2`` around a grid point — at exactly ``step/2`` rounding ties);
2. translate: ``q -= q.min(axis=0)`` pins the bounding-box corner to the
   origin (uniform for all cities, so any common shift cancels);
3. reorder: cities sort lexicographically by ``(qx, qy)`` — the unique
   minimal relabeling, so every permutation of the same city list lands on
   the same array (``np.lexsort`` is stable: quantization-tied cities keep
   their relative submission order; such cities are geometrically
   indistinguishable at the key's resolution, so either assignment maps a
   cached tour onto an equally-valid tour of the resubmitted instance);
4. hash: blake2b over ``n`` and the canonical int64 array.

The returned :class:`CanonicalInstance` keeps the sort permutation so a
tour cached in canonical city ids can be relabeled into any later
submission's city order (:func:`from_canonical_tour`) and vice versa.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: default quantization step in coordinate units. The repo's workloads put
#: cities on [0, 1000]^2 grids (tsp.cpp:373-403 scale), so 1e-3 keeps ~6
#: significant digits — far below any distance that changes a tour — while
#: absorbing float32<->float64 round-trip noise (~1e-5 at that scale).
DEFAULT_STEP = 1e-3


@dataclass(frozen=True)
class CanonicalInstance:
    """Canonical form of one instance plus the maps back to request space."""

    key: str  #: hex digest — the cache key
    n: int
    #: [n] canonical position -> original city index (``xy[perm]`` is sorted)
    perm: np.ndarray
    #: [n] original city index -> canonical position (``perm``'s inverse)
    inv_perm: np.ndarray
    #: [n, 2] int64 quantized, origin-pinned, sorted coordinates
    qxy: np.ndarray


def canonicalize(xy, step: float = DEFAULT_STEP) -> CanonicalInstance:
    """Build the canonical key for an ``[n, 2]`` coordinate array.

    Raises ``ValueError`` on malformed input (wrong shape, empty, or
    non-finite coordinates) — the service turns that into an error
    response rather than a cache poisoning.
    """
    xy = np.asarray(xy, np.float64)
    _validate(xy, step)
    return _canonicalize_validated(xy, step)


def _validate(xy: np.ndarray, step: float) -> None:
    if xy.ndim != 2 or xy.shape[-1] != 2 or xy.shape[0] < 1:
        raise ValueError(f"expected [n>=1, 2] coordinates, got shape {xy.shape}")
    if not np.all(np.isfinite(xy)):
        raise ValueError("coordinates must be finite")
    if not step > 0:
        raise ValueError(f"quantization step must be > 0, got {step}")


def _canonicalize_validated(xy: np.ndarray, step: float) -> CanonicalInstance:
    return _canonicalize_from_q(int(xy.shape[0]), _quantize_pin(xy, step))


def _canonicalize_from_q(n: int, q: np.ndarray) -> CanonicalInstance:
    """Steps 3-4 (the lexsort + hash) from quantized pinned coordinates."""
    # lexicographic-minimal city order: primary qx, secondary qy (np.lexsort
    # keys are listed least-significant first)
    perm = np.lexsort((q[:, 1], q[:, 0])).astype(np.int64)
    qs = np.ascontiguousarray(q[perm])
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(qs.shape[0]).tobytes())
    h.update(qs.tobytes())
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return CanonicalInstance(
        key=h.hexdigest(), n=n, perm=perm, inv_perm=inv, qxy=qs
    )


class CanonicalCache:
    """Bounded memo of the canonicalization itself: raw-order digest ->
    :class:`CanonicalInstance`.

    The service's host path used to pay the full ``canonicalize`` —
    including the O(n log n) lexsort and the inverse-permutation build —
    on every request, cache HITS included (the solution cache can only be
    consulted after the key exists). But the dominant resubmission pattern
    is byte-identical-after-quantization: the same instance re-sent in the
    same city order, possibly translated and jittered. For those, the
    quantized origin-pinned (UNSORTED) coordinates are already identical,
    so a digest of that array is enough to recall the stored perm map and
    key without re-sorting anything. Translation/jitter invariance is
    inherited from the quantize+pin steps; a *permuted* resubmission has
    different raw bytes and pays the one lexsort that genuinely cannot be
    skipped (the permutation is unknown until sorted), landing on the same
    final key via the slow path.

    ``sorts_saved`` counts fast-path hits — surfaced in the service cache
    stats so the trimmed host path is measured, not asserted. Thread-safe;
    entries are immutable (CanonicalInstance is frozen and its arrays are
    never mutated by consumers).
    """

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[str, CanonicalInstance]" = OrderedDict()
        self._lock = threading.Lock()
        self.sorts_saved = 0
        self.raw_misses = 0

    @staticmethod
    def _raw_key(q: np.ndarray) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(q.shape[0]).tobytes())
        h.update(np.ascontiguousarray(q).tobytes())
        return h.hexdigest()

    def get(self, q: np.ndarray) -> Optional[CanonicalInstance]:
        key = self._raw_key(q)
        with self._lock:
            ci = self._entries.get(key)
            if ci is None:
                self.raw_misses += 1
                return None
            self._entries.move_to_end(key)
            self.sorts_saved += 1
            from ..perf.compile_cache import STATS as _PERF_STATS

            _PERF_STATS.incr("canonical_sorts_saved")
            return ci

    def put(self, q: np.ndarray, ci: CanonicalInstance) -> None:
        key = self._raw_key(q)
        with self._lock:
            self._entries[key] = ci
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sorts_saved": self.sorts_saved,
                "raw_misses": self.raw_misses,
                "size": len(self._entries),
            }


def _quantize_pin(xy: np.ndarray, step: float) -> np.ndarray:
    """Steps 1-2 of the canonicalization (quantize + origin-pin), shared
    by the full path and the sort-skipping fast path."""
    q = np.rint(xy / step).astype(np.int64)
    q -= q.min(axis=0)  # translation invariance: pin bbox corner to origin
    return q


def canonicalize_cached(
    xy, cache: Optional[CanonicalCache], step: float = DEFAULT_STEP
) -> CanonicalInstance:
    """:func:`canonicalize` with the lexsort short-circuited through
    ``cache`` for byte-identical (post-quantization) resubmissions. With
    ``cache=None`` this IS ``canonicalize``. Validation always runs — a
    malformed request must fail identically on both paths."""
    xy = np.asarray(xy, np.float64)
    _validate(xy, step)
    if cache is None:
        return _canonicalize_validated(xy, step)
    q = _quantize_pin(xy, step)
    ci = cache.get(q)
    if ci is None:
        ci = _canonicalize_from_q(xy.shape[0], q)
        cache.put(q, ci)
    return ci


def to_canonical_tour(tour: np.ndarray, ci: CanonicalInstance) -> np.ndarray:
    """Relabel a tour of request-space city ids into canonical ids."""
    return ci.inv_perm[np.asarray(tour, np.int64)].astype(np.int32)


def from_canonical_tour(tour: np.ndarray, ci: CanonicalInstance) -> np.ndarray:
    """Relabel a cached canonical-id tour into this request's city ids."""
    return ci.perm[np.asarray(tour, np.int64)].astype(np.int32)


def tour_length_np(tour: np.ndarray, xy: np.ndarray) -> float:
    """True Euclidean length of a CLOSED tour under the request's own
    (unquantized) coordinates — re-measured on every cache hit so the
    reported cost is honest for *this* submission, not the one that
    populated the cache (they can differ by sub-step jitter).

    Edge lengths use the repo-wide ``sqrt(sum(diff*diff))`` form
    (``ops.distance.distance_matrix_np``), NOT ``np.hypot`` — hypot rounds
    differently at the ULP level, and service costs must be comparable
    bit-for-bit with every other entry point's."""
    t = np.asarray(tour, np.int64)
    p = np.asarray(xy, np.float64)[t]
    diff = p[1:] - p[:-1]
    return float(np.sqrt(np.sum(diff * diff, axis=-1)).sum())

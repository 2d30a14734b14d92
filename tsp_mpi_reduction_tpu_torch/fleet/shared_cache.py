"""Shared disk-backed solution-cache tier.

The port of ``TieredSolutionCache`` and its disk tier from
``tsp_mpi_reduction_tpu/fleet/shared_cache.py``. Entry files are the JAX
package's, byte for byte in layout (TSPCKPT1 container, the canonical key
as fingerprint, the same header fields and npz payload), so either
package reads the entries the other wrote.

The serve instance cache (``serve.cache.SolutionCache``) is per-process:
a fleet of N replicas would each re-solve an instance the fleet as a
whole has already answered, and a restarted replica starts cold. This
module promotes the cache to a two-level tier:

- **L1**: each replica's existing in-process LRU, unchanged semantics;
- **L2**: one directory shared by every replica (and the front), one
  file per canonical key, published ATOMICALLY via the
  ``resilience/checkpoint.py`` recipe (``pack`` header + temp + fsync +
  ``os.replace``) so a reader never observes a half-written entry.

Failure posture mirrors ``read_with_fallback``: a torn, truncated, or
bit-rotted entry is DETECTED by the checkpoint header checksum and
skipped as a miss (counted in ``corrupt_skipped``) — never parsed into a
wrong tour. Concurrent publishers of the same key are arbitrated by the
better-entry policy (:meth:`serve.cache.CacheEntry.better_than`):
a publish first reads the current entry and keeps the stronger one, so a
greedy answer racing a certified optimum can at worst waste a write of
the certified entry's own bytes — the replace is atomic, both images are
valid, and the next certified publish restores the stronger entry.

Entry file layout: the TSPCKPT1 container with the canonical key as the
integrity fingerprint, entry metadata (cost / certified_gap / tier) in
the JSON header, and the canonical CLOSED tour as an npz payload.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..obs.metrics import REGISTRY as _REGISTRY
from ..resilience.checkpoint import (
    CheckpointError,
    npz_bytes,
    read_with_fallback,
    sweep_stale_tmp,
    write_atomic,
)
from ..resilience.faults import TransientFault
from ..serve.cache import CacheEntry, SolutionCache

#: on-disk entry suffix (one file per canonical key)
ENTRY_SUFFIX = ".entry"


class SharedCacheTier:
    """The disk (L2) tier: canonical key -> one atomic entry file.

    Thread- and process-safe by construction: reads never lock (the
    entry file is immutable between ``os.replace`` publishes), and
    writes go through the crash-safe checkpoint writer. Every failure
    degrades to a miss or a dropped publish — disk trouble must never
    cost a request its answer."""

    def __init__(self, root: str) -> None:
        import threading

        self.root = root
        os.makedirs(root, exist_ok=True)
        # a PERSISTENT shared dir reused across fleets accumulates one
        # orphaned temp per publisher SIGKILLed mid-publish (replica
        # kills are this subsystem's normal weather) — reap them here,
        # age-bounded so a concurrent booting replica's live publish is
        # never raced
        sweep_stale_tmp(root)
        # per-INSTANCE counters (stats must describe this tier object,
        # not every tier the process ever made), mirrored into the
        # process registry so a replica's /metrics.json scrape carries
        # them fleet-wide
        self._counts_lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "corrupt_skipped": 0,
            "publishes": 0,
            "kept_better": 0,
            "dropped_puts": 0,
        }
        _REGISTRY.declare(
            "fleet_shared_cache_ops_total", "counter",
            "shared disk cache tier operations, by op/outcome",
        )

    def _count(self, name: str, op: str, outcome: str) -> None:
        with self._counts_lock:
            self._counts[name] += 1
        _REGISTRY.inc("fleet_shared_cache_ops_total", op=op, outcome=outcome)

    def _path(self, key: str) -> str:
        # keys are hex digests (serve.canonical) — safe as file names
        return os.path.join(self.root, key + ENTRY_SUFFIX)

    # -- read ----------------------------------------------------------------

    def get(self, key: str) -> Optional[CacheEntry]:
        entry, outcome = self._read(key)
        name = {"hit": "hits", "miss": "misses"}.get(outcome, "corrupt_skipped")
        self._count(name, "get", outcome)
        return entry

    def _read(self, key: str):
        """``(entry-or-None, outcome)`` without counting — shared by the
        client-facing :meth:`get` (which counts) and the publisher-side
        better-entry check (which must not inflate the hit/miss stats)."""
        path = self._path(key)
        if not os.path.exists(path):
            return None, "miss"
        try:
            header, payload, _, _ = read_with_fallback(path, keep=1)
            entry = _decode(header, payload, key)
        except (CheckpointError, KeyError, ValueError, OSError, TransientFault):
            # torn / truncated / bit-rotted / unreadable: skipped as a
            # miss, exactly the read_with_fallback posture — the entry is
            # re-published by whichever replica re-solves the instance
            return None, "corrupt_skipped"
        return entry, "hit"

    # -- write ---------------------------------------------------------------

    def put(self, key: str, entry: CacheEntry) -> None:
        """Publish ``entry`` unless the current disk entry is better
        (the L1 replacement policy, applied across processes). The
        read-check-publish window is racy by design: both racers hold
        valid entries, the replace is atomic, and the better-entry check
        on every future publish is what converges the file to the
        strongest known answer."""
        current, _ = self._read(key)
        if current is not None and not entry.better_than(current):
            self._count("kept_better", "put", "kept_better")
            return
        try:
            write_atomic(
                self._path(key),
                npz_bytes(tour=np.asarray(entry.tour, np.int32)),
                fingerprint=key,
                keep=1,
                extra_header={
                    "entry": {
                        "cost": float(entry.cost),
                        "certified_gap": (
                            None
                            if entry.certified_gap is None
                            else float(entry.certified_gap)
                        ),
                        "tier": str(entry.tier),
                    }
                },
            )
        except (OSError, TransientFault):
            # a failed publish is a dropped put (same degrade as the L1
            # cache.put seam): the next solve of the instance retries it
            self._count("dropped_puts", "put", "dropped")
            return
        self._count("publishes", "put", "published")

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self._counts)


def _decode(header: Optional[Dict], payload: bytes, key: str) -> CacheEntry:
    """Entry file image -> CacheEntry; raises on any malformed field (the
    caller treats that as corrupt-skipped, not an error response)."""
    import io

    if header is None or header.get("fingerprint") != key:
        raise ValueError("entry header missing or keyed to a different instance")
    meta = header.get("entry")
    if not isinstance(meta, dict):
        raise ValueError("entry metadata block missing")
    with np.load(io.BytesIO(payload)) as z:
        tour = np.asarray(z["tour"], np.int32)
    if tour.ndim != 1 or tour.shape[0] < 2 or tour[0] != tour[-1]:
        raise ValueError("entry tour is not a closed tour")
    gap = meta.get("certified_gap")
    return CacheEntry(
        cost=float(meta["cost"]),
        tour=tour,
        certified_gap=None if gap is None else float(gap),
        tier=str(meta["tier"]),
    )


class TieredSolutionCache(SolutionCache):
    """L1 in-process LRU over the shared L2 disk tier.

    ``get``: L1 first; an L1 miss consults the disk tier and PROMOTES a
    hit into L1 (so a restarted replica warm-fills from the fleet's
    collective work one key at a time). ``put``: L1 plus a disk publish,
    each guarded by its own better-entry policy. The service-level
    provenance ("hit") is tier-agnostic — a cross-replica disk hit looks
    exactly like a local one to the client."""

    def __init__(self, capacity: int, root: str) -> None:
        super().__init__(capacity)
        self.shared = SharedCacheTier(root)

    def get(self, key: str) -> Optional[CacheEntry]:
        entry = super().get(key)
        if entry is not None:
            return entry
        entry = self.shared.get(key)
        if entry is not None:
            try:
                super().put(key, entry)  # promote; fires the cache.put seam
            except TransientFault:
                pass  # a failed promotion must not turn the hit into a miss
        return entry

    def put(self, key: str, entry: CacheEntry) -> None:
        super().put(key, entry)
        self.shared.put(key, entry)

    def stats(self) -> Dict[str, int]:
        return dict(super().stats(), shared=self.shared.stats())

"""Bounded LRU solution cache (Clipper-style prediction cache, PAPERS.md).

The port's copy of ``tsp_mpi_reduction_tpu/serve/cache.py``, reporting into
the port's metrics registry and crossing the port's fault seams.

Keys are canonical instance digests (``serve.canonical``); values are
:class:`CacheEntry` — the solved cost, the CLOSED tour in *canonical* city
ids (so one cached solution serves every translated/permuted resubmission),
the certified optimality gap when a certificate exists, and the ladder tier
that produced it. Hit/miss/eviction counters feed the service's
machine-readable stats (``utils.reporting.service_stats_json``).

Thread-safe: every request thread of the service touches this cache
concurrently, so all state mutation happens under one lock (the critical
sections are O(1) dict operations — no solver work is ever done inside).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..obs.metrics import REGISTRY as _REGISTRY
from ..resilience.faults import registry as _fault_registry


@dataclass(frozen=True)
class CacheEntry:
    cost: float
    #: [n+1] CLOSED tour in canonical city ids (tour[0] == tour[-1])
    tour: np.ndarray
    #: certified optimality gap: 0.0 for a proven-optimal / exact answer,
    #: (cost - lower_bound) / lower_bound for a timed-out B&B certificate,
    #: None when the answering tier carries no certificate (heuristic rungs)
    certified_gap: Optional[float]
    tier: str

    def better_than(self, other: "CacheEntry") -> bool:
        """Replacement policy: a strictly cheaper tour always wins; at equal
        cost, an entry WITH a certificate beats one without, and a tighter
        certificate beats a looser one."""
        if self.cost < other.cost:
            return True
        if self.cost > other.cost:
            return False
        if self.certified_gap is None:
            return False
        return other.certified_gap is None or self.certified_gap < other.certified_gap


class SolutionCache:
    """Bounded LRU: ``get`` refreshes recency, ``put`` evicts the coldest
    entry past ``capacity``. A ``put`` for an existing key only replaces
    the stored entry when the new one is :meth:`CacheEntry.better_than`
    the old — a later greedy answer (tight deadline) must never clobber a
    cached certified optimum for the same instance."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Optional[CacheEntry]:
        # fault seam OUTSIDE the lock (a delay-mode fault must not wedge
        # every other request thread); the service absorbs transient
        # lookup faults by retrying, then degrades to a cache miss
        _fault_registry().fire("cache.get")
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        _REGISTRY.inc(
            "serve_cache_lookups_total",
            result="miss" if entry is None else "hit",
        )
        return entry

    def put(self, key: str, entry: CacheEntry) -> None:
        _fault_registry().fire("cache.put")
        evicted = 0
        with self._lock:
            old = self._entries.get(key)
            if old is None or entry.better_than(old):
                self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
        if evicted:
            _REGISTRY.inc("serve_cache_evictions_total", evicted)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "size": len(self._entries),
                "capacity": self.capacity,
            }

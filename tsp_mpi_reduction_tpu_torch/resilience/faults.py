"""Deterministic fault-injection registry: the ``TSP_FAULTS`` env hook.

The resilience subsystem's claims (crash-safe checkpoints, self-healing
serve loop) are only as good as the failures they were tested against, so
every durability/transfer boundary in the codebase carries a NAMED
injection seam, and this registry decides — deterministically — whether a
given crossing of a seam fails, and how. The chaos suite
(``tests/test_chaos.py``) is written entirely against this machinery: one
seam per run, seeded, reproducible.

Spec grammar (``TSP_FAULTS`` or :func:`configure`)::

    spec    = clause (";" clause)*
    clause  = seam ":" mode ("," key "=" value)*
    seam    = one of SEAMS (e.g. ckpt.write, sched.flush)
    mode    = raise | delay | truncate | corrupt
    keys    = nth=N       first seam hit to inject on (1-based, default 1)
              count=C     how many consecutive hits inject (default 1;
                          0 = every hit from nth on)
              at=K        byte offset for truncate/corrupt (default:
                          seeded pseudo-random per hit)
              seed=S      seeds the offset/byte choices (default 0)
              delay_ms=D  sleep for delay mode (default 50)

Examples::

    TSP_FAULTS="ckpt.write:truncate,nth=2,at=100"
    TSP_FAULTS="sched.flush:raise;cache.get:raise,count=3"

Modes:

``raise``
    raise :class:`FaultInjected` at the seam, before any work is done —
    models a crash/exception at the boundary (a killed writer, a failed
    readback, a dead worker thread).
``delay``
    sleep ``delay_ms`` then continue — models a stall (slow disk, a
    wedged device dispatch) for stuck-worker watchdog testing.
``truncate`` (byte seams only)
    the bytes crossing the seam are cut at a deterministic offset AND the
    crossing then raises — models a writer killed mid-write whose torn
    bytes still reached the final path (the legacy ``np.savez`` symptom).
    On pure control seams it degrades to ``raise``.
``corrupt`` (byte seams only)
    a few deterministically-chosen bytes are flipped and the crossing
    continues silently — models bit rot / a torn page that only a
    checksum can catch. On pure control seams it degrades to ``raise``.

Seams are crossed via :func:`fire` (control seams) or
:func:`filter_bytes` (byte seams); both count one hit per crossing, so
``nth`` is stable regardless of mode.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..obs import tracing as _tracing
from .health import HEALTH


def _trace_injection(seam: str, mode: str, hit: int) -> None:
    """Annotate the firing thread's active span (no-op without one): a
    chaos run's injected faults then appear as span events inside the
    very request/trace they hit, with matching trace IDs."""
    _tracing.add_event("fault_injected", seam=seam, mode=mode, hit=hit)

#: every registered injection seam — one per durability/transfer boundary.
SEAMS = frozenset(
    {
        "ckpt.write",   # checkpoint store: atomic publish of a snapshot
        "ckpt.read",    # checkpoint store: candidate read during restore
        "spill.fetch",  # reservoir spill: live-prefix device->host readback
        "ladder.rung",  # serve: one deadline-ladder rung attempt
        "cache.get",    # serve: solution-cache lookup
        "cache.put",    # serve: solution-cache insert
        "sched.flush",  # serve: micro-batch scheduler flush (worker body)
        # fleet seams — crossed by the FRONT once per dispatch
        # attempt, so ``nth`` counts dispatches fleet-wide. ``raise`` at
        # the replica seams is translated by the front into the real
        # action (SIGKILL / SIGSTOP of the target replica process) rather
        # than propagating — the injected failure is a dead/wedged
        # REPLICA, not a front crash; front.dispatch stays a normal
        # transient-fault seam absorbed by the dispatch retry.
        "replica.kill",   # fleet: kill the dispatch target mid-flight
        "replica.hang",   # fleet: wedge (SIGSTOP) the dispatch target
        "front.dispatch", # fleet: one front->replica dispatch attempt
        # adaptive balance: crossed host-side each time the
        # controller escalates to the steal collective; an injected fault
        # degrades that round to the base action (the solve stays exact —
        # balance only moves rows) and is counted in obs.balance
        "balance.steal",
    }
)

MODES = ("raise", "delay", "truncate", "corrupt")


class TransientFault(RuntimeError):
    """Base class for faults a bounded retry is allowed to absorb."""


class FaultInjected(TransientFault):
    """Raised by an armed seam; carries where/why for chaos assertions."""

    def __init__(self, seam: str, mode: str, hit: int):
        super().__init__(f"injected fault: seam={seam} mode={mode} hit={hit}")
        self.seam = seam
        self.mode = mode
        self.hit = hit


@dataclass
class FaultClause:
    seam: str
    mode: str
    nth: int = 1
    count: int = 1  # 0 = unbounded
    at: Optional[int] = None
    seed: int = 0
    delay_ms: float = 50.0

    def armed_for(self, hit: int) -> bool:
        """Does this clause inject on the ``hit``-th crossing (1-based)?"""
        if hit < self.nth:
            return False
        return self.count == 0 or hit < self.nth + self.count


def parse_spec(spec: str) -> List[FaultClause]:
    """Parse the ``TSP_FAULTS`` grammar; raises ValueError on any typo —
    a chaos run with a silently-ignored clause would test nothing."""
    clauses: List[FaultClause] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, _, tail = raw.partition(",")
        seam, sep, mode = head.partition(":")
        seam, mode = seam.strip(), mode.strip()
        if not sep or seam not in SEAMS or mode not in MODES:
            raise ValueError(
                f"bad TSP_FAULTS clause {raw!r}: want seam:mode[,k=v...] "
                f"with seam in {sorted(SEAMS)} and mode in {MODES}"
            )
        clause = FaultClause(seam=seam, mode=mode)
        if tail:
            for kv in tail.split(","):
                key, sep, val = kv.partition("=")
                key = key.strip()
                try:
                    if not sep:
                        raise ValueError("missing '='")
                    if key == "nth":
                        clause.nth = int(val)
                    elif key == "count":
                        clause.count = int(val)
                    elif key == "at":
                        clause.at = int(val)
                    elif key == "seed":
                        clause.seed = int(val)
                    elif key == "delay_ms":
                        clause.delay_ms = float(val)
                    else:
                        raise ValueError(f"unknown key {key!r}")
                except ValueError as e:
                    raise ValueError(
                        f"bad TSP_FAULTS clause {raw!r}: {e}"
                    ) from None
        if clause.nth < 1:
            raise ValueError(f"bad TSP_FAULTS clause {raw!r}: nth must be >= 1")
        clauses.append(clause)
    return clauses


class FaultRegistry:
    """Thread-safe seam hit counting + clause matching."""

    def __init__(self, spec: Optional[str] = None):
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._clauses: List[FaultClause] = parse_spec(spec) if spec else []

    def configure(self, spec: Optional[str]) -> None:
        """Replace the active clauses and reset every hit counter."""
        clauses = parse_spec(spec) if spec else []
        with self._lock:
            self._clauses = clauses
            self._hits = {}

    def clear(self) -> None:
        self.configure(None)

    def hits(self, seam: str) -> int:
        with self._lock:
            return self._hits.get(seam, 0)

    @property
    def active(self) -> bool:
        with self._lock:  # configure() swaps the clause list 
            return bool(self._clauses)

    def _cross(self, seam: str) -> Tuple[int, Optional[FaultClause]]:
        if seam not in SEAMS:
            raise ValueError(f"unregistered fault seam {seam!r}")
        with self._lock:
            hit = self._hits.get(seam, 0) + 1
            self._hits[seam] = hit
            for clause in self._clauses:
                if clause.seam == seam and clause.armed_for(hit):
                    return hit, clause
        return hit, None

    def fire(self, seam: str) -> None:
        """Cross a control seam: raise/sleep when an armed clause matches.
        ``truncate``/``corrupt`` clauses degrade to ``raise`` here — there
        are no bytes to mangle at a control seam.

        Fast path: with no clauses configured (every production run) the
        crossing is a lock-free membership check — hot serve seams
        (cache.get/put on every request across all threads) must not
        serialize on the registry lock for a no-op. Hit counters
        therefore only accumulate while a chaos spec is active."""
        if not self._clauses:
            if seam not in SEAMS:
                raise ValueError(f"unregistered fault seam {seam!r}")
            return
        hit, clause = self._cross(seam)
        if clause is None:
            return
        HEALTH.incr_fault(seam)
        _trace_injection(seam, clause.mode, hit)
        if clause.mode == "delay":
            time.sleep(clause.delay_ms / 1000.0)
            return
        raise FaultInjected(seam, clause.mode, hit)

    def filter_bytes(self, seam: str, blob: bytes) -> Tuple[bytes, Optional[str]]:
        """Cross a byte seam: returns ``(possibly-mangled blob, mode)``
        where mode is None (clean), "truncate", or "corrupt"; raises for a
        ``raise`` clause; sleeps-then-passes for ``delay``. Same lock-free
        no-clause fast path as :meth:`fire`."""
        if not self._clauses:
            if seam not in SEAMS:
                raise ValueError(f"unregistered fault seam {seam!r}")
            return blob, None
        hit, clause = self._cross(seam)
        if clause is None:
            return blob, None
        HEALTH.incr_fault(seam)
        _trace_injection(seam, clause.mode, hit)
        if clause.mode == "raise":
            raise FaultInjected(seam, clause.mode, hit)
        if clause.mode == "delay":
            time.sleep(clause.delay_ms / 1000.0)
            return blob, None
        rng = random.Random(f"{clause.seed}:{seam}:{hit}")
        if clause.mode == "truncate":
            cut = clause.at if clause.at is not None else rng.randrange(1, max(len(blob), 2))
            return blob[: max(0, min(cut, len(blob) - 1))], "truncate"
        # corrupt: flip a handful of deterministically-chosen bytes
        mutable = bytearray(blob)
        if mutable:
            flips = max(1, len(mutable) // 256)
            positions = (
                [clause.at % len(mutable)]
                if clause.at is not None
                else [rng.randrange(len(mutable)) for _ in range(flips)]
            )
            for pos in positions:
                mutable[pos] ^= 0xFF
        return bytes(mutable), "corrupt"


_REGISTRY: Optional[FaultRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> FaultRegistry:
    """The process-global registry, lazily initialized from ``TSP_FAULTS``."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = FaultRegistry(os.environ.get("TSP_FAULTS"))
    return _REGISTRY


def configure(spec: Optional[str]) -> None:
    """Programmatic chaos hook (tests): replace the global clause set."""
    registry().configure(spec)


def clear() -> None:
    registry().clear()

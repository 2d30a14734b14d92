"""fleet/: the serve layer across processes.

The port of ``tsp_mpi_reduction_tpu/fleet``: one front process
dispatching the serve JSONL contract across N supervised replica
subprocesses (the port's ``serve`` CLI), over a shared disk-backed
solution-cache tier:

- ``shared_cache``  the instance cache promoted to an L1 (in-proc LRU)
                    + L2 (atomic-publish disk entries) tier shared by
                    every replica and the front
- ``replica``       one serve subprocess: pipes, liveness evidence,
                    metrics scrape target
- ``supervisor``    liveness probing, bounded-backoff restart, death
                    hand-off (the scheduler watchdog at process
                    granularity)
- ``front``         deadline-capped dispatch + re-dispatch with
                    first-writer-wins, graceful degradation, ``fleet``
                    CLI mode

Chaos seams: ``replica.kill`` / ``replica.hang`` / ``front.dispatch``
(``resilience.faults``). Tracing: one stitched span tree per fleet
request via per-request ``trace_parent`` tokens + a shared sink.
"""

from .front import FleetConfig, FleetFront, FleetTicket, fleet_cli
from .replica import Replica, ReplicaSpec
from .shared_cache import SharedCacheTier, TieredSolutionCache
from .supervisor import ReplicaSupervisor, SupervisorConfig

__all__ = [
    "FleetConfig",
    "FleetFront",
    "FleetTicket",
    "fleet_cli",
    "Replica",
    "ReplicaSpec",
    "SharedCacheTier",
    "TieredSolutionCache",
    "ReplicaSupervisor",
    "SupervisorConfig",
]

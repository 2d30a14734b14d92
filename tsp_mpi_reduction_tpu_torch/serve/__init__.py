"""serve/: the batched solve service layer.

The port of ``tsp_mpi_reduction_tpu/serve``. Turns the batch-oriented
solver stack into a request-serving system (Clipper's prediction cache and
adaptive batching, ORCA's iteration-level scheduling):

- ``canonical``  translation/permutation/jitter-invariant instance keys
- ``cache``      bounded LRU of canonical solutions with certificates
- ``scheduler``  micro-batching: N pending solves -> one padded batched
                 Held-Karp call; B&B proofs in preemptible slices
- ``ladder``     deadline-aware degradation: bnb -> pipeline -> greedy
- ``service``    JSONL request/response loop + ``serve`` CLI mode
"""

from .cache import CacheEntry, SolutionCache
from .canonical import CanonicalInstance, canonicalize
from .ladder import TIERS, DeadlineLadder, LadderConfig, LadderResult
from .scheduler import MicroBatchScheduler
from .service import ServiceConfig, SolveService, run_jsonl, serve_cli

__all__ = [
    "CacheEntry",
    "SolutionCache",
    "CanonicalInstance",
    "canonicalize",
    "TIERS",
    "DeadlineLadder",
    "LadderConfig",
    "LadderResult",
    "MicroBatchScheduler",
    "ServiceConfig",
    "SolveService",
    "run_jsonl",
    "serve_cli",
]

"""Static analysis and runtime contracts of the port.

Counterpart of ``tsp_mpi_reduction_tpu/analysis``, re-targeted at the
torch/CUDA hazards of the port:

- ``graftlint``: stdlib-only per-node AST lint (rules R1-R8, R13) over the
  package: host syncs in hot loops, uploads, implicit ``Tensor.__bool__``,
  per-iteration launches, dropped state, non-atomic writes, the frontier's
  in-place contract, recording inside a CUDA-graph capture, unbounded
  metric labels.
- ``graftflow``: stdlib-only interprocedural dataflow lint (rules R9-R12)
  over the same surface: lock-discipline races, pointers that outlive
  their tensors, kernel launches off the current stream, collectives
  reached by only some ranks. Shares graftlint's disable-comment grammar
  and baseline file.
- ``contracts``: the shape/dtype/device contracts on the ``Frontier`` and
  ``PaddedTour`` boundaries, the reservoir exchange bound and the in-place
  check on the frontier buffer.

The CLI ``python -m tsp_mpi_reduction_tpu_torch.analysis`` runs BOTH static
passes against the one shared baseline; ``--json`` adds per-rule counts,
``--sarif PATH`` emits SARIF 2.1.0. The port's sweep runs it first.

``graftlint``/``graftflow`` must stay importable without torch (they run
before any device exists), so this package init deliberately does NOT
import ``contracts`` eagerly — import it as ``from
tsp_mpi_reduction_tpu_torch.analysis import contracts`` where needed.
"""

from .graftflow import (  # noqa: F401
    FLOW_RULES,
    flow_paths,
    flow_project,
    flow_text,
)
from .graftlint import (  # noqa: F401
    RULES,
    Violation,
    apply_baseline,
    lint_paths,
    lint_text,
    load_baseline,
    write_baseline,
)

"""In-place writes into the device frontier buffer.

Counterpart of ``tsp_mpi_reduction_tpu/perf/donation.py``. The node
buffer is the engine's dominant allocation (capacity + k*n padding rows of
packed int32, hundreds of MB at kroA100 scale). The JAX package runs its
spill writebacks under ``jit`` with the buffer donated, so XLA aliases the
output onto the input and writes only the updated rows. Torch has no
donation: these helpers write the rows into the buffer itself and return
that same allocation, which ``analysis.contracts.check_donated`` holds by
``data_ptr``. A row source on the host is uploaded by the copy (only the
written rows go up).
"""

from __future__ import annotations

import torch


def set_rows_donated(nodes: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``nodes[:rows.shape[0]] = rows`` in place; returns ``nodes``."""
    nodes[: rows.shape[0]].copy_(rows)
    return nodes


def set_rank_rows_donated(nodes: torch.Tensor, ridx: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """The sharded stack's write: ``block`` (``[len(ridx), t, width]``)
    into rank rows ``ridx`` at row prefix ``[:t]`` of the stacked
    ``[R, F, width]`` buffer, as one rectangular scatter in place; returns
    ``nodes``."""
    nodes[ridx, : block.shape[1]] = block
    return nodes

"""Polish of the merged tour (``--improve``).

Counterpart of ``tsp_mpi_reduction_tpu/parallel/seq_improve.py``, one
device: :func:`improve_tour` runs the local search's ``polish`` (2-opt and
Or-opt until neither improves) on the whole tour and re-measures its
length. The JAX package's ring improver ``ring_two_opt``, which shards the
tour over a device mesh, needs real ranks and is not ported yet: a mesh
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.local_search import polish, tour_length


def improve_tour(tour: torch.Tensor, d: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polish a closed tour given as its ``[N]`` open order on ``d`` ``[N, N]``
    -> (order', length').

    The length is re-measured from ``d``: unlike the reference's formulaic
    merge cost (SURVEY.md quirk #4) it is the true cost of the returned
    tour. ``mesh`` must be None (the ring improver is not ported yet).
    """
    if mesh is not None:
        raise ValueError("improve_tour on a device mesh (ring_two_opt) is not ported yet")
    order, _ = polish(tour.long()[None, :], d)
    return order[0], tour_length(order, d, closed=True)[0]

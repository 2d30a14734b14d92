"""Port parity of ``--improve`` (``parallel/seq_improve.improve_tour``)
against the JAX package, on the CPU.

- at ``10 6 500 500`` in float64, the merged tour polished by the port and
  by the JAX package: the same order element for element and the same
  length to 1e-12 relative;
- the CLI's ``--improve`` prints that re-measured cost, no more than the
  formulaic one, also with ``--ranks=P`` (one device polishes, as the JAX
  CLI does with fewer than P devices);
- a mesh that is not a rank group raises (the ring improver over rank
  groups is held to JAX in ``tests/test_torch_ring_improve.py``).
"""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.parallel import seq_improve as jseq
from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
from tsp_mpi_reduction_tpu_torch.parallel import seq_improve as tseq
from tsp_mpi_reduction_tpu_torch.utils import cli

#: the JAX CLI's ``10 6 500 500 --backend=cpu --dtype=float64 --improve``
JAX_IMPROVED_COST = "3536.044960"


def _cost(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue().strip().splitlines()[-1].rsplit(" ", 1)[-1]


def test_improve_tour_matches_jax_float64():
    res = run_pipeline(10, 6, 500, 500, dtype=torch.float64, device="cpu")
    order = res.tour_ids[:-1]
    d = res.dist.numpy()
    t_order, t_len = tseq.improve_tour(torch.as_tensor(order), res.dist)
    j_order, j_len = jseq.improve_tour(jnp.asarray(order, jnp.int32), jnp.asarray(d))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    assert abs(float(t_len) - float(j_len)) <= 1e-12 * float(j_len)
    assert float(t_len) <= res.cost
    assert sorted(t_order.tolist()) == list(range(60))


def test_cli_improve_prints_the_jax_cost():
    base = float(_cost(["10", "6", "500", "500", "--backend=cpu", "--dtype=float64"]))
    improved = _cost(["10", "6", "500", "500", "--backend=cpu", "--dtype=float64", "--improve"])
    assert improved == JAX_IMPROVED_COST and float(improved) <= base


def test_cli_improve_with_ranks_polishes_on_one_device():
    base = float(_cost(["10", "6", "500", "500", "--backend=cpu", "--ranks=3"]))
    assert float(_cost(["10", "6", "500", "500", "--backend=cpu", "--ranks=3", "--improve"])) <= base


def test_mesh_is_not_ported():
    d = torch.rand(8, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="rank group"):
        tseq.improve_tour(torch.arange(8), d, mesh=object())

"""The port's pipeline over real ranks (``models/distributed.run_pipeline_sharded``)
against the JAX package's ``run_pipeline_sharded`` on ``make_rank_mesh(P)``,
on the CPU in float64, exactly.

- P in {1, 3, 4} gloo processes (3 takes the reference tree's downshift
  round) at n = 5, 12 blocks, 1000x1000: the cost, the tour id for id and
  the block costs equal JAX's and the port's one-device
  ``run_pipeline_ranks``; so does ``BatchedRanks(P)`` in this process;
- one process at ``10 6 500 500`` gives the oracle's ``3720.557435`` and
  the golden tour;
- 4 processes over 3 blocks (an idle rank) give a valid tour equal to JAX's.

One group a rank count runs every case of that count.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_probes as probes
from tsp_mpi_reduction_tpu.models import distributed as jdist
from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh
from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_ranks, run_pipeline_sharded
from tsp_mpi_reduction_tpu_torch.parallel import mesh

SMALL = (5, 12, 1000, 1000, "float64")
ORACLE = (10, 6, 500, 500, "float64")
IDLE = (5, 3, 1000, 1000, "float64")
CASES = {1: [SMALL, ORACLE], 3: [SMALL], 4: [SMALL, IDLE]}


@pytest.fixture(scope="module")
def procs():
    return {p: mesh.spawn_ranks(probes.pipelines, p, args=(cases,), device="cpu", timeout_s=120.0)
            for p, cases in CASES.items()}


def _jax(p, case):
    n, nb, gx, gy, _ = case
    res = jdist.run_pipeline_sharded(n, nb, gx, gy, mesh=make_rank_mesh(p), dtype=jnp.float64)
    return res.cost, np.asarray(res.tour_ids), np.asarray(res.block_costs)


def _assert_same(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("p", [1, 3, 4])
def test_sharded_pipeline_equals_jax_and_one_device(procs, p):
    n, nb, gx, gy, dtype = SMALL
    got = procs[p][0]
    _assert_same(got, _jax(p, SMALL))
    one = run_pipeline_ranks(n, nb, gx, gy, p, dtype=dtype, device="cpu")
    _assert_same(got, (one.cost, one.tour_ids, one.block_costs))
    batched = run_pipeline_sharded(n, nb, gx, gy, mesh.BatchedRanks(p), dtype=dtype, device="cpu")
    _assert_same(got, (batched.cost, batched.tour_ids, batched.block_costs))
    assert sorted(got[1][:-1].tolist()) == list(range(n * nb)) and got[1][0] == got[1][-1]


def test_one_rank_is_the_oracle(procs, goldens_dir):
    g = json.loads((goldens_dir / "full_10x6_500x500.json").read_text())
    cost, ids, _ = procs[1][1]
    assert f"{cost:f}" == "3720.557435" and cost == g["final"]["cost"]
    np.testing.assert_array_equal(ids, g["final"]["ids"])


def test_idle_ranks_give_jax_tour(procs):
    got = procs[4][1]
    _assert_same(got, _jax(4, IDLE))
    assert sorted(got[1][:-1].tolist()) == list(range(15))

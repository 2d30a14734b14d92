"""The port's ring improver (``parallel/seq_improve.ring_two_opt``) against
the JAX package's ``ring_two_opt`` on ``make_rank_mesh(4)``, on the CPU in
float64, element for element.

- the merged tour of ``16 8 1000 1000`` (128 cities) improved under
  ``BatchedRanks(4)`` and over 4 gloo processes, at the default 2R rounds
  and at one round: the same order as JAX's, and no dearer than the input;
- ``improve_tour`` takes the ring branch on the group: JAX's order, and its
  length to 1e-12 relative;
- the shape errors (length not divisible, segments under 4 cities) raise
  with JAX's messages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_probes as probes
from tsp_mpi_reduction_tpu.parallel import seq_improve as jseq
from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh
from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
from tsp_mpi_reduction_tpu_torch.ops.local_search import tour_length
from tsp_mpi_reduction_tpu_torch.parallel import mesh

ROUNDS = (None, 1)


@pytest.fixture(scope="module")
def case():
    res = run_pipeline(16, 8, 1000, 1000, dtype=torch.float64, device="cpu")
    tour, d = res.tour_ids[:-1].astype(np.int64), res.dist.numpy()
    assert tour.shape == (128,)
    procs = mesh.spawn_ranks(probes.rings, 4, args=(tour, d, ROUNDS), device="cpu", timeout_s=120.0)
    batched = probes.rings(mesh.BatchedRanks(4), tour, d, ROUNDS)
    return tour, d, procs, batched


def _jax_ring(tour, d, rounds):
    return np.asarray(jseq.ring_two_opt(jnp.asarray(tour, jnp.int32), jnp.asarray(d), make_rank_mesh(4),
                                        rounds=rounds))


@pytest.mark.parametrize("i", range(len(ROUNDS)))
def test_ring_equals_jax(case, i):
    tour, d, procs, batched = case
    want = _jax_ring(tour, d, ROUNDS[i])
    for got in (procs["ring"][i], batched["ring"][i]):
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(128))
    dt = torch.from_numpy(d)
    before = float(tour_length(torch.from_numpy(tour)[None], dt)[0])
    assert float(tour_length(torch.from_numpy(procs["ring"][i])[None], dt)[0]) <= before


def test_improve_tour_takes_the_ring_on_a_group(case):
    tour, d, procs, batched = case
    j_order, j_len = jseq.improve_tour(jnp.asarray(tour, jnp.int32), jnp.asarray(d), make_rank_mesh(4))
    for order, length in (procs["improve"], batched["improve"]):
        np.testing.assert_array_equal(order, np.asarray(j_order))
        assert abs(length - float(j_len)) <= 1e-12 * float(j_len)


def test_shape_errors_equal_jax(case):
    tour, d, procs, batched = case
    want = []
    for bad in (tour[:-1], tour[:12]):
        with pytest.raises(ValueError) as err:
            jseq.ring_two_opt(jnp.asarray(bad, jnp.int32), jnp.asarray(d), make_rank_mesh(4))
        want.append(str(err.value))
    assert procs["errors"] == batched["errors"] == want

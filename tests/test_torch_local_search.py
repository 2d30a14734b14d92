"""Port parity of the tour local search and the B&B incumbent.

The JAX package ``vmap``s one tour's ``while_loop``; the port runs a
``[B, n]`` batch in which finished tours freeze. Each tour must come out
exactly as JAX's (same moves, first-index ties), and the float32 move
sums bit for bit (same adds in the same order). Inputs: nearest-neighbour
tours and numpy-seeded permutations of embedded TSPLIB instances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.ops import local_search as jls
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import local_search as tls
from tsp_mpi_reduction_tpu_torch.utils import tsplib as ttsplib

INSTANCES = ["burma14", "ulysses16", "eil51"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small batched ops: one intra-op thread is fastest and keeps parallel
    test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tours(name, batch=6):
    d = jtsplib.embedded(name).distance_matrix()
    n = d.shape[0]
    rng = np.random.default_rng(n)
    nn = [jbb.nearest_neighbor_tour(np.asarray(d, np.float64), s)[:-1] for s in range(0, n, max(1, n // 3))]
    perms = [rng.permutation(n) for _ in range(batch - len(nn))]
    return d, np.stack(nn + perms).astype(np.int32)


def _jax_batch(fn, tours, d32):
    out = jax.vmap(lambda t: fn(t, d32))(jnp.asarray(tours))
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("name", INSTANCES)
@pytest.mark.parametrize("sweep", ["two_opt", "or_opt", "polish"])
def test_sweeps_match_jax(name, sweep):
    d, tours = _tours(name)
    d32 = np.asarray(d, np.float32)
    jfn = {"two_opt": jls.two_opt_sweep, "or_opt": jls.or_opt_sweep, "polish": jls.polish}[sweep]
    tfn = {"two_opt": tls.two_opt_sweep, "or_opt": tls.or_opt_sweep, "polish": tls.polish}[sweep]
    want_t, want_acc = _jax_batch(jfn, tours, jnp.asarray(d32))
    got_t, got_acc = tfn(torch.as_tensor(tours, dtype=torch.int64), torch.as_tensor(d32))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_acc.numpy().view(np.int32), want_acc.view(np.int32))


def test_open_two_opt_pins_the_endpoints():
    d, tours = _tours("ulysses16")
    d32 = jnp.asarray(np.asarray(d, np.float32))
    want = jax.vmap(lambda t: jls.two_opt_sweep(t, d32, closed=False))(jnp.asarray(tours))
    got = tls.two_opt_sweep(torch.as_tensor(tours).long(), torch.as_tensor(np.array(d32)), closed=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0][:, [0, -1]].numpy(), tours[:, [0, -1]])


def test_tour_length_matches_jax():
    d, tours = _tours("eil51")
    d64 = np.asarray(d, np.float64)
    want = [float(jls.tour_length(jnp.asarray(t), jnp.asarray(d64))) for t in tours]
    got = tls.tour_length(torch.as_tensor(tours).long(), torch.as_tensor(d64))
    np.testing.assert_array_equal(got.numpy(), want)  # integer lengths: exact in float64


@pytest.mark.parametrize("name", INSTANCES + ["berlin52"])
def test_strong_incumbent_matches_jax(name):
    d = jtsplib.embedded(name).distance_matrix()
    want = jbb.strong_incumbent(d, starts=16)
    got = tbb.strong_incumbent(ttsplib.embedded(name).distance_matrix(), starts=16, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[-1] == 0 and sorted(got[:-1]) == list(range(d.shape[0]))


@pytest.mark.parametrize("name", ["burma14", "ulysses16"])
def test_host_incumbent_matches_jax(name):
    d = jtsplib.embedded(name).distance_matrix()
    np.testing.assert_array_equal(tbb.strong_incumbent_host(d, starts=8, perturbations=3),
                                  jbb.strong_incumbent_host(d, starts=8, perturbations=3))

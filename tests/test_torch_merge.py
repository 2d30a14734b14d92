"""Port parity: the merge operator and the fold vs the oracle goldens and
the JAX package. Exact throughout: same distance values, same order of
additions, same first-index tie-break."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import merge as jmerge
from tsp_mpi_reduction_tpu_torch.ops import merge as tmerge
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
from tsp_mpi_reduction_tpu_torch.ops.held_karp import solve_blocks_from_dists
from tsp_mpi_reduction_tpu_torch.utils.state import padded_tour_from_numpy

CONFIGS = [
    "full_10x6_500x500.json",
    "full_5x10_1000x1000.json",
    "full_6x15_1000x1000.json",
    "full_5x50_1000x1000.json",
    "full_3x7_100x100.json",
    "full_4x9_1000x1000.json",
    "full_10x10_123x457.json",
    "full_13x4_1000x1000.json",
    "full_16x2_1000x1000.json",
]


def setup(goldens_dir, name):
    g = json.loads((goldens_dir / name).read_text())
    cfg = g["config"]
    n, b = cfg["ncpb"], cfg["nblocks"]
    _, xy = generate_instance(n, b, cfg["gx"], cfg["gy"])
    dist = torch.as_tensor(distance_matrix_np(xy.reshape(-1, 2)))
    costs, local = solve_blocks_from_dists(torch.as_tensor(distance_matrix_np(xy)))
    tours = local + (torch.arange(b, dtype=torch.int32) * n)[:, None]
    return g, n, b, dist, costs, tours


@pytest.mark.parametrize("name", CONFIGS)
def test_every_fold_cost_matches_golden(goldens_dir, name):
    g, n, b, dist, costs, tours = setup(goldens_dir, name)
    cap = b * n + 1
    acc = tmerge.make_padded(tours[0], n + 1, costs[0], cap)
    length = torch.tensor(n + 1, dtype=torch.int32)
    got = []
    for i in range(1, b):
        acc = tmerge.merge_tours(acc, tmerge.PaddedTour(tours[i], length, costs[i]), dist)
        got.append(float(acc.cost))
    assert got == g["fold_costs"]


@pytest.mark.parametrize("name", CONFIGS)
def test_fold_final_bit_exact(goldens_dir, name):
    g, n, b, dist, costs, tours = setup(goldens_dir, name)
    ids, length, cost = tmerge.fold_tours(tours, costs, dist)
    assert float(cost) == g["final"]["cost"]
    assert int(length) == len(g["final"]["ids"])
    assert ids[: int(length)].tolist() == g["final"]["ids"]
    assert ids.dtype == torch.int32 and length.dtype == torch.int32


def _random_case(rng, corrupted):
    n_ids = 9
    d = np.rint(distance_matrix_np(rng.uniform(0, 50, (n_ids, 2))))  # integer: ties
    l1 = int(rng.integers(3, 7))
    t1_open = rng.permutation(n_ids)[:l1]
    t1 = np.concatenate([t1_open, t1_open[:1]])
    if corrupted:  # --compat-bugs operand: two closed sub-tours back to back
        a = rng.permutation(n_ids)[: int(rng.integers(3, 5))]
        b = rng.permutation(n_ids)[: int(rng.integers(3, 5))]
        t2 = np.concatenate([a, a[:1], b, b[:1]])
    else:
        t2_open = rng.permutation(n_ids)[: int(rng.integers(3, 7))]
        t2 = np.concatenate([t2_open, t2_open[:1]])
    return d, t1, t2


@pytest.mark.parametrize("corrupted", [False, True])
def test_merge_matches_jax_on_random_tours(corrupted):
    rng = np.random.default_rng(11 + corrupted)
    for _ in range(25):
        d, t1, t2 = _random_case(rng, corrupted)
        cap1, cap2 = 20, 12  # fixed shapes: JAX reuses its compiled ops
        jm = jmerge.merge_tours(
            jmerge.make_padded(t1, len(t1), jnp.asarray(10.5), cap1),
            jmerge.make_padded(t2, len(t2), jnp.asarray(20.25), cap2),
            jnp.asarray(d),
        )
        t1p = np.pad(t1, (0, cap1 - len(t1)))
        t2p = np.pad(t2, (0, cap2 - len(t2)))
        tm = tmerge.merge_tours(
            padded_tour_from_numpy(t1p, len(t1), 10.5, "cpu"),
            padded_tour_from_numpy(t2p, len(t2), 20.25, "cpu"),
            torch.as_tensor(d),
        )
        np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
        assert int(tm.length) == int(jm.length)
        assert float(tm.cost) == float(jm.cost)


def test_fold_matches_jax_float32_random():
    """float32 fold from one float32 distance array: exact vs JAX."""
    rng = np.random.default_rng(3)
    n, b = 6, 7
    d32 = distance_matrix_np(rng.uniform(0, 100, (n * b, 2))).astype(np.float32)
    tours, costs = [], []
    for i in range(b):
        perm = rng.permutation(n) + i * n
        tours.append(np.concatenate([perm, perm[:1]]))
        costs.append(np.float32(d32[perm, np.roll(perm, -1)].sum()))
    tours, costs = np.stack(tours).astype(np.int32), np.asarray(costs, np.float32)
    j_ids, j_len, j_cost = jmerge.fold_tours(jnp.asarray(tours), jnp.asarray(costs), jnp.asarray(d32))
    t_ids, t_len, t_cost = tmerge.fold_tours(torch.as_tensor(tours), torch.as_tensor(costs), torch.as_tensor(d32))
    assert t_cost.dtype == torch.float32
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert int(t_len) == int(j_len) and float(t_cost) == float(j_cost)


def test_make_padded_rejects_oversized_and_zeroes_padding():
    with pytest.raises(ValueError):
        tmerge.make_padded(np.arange(10), 10, 0.0, capacity=5)
    t = tmerge.make_padded(np.array([4, 5, 6, 4, 9]), 4, 1.5, capacity=8)
    assert t.ids.tolist() == [4, 5, 6, 4, 0, 0, 0, 0]
    assert int(t.length) == 4 and float(t.cost) == 1.5

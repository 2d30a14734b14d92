"""Port parity of the tree-shaped folds against the JAX package, on the CPU.

- ``fold_tours_tree`` equals JAX's on the goldens' block tours in float64:
  the same ids, length and cost (``==``);
- ``fold_tours_tree_xy`` (swap costs from coordinates) equals
  ``fold_tours_tree`` (gathered from the matrix) on float32 inputs with an
  odd block count, and both equal JAX's;
- a batched merge equals the same merges one pair at a time.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import merge as jmerge
from tsp_mpi_reduction_tpu_torch.ops import merge as tmerge
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix, distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
from tsp_mpi_reduction_tpu_torch.ops.held_karp import solve_blocks_from_dists


def _golden_tours(goldens_dir, name):
    g = json.loads((goldens_dir / name).read_text())
    cfg = g["config"]
    n, b = cfg["ncpb"], cfg["nblocks"]
    _, xy = generate_instance(n, b, cfg["gx"], cfg["gy"])
    dist = distance_matrix_np(xy.reshape(-1, 2))
    costs, local = solve_blocks_from_dists(torch.as_tensor(distance_matrix_np(xy)))
    tours = local + (torch.arange(b, dtype=torch.int32) * n)[:, None]
    return n, b, dist, costs, tours


@pytest.mark.parametrize("name", ["full_5x10_1000x1000.json", "full_5x50_1000x1000.json"])
def test_tree_fold_matches_jax_float64(goldens_dir, name):
    n, b, dist, costs, tours = _golden_tours(goldens_dir, name)
    ids, length, cost = tmerge.fold_tours_tree(tours, costs, torch.as_tensor(dist))
    j_ids, j_len, j_cost = jax.jit(jmerge.fold_tours_tree)(
        jnp.asarray(tours.numpy()), jnp.asarray(costs.numpy()), jnp.asarray(dist))
    assert int(length) == int(j_len) == n * b + 1
    assert ids.shape[0] == np.asarray(j_ids).shape[0]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert float(cost) == float(j_cost)
    t = ids[: int(length)].numpy()
    assert t[0] == t[-1] and sorted(t[:-1].tolist()) == list(range(n * b))


def _float32_case(n, b, seed):
    rng = np.random.default_rng(seed)
    xy = torch.tensor(rng.uniform(0, 100, (n * b, 2)), dtype=torch.float32)
    dist = distance_matrix(xy)
    d = dist.numpy()
    tours, costs = [], []
    for i in range(b):
        perm = rng.permutation(n) + i * n
        perm = np.roll(perm, -int(np.argmin(perm)))
        tours.append(np.concatenate([perm, perm[:1]]))
        costs.append(np.float32(d[perm, np.roll(perm, -1)].sum()))
    return xy, dist, torch.tensor(np.stack(tours), dtype=torch.int32), torch.tensor(np.stack(costs))


@pytest.mark.parametrize("n,b", [(6, 7), (5, 13), (4, 2)])
def test_tree_fold_xy_equals_gather_fold_float32(n, b):
    xy, dist, tours, costs = _float32_case(n, b, seed=n * b)
    a_ids, a_len, a_cost = tmerge.fold_tours_tree(tours, costs, dist)
    x_ids, x_len, x_cost = tmerge.fold_tours_tree_xy(tours, costs, xy)
    assert int(a_len) == int(x_len) == n * b + 1
    assert torch.equal(a_ids, x_ids)
    assert a_cost.view(torch.int32) == x_cost.view(torch.int32)


def test_tree_fold_xy_matches_jax_float32():
    n, b = 6, 7
    xy, _, tours, costs = _float32_case(n, b, seed=n * b)
    x_ids, x_len, x_cost = tmerge.fold_tours_tree_xy(tours, costs, xy)
    j_ids, j_len, j_cost = jax.jit(jmerge.fold_tours_tree_xy)(
        jnp.asarray(tours.numpy()), jnp.asarray(costs.numpy()), jnp.asarray(xy.numpy()))
    np.testing.assert_array_equal(x_ids.numpy(), np.asarray(j_ids))
    assert int(x_len) == int(j_len) and float(x_cost) == float(j_cost)


def test_batched_merge_equals_pairwise():
    """One batched call over four pairs == four single merges."""
    xy, dist, tours, costs = _float32_case(5, 8, seed=4)
    length = torch.full((4,), 6, dtype=torch.int32)
    left = tmerge.PaddedTour(torch.nn.functional.pad(tours[0::2], (0, 5)), length, costs[0::2])
    right = tmerge.PaddedTour(tours[1::2], length, costs[1::2])
    for merge, ctx in ((tmerge.merge_tours, dist), (tmerge.merge_tours_xy, xy)):
        batch = merge(left, right, ctx)
        for i in range(4):
            one = merge(tmerge.PaddedTour(left.ids[i], left.length[i], left.cost[i]),
                        tmerge.PaddedTour(right.ids[i], right.length[i], right.cost[i]), ctx)
            assert torch.equal(batch.ids[i], one.ids)
            assert int(batch.length[i]) == int(one.length) and float(batch.cost[i]) == float(one.cost)

"""Port parity: glibc rand, instance generator and distances vs the JAX
package and the oracle goldens. Tolerance: exact unless stated."""

import json

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.ops import distance as jdistance
from tsp_mpi_reduction_tpu.ops import generator as jgen
from tsp_mpi_reduction_tpu.ops.rand import GlibcRand as JaxGlibcRand
from tsp_mpi_reduction_tpu_torch.ops import distance as tdistance
from tsp_mpi_reduction_tpu_torch.ops import generator as tgen
from tsp_mpi_reduction_tpu_torch.ops.rand import GlibcRand

GOLDEN_CONFIGS = [
    "full_10x6_500x500.json",
    "full_5x50_1000x1000.json",  # grid spill: 50 blocks -> 2x25
    "full_3x7_100x100.json",  # prime block count -> 7x1
    "full_4x9_1000x1000.json",  # perfect square -> 3x3
    "full_10x10_123x457.json",  # non-square grid dims
    "full_16x2_1000x1000.json",
]


def test_rand_matches_golden_stream(goldens_dir):
    golden = json.loads((goldens_dir / "glibc_rand_seed0.json").read_text())
    got = GlibcRand(golden["seed"]).fill(len(golden["values"]))
    np.testing.assert_array_equal(got, np.asarray(golden["values"]))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_rand_matches_jax_package(seed):
    ours, ref = GlibcRand(seed), JaxGlibcRand(seed)
    assert ours.fill(700).tolist() == ref.fill(700).tolist()
    assert [ours.next() for _ in range(50)] == [ref.next() for _ in range(50)]
    assert ours.frand(3.0, 9.5) == ref.frand(3.0, 9.5)


@pytest.mark.parametrize("name", GOLDEN_CONFIGS)
def test_generate_instance_matches_golden_and_jax(goldens_dir, name):
    g = json.loads((goldens_dir / name).read_text())
    cfg = g["config"]
    ids, xy = tgen.generate_instance(cfg["ncpb"], cfg["nblocks"], cfg["gx"], cfg["gy"])
    jids, jxy = jgen.generate_instance(cfg["ncpb"], cfg["nblocks"], cfg["gx"], cfg["gy"])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(xy, jxy)
    want = np.asarray([[[c[1], c[2]] for c in blk] for blk in g["blocks"]])
    np.testing.assert_array_equal(xy, want)
    assert list(tgen.get_blocks_per_dim(cfg["nblocks"])) == list(g["dims"])


@pytest.mark.parametrize("seed", [1, 7])
def test_generate_instance_other_seeds_match_jax(seed):
    a = tgen.generate_instance(7, 12, 640, 480, seed=seed)
    b = jgen.generate_instance(7, 12, 640, 480, seed=seed)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_blocks_per_dim_matches_jax():
    for nb in range(1, 130):
        assert tgen.get_blocks_per_dim(nb) == jgen.get_blocks_per_dim(nb)
        assert tgen.is_square(nb) == jgen.is_square(nb)


def test_distance_matrix_np_matches_jax():
    _, xy = tgen.generate_instance(9, 6, 500, 500)
    np.testing.assert_array_equal(
        tdistance.distance_matrix_np(xy.reshape(-1, 2)),
        jdistance.distance_matrix_np(xy.reshape(-1, 2)),
    )


def test_device_distance_matrix_float64_within_one_ulp_of_host():
    """Squares and sums are exact matches of numpy's; PyTorch's CPU sqrt is
    not always correctly rounded, so the tolerance is 1 ulp (this is why
    the parity path uses the host matrix)."""
    _, xy = tgen.generate_instance(8, 9, 1000, 1000)
    flat = xy.reshape(-1, 2)
    t = torch.as_tensor(flat)
    dx = t[:, None, 0] - t[None, :, 0]
    dy = t[:, None, 1] - t[None, :, 1]
    ndiff = flat[:, None, :] - flat[None, :, :]
    np.testing.assert_array_equal((dx * dx + dy * dy).numpy(), np.sum(ndiff * ndiff, axis=-1))
    got = tdistance.distance_matrix(t)
    np.testing.assert_array_max_ulp(got.numpy(), tdistance.distance_matrix_np(flat), maxulp=1)
    # batched [B, n, 2] form agrees with the flat one on each block
    blocks = tdistance.distance_matrix(torch.as_tensor(xy))
    assert blocks.shape == (9, 8, 8)
    np.testing.assert_array_max_ulp(blocks.numpy(), tdistance.distance_matrix_np(xy), maxulp=1)


def test_device_distance_matrix_float32_close_to_jax():
    """float32: JAX's compiled formula may contract to an FMA (1 ulp), so
    the tolerance is a few float32 ulps of the distance (rtol 1e-6)."""
    import jax.numpy as jnp

    _, xy = tgen.generate_instance(8, 9, 1000, 1000)
    flat = xy.reshape(-1, 2)
    got = tdistance.distance_matrix(torch.as_tensor(flat, dtype=torch.float32)).numpy()
    want = np.asarray(jdistance.distance_matrix(jnp.asarray(flat, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_edge_length_matches_distance_matrix():
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(0, 100, (12, 2)))
    d = tdistance.distance_matrix(pts)
    el = tdistance.edge_length(pts[:, None, :], pts[None, :, :])
    assert torch.equal(el, d)

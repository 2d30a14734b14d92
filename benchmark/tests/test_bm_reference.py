"""The plain reference: against brute force, the C++ oracle's captures in
``goldens/``, and its independence from the program."""

from __future__ import annotations

import ast
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import instances
from benchmark.reference import tsp as ref

ROOT = instances.ROOT
REF_DIR = os.path.join(ROOT, "benchmark", "reference")


def brute_force(d: np.ndarray) -> float:
    n = d.shape[0]
    best = np.inf
    for perm in itertools.permutations(range(1, n)):
        t = (0,) + perm + (0,)
        best = min(best, ref.tour_length(d, t))
    return best


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_held_karp_matches_brute_force(n):
    g = np.random.default_rng(n)
    xy = g.random((3, n, 2)) * 100
    d = ref.euclidean(xy)
    costs, tours = ref.held_karp(torch.as_tensor(d), torch.float64, tours=True, chunk=2)
    for b in range(3):
        want = brute_force(d[b])
        assert abs(float(costs[b]) - want) <= 1e-9 * want
        assert ref.closed_tour_ok(tours[b], np.arange(n), start=0)
        assert abs(ref.tour_length(d[b], tours[b]) - want) <= 1e-9 * want


def _golden(name):
    with open(os.path.join(ROOT, "goldens", name)) as f:
        g = json.load(f)
    cities = [c for blk in g["blocks"] for c in blk]
    xy = np.zeros((len(cities), 2))
    for cid, x, y in cities:
        xy[int(cid)] = (x, y)
    return g, xy


@pytest.mark.parametrize("name", ["full_10x6_500x500.json", "full_5x10_1000x1000.json",
                                  "full_16x2_1000x1000.json", "full_13x4_1000x1000.json"])
def test_fold_reproduces_the_oracle(name):
    """From the oracle's block tours, the reference's float64 fold gives
    the oracle's fold costs and final tour; its Held-Karp gives the
    oracle's block costs."""
    g, xy = _golden(name)
    sols = g["block_solutions"]
    tours = [np.asarray(s["ids"], np.int64) for s in sols]
    costs = [s["cost"] for s in sols]
    # numpy's square root is correctly rounded, as the oracle's is; torch's
    # vectorized CPU one can be an ulp off in float64
    dist = torch.as_tensor(ref.euclidean(xy))
    acc, acc_cost = tours[0], costs[0]
    for t, c, want in zip(tours[1:], costs[1:], g["fold_costs"]):
        acc, acc_cost = ref.merge(acc, acc_cost, t, c, dist)
        assert acc_cost == pytest.approx(want, rel=1e-12)
    assert acc.tolist() == g["final"]["ids"]
    n = g["config"]["ncpb"]
    blocks = np.stack([xy[np.asarray(t[:-1])[np.argsort(t[:-1])]] for t in tours])
    opt, _ = ref.held_karp(torch.as_tensor(ref.euclidean(blocks)), torch.float64)
    assert np.allclose(opt.numpy(), costs, rtol=1e-12)
    assert blocks.shape[1] == n


def test_euc_2d_matches_tsplib_and_copies_keep_distances():
    coords = instances.load_coords("benchmark/data/eil51.json")
    d = ref.euc_2d(coords)
    assert d.shape == (51, 51) and d[0, 1] == 12  # nint(sqrt(12^2 + 3^2))
    roots = set()
    for i in range(16):
        cp = instances.proof_copy(coords, instances.WINDOW, 2**31 + 5, i)
        assert sorted(cp.labels) == list(range(51))
        assert np.array_equal(cp.d, d[np.ix_(cp.labels, cp.labels)])
        assert np.array_equal(cp.xy, coords[cp.labels])
        roots.add(int(cp.labels[0]))
    assert len(roots) > 8  # the root is any city, not one kept
    again = instances.proof_copy(coords, instances.WINDOW, 2**31 + 5, 3)
    assert np.array_equal(again.labels, instances.proof_copy(coords, instances.WINDOW, 2**31 + 5, 3).labels)


def test_reduce_tree_is_the_reference_programs():
    assert ref.reduce_tree(1) == []
    assert ref.reduce_tree(4) == [[(1, 0), (3, 2)], [(2, 0)]]
    assert ref.reduce_tree(6) == [[(4, 0), (5, 1)], [(1, 0), (3, 2)], [(2, 0)]]
    assert ref.rank_block_counts(10, 4) == [2, 3, 3, 2]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    forbidden = {"tsp_mpi_reduction_tpu_torch", "tsp_mpi_reduction_tpu", "jax", "jaxlib", "flax"}
    for fname in os.listdir(REF_DIR):
        if fname.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(REF_DIR, fname))}
            assert not tops & forbidden, (fname, tops & forbidden)
    code = ("import sys, benchmark.reference.tsp, benchmark.checks; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & forbidden, loaded & forbidden


@pytest.mark.parametrize("ranks", [1, 4])
def test_checks_judge_the_reference_sound_and_a_broken_block_not(ranks):
    """The reference's own answer in float32, the configuration's precision,
    passes every pipeline check; one block tour broken fails ``block_bad``
    without stopping the check."""
    from benchmark import checks

    xy = instances.blocked_cities(5, 8, 100.0, 100.0, instances.WINDOW, 2**31 + 1, 0)
    limits = {"block_bad": 0, "block_cost_gap": 1e-5, "block_tour_gap": 1e-5, "block_tour_diff": 0,
              "final_bad": 0, "final_diff": 0, "final_cost_gap": 1e-5}
    ans = checks.control_pipeline(xy, ranks, torch.float32, "cpu")
    assert all(v <= lim for _, v, lim in checks.pipelines([ans], [xy], ranks, limits, "cpu"))
    broken = dict(ans, block_tours=ans["block_tours"].copy())
    broken["block_tours"][3, 2] = 99
    got = dict((k, v) for k, v, _ in checks.pipelines([broken], [xy], ranks, limits, "cpu"))
    assert got["block_bad"] == 1 and got["final_diff"] > 0


@pytest.mark.parametrize("ranks", [1, 4])
def test_checks_fold_the_references_tours_in_the_answers_direction(ranks):
    """Block tours reversed are the reference's tours; the final tour is
    judged against the reference's fold of its own tours, each run in the
    answer's direction. A block tour that is another tour counts in
    ``block_tour_diff`` and its excess length in ``block_tour_gap``."""
    from benchmark import checks

    xy = instances.blocked_cities(6, 8, 100.0, 100.0, instances.WINDOW, 2**31 + 2, 0)
    bsz, n, _ = xy.shape
    limits = {"block_bad": 0, "block_cost_gap": 1e-5, "block_tour_gap": 1e-5, "block_tour_diff": 0,
              "final_bad": 0, "final_diff": 0, "final_cost_gap": 1e-5}
    opt, tours = ref.held_karp(torch.as_tensor(ref.euclidean(xy)), torch.float64, tours=True)
    opt = opt.numpy()
    dist = ref.distances(xy.reshape(-1, 2), torch.float32, "cpu")

    def answer(block_tours):
        glob = list(block_tours + (np.arange(bsz) * n)[:, None])
        fold = ref.fold if ranks == 1 else lambda t, c, d: ref.blocked_ranks(t, c, d, ranks)
        tour, cost = fold(glob, list(opt), dist)
        return {"block_tours": block_tours, "block_costs": opt, "tour": tour, "cost": cost}

    flipped = tours.copy()
    flipped[::2] = flipped[::2, ::-1]
    got = {k: v for k, v, _ in checks.pipelines([answer(flipped)], [xy], ranks, limits, "cpu")}
    assert all(got[k] == 0 for k in ("block_bad", "block_tour_diff", "final_bad", "final_diff")), got
    assert max(got["block_cost_gap"], got["block_tour_gap"], got["final_cost_gap"]) < 1e-12, got
    # the answer's fold over the reference's tours in their own direction
    # differs from the reference's fold in the answer's direction
    stale = dict(answer(tours), block_tours=flipped)
    assert dict((k, v) for k, v, _ in checks.pipelines([stale], [xy], ranks, limits, "cpu"))["final_diff"] > 0
    other = flipped.copy()
    other[1, [2, 3]] = other[1, [3, 2]]
    got = {k: v for k, v, _ in checks.pipelines([answer(other)], [xy], ranks, limits, "cpu")}
    assert got["block_tour_diff"] == 1 and got["block_tour_gap"] > 0 and got["final_diff"] == 0

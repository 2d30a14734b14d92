"""Port parity of the serve layer's solution caches.

- ``serve.cache.SolutionCache``: the same hits, misses, evictions and
  eviction order under the same operations as the JAX package's, and the
  same better-entry policy;
- ``fleet.shared_cache.TieredSolutionCache``: an entry file written by
  either package is read by the other, and a torn one is a miss in both.
"""

import numpy as np
import pytest

from tsp_mpi_reduction_tpu.fleet import shared_cache as jshared
from tsp_mpi_reduction_tpu.serve import cache as jcache
from tsp_mpi_reduction_tpu_torch.fleet import shared_cache as tshared
from tsp_mpi_reduction_tpu_torch.serve import cache as tcache
from tsp_mpi_reduction_tpu_torch.serve import canonical as tcanon


# --------------------------------------------------------------------------- cache


def _entry(mod, cost, gap, tier, n=5):
    return mod.CacheEntry(cost=cost, tour=np.arange(n + 1, dtype=np.int32) % n,
                          certified_gap=gap, tier=tier)


#: one script of cache operations: (op, key, cost, gap, tier)
CACHE_SCRIPT = [
    ("put", "a", 10.0, None, "greedy"), ("put", "b", 9.0, 0.0, "pipeline"),
    ("get", "a"), ("get", "z"), ("put", "c", 8.0, 0.1, "bnb"),
    ("put", "a", 10.0, 0.0, "pipeline"), ("put", "a", 12.0, 0.0, "bnb"),
    ("get", "b"), ("put", "d", 7.0, None, "greedy"), ("get", "c"), ("get", "a"),
    ("put", "e", 6.0, 0.0, "pipeline"), ("get", "b"), ("get", "d"), ("get", "e"),
]


def _run_script(mod, capacity=3):
    c = mod.SolutionCache(capacity)
    seen = []
    for op in CACHE_SCRIPT:
        if op[0] == "put":
            c.put(op[1], _entry(mod, *op[2:]))
        else:
            e = c.get(op[1])
            seen.append(None if e is None else (e.cost, e.certified_gap, e.tier))
    return seen, c.stats(), list(c._entries)


def test_solution_cache_counters_and_eviction_order_match():
    got, want = _run_script(tcache), _run_script(jcache)
    assert got == want
    assert got[1]["evictions"] > 0 and got[1]["hits"] > 0 and got[1]["misses"] > 0
    with pytest.raises(ValueError):
        tcache.SolutionCache(0)


@pytest.mark.parametrize("a,b", [((10.0, None), (10.0, 0.0)), ((10.0, 0.2), (10.0, 0.1)),
                                 ((9.0, None), (10.0, 0.0)), ((10.0, 0.0), (10.0, None))])
def test_better_than_matches(a, b):
    ta, tb = _entry(tcache, *a, "pipeline"), _entry(tcache, *b, "pipeline")
    ja, jb = _entry(jcache, *a, "pipeline"), _entry(jcache, *b, "pipeline")
    assert (ta.better_than(tb), tb.better_than(ta)) == (ja.better_than(jb), jb.better_than(ja))


# --------------------------------------------------------------------------- shared tier


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_tiered_entry_crosses_packages(writer, tmp_path):
    """An entry published by one package's tier is a hit, field for field,
    in the other's; a weaker later publish keeps the better entry on disk."""
    root = str(tmp_path / "shared")
    mods = {"torch": (tshared, tcache), "jax": (jshared, jcache)}
    w_shared, w_cache = mods[writer]
    r_shared, r_cache = mods["jax" if writer == "torch" else "torch"]
    key = tcanon.canonicalize(np.random.default_rng(1).uniform(0, 1000, (7, 2))).key
    entry = w_cache.CacheEntry(cost=123.25, tour=np.array([0, 3, 1, 2, 6, 5, 4, 0], np.int32),
                               certified_gap=0.0, tier="pipeline")
    w_shared.TieredSolutionCache(4, root).put(key, entry)
    reader = r_shared.TieredSolutionCache(4, root)
    got = reader.get(key)
    assert got is not None
    assert (got.cost, got.certified_gap, got.tier) == (123.25, 0.0, "pipeline")
    np.testing.assert_array_equal(got.tour, entry.tour)
    assert reader.shared.stats()["hits"] == 1 and reader.stats()["size"] == 1  # promoted to L1
    worse = r_cache.CacheEntry(cost=130.0, tour=entry.tour, certified_gap=None, tier="greedy")
    reader.put(key, worse)
    assert reader.shared.stats()["kept_better"] == 1
    again = w_shared.TieredSolutionCache(4, root).get(key)
    assert (again.cost, again.tier) == (123.25, "pipeline")
    assert reader.get("0" * 32) is None


def test_tiered_torn_entry_reads_as_miss(tmp_path):
    root = tmp_path / "shared"
    key = "ab" * 16
    tshared.TieredSolutionCache(2, str(root)).put(key, _entry(tcache, 5.0, 0.0, "bnb"))
    path = root / (key + tshared.ENTRY_SUFFIX)
    path.write_bytes(path.read_bytes()[:-7])
    for mod in (tshared, jshared):
        tier = mod.TieredSolutionCache(2, str(root))
        assert tier.get(key) is None
        assert tier.shared.stats()["corrupt_skipped"] == 1

"""Port parity of the serve layer's canonical instance keys.

Keys, perm maps and quantized coordinates are byte-equal to the JAX
package's ``canonicalize`` on random instances, also through the
sort-skipping memo, and a cached tour relabels into any translated,
permuted resubmission the same way in both packages. Instances are made
with numpy from a seed; every comparison is exact.
"""

import numpy as np
import pytest

from tsp_mpi_reduction_tpu.serve import canonical as jcanon
from tsp_mpi_reduction_tpu_torch.serve import canonical as tcanon


def _xy(n, seed):
    return np.random.default_rng(seed).uniform(0, 1000, (n, 2))


def _same_canonical(got, want):
    assert got.key == want.key and got.n == want.n
    for f in ("perm", "inv_perm", "qxy"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16, 17, 64, 1024])
def test_keys_and_perm_maps_byte_equal(n):
    xy = np.rint(_xy(n, n) * 1e3) / 1e3  # on the key's grid: jitter stays invariant
    rng = np.random.default_rng(100 + n)
    # a translated, permuted, jittered resubmission, and a coarse grid with
    # quantization ties (lexsort's stable order decides those)
    moved = xy[rng.permutation(n)] + np.array([37.5, -12.25]) + rng.uniform(-1e-4, 1e-4, (n, 2))
    tied = np.round(xy / 100.0) * 100.0
    for inst in (xy, moved, tied):
        _same_canonical(tcanon.canonicalize(inst), jcanon.canonicalize(inst))
    assert tcanon.canonicalize(moved).key == tcanon.canonicalize(xy).key
    for step in (1e-3, 0.5):
        _same_canonical(tcanon.canonicalize(xy, step), jcanon.canonicalize(xy, step))


def test_canonical_memo_matches_and_counts():
    tmemo, jmemo = tcanon.CanonicalCache(capacity=2), jcanon.CanonicalCache(capacity=2)
    insts = [_xy(9, s) for s in range(3)]
    seq = [0, 0, 1, 2, 0, 2, 1, 1]
    for i in seq:
        got = tcanon.canonicalize_cached(insts[i] + 5.0 * i, tmemo)
        want = jcanon.canonicalize_cached(insts[i] + 5.0 * i, jmemo)
        _same_canonical(got, want)
    assert tmemo.stats() == jmemo.stats()
    _same_canonical(tcanon.canonicalize_cached(insts[0], None), jcanon.canonicalize(insts[0]))


def test_tour_relabel_and_length_match():
    n = 12
    xy = _xy(n, 5)
    tour = np.concatenate([np.random.default_rng(5).permutation(n), [0]])
    tour[-1] = tour[0]
    rng = np.random.default_rng(6)
    dup = xy[rng.permutation(n)] + 123.0
    ct, cj = tcanon.canonicalize(xy), jcanon.canonicalize(xy)
    canon_t = tcanon.to_canonical_tour(tour, ct)
    np.testing.assert_array_equal(canon_t, jcanon.to_canonical_tour(tour, cj))
    dt, dj = tcanon.canonicalize(dup), jcanon.canonicalize(dup)
    back = tcanon.from_canonical_tour(canon_t, dt)
    np.testing.assert_array_equal(back, jcanon.from_canonical_tour(canon_t, dj))
    assert back[0] == back[-1] and sorted(back[:-1].tolist()) == list(range(n))
    assert tcanon.tour_length_np(back, dup) == jcanon.tour_length_np(back, dup)


@pytest.mark.parametrize("bad", [np.zeros((0, 2)), np.zeros((3, 3)), np.array([[0.0, np.nan]])])
def test_validation_errors_match(bad):
    with pytest.raises(ValueError) as te:
        tcanon.canonicalize(bad)
    with pytest.raises(ValueError) as je:
        jcanon.canonicalize(bad)
    assert str(te.value) == str(je.value)

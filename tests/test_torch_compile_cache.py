"""The port's compile-once layer (``perf/compile_cache.py``), the merge
fold's step and the recompilation guard, against the JAX package, on the
CPU.

- the fold: ``_fold_step`` looped over the blocks equals the JAX
  ``fold_tours`` in ids, length and cost, bit for bit in float64 (the JAX
  block solve eager, in a fresh interpreter: ``tests/jax_fresh.py``);
- the store's bookkeeping: ``entry_key`` changes with each of its
  components, ``stats_dict()`` has exactly the JAX keys,
  ``resolve_cache_dir`` reads ``TSP_COMPILE_CACHE`` as the JAX one does;
- the guard: the JAX package's guard cases (``tests/test_graftlint.py``)
  on the port's guard, driven by entries whose ``_cache_size()`` the test
  sets, with the JAX guard's messages;
- on the CPU no graph is captured: the store hands back None and the fold
  runs its eager loop.

Capture and replay need a card: ``tests/test_torch_cuda_compile_cache.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax_fresh
from tsp_mpi_reduction_tpu.analysis import contracts as jcontracts
from tsp_mpi_reduction_tpu.perf import compile_cache as jcc
from tsp_mpi_reduction_tpu_torch.analysis import contracts
from tsp_mpi_reduction_tpu_torch.analysis import graftlint
from tsp_mpi_reduction_tpu_torch.obs.metrics import REGISTRY
from tsp_mpi_reduction_tpu_torch.ops import merge
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
from tsp_mpi_reduction_tpu_torch.ops.held_karp import solve_blocks_from_dists
from tsp_mpi_reduction_tpu_torch.perf import ascent_memo
from tsp_mpi_reduction_tpu_torch.perf import compile_cache as cc
from tsp_mpi_reduction_tpu_torch.serve.canonical import CanonicalCache, canonicalize

#: (cities a block, blocks, grid x, grid y): the goldens' 10 6 500 500 first
FOLD_CONFIGS = [(10, 6, 500, 500), (5, 10, 1000, 1000), (3, 7, 100, 100), (16, 9, 1000, 1000),
                (13, 4, 1000, 1000)]


@pytest.fixture(scope="module")
def jax_folds():
    return dict(zip(FOLD_CONFIGS, jax_fresh.call("fold_blocks_many", FOLD_CONFIGS)))


def _step_loop(tours, costs, dist):
    """``_fold_step`` looped over the blocks, as the eager path runs it."""
    b, l = tours.shape
    ids = torch.nn.functional.pad(tours[0], (0, b * (l - 1) + 1 - l))
    length = torch.full((), l, dtype=torch.int32)
    cost = costs[0].clone()
    step = torch.ones((), dtype=torch.int64)
    for _ in range(1, b):
        out = merge._fold_step(ids, length, cost, tours, costs, dist, step)
        assert out[0] is ids and out[1] is length and out[2] is cost  # in place
    assert int(step) == b
    return ids, length, cost


# -- the fold ------------------------------------------------------------------


@pytest.mark.parametrize("config", FOLD_CONFIGS, ids=lambda c: "x".join(map(str, c)))
def test_fold_step_loop_equals_the_jax_fold(jax_folds, config):
    want = jax_folds[config]
    tours, costs, dist = (torch.as_tensor(want[k]) for k in ("tours", "costs", "dist"))
    ids, length, cost = _step_loop(tours, costs, dist)
    assert cost.dtype == torch.float64 and ids.dtype == length.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want["ids"])
    assert int(length) == want["length"] and float(cost) == want["cost"]
    # the port's fold_tours (the CPU runs the same step eagerly) and its
    # own block solve of the same instance give the same fold
    got = merge.fold_tours(tours, costs, dist)
    assert torch.equal(got[0], ids) and int(got[1]) == want["length"] and float(got[2]) == want["cost"]
    n, nb, gx, gy = config
    _, xy = generate_instance(n, nb, gx, gy)
    c, local = solve_blocks_from_dists(torch.as_tensor(distance_matrix_np(xy)))
    np.testing.assert_array_equal((local + (torch.arange(nb, dtype=torch.int32) * n)[:, None]).numpy(),
                                  want["tours"])
    assert c.tolist() == want["costs"].tolist()


def test_the_goldens_fold_bit_for_bit(goldens_dir, jax_folds):
    import json

    g = json.loads((goldens_dir / "full_10x6_500x500.json").read_text())
    want = jax_folds[(10, 6, 500, 500)]
    ids, length, cost = _step_loop(*(torch.as_tensor(want[k]) for k in ("tours", "costs", "dist")))
    assert ids[: int(length)].tolist() == g["final"]["ids"] and float(cost) == g["final"]["cost"]


@pytest.mark.parametrize("setting", [None, "off"])
def test_the_cpu_fold_captures_nothing(monkeypatch, setting):
    """On the CPU, with the store on or off, the fold runs its eager loop:
    the store hands back no graph and counts nothing."""
    if setting is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cc.ENV_VAR, setting)
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, (24, 2))
    dist = torch.as_tensor(distance_matrix_np(xy))
    tours = torch.as_tensor(np.stack([np.r_[p, p[0]] for p in
                                      (rng.permutation(6) + 6 * i for i in range(4))]).astype(np.int32))
    costs = torch.as_tensor(rng.uniform(10, 20, 4))
    tours0, costs0 = tours.clone(), costs.clone()
    before = cc.stats_dict()
    with contracts.RecompilationGuard({"fold_tours": merge.FOLD}, limit=0):
        got = merge.fold_tours(tours, costs, dist)
    assert merge.FOLD.graph(got[0], got[1], got[2], tours, costs, dist) is None
    after = cc.stats_dict()
    assert (after["aot_hits"], after["aot_misses"]) == (before["aot_hits"], before["aot_misses"])
    want = _step_loop(tours, costs, dist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tours, tours0) and torch.equal(costs, costs0)  # the inputs are not written


def test_a_single_tour_fold_is_the_padded_tour():
    t = torch.tensor([[2, 0, 1, 2]], dtype=torch.int32)
    ids, length, cost = merge.fold_tours(t, torch.tensor([3.5]), torch.zeros(3, 3), capacity=6)
    assert ids.tolist() == [2, 0, 1, 2, 0, 0] and int(length) == 4 and float(cost) == 3.5


def test_strict_contracts_check_the_fold_at_its_boundary(monkeypatch):
    """Under ``TSP_CONTRACTS=strict`` the step checks metadata only; the
    value checks run where the fold starts and ends."""
    monkeypatch.setenv("TSP_CONTRACTS", "strict")
    seen = []
    real = contracts.check_padded_tour

    def spy(t, **kw):
        seen.append((kw.get("where"), kw.get("values", True)))
        return real(t, **kw)

    monkeypatch.setattr(contracts, "check_padded_tour", spy)
    tours = torch.tensor([[0, 1, 2, 0], [3, 4, 5, 3], [6, 7, 8, 6]], dtype=torch.int32)
    dist = torch.as_tensor(distance_matrix_np(np.random.default_rng(2).uniform(0, 9, (9, 2))))
    merge.fold_tours(tours, torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), dist)
    assert seen.count(("merge_tours.t1", False)) == seen.count(("merge_tours.t2", False)) == 2
    assert [w for w, v in seen if v] == ["make_padded", "fold_tours"]


# -- keys, settings, counters -----------------------------------------------------


def _key(**over):
    x = torch.zeros(4, 4, dtype=torch.float32)
    base = dict(name="entry", args=(x, torch.zeros(4, dtype=torch.int32)), statics={"k": 8, "n": 4},
                device="cuda:0", version="torch 2.9.0+cuda 12.8")
    base.update(over)
    return cc.entry_key(base["name"], base["args"], base["statics"], device=base["device"],
                        version=base["version"])


def test_key_stable_for_identical_config():
    assert _key() == _key()
    # the live defaults: the inputs' device and this runtime
    x = torch.zeros(3)
    assert cc.entry_key("e", (x,), {}) == cc.entry_key("e", (x,), {}, device="cpu",
                                                        version=cc.runtime_version())


@pytest.mark.parametrize("change", [
    {"name": "entry2"},
    {"args": (torch.zeros(8, 4), torch.zeros(4, dtype=torch.int32))},  # shape
    {"args": (torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, dtype=torch.int32))},  # dtype
    {"args": (torch.zeros(4, 4).t(), torch.zeros(4, dtype=torch.int32))},  # strides
    {"args": (torch.zeros(4, 4),)},  # input count
    {"statics": {"k": 16, "n": 4}},  # a static's value
    {"statics": {"k": 8, "n": 4, "push_block": 0}},  # the statics' set
    {"version": "torch 2.9.1+cuda 12.8"},  # torch
    {"version": "torch 2.9.0+cuda 12.9"},  # the CUDA runtime
    {"device": "cuda:1"},
], ids=["entry-name", "shape", "dtype", "strides", "input-count", "static-value", "static-set",
        "torch-version", "cuda-version", "device"])
def test_key_invalidates_on_any_config_change(change):
    assert _key(**change) != _key()


def test_key_takes_tensors_only():
    with pytest.raises(TypeError, match="tensors"):
        cc.entry_key("e", (torch.zeros(2), 3), {})


def test_stats_dict_has_exactly_the_jax_keys():
    assert set(cc.stats_dict()) == set(jcc.stats_dict())
    snap = cc.stats_dict()
    assert snap["aot_unsupported"] == 0 and snap["dir"] == ascent_memo.enabled_dir()
    assert snap["ascent_memo_hits"] == ascent_memo.STATS.snapshot()["ascent_memo_hits"]


def test_record_counts_and_mirrors_onto_the_registry():
    before = cc.stats_dict()
    reg = REGISTRY.value("compile_cache_outcomes_total", entry="probe_entry", outcome="miss")
    cc.STATS.record("probe_entry", "miss", 0.25)
    cc.STATS.record("probe_entry", "hit", 0.25)
    cc.STATS.record("probe_entry", "error")
    after = cc.stats_dict()
    assert after["aot_misses"] == before["aot_misses"] + 1
    assert after["aot_hits"] == before["aot_hits"] + 1
    assert after["aot_errors"] == before["aot_errors"] + 1
    e = after["entries"]["probe_entry"]
    assert e["hits"] >= 1 and e["misses"] >= 1 and e["errors"] >= 1
    assert REGISTRY.value("compile_cache_outcomes_total", entry="probe_entry", outcome="miss") == reg + 1
    assert REGISTRY.value("compile_seconds_total", entry="probe_entry", kind="saved") >= 0.25


def test_a_canonical_fast_path_hit_counts_a_saved_sort():
    cache = CanonicalCache()
    xy = np.random.default_rng(3).uniform(0, 100, (9, 2))
    before = cc.stats_dict()["canonical_sorts_saved"]
    q = np.round(xy * 4).astype(np.int64)
    cache.put(q, canonicalize(xy))
    assert cache.get(q) is not None
    assert cc.stats_dict()["canonical_sorts_saved"] == before + 1


@pytest.mark.parametrize("value", ["off", "0", "none", "disabled", "OFF", " off ", "", "/tmp/tsp_cc_dir"])
def test_resolve_cache_dir_reads_the_setting_as_the_jax_one(monkeypatch, value):
    monkeypatch.setenv(cc.ENV_VAR, value)
    assert cc.resolve_cache_dir() == jcc.resolve_cache_dir()
    assert cc.store_enabled() == (jcc.resolve_cache_dir() is not None)


def test_resolve_cache_dir_unset_is_each_packages_default(monkeypatch):
    """Unset, each package resolves to its own default directory: the JAX
    one under ``~/.cache``, the port's under its checkout's ``build/``
    (the port writes nothing outside its checkout)."""
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert jcc.resolve_cache_dir() == jcc.default_cache_dir()
    assert cc.resolve_cache_dir() == cc.default_cache_dir()
    assert cc.default_cache_dir().endswith("build/torch_cache") and cc.store_enabled()


def test_the_store_captures_from_cuda_tensors_only(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    x = torch.zeros(3)
    assert cc.aot_load_or_compile("e", lambda t: t + 1, (x,)) is None
    with pytest.raises(ValueError, match="CUDA"):
        cc.load_or_build("e", lambda t: t + 1, (x,))
    assert cc.GraphEntry("e", lambda t: t)._cache_size() == 0


def test_the_store_capture_region_passes_r8_without_a_waiver():
    rel = "tsp_mpi_reduction_tpu_torch/perf/compile_cache.py"
    src = (pathlib.Path(__file__).resolve().parent.parent / rel).read_text()
    waived = []
    assert graftlint.lint_text(src, rel, rules={"R8"}, waived=waived) == [] and waived == []
    assert 'capture_error_mode="thread_local"' in src and "graftlint: disable" not in src


def test_r8_reads_the_stores_capture_region():
    """A recording inside ``capture_region`` is a finding: the lint sees the
    store's capture, which replaces ``torch.cuda.graph``'s."""
    vs = graftlint.lint_text("""
from tsp_mpi_reduction_tpu_torch.perf import compile_cache
from tsp_mpi_reduction_tpu_torch.obs.metrics import REGISTRY

def capture(g, s, x):
    with compile_cache.capture_region(g, s):
        REGISTRY.inc("steps_total")
        return x + 1
""", "probe.py", rules={"R8"})
    assert [(v.scope, v.rule) for v in vs] == [("capture", "R8")]
    src = (pathlib.Path(__file__).resolve().parent.parent
           / "tsp_mpi_reduction_tpu_torch/perf/compile_cache.py").read_text()
    assert "with capture_region(graph, side):" in src and "torch.cuda.graph(" not in src


def _graph(key, nbytes):
    """A stand-in stored graph whose static buffers take ``nbytes``."""
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    return cc.CapturedGraph("probe", key, None, (buf,), (buf,), 0.01)


def test_a_graph_pins_its_inputs_and_its_own_outputs_once():
    a, b = torch.zeros(10, dtype=torch.float64), torch.zeros(3, dtype=torch.int32)
    out = torch.zeros(5, dtype=torch.float32)
    assert cc.CapturedGraph("p", "k", None, (a, b), (a, b), 0.0).nbytes == 80 + 12
    assert cc.CapturedGraph("p", "k", None, (a, b), (a, out), 0.0).nbytes == 80 + 12 + 20


@pytest.mark.parametrize("max_entries,max_bytes,sizes,kept", [
    (3, 1 << 20, [10, 10, 10, 10, 10], ["k2", "k3", "k4"]),  # the count bound
    (32, 25, [10, 10, 10], ["k1", "k2"]),  # the byte bound
    (32, 25, [10, 40], ["k1"]),  # the newest graph stays, alone, over the bound
    (32, 1 << 20, [10] * 16, [f"k{i}" for i in range(16)]),  # serve's 16 sizes all kept
])
def test_the_store_drops_the_least_recent_graph_past_either_bound(max_entries, max_bytes, sizes, kept):
    store = cc._GraphStore(max_entries, max_bytes)
    for i, n in enumerate(sizes):
        store.insert(f"k{i}", _graph(f"k{i}", n))
    assert list(store._graphs) == kept
    assert store.evictions == len(sizes) - len(kept) and store.nbytes() <= max(max_bytes, sizes[-1])


def test_a_lookup_makes_a_graph_the_most_recent():
    store = cc._GraphStore(2, 1 << 20)
    store.insert("a", _graph("a", 4))
    store.insert("b", _graph("b", 4))
    assert store.lookup("a") is not None and store.lookup("zz") is None
    store.insert("c", _graph("c", 4))
    assert list(store._graphs) == ["a", "c"]


def test_the_store_bounds_are_the_documented_ones():
    assert (cc.MAX_ENTRIES, cc.MAX_BYTES) == (32, 4 << 30)
    assert cc._STORE.max_entries == cc.MAX_ENTRIES and cc._STORE.max_bytes == cc.MAX_BYTES


# -- the recompilation guard ---------------------------------------------------------


class _Entry:
    """A stand-in store entry: its cache size is what the test sets."""

    def __init__(self, size=0):
        self.size = size

    def _cache_size(self):
        return self.size

    def call(self, new_key=False):
        self.size += int(new_key)


@pytest.mark.parametrize("guard", [contracts, jcontracts], ids=["port", "jax"])
def test_guard_passes_fixed_shape_loop(guard):
    f = _Entry(1)  # warmed up outside the guard
    with guard.RecompilationGuard({"f": f}, limit=0) as g:
        for _ in range(5):
            f.call()
    assert g.misses() == {"f": 0}


def test_guard_fails_loop_that_recaptures_every_call():
    msgs = []
    for guard in (contracts, jcontracts):
        f = _Entry(1)
        with pytest.raises(guard.RecompilationError, match="recompiled") as err:
            with guard.RecompilationGuard({"hot_loop": f}, limit=0):
                for _ in range(3):
                    f.call(new_key=True)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "hot_loop: 3 new compile(s) (budget 0)" in msgs[0]


def test_guard_budget_allows_intentional_first_capture():
    f = _Entry()
    with contracts.RecompilationGuard({"f": f}, limit=1):
        f.call(new_key=True)
        for _ in range(3):
            f.call()


def test_guard_rejects_an_entry_without_a_cache():
    for guard in (contracts, jcontracts):
        with pytest.raises(ValueError, match="_cache_size") as err:
            guard.RecompilationGuard({"plain": lambda x: x})
    assert str(err.value) == "not jitted callables (no _cache_size): plain"
    assert contracts.jit_cache_size(lambda x: x) is None
    assert contracts.jit_cache_size(merge.FOLD) == merge.FOLD._cache_size()


def test_guard_on_the_fold_entry():
    """The port's own entry point: a fixed-shape fold loop on the CPU
    captures nothing (the CPU runs the eager step)."""
    tours = torch.tensor([[0, 1, 2, 0], [3, 4, 5, 3]], dtype=torch.int32)
    dist = torch.as_tensor(distance_matrix_np(np.random.default_rng(1).uniform(0, 9, (6, 2))))
    with contracts.RecompilationGuard({"fold_tours": merge.FOLD}, limit=0) as g:
        for _ in range(4):
            merge.fold_tours(tours, torch.tensor([1.0, 2.0], dtype=torch.float64), dist)
    assert g.misses() == {"fold_tours": 0}


def test_guard_does_not_mask_region_exception():
    f = _Entry(1)
    with pytest.raises(RuntimeError, match="inner"):
        with contracts.RecompilationGuard({"f": f}, limit=0):
            f.call(new_key=True)  # a miss the guard would flag...
            raise RuntimeError("inner")  # ...but the real error wins


def test_recompilation_error_is_a_contract_error():
    assert issubclass(contracts.RecompilationError, contracts.ContractError)
    assert issubclass(contracts.RecompilationError, ValueError)

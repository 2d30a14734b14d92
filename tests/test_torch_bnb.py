"""Port parity of branch-and-bound, on the CPU, against the JAX package's
host loop (``solve(..., device_loop=False)``).

- bound tables: bit-exact float32 arrays and the same certified root bound;
- the packed frontier layout and its numpy/tensor helpers;
- one expansion step from one frontier carried across with
  ``utils.state``: the same count, overflow, incumbent and live rows;
- whole solves: the same proof, cost, node count and certified bound on
  the integer (TSPLIB) metrics, where every float32 value of the search is
  exact; on a non-integer metric only cost and proof are compared, since
  reductions may add in another order;
- the CLI entry point.

Inputs are embedded TSPLIB instances or made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.tools import bnb_solve
from tsp_mpi_reduction_tpu_torch.utils import state
from tsp_mpi_reduction_tpu_torch.utils import tsplib as ttsplib

BD_FIELDS = ("min_out", "bound_adj", "dbar", "pi", "slack", "ascent_step", "lam_budget")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The search is many small ops: one intra-op thread is fastest and
    keeps parallel test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dist(spec):
    return jtsplib.resolve_instance(spec).distance_matrix()


def _float_metric(n, seed=0):
    """A non-integer metric: plain Euclidean distances of random:N."""
    xy = jtsplib.resolve_instance(f"random:{n}:{seed}").coords
    return np.sqrt(((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# --------------------------------------------------------------------------- setup


@pytest.mark.parametrize("spec", ["burma14", "ulysses16", "random:20"])
@pytest.mark.parametrize("bound", ["one-tree", "min-out"])
def test_bound_setup_bit_exact(spec, bound):
    d = _dist(spec)
    want = jbb._bound_setup(d, bound, node_ascent=2)
    got = tbb._bound_setup(d, bound, node_ascent=2, device="cpu")
    for f in BD_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()), _bits(getattr(want, f)), err_msg=f)
    assert got.root_lb == want.root_lb and got.integral == want.integral


def test_bound_setup_non_integral_slack():
    d = _float_metric(18)
    want = jbb._bound_setup(d, "one-tree", node_ascent=2)
    got = tbb._bound_setup(d, "one-tree", node_ascent=2, device="cpu")
    assert not got.integral and float(got.slack) > 0
    for f in BD_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()), _bits(getattr(want, f)), err_msg=f)
    assert got.root_lb == want.root_lb


def test_tsplib_copy_matches():
    for name in ("burma14", "ulysses16", "eil51", "berlin52", "kroA100"):
        np.testing.assert_array_equal(ttsplib.embedded(name).distance_matrix(),
                                      jtsplib.embedded(name).distance_matrix())
    assert ttsplib.resolve_instance("random:20:3").name == jtsplib.resolve_instance("random:20:3").name


# --------------------------------------------------------------------------- layout


@pytest.mark.parametrize("n", [5, 16, 51, 200])
def test_packed_rows_match_jax(n):
    rng = np.random.default_rng(n)
    rows = 9
    path = rng.integers(0, n, size=(rows, n))
    w = (n + 31) // 32
    mask = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    depth = rng.integers(1, n, size=rows)
    cost, bound, smin = (rng.random(rows).astype(np.float32) * 1000 for _ in range(3))
    packed = tbb._pack_rows_np(path, mask, depth, cost, bound, smin)
    np.testing.assert_array_equal(packed, jbb._pack_rows_np(path, mask, depth, cost, bound, smin))
    got = tbb._unpack_rows_np(packed, n)
    want = jbb._unpack_rows_np(packed, n)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert tbb._layout(packed.shape[1]) == jbb._layout(packed.shape[1])
    fr = state.frontier_from_numpy(packed, rows, False, "cpu")
    np.testing.assert_array_equal(fr.path_view(n).numpy(), path)
    np.testing.assert_array_equal(fr.mask.numpy().view(np.uint32), mask)
    np.testing.assert_array_equal(fr.cost.numpy(), cost)
    pos = rng.integers(0, n, size=rows).astype(np.int32)
    np.testing.assert_array_equal(
        tbb._path_byte_get(fr.path_words, torch.as_tensor(pos)).numpy(),
        np.asarray(jbb._path_byte_get(jnp.asarray(packed[:, : tbb._path_words(n)]), jnp.asarray(pos))),
    )


def test_root_frontier_matches_jax():
    d = _dist("eil51")
    bd = jbb._bound_setup(d, "one-tree")
    min_out = np.asarray(bd.min_out, np.float64)
    want = jbb.make_root_frontier(51, 500, min_out, pad_rows=64)
    got = tbb.make_root_frontier(51, 500, min_out, device="cpu", pad_rows=64)
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    assert int(got.count) == 1 and not bool(got.overflow)


# --------------------------------------------------------------------------- one step


def _jax_state(d, bound, k, steps, ils_rounds=0):
    """Bound tables, incumbent and the frontier after ``steps`` JAX steps."""
    n = d.shape[0]
    bd = jbb._bound_setup(d, bound, node_ascent=2)
    tour = jbb.strong_incumbent(d, starts=16, perturbations=ils_rounds)
    ic = jnp.asarray(jbb.tour_cost(np.asarray(d, np.float64), tour), jnp.float32)
    fr = jbb.make_root_frontier(n, 4 * k * n, np.asarray(bd.min_out, np.float64), pad_rows=k * n)
    fr, ic, it, _ = jbb._expand_loop(
        fr, ic, jnp.asarray(tour, jnp.int32), jnp.asarray(d, jnp.float32), bd.min_out,
        bd.bound_adj, bd.dbar, bd.pi, bd.slack, bd.ascent_step, bd.lam_budget,
        k=k, n=n, inner_steps=steps, integral=bd.integral, use_mst=True, node_ascent=2,
        mst_kernel="prim", push_order="best-first", push_block=0, step_kernel="reference",
    )
    return bd, fr, ic, it


def _carry(bd, fr, ic, it):
    t_bd = state.bound_data_from_numpy(*(np.asarray(getattr(bd, f)) for f in BD_FIELDS),
                                       bd.root_lb, bd.integral, "cpu")
    t_fr = state.frontier_from_numpy(np.array(fr.nodes), int(fr.count), bool(fr.overflow), "cpu")
    return t_bd, t_fr, torch.tensor(float(ic), dtype=torch.float32), torch.as_tensor(np.array(it))


def _assert_step_equal(d, bd, fr, ic, it, k, **kw):
    n = d.shape[0]
    t_bd, t_fr, t_ic, t_it = _carry(bd, fr, ic, it)
    t_fr, t_ic, t_it, t_take = tbb._expand_step(
        t_fr, t_ic, t_it, torch.as_tensor(np.asarray(d, np.float32)), t_bd, k, n, **kw
    )
    j_fr, j_ic, j_it, stats = jbb._expand_step(
        fr, ic, it, jnp.asarray(d, jnp.float32), bd.min_out, bd.bound_adj, bd.dbar, bd.pi,
        bd.slack, bd.ascent_step, bd.lam_budget, k, n, bd.integral, kw["use_mst"],
        kw["node_ascent"], "prim", kw["push_order"], kw.get("push_block", 0), "reference",
    )
    cnt = int(j_fr.count)
    assert int(t_fr.count) == cnt and cnt > 0
    assert bool(t_fr.overflow) == bool(j_fr.overflow)
    assert int(t_take) == int(stats["popped"])
    assert float(t_ic) == float(j_ic)
    np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
    np.testing.assert_array_equal(t_fr.nodes[:cnt].numpy(), np.asarray(j_fr.nodes)[:cnt])


@pytest.mark.parametrize("push_order", ["best-first", "natural"])
@pytest.mark.parametrize("use_mst", [True, False], ids=["mst", "nomst"])
@pytest.mark.parametrize("node_ascent", [0, 2])
def test_expand_step_matches_jax(push_order, use_mst, node_ascent):
    d = _dist("ulysses16")
    bd, fr, ic, it = _jax_state(d, "min-out", k=32, steps=6)
    _assert_step_equal(d, bd, fr, ic, it, 32, use_mst=use_mst, node_ascent=node_ascent,
                       mst_kernel="prim", push_order=push_order)


def test_expand_step_capped_push_block_matches_jax():
    d = _dist("ulysses16")
    bd, fr, ic, it = _jax_state(d, "min-out", k=32, steps=6)
    _assert_step_equal(d, bd, fr, ic, it, 32, use_mst=True, node_ascent=2, mst_kernel="prim",
                       push_order="best-first", push_block=300)


def test_expand_step_one_tree_matches_jax():
    d = _dist("eil51")
    bd, fr, ic, it = _jax_state(d, "one-tree", k=64, steps=3, ils_rounds=0)
    _assert_step_equal(d, bd, fr, ic, it, 64, use_mst=True, node_ascent=2, mst_kernel="prim",
                       push_order="best-first")


def test_expand_step_non_integral_matches_jax():
    d = _float_metric(18)
    bd, fr, ic, it = _jax_state(d, "min-out", k=32, steps=4)
    _assert_step_equal(d, bd, fr, ic, it, 32, use_mst=True, node_ascent=0, mst_kernel="prim",
                       push_order="best-first")


def test_expand_step_kernel_name_on_cpu_is_the_plain_chain():
    d = _dist("ulysses16")
    bd, fr, ic, it = _jax_state(d, "min-out", k=32, steps=6)
    outs = []
    for mk in ("prim", "prim_chain"):
        t_bd, t_fr, t_ic, t_it = _carry(bd, fr, ic, it)
        outs.append(tbb._expand_step(t_fr, t_ic, t_it, torch.as_tensor(np.asarray(d, np.float32)), t_bd,
                                     32, 16, use_mst=True, node_ascent=2, mst_kernel=mk))
    assert torch.equal(outs[0][0].nodes, outs[1][0].nodes) and int(outs[0][0].count) == int(outs[1][0].count)


def test_eil51_first_dispatch_frontier_matches_jax():
    """eil51 at its full width (k = 1024, capacity 2^18): the frontier,
    incumbent and node count after the first 32 steps of the host loop."""
    d = _dist("eil51")
    n, k, cap = 51, 1024, 1 << 18
    bd = jbb._bound_setup(d, "one-tree", node_ascent=2)
    tour = jbb.strong_incumbent(d, starts=16)
    ic = jnp.asarray(jbb.tour_cost(np.asarray(d, np.float64), tour), jnp.float32)
    fr = jbb.make_root_frontier(n, cap, np.asarray(bd.min_out, np.float64), pad_rows=k * n)
    j_fr, j_ic, _, j_pop = jbb._expand_loop(
        fr, ic, jnp.asarray(tour, jnp.int32), jnp.asarray(d, jnp.float32), bd.min_out,
        bd.bound_adj, bd.dbar, bd.pi, bd.slack, bd.ascent_step, bd.lam_budget,
        k=k, n=n, inner_steps=32, integral=True, use_mst=True, node_ascent=2,
        mst_kernel="prim", push_order="best-first", push_block=0, step_kernel="reference",
    )

    t_bd = tbb._bound_setup(d, "one-tree", node_ascent=2, device="cpu")
    t_tour = tbb.strong_incumbent(d, starts=16, device="cpu")
    np.testing.assert_array_equal(t_tour, tour)
    t_fr = tbb.make_root_frontier(n, cap, t_bd.min_out.numpy().astype(np.float64), "cpu", k * n)
    t_ic = torch.tensor(tbb.tour_cost(np.asarray(d, np.float64), t_tour), dtype=torch.float32)
    t_fr, t_ic, _, t_pop, steps = tbb._expand_loop(
        t_fr, t_ic, torch.as_tensor(t_tour), torch.as_tensor(np.asarray(d, np.float32)), t_bd,
        k, n, 32, use_mst=True, node_ascent=2, mst_kernel="prim", push_order="best-first",
    )
    cnt = int(j_fr.count)
    assert steps == 32 and t_pop == int(j_pop) and int(t_fr.count) == cnt > 0
    assert float(t_ic) == float(j_ic)
    np.testing.assert_array_equal(t_fr.nodes[:cnt].numpy(), np.asarray(j_fr.nodes)[:cnt])


# --------------------------------------------------------------------------- whole solves


def _both(d, **kw):
    want = jbb.solve(d, device_loop=False, **kw)
    got = tbb.solve(d, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize(
    "spec,kw",
    [
        ("burma14", dict(capacity=1 << 14, k=64)),
        ("ulysses16", dict()),
        ("berlin52", dict()),
        ("ulysses16", dict(capacity=1 << 14, k=32, max_iters=400, bound="min-out", ils_rounds=0)),
        ("ulysses16", dict(capacity=1 << 14, k=32, max_iters=300, bound="min-out", ils_rounds=0,
                           push_order="natural", node_ascent=0)),
    ],
    ids=["burma14", "ulysses16", "berlin52", "ulysses16-minout", "ulysses16-natural"],
)
def test_solve_matches_jax(spec, kw):
    d = _dist(spec)
    want, got = _both(d, **kw)
    assert got.proven_optimal == want.proven_optimal
    assert got.cost == want.cost
    assert got.nodes_expanded == want.nodes_expanded
    assert got.iterations == want.iterations
    assert got.lower_bound == want.lower_bound
    assert got.root_lower_bound == want.root_lower_bound
    np.testing.assert_array_equal(got.tour, want.tour)
    assert got.mst_kernel == "prim"


def test_solve_non_integral_cost_and_proof():
    """A non-integer metric: float32 reductions may add in another order
    than XLA's, so only the proof and the optimum are compared."""
    d = _float_metric(18)
    want, got = _both(d, capacity=1 << 15, k=64)
    assert got.proven_optimal and want.proven_optimal
    assert got.cost == want.cost
    assert got.tour[0] == got.tour[-1] == 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(checkpoint_path="x.npz"),
        dict(resume_from="x.npz"),
        dict(ascent="device"),
        dict(mst_kernel="boruvka"),
    ],
    ids=["checkpoint", "resume", "ascent", "boruvka"],
)
def test_later_slices_raise_not_ported(kw):
    with pytest.raises(ValueError, match="not ported yet"):
        tbb.solve(_dist("burma14"), capacity=1 << 14, k=16, device="cpu", **kw)


def test_cli_proves_burma14_on_cpu(capsys):
    import json

    assert bnb_solve.main(["burma14", "--backend=cpu", "--k=64", "--capacity=16384"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["proven_optimal"] and out["cost"] == 3323.0 and out["optimal"]
    assert out["mst_kernel"] == "prim" and out["prim_chain_launches"] == 0
    assert out["step_kernel"] == "reference" and out["push_rows_launches"] == 0
    assert out["device_loop"] is False and out["reorder_every"] == 0
    for key in ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
                "spill_bytes_to_device"):
        assert out[key] == 0
    assert out["device"] == "cpu" and out["time_to_proof_s"] is not None
    for key in ("health", "compile_cache", "series", "anomalies", "rank_series", "obs"):
        assert out[key] is None


def test_cli_needs_a_gpu_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bnb_solve.main(["burma14"]) == 2
    assert "--backend=cpu" in capsys.readouterr().err


def test_cli_rejects_a_bad_instance(capsys):
    assert bnb_solve.main(["random:2", "--backend=cpu"]) == 2

"""Port parity of the fused B&B push (``push_rows``), on the CPU, against
the JAX package.

- ``push_rows_reference`` (the plain version the wrapper takes for CPU
  tensors) against ``expand_pallas.push_rows`` in Pallas interpret mode:
  the whole frontier buffer, bit for bit, with NaN, -0.0 and inf bit
  patterns in the float columns, under both push orders and at the edges
  (nothing pushed, everything pushed, a destination at row F-1);
- the wrapper's checks and its launch count;
- one fused expansion step against the JAX fused step;
- the budgeted eil51 and kroA100 solves of ``tests/test_expand_pallas.py``:
  fused == reference in the port == the JAX package.

Inputs are embedded TSPLIB instances or made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.ops import expand_pallas
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.utils import tsplib as jtsplib
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
from tsp_mpi_reduction_tpu_torch.utils import state

BD_FIELDS = ("min_out", "bound_adj", "dbar", "pi", "slack", "ascent_step", "lam_budget")
#: float32 bit patterns the float columns must carry through unchanged:
#: quiet NaN, NaN with a payload, -0.0, +inf, -inf
SPECIAL_BITS = np.array([0x7FC00000, 0x7FC00123, 0x80000000, 0x7F800000, 0xFF800000],
                        np.uint32).view(np.int32)


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path. Once ``compile_cache.enable()``
    has run in this process (an earlier test's serve CLI does), its
    solves would load whatever executables the shared AOT store holds,
    some compiled for an 8-device mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def push_inputs(n, k, order, case, seed):
    """A frontier buffer, k parent rows, dest and the three float columns
    (as float32 whose bits include the special patterns)."""
    rng = np.random.default_rng(seed)
    cols = ek.row_width(n)
    pw, w = (n + 3) // 4, (n + 31) // 32
    f_rows = k * n + 17
    nodes = rng.integers(-(2**31), 2**31, size=(f_rows, cols), dtype=np.int64).astype(np.int32)
    parents = rng.integers(-(2**31), 2**31, size=(k, cols), dtype=np.int64).astype(np.int32)
    parents[:, pw + w] = rng.integers(0, n + 3, size=k)  # depths, some past n - 1
    push = {"mixed": rng.random((k, n)) < 0.3, "none": np.zeros((k, n), bool),
            "all": np.ones((k, n), bool)}[case]
    n_push = int(push.sum())
    rank = np.zeros(k * n, np.int64)
    order_idx = np.flatnonzero(push.reshape(-1))
    if order == "best-first":
        order_idx = rng.permutation(order_idx)
    rank[order_idx] = np.arange(n_push)
    base = f_rows - n_push if case != "mixed" else int(rng.integers(0, f_rows - n_push + 1))
    parked = rng.integers(f_rows, f_rows + 50, size=k * n)  # >= F: not stored
    dest = np.where(push.reshape(-1), base + rank, parked).reshape(k, n).astype(np.int32)
    floats = []
    for _ in range(3):
        bits = rng.integers(-(2**31), 2**31, size=(k, n), dtype=np.int64).astype(np.int32)
        pos = rng.integers(0, k * n, size=len(SPECIAL_BITS))
        bits.reshape(-1)[pos] = SPECIAL_BITS
        floats.append(bits.view(np.float32))
    return nodes, parents, dest, floats


def jax_push(nodes, parents, dest, floats, n):
    out = expand_pallas.push_rows(jnp.asarray(nodes), jnp.asarray(parents), jnp.asarray(dest),
                                  *(jnp.asarray(f) for f in floats), n, interpret=True)
    return np.asarray(out)


def torch_push(nodes, parents, dest, floats, n, fn=ek.push_rows_reference):
    t_nodes = torch.from_numpy(nodes.copy())
    out = fn(t_nodes, torch.from_numpy(parents), torch.from_numpy(dest),
             *(torch.from_numpy(f) for f in floats), n)
    assert out is t_nodes  # in place
    return out.numpy()


@pytest.mark.parametrize("order", ["natural", "best-first"])
@pytest.mark.parametrize("n", [8, 33, 100])
def test_push_rows_reference_matches_pallas_whole_buffer(n, order):
    inputs = push_inputs(n, 5, order, "mixed", seed=n)
    np.testing.assert_array_equal(torch_push(*inputs, n), jax_push(*inputs, n))


@pytest.mark.parametrize("case", ["none", "all"])
def test_push_rows_reference_edges_match_pallas(case):
    """Nothing pushed (the buffer is untouched), and everything pushed with
    the last destination at row F - 1."""
    n = 33
    inputs = push_inputs(n, 3, "best-first", case, seed=7)
    got = torch_push(*inputs, n)
    np.testing.assert_array_equal(got, jax_push(*inputs, n))
    if case == "none":
        np.testing.assert_array_equal(got, inputs[0])
    else:
        assert int(inputs[2].max()) == inputs[0].shape[0] - 1


def test_push_rows_keeps_special_float_bits():
    n = 100
    nodes, parents, dest, floats = push_inputs(n, 4, "natural", "all", seed=3)
    got = torch_push(nodes, parents, dest, floats, n)
    flat = dest.reshape(-1)
    for col, f in zip((-3, -2, -1), floats):
        np.testing.assert_array_equal(got[flat, col], f.view(np.int32).reshape(-1))
    assert set(SPECIAL_BITS.tolist()) <= set(got[flat, -3:].reshape(-1).tolist())


def test_push_rows_on_cpu_is_the_plain_version_and_counts_nothing():
    n = 33
    inputs = push_inputs(n, 6, "best-first", "mixed", seed=11)
    ek.reset_launches()
    np.testing.assert_array_equal(torch_push(*inputs, n, fn=ek.push_rows), torch_push(*inputs, n))
    assert ek.LAUNCHES == {"push_rows": 0}


def test_push_rows_layout_constants_match_jax():
    assert ek.PATH_PACK == expand_pallas.PATH_PACK == tbb.PATH_PACK
    for n in (5, 33, 100, 200):
        np.testing.assert_array_equal(ek._set_bit_words(n), expand_pallas._set_bit_words(n))
        assert ek.row_width(n) == tbb._path_words(n) + (n + 31) // 32 + 4
    assert ek.row_width(51) == 19 and ek.row_width(100) == 33


def _bad_call(**override):
    n, k = 8, 2
    args = dict(nodes=torch.zeros((32, ek.row_width(n)), dtype=torch.int32),
                parents=torch.zeros((k, ek.row_width(n)), dtype=torch.int32),
                dest=torch.zeros((k, n), dtype=torch.int32),
                ccost=torch.zeros((k, n)), cbound=torch.zeros((k, n)), csum=torch.zeros((k, n)))
    args.update(override)
    ek.push_rows(args["nodes"], args["parents"], args["dest"], args["ccost"], args["cbound"],
                 args["csum"], n)


@pytest.mark.parametrize(
    "override,match",
    [
        (dict(nodes=torch.zeros((32, 9), dtype=torch.int32)), "row width"),
        (dict(parents=torch.zeros((2, 9), dtype=torch.int32)), "parents"),
        (dict(dest=torch.zeros((2, 8), dtype=torch.int64)), "int32"),
        (dict(ccost=torch.zeros((2, 8), dtype=torch.float64)), "float32"),
        (dict(csum=torch.zeros((3, 8))), "ccost/cbound/csum"),
        (dict(dest=torch.zeros((2, 8), dtype=torch.int32, device="meta")), "one CUDA device"),
    ],
    ids=["width", "parents", "dest-dtype", "float-dtype", "shape", "mixed-device"],
)
def test_push_rows_wrapper_rejects(override, match):
    with pytest.raises(ValueError, match=match):
        _bad_call(**override)


# --------------------------------------------------------------------------- one fused step


def _instance(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    return np.rint(np.hypot(*(xy[:, None] - xy[None, :]).transpose(2, 0, 1)) * 10)


def _warm_state(d, k, push_order):
    """A mid-search JAX frontier: three reference steps from the root."""
    n = d.shape[0]
    bd = jbb._bound_setup(d, "one-tree", node_ascent=0, ascent="host")
    d64 = np.asarray(d, np.float64)
    tour = jbb.nearest_neighbor_tour(d64)
    ic = jnp.asarray(jbb.tour_cost(d64, tour), jnp.float32)
    it = jnp.asarray(tour, jnp.int32)
    fr = jbb.make_root_frontier(n, 1024, np.asarray(bd.min_out, np.float64), pad_rows=k * n)
    d32 = jnp.asarray(d, jnp.float32)
    for _ in range(3):
        fr, ic, it, _ = jbb._expand_step(fr, ic, it, d32, bd.min_out, bd.bound_adj, bd.dbar, bd.pi,
                                         bd.slack, bd.ascent_step, bd.lam_budget, k, n, bd.integral,
                                         False, 0, "prim", push_order, 0, "reference")
    return bd, fr, ic, it


@pytest.mark.parametrize("push_order", ["best-first", "natural"])
@pytest.mark.parametrize("n", [8, 33])
@pytest.mark.parametrize("use_mst", [False, True], ids=["nomst", "mst"])
def test_fused_step_matches_jax_fused_step(n, push_order, use_mst):
    d = _instance(n, seed=n)
    k = 8
    bd, fr, ic, it = _warm_state(d, k, push_order)
    t_bd = state.bound_data_from_numpy(*(np.asarray(getattr(bd, f)) for f in BD_FIELDS),
                                       bd.root_lb, bd.integral, "cpu")
    t_fr = state.frontier_from_numpy(np.array(fr.nodes), int(fr.count), bool(fr.overflow), "cpu")
    t_out = tbb._expand_step(t_fr, torch.tensor(float(ic)), torch.as_tensor(np.array(it)),
                             torch.as_tensor(np.asarray(d, np.float32)), t_bd, k, n, use_mst=use_mst,
                             node_ascent=0, push_order=push_order, step_kernel="fused")
    j_fr, j_ic, j_it, stats = jbb._expand_step(
        fr, ic, it, jnp.asarray(d, jnp.float32), bd.min_out, bd.bound_adj, bd.dbar, bd.pi, bd.slack,
        bd.ascent_step, bd.lam_budget, k, n, bd.integral, use_mst, 0, "prim", push_order, 0, "fused",
    )
    cnt = int(j_fr.count)
    assert int(t_out[0].count) == cnt > 0
    assert bool(t_out[0].overflow) == bool(j_fr.overflow)
    assert int(t_out[3]) == int(stats["popped"])
    assert float(t_out[1]) == float(j_ic)
    np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(j_it))
    np.testing.assert_array_equal(t_out[0].nodes[:cnt].numpy(), np.asarray(j_fr.nodes)[:cnt])


def test_fused_step_refuses_push_block_and_unknown_kernel():
    d = _instance(8, seed=1)
    bd, fr, ic, it = _warm_state(d, 4, "best-first")
    t_bd = state.bound_data_from_numpy(*(np.asarray(getattr(bd, f)) for f in BD_FIELDS),
                                       bd.root_lb, bd.integral, "cpu")
    t_fr = state.frontier_from_numpy(np.array(fr.nodes), int(fr.count), bool(fr.overflow), "cpu")
    args = (t_fr, torch.tensor(float(ic)), torch.as_tensor(np.array(it)),
            torch.as_tensor(np.asarray(d, np.float32)), t_bd, 4, 8)
    with pytest.raises(ValueError, match="push_block is a reference"):
        tbb._expand_step(*args, use_mst=False, push_block=16, step_kernel="fused")
    with pytest.raises(ValueError, match="unknown step_kernel"):
        tbb._expand_step(*args, use_mst=False, step_kernel="mosaic")
    with pytest.raises(ValueError, match="unknown step_kernel"):
        tbb._resolve_step_kernel("mosaic", "cpu")
    assert tbb._resolve_step_kernel("auto", "cpu") == "reference"
    assert tbb._resolve_step_kernel("auto", "cuda") == "fused"


# --------------------------------------------------------------------------- budgeted solves


def _solve_fields(res):
    return (res.cost, res.proven_optimal, res.nodes_expanded, res.iterations,
            res.lower_bound, res.lower_bound_raw, tuple(int(x) for x in res.tour))


@pytest.mark.parametrize(
    "spec,kw",
    [
        ("eil51", dict(capacity=1 << 12, k=64, inner_steps=8, max_iters=128, node_ascent=0,
                       ils_rounds=0)),
        ("kroA100", dict(capacity=1 << 12, k=16, inner_steps=4, max_iters=12, mst_prune=False,
                         node_ascent=0, ils_rounds=0)),
    ],
    ids=["eil51", "kroA100"],
)
def test_budgeted_solve_fused_equals_reference_equals_jax(spec, kw):
    d = jtsplib.embedded(spec).distance_matrix()
    want = jbb.solve(d, device_loop=False, step_kernel="reference", **kw)
    fused = tbb.solve(d, device="cpu", device_loop=False, step_kernel="fused", **kw)
    ref = tbb.solve(d, device="cpu", device_loop=False, step_kernel="reference", **kw)
    assert _solve_fields(fused) == _solve_fields(ref) == _solve_fields(want)
    assert fused.step_kernel == "fused" and ref.step_kernel == "reference"

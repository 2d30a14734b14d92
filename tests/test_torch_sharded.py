"""The port's sharded branch-and-bound (``solve_sharded``: R rank frontiers
stacked on one device) against the JAX package's ``solve_sharded`` on R
virtual CPU devices.

- every balance scheme (pair, ring, steal, adaptive) under the host loop
  (``tests/test_balance.py``'s ``_SOLVE_KW``) and the device loop (the
  graft entry's mesh run, min-out), with round-robin and single-rank
  seeding, under the fused and the reference push: cost, tour, proof,
  certified LB, nodes, per-rank nodes, iterations, every spill counter and
  the whole balance summary, exactly;
- spill-forcing runs (per-rank reservoirs exchanging and refilling) under
  both loops;
- the ``bnb.balance``, ``bnb.spill_round`` and ``bnb.reorder`` spans carry
  the JAX package's attributes and events, span for span;
- a 1-rank mesh launches no balance step;
- an injected ``balance.steal`` fault degrades as in JAX and the proof
  stays equal;
- sharded snapshots both ways: a JAX R=4 snapshot resumes in the port and
  a port R=4 snapshot (the JAX package's arrays, key for key) resumes in
  JAX, each to the other package's numbers and to the uninterrupted
  optimum; a chunked sharded proof equals JAX's chunk for chunk with a
  monotone certified LB;
- ``tools/bnb_solve random:12:7 --ranks=4`` has the JAX payload's keys and
  its timing-free values;
- a spent time limit stops after one round with a resumable snapshot.

Instances are rounded x10 Euclidean distances of points made with numpy
from a seed.
"""

import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.obs import tracing as jtracing
from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.resilience import checkpoint as jckpt
from tsp_mpi_reduction_tpu.resilience import faults as jfaults
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.obs import tracing as ttracing
from tsp_mpi_reduction_tpu_torch.parallel import balance as tbal
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the host loop: ``tests/test_balance.py``'s ``_SOLVE_KW``
HOST_KW = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
               node_ascent=0, device_loop=False, max_iters=2_000_000)
#: the device loop: the graft entry's mesh run (``__graft_entry__.py:96-99``)
#: under the weak bound of its checkpoint leg, so the tree is not trivial
DEVICE_KW = dict(capacity_per_rank=1 << 10, k=8, inner_steps=4, device_loop=True, reorder_every=8,
                 bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)
#: the spill-forcing run (``__graft_entry__.py:146-154``: device loop, a
#: capacity under the working set) with the mesh run's re-sort every 8
#: steps; without the re-sort the balance keeps every rank under the
#: guard and neither package spills
SPILL_KW = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=True, reorder_every=8,
                bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path: once ``compile_cache.enable()``
    has run in this process, its store can hand back executables compiled
    for another mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread_no_faults():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()
    torch.set_num_threads(before)


def random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _fields(res) -> dict:
    """Every timing-free field both packages report."""
    return dict(
        cost=res.cost, tour=[int(c) for c in res.tour], proven=res.proven_optimal,
        lb=res.lower_bound, lb_raw=res.lower_bound_raw, root_lb=res.root_lower_bound,
        nodes=res.nodes_expanded, per_rank=[int(x) for x in res.nodes_per_rank],
        iterations=res.iterations,
        spill=[res.spill_rounds, res.spill_events, res.spill_full_merges, res.spill_bytes_to_host,
               res.spill_bytes_to_device],
        balance=res.balance,
    )


def _both(d, ranks=4, step_kernel="reference", **kw):
    want = jbb.solve_sharded(d, make_rank_mesh(ranks), **kw)
    got = tbb.solve_sharded(d, ranks, device="cpu", step_kernel=step_kernel, **kw)
    return got, want


@pytest.mark.parametrize("seed_mode", ["round-robin", "single-rank"])
@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("balance", tbb.BALANCES)
def test_solve_sharded_equals_jax(balance, loop, seed_mode):
    d = random_d(10, 3)
    kw = dict(HOST_KW if loop == "host" else DEVICE_KW, balance=balance, seed_mode=seed_mode)
    # the port's two pushes share every screen and destination: each
    # (balance, loop) pair runs one of them per seeding
    kernel = "fused" if seed_mode == "round-robin" else "reference"
    got, want = _both(d, step_kernel=kernel, **kw)
    assert _fields(got) == _fields(want)
    assert got.proven_optimal and got.step_kernel == kernel and got.device_loop == (loop == "device")
    assert got.balance["mode"] == balance


@pytest.mark.parametrize("balance,kw,inst", [("adaptive", HOST_KW, (11, 1)), ("pair", SPILL_KW, (12, 7))],
                         ids=["host-adaptive", "device-pair"])
def test_spilling_sharded_solve_equals_jax(balance, kw, inst):
    got, want = _both(random_d(*inst), balance=balance, step_kernel="fused", **kw)
    assert _fields(got) == _fields(want)
    assert got.proven_optimal and got.spill_rounds > 0 and got.spill_events > 0


@pytest.mark.parametrize("read_steps", [1, 32, 256], ids=["every-round", "default", "long"])
def test_device_loop_reads_once_a_run_of_rounds_and_equals_jax(monkeypatch, read_steps):
    """The device loop's dispatch reads its counters once a run of rounds
    (``_SHARD_READ_STEPS`` steps, in whole rounds): every round, the
    default run, or a long one. Rounds issued past the stop change
    nothing: the same numbers as the JAX package's one-dispatch loop, with
    the steps issued past the stops bounded by a run a dispatch."""
    monkeypatch.setattr(tbb, "_SHARD_READ_STEPS", read_steps)
    kw = dict(SPILL_KW, balance="pair")
    got, want = _both(random_d(12, 7), step_kernel="fused", **kw)
    assert _fields(got) == _fields(want) and got.proven_optimal and got.spill_rounds > 0
    run = max(1, -(-read_steps // kw["inner_steps"])) * kw["inner_steps"]
    over = got.replays - got.iterations
    if read_steps == 1:
        assert over == 0
    assert 0 <= over <= (run - kw["inner_steps"]) * got.dispatches
    assert not got.step_graph and got.warm_steps == 0


def _bnb_spans(path):
    """The solve's ``bnb.*`` spans without ids and times."""
    return [(r["name"], r["attrs"], [(e["name"], e["attrs"]) for e in r["events"]])
            for r in jtracing.read_trace(path) if r["name"].startswith("bnb.")]


def test_balance_spill_and_reorder_spans_equal_jax(tmp_path):
    kw = dict(HOST_KW, balance="adaptive", reorder_every=4)
    d = random_d(11, 1)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jtracing.configure(jpath)
    try:
        jbb.solve_sharded(d, make_rank_mesh(4), **kw)
    finally:
        jtracing.configure(None)
    ttracing.configure(tpath)
    try:
        res = tbb.solve_sharded(d, 4, device="cpu", **kw)
    finally:
        ttracing.configure(None)
    got, want = _bnb_spans(tpath), _bnb_spans(jpath)
    assert got == want
    names = {g[0] for g in got}
    assert names == {"bnb.balance", "bnb.spill_round", "bnb.reorder"} and res.spill_rounds > 0


def test_one_rank_mesh_launches_no_balance_step(monkeypatch):
    def no_step(*a, **kw):
        raise AssertionError("a balance step ran on a 1-rank mesh")

    monkeypatch.setattr(tbal, "apply", no_step)
    d = random_d(9, 3)
    for mode in ("pair", "ring", "steal", "adaptive"):
        res = tbb.solve_sharded(d, 1, balance=mode, device="cpu", **HOST_KW)
        want = jbb.solve_sharded(d, make_rank_mesh(1), balance=mode, **HOST_KW)
        assert _fields(res) == _fields(want)
        assert res.proven_optimal
        assert res.balance["collective_dispatches"] == 0
        assert set(res.balance["actions"]) == {"skip"}
        assert res.balance["moved_rows_total"] == 0


def test_steal_fault_degrades_as_jax():
    spec = "balance.steal:raise,count=0"
    kw = dict(HOST_KW, balance="adaptive", seed_mode="single-rank")
    d = random_d(11, 2)
    jfaults.configure(spec)
    want = jbb.solve_sharded(d, make_rank_mesh(4), **kw)
    tfaults.configure(spec)
    got = tbb.solve_sharded(d, 4, device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert got.proven_optimal and got.balance["steal_degraded"] > 0
    assert got.balance["actions"].get("steal", 0) == 0
    assert tfaults.registry().hits("balance.steal") == jfaults.registry().hits("balance.steal") > 0


def _payload(path):
    """A snapshot's arrays (header checked by the JAX store)."""
    _, payload, _, _ = jckpt.read_with_fallback(path)
    z = np.load(io.BytesIO(payload))
    return {k: z[k] for k in z.files}


def test_sharded_snapshots_resume_both_ways(tmp_path):
    d = random_d(11, 2)
    kw = dict(HOST_KW, balance="pair")
    whole = jbb.solve_sharded(d, make_rank_mesh(4), **kw)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jpart = jbb.solve_sharded(d, make_rank_mesh(4), checkpoint_path=jpath, **dict(kw, max_iters=60))
    tpart = tbb.solve_sharded(d, 4, device="cpu", checkpoint_path=tpath, **dict(kw, max_iters=60))
    assert not jpart.proven_optimal and _fields(tpart) == _fields(jpart)
    # the same partial run writes the same snapshot, key for key and dtype for dtype
    jz, tz = _payload(jpath), _payload(tpath)
    assert sorted(jz) == sorted(tz) and int(tz["num_ranks"]) == 4
    for key in jz:
        assert jz[key].dtype == tz[key].dtype and np.array_equal(jz[key], tz[key]), key
    # JAX's snapshot resumed by the port, the port's resumed by JAX
    t_from_j = tbb.solve_sharded(d, 4, device="cpu", resume_from=jpath, **kw)
    j_from_j = jbb.solve_sharded(d, make_rank_mesh(4), resume_from=jpath, **kw)
    j_from_t = jbb.solve_sharded(d, make_rank_mesh(4), resume_from=tpath, **kw)
    assert _fields(t_from_j) == _fields(j_from_j) == _fields(j_from_t)
    for res in (t_from_j, j_from_t):
        assert res.proven_optimal and res.cost == whole.cost and res.lower_bound == whole.lower_bound
        assert list(res.tour) == list(whole.tour)
    with pytest.raises(ValueError, match="ranks"):
        tbb.solve_sharded(d, 2, device="cpu", resume_from=jpath, **kw)


def test_chunked_sharded_proof_equals_jax_and_stays_monotone(tmp_path):
    d = random_d(12, 33)
    kw = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False)
    ref = tbb.solve_sharded(d, 4, device="cpu", **kw)
    floors = {}
    for pkg in ("jax", "port"):
        ck = str(tmp_path / f"{pkg}.npz")
        floors[pkg] = []
        for chunk in range(60):
            resume = ck if chunk else None
            if pkg == "jax":
                res = jbb.solve_sharded(d, make_rank_mesh(4), max_iters=150, checkpoint_path=ck,
                                        resume_from=resume, **kw)
            else:
                res = tbb.solve_sharded(d, 4, device="cpu", max_iters=150, checkpoint_path=ck,
                                        resume_from=resume, **kw)
            floors[pkg].append((res.lower_bound, res.nodes_expanded, res.spill_rounds))
            if res.proven_optimal:
                break
        assert res.proven_optimal and res.cost == ref.cost and res.lower_bound == ref.lower_bound
        assert list(res.tour) == list(ref.tour)
    assert floors["port"] == floors["jax"] and len(floors["port"]) >= 2
    lbs = [f[0] for f in floors["port"]]
    assert lbs == sorted(lbs)


def test_cli_ranks_payload_equals_jax(capsys):
    argv = ["random:12:7", "--ranks=4", "--backend=cpu"]
    assert bnb_solve.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = importlib.util.spec_from_file_location("jax_bnb_solve", REPO / "tools" / "bnb_solve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from tsp_mpi_reduction_tpu.utils import tsplib

    inst = tsplib.resolve_instance("random:12:7")
    res = jbb.solve_sharded(inst.distance_matrix(), make_rank_mesh(4), capacity_per_rank=(1 << 17) // 4,
                            k=256)

    class Args:
        ranks = 4
        bound = "one-tree"
        mst_kernel = "prim"
        step_kernel = "reference"
        push_order = "best-first"
        push_block = 0
        balance = "pair"

    want = mod.result_payload(res, inst, Args())
    assert set(want) <= set(got)
    # the JAX block's XLA compile phases have no counterpart in the port;
    # device_costs has the JAX block's keys (no entry: the CPU launches no
    # kernel)
    assert set(want["obs"]) - {"compile_phases_s"} == set(got["obs"])
    assert set(got["obs"]["device_costs"]) == set(want["obs"]["device_costs"])
    timing = {"nodes_per_sec", "time_to_best_s", "wall_s", "setup_s", "setup_ascent_s",
              "setup_ils_s", "time_to_proof_s", "health", "compile_cache", "series", "anomalies",
              "obs"}
    for key in set(want) - timing:
        assert got[key] == want[key], key
    assert got["obs"]["balance"] == want["obs"]["balance"]
    # the telemetry blocks, their timing columns and clock-read events aside
    assert got["rank_series"] == want["rank_series"] and got["rank_series"]["ranks"] == 4
    assert got["obs"]["rank_balance"] == want["obs"]["rank_balance"]
    exact = [want["series"]["columns"].index(c) for c in ("step", "nodes", "frontier", "spill_to_host",
                                                          "spill_to_device", "incumbent", "lb_floor",
                                                          "reservoir")]

    def timing_free(series):
        return ({k: v for k, v in series.items() if k != "rows"},
                [[r[i] for i in exact] for r in series["rows"]])

    assert timing_free(got["series"]) == timing_free(want["series"])

    def clock_free(anomalies):
        return [e for e in anomalies["events"] if e["kind"] != "nodes_rate_collapse"]

    assert clock_free(got["anomalies"]) == clock_free(want["anomalies"])
    assert got["ranks"] == 4 and len(got["nodes_per_rank"]) == 4 and got["balance"] == "pair"


def test_cli_ranks_needs_a_gpu_unless_told_cpu(capsys):
    assert bnb_solve.main(["random:9", "--ranks=0", "--backend=cpu"]) == 2
    assert "--ranks" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bnb_solve.main(["eil51", "--ranks=8", "--k=128"]) == 2
    assert "--backend=cpu" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [HOST_KW, DEVICE_KW], ids=["host", "device"])
def test_time_limit_stops_after_one_round_with_a_snapshot(kw, tmp_path):
    """A spent clock stops the solve after its first dispatch, with the JAX
    package's numbers under the same limit. The host loop's dispatch is
    one round: it stops unproven, with a resumable snapshot whose resume
    lands on the uninterrupted optimum. The device loop sizes its dispatch
    by the clock as ``solve`` does (no measured rate yet: the first
    ``_FIRST_DISPATCH_STEPS`` steps' worth of rounds), which here ends at
    the proof."""
    d = random_d(11, 2)
    ck = str(tmp_path / "cut.npz")
    cut = tbb.solve_sharded(d, 4, device="cpu", time_limit_s=1e-9, checkpoint_path=ck, **kw)
    want = jbb.solve_sharded(d, make_rank_mesh(4), time_limit_s=1e-9, **kw)
    assert _fields(cut) == _fields(want) and cut.dispatches == 1
    if kw["device_loop"]:
        assert cut.proven_optimal and not cut.checkpoint_save_s
        assert kw["inner_steps"] < cut.iterations <= tbb._FIRST_DISPATCH_STEPS
        return
    assert not cut.proven_optimal and cut.iterations == kw["inner_steps"]
    assert cut.lower_bound <= cut.cost and len(cut.checkpoint_save_s) == 1
    whole = tbb.solve_sharded(d, 4, device="cpu", **kw)
    res = tbb.solve_sharded(d, 4, device="cpu", resume_from=ck, **kw)
    assert res.proven_optimal and (res.cost, res.lower_bound) == (whole.cost, whole.lower_bound)

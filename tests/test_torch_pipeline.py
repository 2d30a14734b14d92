"""Port parity for the whole slice: pipeline, rank emulation, reduce tree,
CLI, device selection and state carry, vs the JAX package and the oracle
goldens. Exact unless stated."""

import json
import subprocess
import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import distributed as jdist
from tsp_mpi_reduction_tpu.models import pipeline as jpipe
from tsp_mpi_reduction_tpu.ops import held_karp as jhk
from tsp_mpi_reduction_tpu.parallel import reduce as jreduce
from tsp_mpi_reduction_tpu.utils import cli as jcli
from tsp_mpi_reduction_tpu_torch.models import distributed as tdist
from tsp_mpi_reduction_tpu_torch.models import pipeline as tpipe
from tsp_mpi_reduction_tpu_torch.ops import held_karp as thk
from tsp_mpi_reduction_tpu_torch.parallel import reduce as treduce
from tsp_mpi_reduction_tpu_torch.utils import backend, state
from tsp_mpi_reduction_tpu_torch.utils import cli as tcli
from tsp_mpi_reduction_tpu_torch.utils import reporting as treporting
from tsp_mpi_reduction_tpu_torch.utils.profiling import PhaseTimer

ROOT = pathlib.Path(__file__).resolve().parent.parent

GOLDEN_RUNS = [
    "full_10x6_500x500.json",
    "full_5x50_1000x1000.json",
    "full_4x9_1000x1000.json",
    "full_13x4_1000x1000.json",
    "full_10x100_1000x1000.json",
]


@pytest.mark.parametrize("name", GOLDEN_RUNS)
def test_pipeline_bit_exact_vs_golden(goldens_dir, name):
    g = json.loads((goldens_dir / name).read_text())
    cfg = g["config"]
    res = tpipe.run_pipeline(cfg["ncpb"], cfg["nblocks"], cfg["gx"], cfg["gy"], device="cpu")
    assert res.cost == g["final"]["cost"]
    np.testing.assert_array_equal(res.tour_ids, g["final"]["ids"])
    assert res.num_cities == cfg["ncpb"] * cfg["nblocks"]
    assert res.block_costs.tolist() == [s["cost"] for s in g["block_solutions"]]


def test_make_run_cost_matches_jax():
    res = tpipe.run_pipeline(10, 6, 500, 500, device="cpu")
    ref = jpipe.run_pipeline(10, 6, 500, 500)
    assert f"{res.cost:f}" == "3720.557435"
    assert res.cost == ref.cost
    np.testing.assert_array_equal(res.tour_ids, ref.tour_ids)
    assert (res.dp_states, res.dp_transitions) == (ref.dp_states, ref.dp_transitions)
    assert set(res.phase_seconds) == {"generate", "distances", "solve", "merge_fold"}
    assert res.dist.dtype == torch.float64 and res.dist.device.type == "cpu"


def test_pipeline_float32_close_to_jax_float32():
    """float32 starts from device distances that JAX may compute with an
    FMA (1 ulp apart), so the final cost is compared at rtol 1e-5."""
    res = tpipe.run_pipeline(6, 8, 500, 500, dtype="float32", device="cpu")
    with jhk.use_impl("compact"):
        ref = jpipe.run_pipeline(6, 8, 500, 500, dtype=jnp.float32)
    assert res.cost == pytest.approx(ref.cost, rel=1e-5)
    assert sorted(res.tour_ids[:-1].tolist()) == list(range(48))


@pytest.mark.parametrize("p", [2, 3, 5])
@pytest.mark.parametrize("compat_bugs", [False, True])
def test_run_pipeline_ranks_matches_jax(p, compat_bugs):
    got = tdist.run_pipeline_ranks(5, 12, 300, 300, p, compat_bugs=compat_bugs, device="cpu")
    want = jdist.run_pipeline_ranks(5, 12, 300, 300, p, compat_bugs=compat_bugs)
    assert got.cost == want.cost
    np.testing.assert_array_equal(got.tour_ids, want.tour_ids)
    np.testing.assert_array_equal(got.block_costs, want.block_costs)


def test_ranks_one_equals_single_rank_oracle(goldens_dir):
    g = json.loads((goldens_dir / "full_10x6_500x500.json").read_text())
    res = tdist.run_pipeline_ranks(10, 6, 500, 500, 1, device="cpu")
    assert res.cost == g["final"]["cost"]
    np.testing.assert_array_equal(res.tour_ids, g["final"]["ids"])


def test_idle_ranks_still_reduce():
    res = tdist.run_pipeline_ranks(4, 5, 500, 500, 8, device="cpu")
    assert sorted(res.tour_ids[:-1].tolist()) == list(range(20))


def test_tree_helpers_match_jax():
    for p in range(1, 13):
        assert treduce.tree_schedule(p) == jreduce.tree_schedule(p)
        for nb in (1, 5, 12, 20):
            assert treduce.rank_block_counts(nb, p) == jreduce.rank_block_counts(nb, p)
            assert treduce.assign_blocks_to_ranks(nb, p) == jreduce.assign_blocks_to_ranks(nb, p)
            assert treduce.compat_capacity(nb, 4, p) == jreduce.compat_capacity(nb, 4, p)
            a, b = tdist._rank_block_layout(nb, p), jdist._rank_block_layout(nb, p)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_rejects_degenerate_configs():
    for args in [(2, 4), (1, 4), (5, 0), (19, 2)]:
        with pytest.raises(ValueError):
            tpipe.run_pipeline(args[0], args[1], 100, 100, device="cpu")
    with pytest.raises(ValueError):
        tdist.run_pipeline_ranks(2, 4, 100, 100, 2, device="cpu")


# --- CLI ---------------------------------------------------------------------


def _cli(capsys, main, argv):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out.strip().split("\n"), out.err


def _strip_ms(line):
    head, _, tail = line.partition(" ms ")
    return head.rsplit(" ", 1)[0] + " <ms> ms " + tail


@pytest.mark.parametrize("extra", [[], ["--ranks=4"], ["--ranks=3", "--compat-bugs"]])
def test_cli_lines_match_jax_cli(capsys, extra):
    argv = ["5", "10", "500", "500", "--backend=cpu", *extra]
    code, ours, _ = _cli(capsys, tcli.main, argv)
    jcode, theirs, _ = _cli(capsys, jcli.main, argv)
    assert code == jcode == 0
    assert ours[:2] == theirs[:2]
    assert _strip_ms(ours[2]) == _strip_ms(theirs[2])


def test_cli_make_run_line(capsys):
    code, lines, _ = _cli(capsys, tcli.main, ["10", "6", "500", "500", "--backend=cpu", "--impl=fused"])
    assert code == 0
    assert lines[0] == "We have 10 cities for each of our 6 blocks"
    assert lines[1] == "2 blocks in X 3 in Y"
    assert lines[2].startswith("TSP ran in ")
    assert lines[2].endswith(" ms for 60 cities and the trip cost 3720.557435")


def test_cli_metrics_json(capsys):
    code, _, err = _cli(capsys, tcli.main, ["5", "10", "500", "500", "--backend=cpu", "--metrics"])
    assert code == 0
    m = json.loads(err.strip().split("\n")[-1])
    assert m["config"]["numBlocks"] == 10 and m["config"]["impl"] == "compact"
    assert m["config"]["dtype"] == "float64" and m["dp_transitions"] > 0


def test_cli_wrong_arity_exit_1(capsys):
    code, lines, _ = _cli(capsys, tcli.main, ["10", "6"])
    assert code == 1
    assert lines == [treporting.usage_line()]


def test_cli_seventeen_cities_status_57():
    r = subprocess.run(
        [sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "17", "6", "500", "500", "--backend=cpu"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=120,
    )
    assert r.returncode == 57  # exit(1337) truncated by the OS, as the reference's
    assert "retry that with less than 16" in r.stdout


def test_cli_degenerate_blocks_exit_2(capsys):
    code, _, err = _cli(capsys, tcli.main, ["2", "6", "500", "500", "--backend=cpu"])
    assert code == 2 and "3 cities" in err


@pytest.mark.parametrize("flag", ["--backend=auto", "--backend=cuda"])
def test_cli_without_gpu_errors_instead_of_running_on_cpu(capsys, monkeypatch, flag):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, _, err = _cli(capsys, tcli.main, ["5", "4", "500", "500", flag])
    assert code == 2
    assert "CUDA" in err and "TSP ran in" not in capsys.readouterr().out


# --- device selection, state carry, timing -----------------------------------


def test_resolve_device_and_dtype_policy(monkeypatch):
    assert backend.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda"):
        with pytest.raises(RuntimeError):
            backend.resolve_device(name)
    with pytest.raises(ValueError):
        backend.resolve_device("tpu")
    assert backend.default_dtype("cpu") == torch.float64
    assert backend.default_dtype("cuda") == torch.float32
    assert backend.parse_dtype("float32") == torch.float32


def test_state_carries_numpy_inputs():
    from tsp_mpi_reduction_tpu.ops.distance import distance_matrix_np as jdnp

    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 300, (3, 5, 2))
    xy_t, dist = state.instance_from_numpy(xy, torch.float64, "cpu")
    assert xy_t.shape == (15, 2)
    np.testing.assert_array_equal(dist.numpy(), jdnp(xy.reshape(-1, 2)))
    _, d32 = state.instance_from_numpy(xy, torch.float32, "cpu")
    assert d32.dtype == torch.float32

    jplan = jhk.build_plan(7)
    plan = state.plan_from_numpy(
        jplan.n, jplan.scatter_idx, jplan.prev_idx, jplan.member, jplan.dp_states, jplan.dp_transitions
    )
    ours = thk.build_plan(7)
    for field in ("scatter_idx", "prev_idx", "member"):
        np.testing.assert_array_equal(getattr(plan, field), getattr(ours, field))
    assert (plan.n, plan.dp_states, plan.dp_transitions) == (ours.n, ours.dp_states, ours.dp_transitions)
    sc, pv, mem = state.plan_to_torch(plan, "cpu")
    assert sc.dtype == pv.dtype == torch.int64 and mem.dtype == torch.bool
    np.testing.assert_array_equal(pv.numpy(), jplan.prev_idx)

    t = state.padded_tour_from_numpy(np.array([3, 4, 5, 3, 0]), 4, 2.5, "cpu")
    assert t.ids.dtype == torch.int32 and int(t.length) == 4 and float(t.cost) == 2.5


def test_block_distance_slices_matches_jax():
    rng = np.random.default_rng(2)
    d = rng.uniform(size=(12, 12))
    got = tpipe.block_distance_slices(torch.as_tensor(d), 3, 4)
    want = jpipe.block_distance_slices(jnp.asarray(d), 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_phase_timer_accumulates():
    timer = PhaseTimer(device="cpu")
    with timer.phase("a"):
        pass
    with timer.phase("a"):
        pass
    timer.add("b", 0.5)
    snap = timer.snapshot()
    assert set(snap) == {"a", "b"} and snap["b"] == 0.5 and snap["a"] >= 0.0

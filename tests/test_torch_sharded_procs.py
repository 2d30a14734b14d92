"""The port's sharded branch-and-bound over real ranks: ``solve_sharded`` on
4 gloo processes (``ProcessRanks``) against the same solve with the 4 ranks
batched in this process (``BatchedRanks``), which ``tests/test_torch_sharded.py``
holds to the JAX package node for node. On the CPU, exactly.

- pair, ring, steal and adaptive under the host loop (``HOST_KW``,
  round-robin seeding) and the device loop (``DEVICE_KW``, single-rank
  seeding), the spill-forcing device loop (``SPILL_KW``) and a spilling
  host-loop adaptive solve: cost, tour, proof, certified LB, nodes, nodes
  per rank, iterations, rank-steps, every spill counter and the whole
  balance summary;
- snapshots cross every way: a procs snapshot equals the batched solve's
  array for array and resumes in the batched port and in JAX, a batched
  snapshot resumes over procs, each to the uninterrupted optimum;
- an injected ``balance.steal`` fault fires on rank 0 only, degrades as in
  the batched solve and the proof stays equal;
- a snapshot of another rank count is refused on every rank;
- a spent time limit stops every rank after the same first round, with
  one snapshot (rank 0's clock decides);
- ``tools/bnb_solve random:12:7 --ranks=4 --transport=procs`` prints the
  batched payload's timing-free values and its summed launch counts; under
  ``torchrun --standalone`` (2 processes) the CLI joins torchrun's group
  and rank 0 prints the batched payload's search numbers; each torchrun
  rank's solve runs on its ``LOCAL_RANK`` card, which it makes current.

All procs solves run in one group of 4 processes.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_rank_probes as probes
from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.resilience import checkpoint as jckpt
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.parallel import mesh
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.tools import bnb_solve
from tsp_mpi_reduction_tpu_torch.utils import tsplib

HOST_KW = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
               node_ascent=0, device_loop=False, max_iters=2_000_000)
DEVICE_KW = dict(capacity_per_rank=1 << 10, k=8, inner_steps=4, device_loop=True, reorder_every=8,
                 bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)
SPILL_KW = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=True, reorder_every=8,
                bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)
STEAL_FAULT = "balance.steal:raise,count=0"


def random_d(n, seed):
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _solve_cases(tmp):
    """name -> (d, kw, fault spec): every procs solve of this file."""
    cases = {}
    for bal in tbb.BALANCES:
        cases[f"host-{bal}"] = (random_d(10, 3), dict(HOST_KW, balance=bal), None)
        cases[f"device-{bal}"] = (random_d(10, 3), dict(DEVICE_KW, balance=bal, seed_mode="single-rank"), None)
    cases["spill-device-pair"] = (random_d(12, 7), dict(SPILL_KW, balance="pair"), None)
    cases["spill-host-adaptive"] = (random_d(11, 1), dict(HOST_KW, balance="adaptive"), None)
    cases["steal-fault"] = (random_d(11, 2), dict(HOST_KW, balance="adaptive", seed_mode="single-rank"),
                            STEAL_FAULT)
    for loop, kw in (("host", HOST_KW), ("device", DEVICE_KW)):
        cases[f"cut-{loop}"] = (random_d(11, 2), dict(kw, time_limit_s=1e-9,
                                                      checkpoint_path=str(tmp / f"cut-{loop}.npz")), None)
    snap = dict(HOST_KW, balance="pair")
    cases["snap-part"] = (random_d(11, 2), dict(snap, max_iters=60, checkpoint_path=str(tmp / "procs.npz")), None)
    cases["snap-from-batched"] = (random_d(11, 2), dict(snap, resume_from=str(tmp / "batched.npz")), None)
    return cases


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread_no_faults():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tfaults.clear()
    yield
    tfaults.clear()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every case in one 4-process group, after the batched snapshot that
    one case resumes."""
    tmp = tmp_path_factory.mktemp("procs")
    torch.set_num_threads(1)
    tbb.solve_sharded(random_d(11, 2), 4, device="cpu", checkpoint_path=str(tmp / "batched.npz"),
                      **dict(HOST_KW, balance="pair", max_iters=60))
    cases = _solve_cases(tmp)
    got = mesh.spawn_ranks(probes.sharded, 4, args=(list(cases.values()),), device="cpu", timeout_s=300.0)
    return tmp, cases, dict(zip(cases, got))


def _batched(d, kw, spec=None):
    tfaults.configure(spec)
    try:
        res = tbb.solve_sharded(d, 4, device="cpu", **kw)
        return probes._fields(res), tfaults.registry().hits("balance.steal")
    finally:
        tfaults.clear()


@pytest.mark.parametrize("name", [f"{loop}-{bal}" for loop in ("host", "device") for bal in tbb.BALANCES]
                         + ["spill-device-pair", "spill-host-adaptive"])
def test_procs_solve_equals_batched(procs, name):
    _, cases, got = procs
    d, kw, _ = cases[name]
    fields, _, its = got[name]
    want, _ = _batched(d, kw)
    assert fields == want
    assert fields["proven"] and its == [fields["iterations"]] * 4
    if name.startswith("spill"):
        assert fields["spill"][0] > 0 and fields["spill"][1] > 0


def test_steal_fault_fires_on_rank_zero_only(procs):
    _, cases, got = procs
    d, kw, spec = cases["steal-fault"]
    fields, hits, _ = got["steal-fault"]
    want, want_hits = _batched(d, kw, spec)
    assert fields == want and fields["proven"]
    assert fields["balance"]["steal_degraded"] > 0 and fields["balance"]["actions"].get("steal", 0) == 0
    assert hits == [want_hits, 0, 0, 0] and want_hits > 0


@pytest.mark.parametrize("loop,kw", [("host", HOST_KW), ("device", DEVICE_KW)])
def test_spent_time_limit_stops_every_rank_at_one_round(procs, loop, kw):
    """Every rank stops after the same first dispatch, rank 0's clock
    deciding: the host loop's one round, unproven with a snapshot; the
    device loop's dispatch sized by that clock, as the batched solve's."""
    tmp, cases, got = procs
    fields, _, its = got[f"cut-{loop}"]
    d_cut, kw_cut, _ = cases[f"cut-{loop}"]
    want, _ = _batched(d_cut, dict(kw_cut, checkpoint_path=str(tmp / f"cut-{loop}-batched.npz")))
    assert fields == want and its == [fields["iterations"]] * 4
    if loop == "device":
        assert fields["proven"] and fields["saves"] == 0
        return
    assert not fields["proven"] and its == [kw["inner_steps"]] * 4 and fields["saves"] == 1
    d = random_d(11, 2)
    whole = tbb.solve_sharded(d, 4, device="cpu", **kw)
    res = tbb.solve_sharded(d, 4, device="cpu", resume_from=str(tmp / f"cut-{loop}.npz"), **kw)
    assert res.proven_optimal and (res.cost, res.lower_bound) == (whole.cost, whole.lower_bound)


def _payload(path):
    _, payload, _, _ = jckpt.read_with_fallback(path)
    z = np.load(io.BytesIO(payload))
    return {k: z[k] for k in z.files}


def test_snapshots_cross_procs_batched_and_jax(procs):
    tmp, cases, got = procs
    d = random_d(11, 2)
    kw = dict(HOST_KW, balance="pair")
    whole = probes._fields(tbb.solve_sharded(d, 4, device="cpu", **kw))
    # the same partial run writes the same snapshot over procs and batched
    part, _, _ = got["snap-part"]
    assert not part["proven"] and part["saves"] == 1
    pz, bz = _payload(str(tmp / "procs.npz")), _payload(str(tmp / "batched.npz"))
    assert sorted(pz) == sorted(bz) and int(pz["num_ranks"]) == 4
    for key in bz:
        assert pz[key].dtype == bz[key].dtype and np.array_equal(pz[key], bz[key]), key
    # procs -> batched, procs -> JAX, batched -> procs: one and the same finish
    b_from_p = probes._fields(tbb.solve_sharded(d, 4, device="cpu", resume_from=str(tmp / "procs.npz"), **kw))
    j_from_p = jbb.solve_sharded(d, make_rank_mesh(4), resume_from=str(tmp / "procs.npz"), **kw)
    p_from_b, _, _ = got["snap-from-batched"]
    assert p_from_b == b_from_p
    assert (j_from_p.cost, j_from_p.lower_bound, j_from_p.nodes_expanded) == (
        b_from_p["cost"], b_from_p["lb"], b_from_p["nodes"])
    assert [int(x) for x in j_from_p.nodes_per_rank] == b_from_p["per_rank"]
    for res in (b_from_p, p_from_b):
        assert res["proven"] and (res["cost"], res["lb"], res["tour"]) == (whole["cost"], whole["lb"], whole["tour"])
    assert [int(c) for c in j_from_p.tour] == whole["tour"]


def _cli(argv, capsys):
    assert bnb_solve.main(argv) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    transport = [json.loads(x.split("transport: ", 1)[1]) for x in captured.err.splitlines()
                 if x.startswith("transport: ")]
    return line, transport[-1]


def test_cli_procs_payload_equals_batched(capsys):
    argv = ["random:12:7", "--ranks=4", "--backend=cpu"]
    want, w_info = _cli(argv, capsys)
    got, info = _cli(argv + ["--transport=procs"], capsys)
    timing = {"nodes_per_sec", "time_to_best_s", "wall_s", "setup_s", "setup_ascent_s", "setup_ils_s",
              "time_to_proof_s", "health", "compile_cache", "obs", "checkpoint_save_s", "checkpoint_restore_s",
              "series", "anomalies"}
    assert set(got) == set(want)
    for key in set(want) - timing:
        assert got[key] == want[key], key
    assert got["obs"]["balance"] == want["obs"]["balance"]
    assert got["obs"]["rank_balance"] == want["obs"]["rank_balance"] and got["rank_series"]["ranks"] == 4
    # the series' columns but wall_s and nodes_per_s, and the sentinels'
    # events but the nodes/s collapse, read no clock
    clocked = [want["series"]["columns"].index(c) for c in ("wall_s", "nodes_per_s")]
    for pay in (got, want):
        for row in pay["series"]["rows"]:
            for i in clocked:
                row[i] = None
        pay["anomalies"]["events"] = [e for e in pay["anomalies"]["events"] if e["kind"] != "nodes_rate_collapse"]
    assert got["series"] == want["series"] and got["anomalies"]["events"] == want["anomalies"]["events"]
    assert w_info == {"transport": "batched", "ranks": 4}
    assert info["transport"] == "procs" and info["backend"] == "gloo" and len(info["launches_per_rank"]) == 4
    for key in ("prim_chain", "push_rows"):
        assert got[f"{key}_launches"] == sum(lc[key] for lc in info["launches_per_rank"])
    for st in info["collectives_per_rank"]:
        assert st["staged_bytes"]["all_gather"] > 0 and st["cold_start_s"] > 0


def test_cli_joins_a_torchrun_group():
    argv = ["random:10:3", "--ranks=2", "--backend=cpu", "--bound=min-out", "--k=8", "--capacity=1024"]
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
                        "-m", "tsp_mpi_reduction_tpu_torch.tools.bnb_solve", *argv, "--transport=procs"],
                       capture_output=True, text=True, cwd=str(root), env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1  # rank 0 alone prints
    got = json.loads(lines[0])
    d = tsplib.resolve_instance("random:10:3").distance_matrix()
    res = tbb.solve_sharded(d, 2, device="cpu", capacity_per_rank=512, k=8, bound="min-out")
    assert (got["cost"], got["nodes_expanded"], got["nodes_per_rank"]) == (
        res.cost, res.nodes_expanded, [int(x) for x in res.nodes_per_rank])
    assert '"transport": "procs"' in r.stderr


def test_torchrun_rank_solves_on_its_local_card(tmp_path, monkeypatch):
    """Under torchrun, ``make_rank_mesh`` makes ``LOCAL_RANK``'s card this
    process's current card, and the CLI solves on the rank's device, not on
    the index-less ``cuda`` (card 0)."""
    import torch.distributed as dist

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    mesh.initialize_multihost(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0, timeout_s=30)
    try:
        ranks = mesh.make_rank_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()
    assert ranks.device == torch.device("cuda", 1) and current == [torch.device("cuda", 1)]

    seen = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(mesh, "initialize_multihost", lambda: 2)
    monkeypatch.setattr(mesh, "make_rank_mesh", lambda num_ranks, device: ranks)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(bnb_solve, "_solve", lambda args, inst, device, r: seen.append((device, r.device)))
    assert bnb_solve.main(["random:10:3", "--ranks=2", "--backend=cpu", "--transport=procs"]) == 0
    assert seen == [(torch.device("cuda", 1), torch.device("cuda", 1))]


def test_procs_resume_refuses_another_rank_count_on_every_rank(procs):
    """Rank 0 reads the snapshot; its refusal reaches every rank, so no
    rank is left waiting for rows."""
    tmp, _, _ = procs
    case = (random_d(11, 2), dict(HOST_KW, resume_from=str(tmp / "procs.npz")), None)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="written for 4 ranks; cannot resume with 2 ranks"):
        mesh.spawn_ranks(probes.sharded, 2, args=([case],), device="cpu", timeout_s=120.0)
    assert time.monotonic() - t0 < 60.0

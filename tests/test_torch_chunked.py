"""The port's checkpoint CLI and chunked campaign driver, on the CPU.

- ``tools/bnb_solve --checkpoint/--resume``: burma14 cut in two ends where
  one uninterrupted run ends (cost and certified LB), and the JSON line
  carries the ``health`` block;
- ``tools/bnb_chunked``: a two-chunk campaign of fresh processes prints
  one line a chunk and the summary, resumes chunk 1's snapshot, refuses
  another instance's snapshot under ``--resume-existing`` before any chunk
  runs, traces to one span tree, and without ``--backend=cpu`` on a host
  with no GPU exits non-zero without running a chunk on the CPU.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tsp_mpi_reduction_tpu_torch.obs import tracing
from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: burma14 under min-out with no ILS: a search of a few hundred steps
CLI = ["burma14", "--backend=cpu", "--bound=min-out", "--ils-rounds=0", "--k=64",
       "--capacity=4096"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cli(argv, capsys):
    assert bnb_solve.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("loop", ["off", "on"])
def test_bnb_solve_checkpoint_and_resume_equal_one_run(loop, capsys, tmp_path):
    whole = _cli(CLI + [f"--device-loop={loop}"], capsys)
    ck = str(tmp_path / "b.npz")
    first = _cli(CLI + [f"--device-loop={loop}", "--max-iters=64", f"--checkpoint={ck}"], capsys)
    assert not first["proven_optimal"] and os.path.exists(ck)
    second = _cli(CLI + [f"--device-loop={loop}", f"--checkpoint={ck}", f"--resume={ck}"], capsys)
    assert whole["proven_optimal"] and second["proven_optimal"]
    assert (second["cost"], second["lower_bound"]) == (whole["cost"], whole["lower_bound"])
    assert whole["cost"] == whole["lower_bound"] == 3323.0
    assert second["setup_ils_s"] == 0.0 and first["lower_bound"] <= second["lower_bound"]
    assert second["health"]["fallback_restores"] == first["health"]["fallback_restores"]


def test_bnb_solve_periodic_checkpoint(capsys, tmp_path):
    ck = str(tmp_path / "p.npz")
    out = _cli(CLI + ["--device-loop=on", "--max-iters=100", f"--checkpoint={ck}",
                      "--checkpoint-every=16"], capsys)
    assert not out["proven_optimal"]
    # 6 periodic saves and the final one: the rotation holds the newest 3
    assert all(os.path.exists(p) for p in (ck, ck + ".1", ck + ".2"))


def _campaign(argv, tmp_path, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.tools.bnb_chunked", *argv],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
    )


def test_chunked_campaign_of_two_fresh_processes(tmp_path):
    """Two chunks of 40 steps: one JSON line each and the summary; chunk 2
    resumed chunk 1's snapshot (no ILS, certified LB not lower), and the
    campaign traced to TSP_TRACE is one tree under one root."""
    ck, trace = str(tmp_path / "c.npz"), str(tmp_path / "trace.jsonl")
    r = _campaign(CLI + ["--chunk-iters=40", "--max-chunks=2", f"--checkpoint={ck}"], tmp_path,
                  env={"TSP_TRACE": trace})
    assert r.returncode == 0, r.stderr
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert len(lines) == 3 and lines[2]["summary"] and lines[2]["chunks"] == 2
    c1, c2, summary = lines
    assert c1["iterations"] == c2["iterations"] == 40 and c1["device_loop"] and c2["device_loop"]
    assert c1["device"] == c2["device"] == "cpu"
    assert c2["setup_ils_s"] == 0.0 and c2["lower_bound"] >= c1["lower_bound"]
    assert summary["lb_certified"] == c2["lb_certified"] and summary["cost"] == c2["cost"]
    assert summary["gap"] == round(c2["cost"] - c2["lb_certified"], 3)
    # each chunk's line carries its own telemetry, as the JAX driver's do
    for c in (c1, c2):
        assert sum(r[2] for r in c["series"]["rows"]) == c["nodes_expanded"] > 0
        assert set(c["anomalies"]) == {"events", "fired"} and c["rank_series"] is None
    spans = tracing.read_trace(trace)
    trees = tracing.build_trees(spans)
    assert len(trees) == 1
    (tree,) = trees.values()
    assert not tree["orphans"] and len(tree["roots"]) == 1
    root = tree["roots"][0]
    assert root["span"]["name"] == "bnb.campaign"
    chunks = root["children"]
    assert [c["span"]["name"] for c in chunks] == ["campaign.chunk"] * 2
    assert all([g["span"]["name"] for g in c["children"]] == ["bnb.solve"] for c in chunks)


def test_chunked_resume_existing_refuses_another_instance(tmp_path, capsys):
    ck = str(tmp_path / "u.npz")
    _cli(["ulysses16", "--backend=cpu", "--bound=min-out", "--ils-rounds=0", "--k=16",
          "--capacity=4096", "--max-iters=3", f"--checkpoint={ck}"], capsys)
    r = _campaign(CLI + ["--chunk-iters=40", f"--checkpoint={ck}", "--resume-existing"], tmp_path)
    assert r.returncode == 2 and r.stdout == ""
    assert "different instance" in r.stderr
    r = _campaign(CLI + ["--chunk-iters=40", f"--checkpoint={ck}"], tmp_path)
    assert r.returncode == 2 and "already exists" in r.stderr


def test_chunked_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cpu_free = [a for a in CLI if a != "--backend=cpu"]
    r = _campaign(cpu_free + ["--chunk-iters=40", "--max-chunks=2", "--chunk-retries=0",
                              f"--checkpoint={tmp_path / 'g.npz'}"], tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert "--backend=cpu" in r.stderr and not (tmp_path / "g.npz").exists()

"""The port's step profile (``tools/step_profile.py``) on the CPU: it runs
small components and writes its JSON to ``--out``; unknown components and
a missing GPU exit 2."""

import json

import torch

from tsp_mpi_reduction_tpu_torch.tools import step_profile


def test_runs_small_components_and_writes_json(tmp_path, capsys):
    out = tmp_path / "sp.json"
    argv = ["burma14", "--backend=cpu", "--k=16", "--reps=1", "--steps=2", "--bound-iters=2",
            "--warm-steps=4", f"--out={out}", "--only=full_boruvka,nomst,bound_prim_chain,sort"]
    assert step_profile.main(argv) == 0
    got = json.loads(out.read_text())
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    comps = got["components"]
    assert set(comps) == {"full_boruvka", "nomst", "bound_prim_chain", "sort"}
    assert comps["full_boruvka"]["mst_kernel"] == "boruvka" and comps["nomst"]["mst_kernel"] is None
    assert comps["bound_prim_chain"]["unit"] == "bound eval"
    assert all(c["ms_per_unit"] > 0 and c["prim_chain_launches_per_unit"] == 0 for c in comps.values())
    assert got["device"] == "cpu" and got["warm_count"] > 0


def test_refusals(capsys):
    assert step_profile.main(["burma14", "--backend=cpu", "--only=full_prim"]) == 2
    if not torch.cuda.is_available():
        assert step_profile.main(["burma14"]) == 2

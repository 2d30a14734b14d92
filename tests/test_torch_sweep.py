"""The port's ``test.sh`` sweep (``tools/sweep.py``) on the CPU.

- ``--quick --backend=cpu`` writes the CSV header and 8 rows whose costs are
  the port's rank-emulated runs of the same configurations;
- ``--resume`` skips the rows already written and appends;
- a file of 100 or more rows is not overwritten without ``--force``;
- the default ``--out`` is never the committed ``results.csv``.
"""

import pytest

from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_ranks
from tsp_mpi_reduction_tpu_torch.tools import sweep
from tsp_mpi_reduction_tpu_torch.utils import reporting


def test_quick_sweep_writes_header_and_8_rows(tmp_path, capsys):
    out = tmp_path / "q.csv"
    assert sweep.main(["--quick", "--backend=cpu", f"--out={out}"]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == reporting.CSV_HEADER == "numCities,numBlocks,numProcs,time,cost"
    rows = [ln.split(",") for ln in lines[1:]]
    assert [tuple(map(int, r[:3])) for r in rows] == [
        (n, b, p) for n in (5, 8) for b in (10, 50) for p in (2, 8)]
    want = run_pipeline_ranks(8, 50, 1000, 1000, 8, device="cpu").cost
    assert rows[-1][4] == f"{want:f}"
    assert capsys.readouterr().out.splitlines() == lines[1:]


def test_resume_appends_only_missing_rows(tmp_path):
    out = tmp_path / "r.csv"
    assert sweep.main(["--backend=cpu", f"--out={out}", "--cities=5", "--blocks=10", "--procs=2"]) == 0
    with open(out, "a") as f:
        f.write("5,10,4,1")  # a row a killed sweep left unterminated
    assert sweep.main(["--backend=cpu", f"--out={out}", "--cities=5", "--blocks=10",
                       "--procs=2,4", "--resume"]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == reporting.CSV_HEADER and lines[1].startswith("5,10,2,")
    assert lines[2] == "5,10,4,1" and lines[3].startswith("5,10,4,") and len(lines) == 4


def test_overwrite_guard(tmp_path):
    out = tmp_path / "big.csv"
    out.write_text(reporting.CSV_HEADER + "\n" + "5,10,2,1,1.0\n" * 100)
    with pytest.raises(SystemExit) as e:
        sweep.main(["--quick", "--backend=cpu", f"--out={out}"])
    assert e.value.code == 2 and len(out.read_text().splitlines()) == 101
    assert sweep.main(["--backend=cpu", f"--out={out}", "--cities=5", "--blocks=10", "--procs=2",
                       "--force"]) == 0
    assert len(out.read_text().splitlines()) == 2


def test_default_out_is_not_the_committed_csv(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert sweep.main(["--quick", "--backend=cpu", "--cities=5", "--blocks=10", "--procs=2"]) == 0
    assert (tmp_path / "results_torch_quick.csv").exists() and not (tmp_path / "results.csv").exists()

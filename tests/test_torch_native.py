"""The port's ctypes binding to the native C++ runtime and
``--backend=native``, on the CPU.

- the binding against the goldens (glibc rand stream, generator, block
  solutions, the whole pipeline) and against the port's torch generator;
- the CLI's ``--backend=native 10 6 500 500`` prints the oracle's
  ``3720.557435`` with the banner and dims lines;
- ``--backend=native`` refuses ``--improve``, ``--trace``,
  ``--dtype=float32``, ``--compat-bugs`` and a non-auto ``--impl`` with exit 2.
"""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from tsp_mpi_reduction_tpu_torch import native
from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance, get_blocks_per_dim
from tsp_mpi_reduction_tpu_torch.utils import cli


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.build()


def test_rand_stream_matches_golden(goldens_dir):
    golden = json.loads((goldens_dir / "glibc_rand_seed0.json").read_text())
    assert native.rand_stream(0, len(golden["values"])).tolist() == golden["values"]


def test_blocks_per_dim_and_generator_match_the_port():
    for nb in list(range(1, 40)) + [97, 144, 200]:
        assert native.blocks_per_dim(nb) == get_blocks_per_dim(nb)
    _, xy = generate_instance(7, 12, 777, 333, seed=5)
    np.testing.assert_array_equal(native.generate(7, 12, 777, 333, seed=5), xy)


@pytest.mark.parametrize("config", ["10x6_500x500", "13x4_1000x1000"])
def test_generate_and_solve_block_match_golden(goldens_dir, config):
    golden = json.loads((goldens_dir / f"full_{config}.json").read_text())
    c = golden["config"]
    xy = native.generate(c["ncpb"], c["nblocks"], c["gx"], c["gy"], seed=0)
    gold = np.asarray([[[city[1], city[2]] for city in block] for block in golden["blocks"]])
    np.testing.assert_array_equal(xy, gold)
    for b, sol in enumerate(golden["block_solutions"]):
        cost, tour = native.solve_block(distance_matrix_np(xy[b]))
        assert cost == sol["cost"]
        assert (tour + b * c["ncpb"]).tolist() == sol["ids"]


@pytest.mark.parametrize("config", ["10x6_500x500", "10x10_123x457", "13x4_1000x1000"])
def test_pipeline_matches_golden(goldens_dir, config):
    golden = json.loads((goldens_dir / f"full_{config}.json").read_text())
    c = golden["config"]
    cost, tour, block_costs = native.run_pipeline(c["ncpb"], c["nblocks"], c["gx"], c["gy"])
    assert cost == golden["final"]["cost"]
    assert tour.tolist() == golden["final"]["ids"]
    assert block_costs.tolist() == [s["cost"] for s in golden["block_solutions"]]


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue().strip().splitlines(), err.getvalue()


def test_cli_native_prints_the_oracle_cost():
    rc, lines, _ = _run(["10", "6", "500", "500", "--backend=native"])
    assert rc == 0
    assert lines[:2] == ["We have 10 cities for each of our 6 blocks", "2 blocks in X 3 in Y"]
    assert lines[-1].endswith(" ms for 60 cities and the trip cost 3720.557435")


@pytest.mark.parametrize("flag", ["--improve", "--trace=t", "--dtype=float32", "--compat-bugs",
                                  "--impl=fused"])
def test_cli_native_refusals_exit_2(flag):
    rc, lines, err = _run(["10", "6", "500", "500", "--backend=native", flag])
    assert rc == 2 and lines == [] and err.startswith("error: ")

"""The reference's ``test.sh`` sweep, on the port.

    python -m tsp_mpi_reduction_tpu_torch.tools.sweep [--quick] [--out FILE]
        [--backend=auto|cuda|cpu] [--dtype=float64|float32] [--resume] [--force]
        [--cities=5,8] [--blocks=10,50] [--procs=2,8] [--grid=1000]

Counterpart of ``tools/sweep.py``. The reference sweeps cities/block 5-10
x blocks 10..200 step 10 x procs 2..20 step 2 on a 1000x1000 grid and
scrapes time and cost from each run's last line into a CSV with the header
``numCities,numBlocks,numProcs,time,cost`` (test.sh:1-24). This driver
writes the same schema; the ``numProcs`` axis runs the port's rank
emulation (``models.distributed.run_pipeline_ranks``: the reference's
block assignment and merge tree on one device).

``--out`` defaults to ``results_torch.csv``, or ``results_torch_quick.csv``
under ``--quick`` (2 x 2 x 2 configurations), so no run of the port writes
the committed ``results.csv``; overwriting a file of 100 or more rows
needs ``--force``, and ``--resume`` appends, skipping the configurations
the file already holds.

Before any device is touched the sweep runs the port's lint gate
(``python -m tsp_mpi_reduction_tpu_torch.analysis --quiet``, as the JAX
sweep runs its own): a host sync or relaunching loop in a hot path
invalidates the timing columns this harness exists to produce. Its
summary line goes to stderr, so stdout stays the CSV rows; on new findings
the sweep exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List, Optional

from ..utils import reporting


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sweep", description="test.sh sweep of the PyTorch/CUDA port")
    ap.add_argument("--out", default=None)
    ap.add_argument("--grid", type=int, default=1000)  # test.sh:2
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["float64", "float32"])
    ap.add_argument("--resume", action="store_true",
                    help="append to --out, skipping configs it already contains")
    ap.add_argument("--force", action="store_true",
                    help="allow overwriting an existing large results file")
    ap.add_argument("--cities", default=None, help="comma list overriding the cities/block axis")
    ap.add_argument("--blocks", default=None, help="comma list overriding the blocks axis")
    ap.add_argument("--procs", default=None, help="comma list overriding the procs axis")
    return ap


def _done_configs(path: str) -> set:
    """(cities, blocks, procs) of the rows already in ``path``."""
    done = set()
    try:
        with open(path) as f:
            for ln in f:
                parts = ln.strip().split(",")
                if len(parts) == 5 and parts[0].isdigit():
                    done.add((int(parts[0]), int(parts[1]), int(parts[2])))
    except OSError:
        pass
    return done


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = "results_torch_quick.csv" if args.quick else "results_torch.csv"
    if not args.resume and not args.force:
        try:
            with open(args.out) as f:
                existing = sum(1 for _ in f) - 1
        except OSError:
            existing = 0
        if existing >= 100:
            ap.error(f"{args.out} holds {existing} data rows; refusing to overwrite a full sweep "
                     "artifact (use --resume, --force, or a different --out)")

    # lint gate before burning hours of sweep (stdlib only: no device yet)
    from ..analysis.__main__ import main as graftlint

    with contextlib.redirect_stdout(sys.stderr):
        gate = graftlint(["--quiet"])
    if gate != 0:
        print("sweep: graftlint found new violations; fix or baseline them first "
              "(python -m tsp_mpi_reduction_tpu_torch.analysis)", file=sys.stderr)
        return 2

    from ..models.distributed import run_pipeline_ranks
    from ..utils.backend import default_dtype, parse_dtype, resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dtype = default_dtype(device) if args.dtype is None else parse_dtype(args.dtype)

    if args.quick:
        cities, blocks, procs = [5, 8], [10, 50], [2, 8]
    else:  # test.sh:5,9,12
        cities, blocks, procs = range(5, 11), range(10, 201, 10), range(2, 21, 2)
    if args.cities:
        cities = [int(x) for x in args.cities.split(",")]
    if args.blocks:
        blocks = [int(x) for x in args.blocks.split(",")]
    if args.procs:
        procs = [int(x) for x in args.procs.split(",")]

    done = _done_configs(args.out) if args.resume else set()
    # resume never truncates, and first terminates a row a killed sweep left
    exists = args.resume and os.path.exists(args.out) and os.path.getsize(args.out) > 0
    needs_nl = False
    if exists:
        with open(args.out, "rb") as f:
            f.seek(-1, 2)
            needs_nl = f.read(1) != b"\n"
    with open(args.out, "a" if exists else "w") as f:
        if not exists:
            f.write(reporting.CSV_HEADER + "\n")
        elif needs_nl:
            f.write("\n")
        for n in cities:
            for nb in blocks:
                for p in procs:
                    if (n, nb, p) in done:
                        continue
                    t0 = time.perf_counter()
                    res = run_pipeline_ranks(n, nb, args.grid, args.grid, p, dtype=dtype, device=device)
                    ms = int((time.perf_counter() - t0) * 1000)
                    row = reporting.csv_row(n, nb, p, ms, res.cost)
                    print(row)
                    f.write(row + "\n")
                    f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell: what its comparison reads when the answers come
from a lower precision than the configuration states. It has to come out
as not correct; its readings set the upper end of each limit.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 [--calls 4]

- B&B cells: the program solves copies whose distances were computed in
  bfloat16 (coordinates, differences, squares and root), the precision
  below the float32 the configuration holds them in; the comparison
  recomputes every length exactly.
- Pipeline cells: the plain reference, put in the program's place,
  computes Held-Karp, the fold and the reduce tree in bfloat16.

Each seed prints one JSON line of readings; the benchmark's own runs do
not run this. ``benchmark/tests`` runs it on the CPU at a small size.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from . import checks, harness, instances


def readings(cell: harness.Cell, seed: int, calls: int, device) -> dict:
    import torch

    device = torch.device(device)
    if "instance" in cell.config:
        drv = harness.driver_module(cell.traffic["driver"]).Driver(cell.config, cell.traffic, seed, device,
                                                                   "bfloat16")
        low = drv.inputs(instances.CONTROL, 0, calls)
        answers = [drv.call(cp) for cp in low]
        got = drv.check(answers, low)  # lengths recomputed exactly from the copies' coordinates
        drv.release()
    else:
        dep = cell.config["deployment"]
        ranks = int(cell.traffic.get("ranks", 1))
        xys = [instances.blocked_cities(dep["cities_per_block"], dep["num_blocks"], dep["grid_x"], dep["grid_y"],
                                        instances.CONTROL, seed, i) for i in range(calls)]
        answers = [checks.control_pipeline(xy, ranks, torch.bfloat16, device) for xy in xys]
        got = checks.pipelines(answers, xys, ranks, cell.config["limits"], device)
    return {"seed": seed, "correct": all(v <= lim for _, v, lim in got),
            "checks": {name: {"value": v, "limit": lim} for name, v, lim in got}}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.calls, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

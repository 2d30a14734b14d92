"""CLI: the reference's argv contract plus backend/rank/impl flags.

Compatibility surface (as ``tsp_mpi_reduction_tpu/utils/cli.py``):

- four positional ints ``numCitiesPerBlock numBlocks gridDimX gridDimY``
  (tsp.cpp:282-288); wrong arity -> usage line, exit 1 (tsp.cpp:280-284);
- ``numCitiesPerBlock > 16`` -> the reference's message and
  ``exit(1337)``, seen as status 57 (tsp.cpp:289-295);
- stdout: banner, dims line and the machine-parsed final line
  ``TSP ran in <ms> ms for <n> cities and the trip cost <cost>``.

Flags:
  --backend={auto,cuda,cpu}   auto and cuda need a GPU (no CPU fallback)
  --ranks=P                   emulate a P-rank MPI run (same merge tree)
  --dtype={float64,float32}   default float64 on cpu, float32 on cuda
  --impl=NAME                 Held-Karp impl (auto, compact, dense, fused, pallas)
  --metrics                   JSON metrics line on stderr
  --seed=S                    instance seed (the reference hardwires srand(0))
  --compat-bugs               reproduce the reference's reduce corruption

Degenerate blocks (n < 3) exit 2 with an error, as does a missing GPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from . import reporting


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsp-torch",
        usage=reporting.usage_line(),
        description="PyTorch/CUDA blocked TSP solver (JZHeadley/TSP-MPI-Reduction capabilities)",
    )
    p.add_argument("numCitiesPerBlock", type=int)
    p.add_argument("numBlocks", type=int)
    p.add_argument("gridDimX", type=int)
    p.add_argument("gridDimY", type=int)
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=1, metavar="P")
    p.add_argument("--dtype", default=None, choices=["float64", "float32"])
    p.add_argument(
        "--impl", default="auto", choices=["auto", "compact", "dense", "fused", "jnp", "pallas"],
        help="Held-Karp impl; auto is the relax_dense_sweep kernel on cuda",
    )
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--compat-bugs",
        action="store_true",
        help="for --ranks > 1: replicate the reference's reduce-side "
        "path-accumulation corruption (SURVEY.md quirk #5)",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    t_start = time.perf_counter()
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        if e.code in (0, None):  # -h/--help
            return 0
        print(reporting.usage_line())  # the reference's arity check
        return 1

    if args.numCitiesPerBlock > 16:
        print(reporting.too_many_cities_line())
        sys.exit(1337)  # truncated by the OS to 57, as the reference's is

    import torch

    from ..models.distributed import run_pipeline_ranks
    from ..models.pipeline import run_pipeline
    from ..ops import held_karp
    from ..ops.generator import get_blocks_per_dim
    from .backend import default_dtype, parse_dtype, resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dtype = default_dtype(device) if args.dtype is None else parse_dtype(args.dtype)

    n, nb = args.numCitiesPerBlock, args.numBlocks
    print(reporting.banner_line(n, nb))
    rows, cols = get_blocks_per_dim(nb)
    print(reporting.dims_line(rows, cols))

    try:
        with held_karp.use_impl(args.impl):
            impl = held_karp.effective_impl(device)
            if args.ranks > 1:
                res = run_pipeline_ranks(
                    n, nb, args.gridDimX, args.gridDimY, args.ranks, seed=args.seed,
                    dtype=dtype, compat_bugs=args.compat_bugs, device=device,
                )
            else:
                res = run_pipeline(
                    n, nb, args.gridDimX, args.gridDimY, seed=args.seed,
                    dtype=dtype, device=device,
                )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    elapsed_ms = int((time.perf_counter() - t_start) * 1000)
    print(reporting.final_line(elapsed_ms, res.num_cities, res.cost))
    if args.metrics:
        print(
            reporting.metrics_json(
                config={
                    "numCitiesPerBlock": n,
                    "numBlocks": nb,
                    "gridDimX": args.gridDimX,
                    "gridDimY": args.gridDimY,
                    "ranks": args.ranks,
                    "backend": device.type,
                    "dtype": str(dtype).replace("torch.", ""),
                    "impl": impl,
                    "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                },
                elapsed_ms=elapsed_ms,
                cost=res.cost,
                phase_seconds=res.phase_seconds,
                dp_states=res.dp_states,
                dp_transitions=res.dp_transitions,
            ),
            file=sys.stderr,
        )
    return 0

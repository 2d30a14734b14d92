"""TSPLIB branch-and-bound driver of the port: one JSON metrics line.

    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve burma14 [--backend=auto|cuda|cpu]
    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve eil51 --k=1024 --capacity=262144

Counterpart of ``tools/bnb_solve.py``, single device. The instance is an
embedded TSPLIB name, ``random:N[:SEED]`` or a ``.tsp`` path. The line
carries the keys of the JAX driver's ``result_payload`` that this port
computes (the host reservoir's ``spill_*`` counters included), ``null``
for the telemetry blocks it does not port yet, the resolved
``mst_kernel``, ``step_kernel`` and ``device_loop``, and the launches of
the ``prim_chain`` and ``push_rows`` kernels in the solve. On a GPU the
defaults run the device loop with both kernels. ``--backend=auto`` and
``cuda`` need a GPU (exit 2 without one).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def result_payload(res, inst, args, device, launches: dict) -> dict:
    """The one-line JSON payload (schema of the JAX driver's
    ``result_payload``, single device)."""
    opt = inst.known_optimum
    return {
        "instance": inst.name,
        "dimension": inst.dimension,
        "cost": res.cost,
        "known_optimum": opt,
        "optimal": (res.cost == opt) if opt is not None else None,
        "proven_optimal": res.proven_optimal,
        "nodes_expanded": res.nodes_expanded,
        "nodes_per_sec": round(res.nodes_per_sec, 1),
        "time_to_best_s": round(res.time_to_best, 4),
        "wall_s": round(res.wall_seconds, 3),
        "setup_s": round(res.setup_seconds, 3),
        "setup_ascent_s": round(res.ascent_seconds, 3),
        "setup_ils_s": round(res.ils_seconds, 3),
        # end to end: bound setup + incumbent + search
        "time_to_proof_s": (
            round(res.setup_seconds + res.wall_seconds, 3) if res.proven_optimal else None
        ),
        "ranks": 1,
        "nodes_per_rank": None,
        "bound": args.bound,
        "mst_kernel": res.mst_kernel,
        "step_kernel": res.step_kernel,
        "device_loop": res.device_loop,
        "reorder_every": args.reorder_every,
        "push_order": args.push_order,
        "push_block": args.push_block,
        "balance": None,
        "root_lower_bound": round(res.root_lower_bound, 3),
        "lower_bound": round(res.lower_bound, 3),
        "lb_raw": round(res.lower_bound_raw, 3) if res.lower_bound_raw > -1e30 else None,
        "lb_certified": round(res.lower_bound, 3),
        "gap": round(res.cost - res.lower_bound, 3) if res.lower_bound > -1e30 else None,
        "spill_rounds": res.spill_rounds,
        "spill_events": res.spill_events,
        "spill_full_merges": res.spill_full_merges,
        "spill_bytes_to_host": res.spill_bytes_to_host,
        "spill_bytes_to_device": res.spill_bytes_to_device,
        "health": None,
        "compile_cache": None,
        "series": None,
        "anomalies": None,
        "rank_series": None,
        "obs": None,
        "iterations": res.iterations,
        "steps_run": res.steps_run,
        "prim_chain_launches": launches["prim_chain"],
        "push_rows_launches": launches["push_rows"],
        "device": device,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bnb_solve", description="exact TSPLIB branch-and-bound (PyTorch/CUDA)")
    ap.add_argument("instance", help="embedded name (burma14, ulysses16, ulysses22, eil51, "
                    "berlin52, kroA100), random:N[:SEED], or a TSPLIB .tsp path")
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"])
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--inner-steps", type=int, default=32)
    ap.add_argument("--time-limit", type=float, default=None)
    ap.add_argument("--max-iters", type=int, default=200_000)
    ap.add_argument("--bound", default="one-tree", choices=["one-tree", "min-out"])
    ap.add_argument("--node-ascent", type=int, default=2,
                    help="per-node mini-ascent steps on the MST bound (0 disables)")
    ap.add_argument("--mst-kernel", default="auto", choices=["auto", "prim", "prim_chain"],
                    help="Prim chain of the MST bound: auto (the prim_chain CUDA kernel "
                    "on cuda, the plain chain on cpu), prim (plain torch) or prim_chain")
    ap.add_argument("--step-kernel", default="auto", choices=["auto", "reference", "fused"],
                    help="the expansion step's push: auto (the push_rows CUDA kernel on cuda, "
                    "the reference push on cpu), reference (the candidate block) or fused")
    ap.add_argument("--device-loop", default="auto", choices=["auto", "on", "off"],
                    help="per-step capacity guard with on-device compaction (auto: on for "
                    "cuda, off for cpu); off runs --inner-steps steps between checks")
    ap.add_argument("--reorder-every", type=int, default=0,
                    help="every N expansion steps, re-sort the stack best-bound-first (0 = off)")
    ap.add_argument("--push-order", default="best-first", choices=["best-first", "natural"])
    ap.add_argument("--push-block", type=int, default=0,
                    help="cap the per-step push block write at this many rows (0 = k*n)")
    ap.add_argument("--ils-rounds", type=int, default=None,
                    help="iterated-local-search rounds of the incumbent (default: 30 for n >= 30)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from ..models import branch_bound as bb
    from ..ops import expand_kernels, prim_kernels
    from ..utils import tsplib
    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        inst = tsplib.resolve_instance(args.instance)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read instance: {e}", file=sys.stderr)
        return 2
    d = inst.distance_matrix()

    prim_kernels.reset_launches()
    expand_kernels.reset_launches()
    res = bb.solve(
        d,
        capacity=args.capacity,
        k=args.k,
        inner_steps=args.inner_steps,
        time_limit_s=args.time_limit,
        max_iters=args.max_iters,
        bound=args.bound,
        node_ascent=args.node_ascent,
        ils_rounds=args.ils_rounds,
        mst_kernel=args.mst_kernel,
        push_order=args.push_order,
        push_block=args.push_block,
        step_kernel=args.step_kernel,
        device_loop={"auto": None, "on": True, "off": False}[args.device_loop],
        reorder_every=args.reorder_every,
        device=device,
    )
    name = device.type
    if device.type == "cuda":
        import torch

        name = torch.cuda.get_device_name(device)
    launches = {**prim_kernels.LAUNCHES, **expand_kernels.LAUNCHES}
    print(json.dumps(result_payload(res, inst, args, name, launches)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

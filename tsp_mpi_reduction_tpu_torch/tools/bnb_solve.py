"""TSPLIB branch-and-bound driver of the port: one JSON metrics line.

    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve burma14 [--backend=auto|cuda|cpu]
    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve eil51 --k=1024 --capacity=262144
    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve kroA100 --max-iters=300 \
        --checkpoint=run.npz [--resume=run.npz] [--checkpoint-every=N]
    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve eil51 --ranks=8 --k=128 \
        [--balance=pair|ring|steal|adaptive] [--transport=batched|procs]
    torchrun --nproc-per-node=R -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve eil51 \
        --ranks=R --transport=procs

Counterpart of ``tools/bnb_solve.py``. ``--ranks=R`` (R > 1) runs the
sharded solve (``solve_sharded``) over R rank frontiers of ``--capacity //
R`` rows each, balanced by ``--balance``; the line then carries
``nodes_per_rank`` and the balance controller's summary under
``obs.balance``. ``--transport=batched`` (the default) stacks the R ranks
on the one device; ``procs`` runs each rank as a process of a gloo group
(``parallel/mesh.py``): R local processes started here, or, under
``torchrun`` (``WORLD_SIZE`` set), the group torchrun started. Rank 0
prints the line (the launch counts summed over the ranks); the transport,
each rank's launches, staged collective bytes and cold start go on a
``transport:`` line on stderr before it. The instance is an
embedded TSPLIB name, ``random:N[:SEED]`` or a ``.tsp`` path. The line
carries the keys of the JAX driver's ``result_payload`` that this port
computes (the host reservoir's ``spill_*`` counters, the ``health``
block, and a ``compile_cache`` block with the JAX keys: the graph
store's counters and the root-ascent memo's, ``perf/compile_cache.py``),
the telemetry blocks
(``series``, ``anomalies``, ``rank_series``, ``obs.rank_balance``, and
``obs.device_costs``, the kernels' analytic roofline records; ``null``
blocks under ``TSP_OBS=off`` or where a single-device solve has no rank
view), the resolved ``mst_kernel``, ``step_kernel`` and ``device_loop``, the
launches of the ``prim_chain`` and ``push_rows`` kernels in the solve, and
the host seconds of the snapshot's saves and restore. On a GPU the
defaults run the device loop with both kernels. ``--backend=auto`` and
``cuda`` need a GPU (exit 2 without one). ``--checkpoint`` /
``--resume`` read and write the TSPCKPT1 snapshots of the JAX package's
driver, so a chunk of either package resumes in the other. The solve
runs inside a ``bnb.solve`` span that attaches under
``TSP_TRACE_PARENT`` (the chunked driver sets it per chunk). This tool
turns the memo's disk tier on (``perf/ascent_memo.py``,
``TSP_COMPILE_CACHE``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def result_payload(res, inst, args, device, launches: dict, health: dict,
                   ckpt_bytes: Optional[int], memo: dict, trace_path: Optional[str] = None) -> dict:
    """The one-line JSON payload (schema of the JAX driver's
    ``result_payload`` plus the port's own keys). ``obs`` holds the port's
    ``obs_block`` (with ``device_costs``; the JAX block's XLA compile
    phases have no counterpart here), the rank imbalance accounting
    (``rank_balance``) and the balance controller's summary (both for
    sharded solves)."""
    from ..utils import reporting

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
        "ranks": args.ranks,
        "nodes_per_rank": (
            [int(x) for x in res.nodes_per_rank] if res.nodes_per_rank is not None else None
        ),
        "bound": args.bound,
        "mst_kernel": res.mst_kernel,
        "step_kernel": res.step_kernel,
        "device_loop": res.device_loop,
        "reorder_every": args.reorder_every,
        "push_order": args.push_order,
        "push_block": args.push_block,
        "balance": args.balance if args.ranks > 1 else None,
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
        "health": health,
        "compile_cache": memo,
        # one row a host-loop dispatch (obs.timeseries), the sentinels'
        # verdicts (obs.anomaly) and the per-rank windows (obs.rankview);
        # null under TSP_OBS=off, rank_series also for a single device
        "series": res.series,
        "anomalies": res.anomalies,
        "rank_series": res.rank_series,
        "obs": {**reporting.obs_block(trace_path=trace_path), "rank_balance": res.rank_balance,
                "balance": res.balance},
        "iterations": res.iterations,
        "steps_run": res.steps_run,
        # the search's predicated steps (graph replays on CUDA, or eager
        # calls), its dispatches, and a capture this run made: warm-up
        # steps (they launch the kernels too) and seconds
        "replays": res.replays,
        "dispatches": res.dispatches,
        "step_graph": res.step_graph,
        "warm_steps": res.warm_steps,
        "capture_s": round(res.capture_seconds, 4),
        "prim_chain_launches": launches["prim_chain"],
        "push_rows_launches": launches["push_rows"],
        "checkpoint_save_s": [round(t, 4) for t in res.checkpoint_save_s],
        "checkpoint_restore_s": round(res.checkpoint_restore_s, 4),
        "checkpoint_bytes": ckpt_bytes,
        "device": device,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bnb_solve", description="exact TSPLIB branch-and-bound (PyTorch/CUDA)")
    ap.add_argument("instance", help="embedded name (burma14, ulysses16, ulysses22, eil51, "
                    "berlin52, kroA100), random:N[:SEED], or a TSPLIB .tsp path")
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=1,
                    help="rank frontiers of the sharded solve (1: the single-device solve)")
    ap.add_argument("--transport", default="batched", choices=["batched", "procs"],
                    help="how the ranks run: batched on the one device, or one process each "
                    "over a gloo group (joins torchrun's group when WORLD_SIZE is set)")
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--inner-steps", type=int, default=32)
    ap.add_argument("--time-limit", type=float, default=None)
    ap.add_argument("--max-iters", type=int, default=200_000)
    ap.add_argument("--checkpoint", default=None,
                    help="snapshot path: written every --checkpoint-every iterations and "
                    "whenever the solve stops unproven")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="snapshot to continue from (either package's)")
    ap.add_argument("--bound", default="one-tree", choices=["one-tree", "min-out"])
    ap.add_argument("--node-ascent", type=int, default=2,
                    help="per-node mini-ascent steps on the MST bound (0 disables)")
    ap.add_argument("--mst-kernel", default="auto", choices=["auto", "prim", "prim_chain", "boruvka"],
                    help="MST bound kernel: auto (the prim_chain CUDA kernel on cuda, the plain "
                    "chain on cpu), prim (plain torch), prim_chain, or boruvka (log-depth "
                    "rounds in plain torch ops); all certify the same bound value")
    ap.add_argument("--step-kernel", default="auto", choices=["auto", "reference", "fused"],
                    help="the expansion step's push: auto (the push_rows CUDA kernel on cuda, "
                    "the reference push on cpu), reference (the candidate block) or fused")
    ap.add_argument("--device-loop", default="auto", choices=["auto", "on", "off"],
                    help="per-step capacity guard with on-device compaction (auto: on for "
                    "cuda, off for cpu); off runs --inner-steps steps between checks")
    ap.add_argument("--balance", default="pair", choices=["pair", "ring", "steal", "adaptive"],
                    help="sharded load balance: pair (richest donates to poorest each round), "
                    "ring (successor donation), steal (one global repartition), or adaptive "
                    "(a controller picks skip/pair/steal per dispatch)")
    ap.add_argument("--reorder-every", type=int, default=0,
                    help="every N expansion steps, re-sort the stack best-bound-first (0 = off)")
    ap.add_argument("--push-order", default="best-first", choices=["best-first", "natural"])
    ap.add_argument("--push-block", type=int, default=0,
                    help="cap the per-step push block write at this many rows (0 = k*n)")
    ap.add_argument("--ils-rounds", type=int, default=None,
                    help="iterated-local-search rounds of the incumbent (default: 30 for n >= 30)")
    return ap


def _solve(args, inst, device, ranks=None):
    """Run the solve of ``args`` on this process (one rank of ``ranks`` when
    given) -> ``(payload, transport info)`` on rank 0, None elsewhere."""
    from ..models import branch_bound as bb
    from ..obs import tracing
    from ..ops import expand_kernels, prim_kernels
    from ..perf import ascent_memo, compile_cache
    from ..resilience.health import HEALTH

    d = inst.distance_matrix()
    ascent_memo.enable()
    prim_kernels.reset_launches()
    expand_kernels.reset_launches()
    kw = dict(
        k=args.k,
        inner_steps=args.inner_steps,
        time_limit_s=args.time_limit,
        max_iters=args.max_iters,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
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
    with tracing.span("bnb.solve", parent=tracing.parent_from_env(), instance=inst.name,
                      ranks=args.ranks):
        if args.ranks > 1:
            res = bb.solve_sharded(d, args.ranks, capacity_per_rank=args.capacity // args.ranks,
                                   balance=args.balance, ranks=ranks, **kw)
        else:
            res = bb.solve(d, capacity=args.capacity, **kw)
    launches = {**prim_kernels.LAUNCHES, **expand_kernels.LAUNCHES}
    info = {"transport": args.transport, "ranks": args.ranks}
    if ranks is not None:
        # every rank process counts its own launches; the line sums them
        per_rank = ranks.gather_objects((launches, ranks.stats()))
        if per_rank is None:
            return None
        launches = {key: sum(lc[key] for lc, _ in per_rank) for key in launches}
        info.update(backend="gloo", launches_per_rank=[lc for lc, _ in per_rank],
                    collectives_per_rank=[st for _, st in per_rank])
    name = device.type
    if device.type == "cuda":
        import torch

        name = torch.cuda.get_device_name(device)
    ckpt = args.checkpoint and bb._norm_ckpt_path(args.checkpoint)
    ckpt_bytes = os.path.getsize(ckpt) if ckpt and os.path.exists(ckpt) else None
    payload = result_payload(res, inst, args, name, launches, HEALTH.snapshot(), ckpt_bytes,
                             compile_cache.stats_dict(), trace_path=tracing.TRACER.path)
    return payload, info


def _solve_rank(ranks, argv: List[str]):
    """One rank process of ``--transport=procs`` (``spawn_ranks``' target)."""
    from ..utils import tsplib

    args = build_parser().parse_args(argv)
    return _solve(args, tsplib.resolve_instance(args.instance), ranks.device, ranks)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

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
    if args.ranks < 1:
        print(f"error: --ranks must be >= 1, got {args.ranks}", file=sys.stderr)
        return 2
    if args.transport == "procs" and args.ranks > 1:
        from ..parallel import mesh

        if os.environ.get("WORLD_SIZE"):
            import torch.distributed as dist

            mesh.initialize_multihost()
            try:
                ranks = mesh.make_rank_mesh(args.ranks, device=device.type)
                out = _solve(args, inst, ranks.device, ranks)
            finally:
                dist.destroy_process_group()
        else:
            out = mesh.spawn_ranks(_solve_rank, args.ranks, args=(argv,), device=device.type)
    else:
        out = _solve(args, inst, device)
    if out is None:  # a rank other than 0 of a torchrun group
        return 0
    payload, info = out
    if args.ranks > 1:
        print("transport: " + json.dumps(info), file=sys.stderr)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())

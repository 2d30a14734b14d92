"""Rank-process targets of the port's real-rank tests (``tests/test_torch_mesh.py``,
``test_torch_pipeline_sharded.py``, ``test_torch_ring_improve.py``,
``test_torch_sharded_procs.py``).

``parallel.mesh.spawn_ranks`` pickles its target by module and name and the
spawned rank imports that module, so the targets live here, in a module
that imports the port and never ``jax``. Each target takes the rank group
first; run with ``BatchedRanks(R)`` in the test process it computes what
R rank processes compute, and returns the same ``[R, ...]`` result on rank
0. Many cases run in one group, so a test file spawns few groups.
"""

import sys

import numpy as np
import torch

from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_sharded
from tsp_mpi_reduction_tpu_torch.parallel.reduce import tree_schedule
from tsp_mpi_reduction_tpu_torch.parallel.seq_improve import improve_tour, ring_two_opt
from tsp_mpi_reduction_tpu_torch.resilience import faults


def _rows(ranks, local: np.ndarray):
    """Every rank's rows ``[R, ...]`` on rank 0 (None elsewhere)."""
    parts = ranks.gather_objects(local)
    return None if parts is None else np.concatenate(parts)


def primitive_inputs(num_ranks: int, seed: int) -> dict:
    """The ``[R, ...]`` inputs of :func:`primitives`, made with numpy."""
    rng = np.random.default_rng(seed)
    return {
        "i32": rng.integers(-2**28, 2**28, (num_ranks, 3, 2)).astype(np.int32),
        "f64": rng.standard_normal((num_ranks, 5)),
        "f32": rng.standard_normal((num_ranks, 4)).astype(np.float32),
        "bool": rng.random((num_ranks, 6)) < 0.3,
    }


def primitives(ranks, seed: int) -> dict:
    """Every collective of the group on numpy-seeded inputs: each rank
    takes its rows of the ``[R, ...]`` inputs, runs the primitive and
    reports its rows. Also whether ``jax`` was imported in this process."""
    x = {k: torch.from_numpy(v[ranks.ids]) for k, v in primitive_inputs(ranks.num_ranks, seed).items()}
    out = {"jax_loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))}
    for name, t in x.items():
        out[f"all_gather_{name}"] = ranks.all_gather(t).numpy()
        out[f"fwd_{name}"] = _rows(ranks, ranks.shift_fwd(t).numpy())
        out[f"back_{name}"] = _rows(ranks, ranks.shift_back(t).numpy())
        for i, (_, pairs) in enumerate(tree_schedule(ranks.num_ranks)):
            out[f"tree{i}_{name}"] = _rows(ranks, ranks.ppermute(t, pairs).numpy())
        # a value held once a process (no rank dim): every process proposes
        # its first local row and takes rank 0's
        out[f"bcast_{name}"] = ranks.gather_objects(ranks.broadcast(t[0]).numpy())
    for op in ("min", "max", "sum"):
        for name in ("i32", "f64", "f32"):
            out[f"{op}_{name}"] = ranks.all_reduce(x[name], op).numpy()
    out["any_bool"] = ranks.all_reduce(x["bool"], "any").numpy()
    # every rank proposes another value; all must take rank 0's
    out["agree"] = ranks.gather_objects(ranks.agree(bool(x["bool"][0, 0]) ^ (ranks.rank > 0)))
    out["gather"] = ranks.gather_objects(ranks.ids)
    out["scatter"] = ranks.scatter_objects([[f"to {r}" for r in ids] for ids in ranks.process_ids()]
                                           if ranks.is_root else None)
    out["scatter"] = ranks.gather_objects(out["scatter"])
    return out if ranks.is_root else None


def fail_on(ranks, bad: int):
    """Rank ``bad`` raises; the others wait in a collective it never joins."""
    if ranks.rank == bad:
        raise RuntimeError(f"rank {bad} was told to fail")
    ranks.all_gather(torch.zeros((1, 1)))
    return "unreachable"


def ranks_device(ranks):
    """A process group's rank device; a batched group runs on the CPU here."""
    return getattr(ranks, "device", "cpu")


def pipelines(ranks, cases):
    """``run_pipeline_sharded`` per case ``(n, nb, gx, gy, dtype)`` -> rank
    0's ``(cost, tour ids, block costs)``, in case order."""
    out = []
    for n, nb, gx, gy, dtype in cases:
        res = run_pipeline_sharded(n, nb, gx, gy, ranks, dtype=dtype, device=ranks_device(ranks))
        out.append(None if res is None else (res.cost, res.tour_ids, res.block_costs))
    return out if ranks.is_root else None


def rings(ranks, tour: np.ndarray, d: np.ndarray, rounds):
    """``ring_two_opt`` of ``tour`` on ``d`` for each ``rounds`` value, then
    ``improve_tour``'s ring branch, and each shape error's message."""
    t, dt = torch.from_numpy(tour), torch.from_numpy(d)
    out = {"ring": [ring_two_opt(t, dt, ranks, rounds=r).numpy() for r in rounds]}
    order, length = improve_tour(t, dt, ranks)
    out["improve"] = (order.numpy(), float(length))
    errors = []
    for bad in (t[:-1], t[: 3 * ranks.num_ranks]):
        try:
            ring_two_opt(bad, dt, ranks)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out if ranks.is_root else None


def _fields(res) -> dict:
    """Every timing-free field of a sharded solve."""
    return dict(
        cost=res.cost, tour=[int(c) for c in res.tour], proven=res.proven_optimal,
        lb=res.lower_bound, lb_raw=res.lower_bound_raw, root_lb=res.root_lower_bound,
        nodes=res.nodes_expanded, per_rank=[int(x) for x in res.nodes_per_rank],
        iterations=res.iterations, steps=res.steps_run,
        spill=[res.spill_rounds, res.spill_events, res.spill_full_merges, res.spill_bytes_to_host,
               res.spill_bytes_to_device],
        balance=res.balance, saves=len(res.checkpoint_save_s),
    )


def sharded(ranks, cases):
    """``solve_sharded`` per case ``(d, kw, fault spec or None)`` -> rank
    0's timing-free fields, the ``balance.steal`` seam's hits on every rank
    and every rank's iterations, in case order."""
    out = []
    for d, kw, spec in cases:
        faults.configure(spec)
        try:
            res = bb.solve_sharded(d, ranks.num_ranks, device=ranks_device(ranks), ranks=ranks, **kw)
            hits = ranks.gather_objects(faults.registry().hits("balance.steal"))
        finally:
            faults.clear()
        its = ranks.gather_objects(res.iterations)
        out.append((_fields(res), hits, its))
    return out if ranks.is_root else None


def telemetry_rank(ranks, d: np.ndarray, kw: dict):
    """``solve_sharded`` of ``d`` -> rank 0's telemetry blocks (the series
    with its timing columns reduced to their row count), after checking
    that every rank process returns the same rank view."""
    res = bb.solve_sharded(d, ranks.num_ranks, device=ranks_device(ranks), ranks=ranks, **kw)
    cols = res.series["columns"]
    keep = [cols.index(c) for c in ("step", "nodes", "frontier", "spill_to_host", "spill_to_device",
                                    "incumbent", "lb_floor", "reservoir")]
    series = {k: v for k, v in res.series.items() if k != "rows"}
    series["rows"] = [[r[i] for i in keep] for r in res.series["rows"]]
    series["timing_rows"] = len(res.series["rows"])
    views = ranks.gather_objects((res.rank_series, res.rank_balance, series))
    if views is None:
        return None
    if any(v != views[0] for v in views):
        raise AssertionError("the rank processes disagree on the rank view")
    return dict(rank_series=res.rank_series, rank_balance=res.rank_balance, series=series,
                anomalies=res.anomalies, spill_events=res.spill_events)

"""Compute a JAX-package oracle in a fresh interpreter with a fresh ``HOME``.

A module-scoped fixture is built before the function-scoped autouse
fixtures of its first test, so an oracle computed there in the pytest
worker's own process is exposed to whatever the worker's earlier test
files left behind: the JAX AOT store switched on by a CLI or a serve test
(``compile_cache._enabled_dir`` and its in-process executable memo, which
can hand back an executable of another mesh), the fault registry, the
telemetry switch. :func:`call` runs one of the oracle functions below in a
child process set up as ``tests/conftest.py`` sets up the workers (8
virtual CPU devices, float64), with the AOT store, faults, telemetry
overrides and trace sink of the environment removed, and returns its
pickled result.

The child runs this file as a script; it imports nothing of the port.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: environment switches of the JAX package that must not reach the oracle
_DROPPED_ENV = ("TSP_FAULTS", "TSP_OBS", "TSP_TRACE", "TSP_CONTRACTS", "TSP_COMPILE_CACHE")


def call(name: str, *args, timeout_s: float = 600.0, **kwargs):
    """``name(*args, **kwargs)`` of this module, in a fresh interpreter."""
    with tempfile.TemporaryDirectory(prefix="jax_fresh_") as tmp:
        req, out = os.path.join(tmp, "req.pkl"), os.path.join(tmp, "out.pkl")
        with open(req, "wb") as fh:
            pickle.dump((name, args, kwargs), fh)
        env = {k: v for k, v in os.environ.items() if k not in _DROPPED_ENV}
        env.update(HOME=tmp, JAX_PLATFORMS="cpu", TSP_COMPILE_CACHE="off",
                   PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep))
        proc = subprocess.run([sys.executable, __file__, req, out], env=env, capture_output=True,
                              text=True, timeout=timeout_s)
        if proc.returncode != 0:
            raise RuntimeError(f"oracle {name}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        with open(out, "rb") as fh:
            return pickle.load(fh)


# --------------------------------------------------------------------------- the oracles


def solve_sharded(d, ranks: int, **kw):
    """``branch_bound.solve_sharded`` on the first ``ranks`` virtual devices."""
    from tsp_mpi_reduction_tpu.models import branch_bound as jbb
    from tsp_mpi_reduction_tpu.parallel.mesh import make_rank_mesh

    return jbb.solve_sharded(d, make_rank_mesh(ranks), **kw)


def solve_sharded_many(cases):
    """``[(d, ranks, kw), ...]`` -> the :func:`solve_sharded` results, in one process."""
    return [solve_sharded(d, ranks, **kw) for d, ranks, kw in cases]


def step_chain(instance: str, k: int, steps: int, dispatches: int, warm: int, capacity: int,
               use_mst: bool = False):
    """The root ``bench.py`` step child's chain under the reference step:
    ``warm`` steps from the root, then 1 + ``dispatches`` dispatches of
    ``_expand_loop_ref``, each from the same warm frontier and carrying
    only the incumbent -> (final incumbent, nodes of the last dispatch,
    row bytes)."""
    import jax.numpy as jnp
    import numpy as np

    from tsp_mpi_reduction_tpu.models import branch_bound as bb
    from tsp_mpi_reduction_tpu.utils import tsplib

    d = tsplib.embedded(instance).distance_matrix()
    n = d.shape[0]
    bd = bb._bound_setup(d, "one-tree", node_ascent=0, ascent="host")
    d64 = np.asarray(d, np.float64)
    tour = bb.nearest_neighbor_tour(d64)
    inc_cost = jnp.asarray(bb.tour_cost(d64, tour), jnp.float32)
    inc_tour = jnp.asarray(tour, jnp.int32)
    fr = bb.make_root_frontier(n, capacity, np.asarray(bd.min_out, np.float64))
    args = (jnp.asarray(d, jnp.float32), bd.min_out, bd.bound_adj, bd.dbar, bd.pi, bd.slack,
            bd.ascent_step, bd.lam_budget)
    fr, inc_cost, inc_tour, _ = bb._expand_loop_ref(fr, inc_cost, inc_tour, *args, k, n, warm,
                                                    bd.integral, True, 0, "prim", "best-first", 0,
                                                    "reference")
    c, nodes = inc_cost * 1.0, 0
    for _ in range(1 + dispatches):
        _, c, _, nodes = bb._expand_loop_ref(fr, c, inc_tour, *args, k, n, steps, bd.integral,
                                             use_mst, 0, "prim", "best-first", 0, "reference")
    return {"final_incumbent": float(c), "nodes": int(nodes), "row_bytes": int(fr.nodes.shape[-1]) * 4}


def guarded_steps_many(cases):
    """``[(rows, count, inc_cost, inc_tour, d, kw), ...]`` -> for each, the
    JAX package's device loop (``_solve_device``: ``_guarded_expand_steps``
    in one program) from that packed frontier and incumbent, with
    ``kw``'s bound, k, budget, re-sort period and start step, the
    reference push and the plain Prim chain -> ``{nodes, count,
    overflow, inc_cost, inc_tour, popped, steps, best_step}`` as numpy."""
    import jax.numpy as jnp
    import numpy as np

    from tsp_mpi_reduction_tpu.models import branch_bound as bb

    out = []
    for rows, count, inc_cost, inc_tour, d, kw in cases:
        n = d.shape[0]
        bd = bb._bound_setup(d, kw["bound"], node_ascent=kw["node_ascent"])
        fr = bb.Frontier(jnp.asarray(rows), jnp.asarray(count, jnp.int32), jnp.asarray(False))
        fr, ic, itour, popped, steps, best = bb._solve_device(
            fr, jnp.asarray(inc_cost, jnp.float32), jnp.asarray(inc_tour, jnp.int32),
            jnp.asarray(d, jnp.float32), bd.min_out, bd.bound_adj, bd.dbar, bd.pi, bd.slack,
            bd.ascent_step, bd.lam_budget, jnp.asarray(kw["max_steps"], jnp.int32),
            jnp.asarray(kw["step0"], jnp.int32), k=kw["k"], n=n, integral=bd.integral,
            use_mst=kw["use_mst"], node_ascent=kw["node_ascent"], reorder_every=kw["reorder_every"],
            mst_kernel="prim", push_order="best-first", push_block=0, step_kernel="reference")
        out.append({"nodes": np.asarray(fr.nodes), "count": int(fr.count), "overflow": bool(fr.overflow),
                    "inc_cost": float(ic), "inc_tour": np.asarray(itour), "popped": int(popped),
                    "steps": int(steps), "best_step": int(best)})
    return out


def rank_loops_many(cases):
    """``[(rows, count, overflow, inc_cost, inc_tour, d, kw), ...]`` -> for
    each, one rank's loop of the JAX package from that packed frontier and
    incumbent: ``kw["loop"]`` "guarded" is the device loop
    (``_solve_device``: ``_guarded_expand_steps`` with ``max_steps``, the
    re-sort period and start step), "host" the host loop's
    ``_expand_loop_ref`` (``max_steps`` as ``inner_steps``); ``kw``'s
    bound, k, MST screen and node ascent, the plain Prim chain and the
    reference push -> ``{nodes, count, overflow, inc_cost, inc_tour,
    popped, steps, best_step}`` as numpy (``steps`` and ``best_step`` None
    for the host loop)."""
    import jax.numpy as jnp
    import numpy as np

    from tsp_mpi_reduction_tpu.models import branch_bound as bb

    out = []
    for rows, count, overflow, inc_cost, inc_tour, d, kw in cases:
        n = d.shape[0]
        bd = bb._bound_setup(d, kw["bound"], node_ascent=kw["node_ascent"])
        fr = bb.Frontier(jnp.asarray(rows), jnp.asarray(count, jnp.int32), jnp.asarray(bool(overflow)))
        args = (jnp.asarray(inc_cost, jnp.float32), jnp.asarray(inc_tour, jnp.int32), jnp.asarray(d, jnp.float32),
                bd.min_out, bd.bound_adj, bd.dbar, bd.pi, bd.slack, bd.ascent_step, bd.lam_budget)
        steps = best = None
        if kw["loop"] == "guarded":
            fr, ic, itour, popped, steps, best = bb._solve_device(
                fr, *args, jnp.asarray(kw["max_steps"], jnp.int32), jnp.asarray(kw["step0"], jnp.int32),
                k=kw["k"], n=n, integral=bd.integral, use_mst=kw["use_mst"], node_ascent=kw["node_ascent"],
                reorder_every=kw["reorder_every"], mst_kernel="prim", push_order="best-first", push_block=0,
                step_kernel="reference")
            steps, best = int(steps), int(best)
        else:
            fr, ic, itour, popped = bb._expand_loop_ref(
                fr, *args, kw["k"], n, kw["max_steps"], bd.integral, kw["use_mst"], kw["node_ascent"], "prim",
                "best-first", 0, "reference")
        out.append({"nodes": np.asarray(fr.nodes), "count": int(fr.count), "overflow": bool(fr.overflow),
                    "inc_cost": float(ic), "inc_tour": np.asarray(itour), "popped": int(popped),
                    "steps": steps, "best_step": best})
    return out


def balance_steps_many(cases):
    """``[(action, nodes [R, F, C], counts [R], round_i, t_slots, capacity,
    phys_rows), ...]`` -> for each, the JAX package's balance step under
    ``shard_map`` on R virtual devices, as the sharded solve's rank bodies
    call it -> ``(nodes, counts, m_out)`` as numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from tsp_mpi_reduction_tpu.parallel import balance as jbal
    from tsp_mpi_reduction_tpu.parallel.mesh import RANK_AXIS, make_rank_mesh
    from tsp_mpi_reduction_tpu.utils.backend import shard_map

    out = []
    for action, nodes, counts, round_i, t_slots, capacity, phys_rows in cases:
        r = nodes.shape[0]
        perm_fwd = [(i, (i + 1) % r) for i in range(r)]
        perm_back = [((i + 1) % r, i) for i in range(r)]

        def body(nd, c, ri, action=action, r=r, t_slots=t_slots, capacity=capacity, phys_rows=phys_rows,
                 perm_fwd=perm_fwd, perm_back=perm_back):
            nd2, c2, m = jbal.apply(action, nd[0], c[0], ri, num_ranks=r, t_slots=t_slots, capacity=capacity,
                                    phys_rows=phys_rows, perm_fwd=perm_fwd, perm_back=perm_back)
            return nd2[None], c2[None], m[None]

        fn = jax.jit(shard_map(body, mesh=make_rank_mesh(r), in_specs=(P(RANK_AXIS), P(RANK_AXIS), P()),
                               out_specs=(P(RANK_AXIS), P(RANK_AXIS), P(RANK_AXIS))))
        got = fn(jnp.asarray(nodes), jnp.asarray(counts, jnp.int32), jnp.asarray(round_i, jnp.int32))
        out.append(tuple(np.asarray(x) for x in got))
    return out


def fold_blocks_many(configs):
    """``[(n, blocks, gx, gy), ...]`` -> for each, the JAX package's blocked
    instance folded by its ``fold_tours`` in float64: the block solve eager
    (outside ``jit``) on host-computed float64 distances, the oracle's
    layout -> ``{tours, costs, dist, ids, length, cost}`` as numpy."""
    import jax.numpy as jnp
    import numpy as np

    from tsp_mpi_reduction_tpu.ops import held_karp as jhk
    from tsp_mpi_reduction_tpu.ops import merge as jmerge
    from tsp_mpi_reduction_tpu.ops.distance import distance_matrix_np
    from tsp_mpi_reduction_tpu.ops.generator import generate_instance

    out = []
    for n, nb, gx, gy in configs:
        _, xy = generate_instance(n, nb, gx, gy)
        costs, local = jhk.solve_blocks_from_dists(distance_matrix_np(np.asarray(xy, np.float64)))
        tours = np.asarray(local, np.int32) + (np.arange(nb, dtype=np.int32) * n)[:, None]
        dist = distance_matrix_np(np.asarray(xy, np.float64).reshape(-1, 2))
        ids, length, cost = jmerge.fold_tours(jnp.asarray(tours), costs, jnp.asarray(dist))
        out.append({"tours": tours, "costs": np.asarray(costs), "dist": dist, "ids": np.asarray(ids),
                    "length": int(length), "cost": float(cost)})
    return out


def _main(req: str, out: str) -> int:
    import jax

    from tsp_mpi_reduction_tpu.utils.backend import force_host_platform

    force_host_platform(8)
    jax.config.update("jax_enable_x64", True)
    with open(req, "rb") as fh:
        name, args, kwargs = pickle.load(fh)
    result = globals()[name](*args, **kwargs)
    with open(out, "wb") as fh:
        pickle.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_main(*sys.argv[1:3]))

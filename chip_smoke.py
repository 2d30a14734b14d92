#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tsp_mpi_reduction_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), then
   the CUDA kernels built from ``kernels/csrc`` for sm_90a;
2. kernel parity: each hand kernel against its plain PyTorch version,
   exactly (``torch.equal``), f32 and f64, with inf entries and ties
   (``relax_minplus`` at M in {1, 4, 9, 15, 16, 17}, J = 1, 130 and one
   row past a whole tile, ``g`` aligned or one element off a 16-byte
   boundary; the dense sweep against the per-level plain loop at m in {2,
   5, 9, 10, 11, 15, 17}); plus a check that ``argmin``/``argmax`` pick the
   first index on CUDA;
3. oracle parity: the CLI's ``10 6 500 500`` cost, and the goldens'
   block solutions, fold costs and final tour in float64 under the
   ``fused`` and ``pallas`` impls; ``--ranks=4`` equal under fused/compact;
4. full size: n = 16 cities per block (the reference's cap), 1024 blocks,
   1000x1000, float32, impl ``auto`` — phase times, the final line, the
   sweep's h + 1 launches, fused against plain compact on one distance
   tensor (exact), the sweep against the per-level plain loop at full size
   in float32 and float64 (exact), ``relax_minplus`` on the 14 compact
   steps of the pallas path rebuilt from the finished table (exact),
   per-kernel times from CUDA events (eager and CUDA-graph replay;
   ``relax_dense`` per solve and per launch) with the kernels' bounds,
   and each impl's wall time;
5. ``prim_chain`` parity: the B&B Prim kernel against its plain version
   on the same CUDA tensors, bit for bit (``tot`` as int32 bits, ``deg``
   exactly), n in {5, 14, 33, 51, 96, 97, 100, 200}, k in {37, 300, 1024},
   with and without per-lane ``lam``, integer and non-integer ``dbar``,
   -0.0 and +inf in ``dbar``, |U| in {0, 1, 2, n} mixed across lanes;
6. B&B proofs through the CLI entry point (``tools/bnb_solve``, defaults:
   the device loop, ``mst_kernel`` and ``step_kernel`` auto): burma14 3323,
   ulysses16 6859, berlin52 7542; and ulysses16 under min-out with no ILS
   (host loop) expands the same nodes under the kernel and under the plain
   chain;
7. the B&B full-size run through the default CLI: eil51 at k = 1024,
   capacity 2^18, one-tree, node_ascent 2, the device loop with the fused
   push — proves 426 from root bound 423 in 153,747 nodes, with one
   ``push_rows`` and (1 + node_ascent) ``prim_chain`` launches per step;
   the same under ``--step-kernel=reference``; setup/search seconds,
   nodes/s, time to proof and the largest frontier count of both; both B&B
   kernels on the main path's recorded inputs (every launch, bit for bit
   against the plain versions, then timed eager and by CUDA-graph replay
   beside their bounds and plain versions; ``prim_chain`` also on
   synthetic half-visited lanes; ``push_rows`` beside its launch floor, an
   empty kernel on the same grid, and with the children one parent
   pushes), ``push_rows`` against the reference push section;
8. ``push_rows`` parity: the kernel against its plain version on the same
   CUDA tensors, the whole buffer bit for bit, n in {5, 13, 14, 33, 51,
   100, 128, 200}, k in {1, 11, 37, 1024}, nothing / some / everything
   pushed (then up to row F-1) / one parent pushing all n children, NaN,
   -0.0 and inf bit patterns in the float columns;
9. one chunk of the kroA100 certified-gap campaign through the CLI (k =
   1024, capacity 2^19, node_ascent 6, re-sort every 16 steps, device
   loop, 300 steps) under the fused and the reference push: both equal
   the JAX package's numbers for the same call on the CPU (nodes,
   iterations, cost, certified LB, every spill counter); ``push_rows`` on
   the recorded inputs of every launch of the chunk, bit for bit, and
   ``prim_chain`` on those of its first 20 steps, checked and timed;
10. a spill-forcing proof (13 random cities, capacity at the device
    loop's 4*k*(n-1) floor): compacts on the card, exchanges with the host
    reservoir and proves, fused == reference == the JAX package's pinned
    numbers.

Each main path (phase 4's Held-Karp run, phase 7's eil51 and phase 9's
kroA100 runs) runs with the kernels' launch counts reset just before and
read just after; a kernel of the path that never launched fails the run.
The last two lines are the per-kernel JSON and ``{"ok": true, ...}``. In
the JSON every kernel's ``ms`` is its eager time by CUDA events (the
host's launch gaps included) and ``device_ms`` the same launches replayed
from a CUDA graph (the device's time alone); ``per`` says the unit: a
launch, or for ``relax_dense`` one sweep (a whole DP of
``launches_per_solve`` launches), with its bound for the same work. The
timing helpers are ``tsp_mpi_reduction_tpu_torch/tools/kernel_times.py``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "goldens"

N_FULL, B_FULL, GRID_FULL = 16, 1024, 1000
KERNEL_SOURCE = "tsp_mpi_reduction_tpu_torch/kernels/csrc/held_karp_relax.cu"
PRIM_SOURCE = "tsp_mpi_reduction_tpu_torch/kernels/csrc/prim_chain.cu"
PUSH_SOURCE = "tsp_mpi_reduction_tpu_torch/kernels/csrc/push_rows.cu"
REPLACES = {
    "relax_minplus": "tsp_mpi_reduction_tpu/ops/held_karp_pallas.py:74",
    "relax_dense": "tsp_mpi_reduction_tpu/ops/held_karp_pallas.py:173",
    "prim_chain": "tsp_mpi_reduction_tpu/ops/prim_pallas.py:155",
    "push_rows": "tsp_mpi_reduction_tpu/ops/expand_pallas.py:214",
}
# the B&B full-size run (BENCHMARKS.md:112): eil51 at the width users run
BNB_FULL = ("eil51", 1024, 1 << 18)
BNB_FULL_NODES, BNB_FULL_COST, BNB_FULL_ROOT_LB = 153_747, 426.0, 423.0
# ulysses16, min-out, no ILS, k = 32, 3000 steps: the JAX host loop's count
TRAJECTORY_NODES = 96_208
# one chunk of the kroA100 campaign (tools/tpu_bench.sh:130-134) and the
# JAX package's numbers for the same call on the CPU (solve(d, k=1024,
# capacity=1 << 19, node_ascent=6, reorder_every=16, device_loop=True,
# max_iters=300))
KRO_ARGS = ["kroA100", "--k=1024", "--capacity=524288", "--node-ascent=6", "--reorder-every=16",
            "--device-loop=on", "--max-iters=300"]
KRO_PINNED = {"nodes_expanded": 303_204, "iterations": 300, "cost": 21282.0,
              "lower_bound": 21041.375, "proven_optimal": False, "spill_rounds": 3,
              "spill_events": 3, "spill_full_merges": 0, "spill_bytes_to_host": 157_217_676,
              "spill_bytes_to_device": 103_809_024}
# the spill-forcing proof: 13 random cities (numpy seed 1, rounded x10
# Euclidean), min-out, no MST re-bound, k = 8, capacity 4*k*(n-1) = 384;
# the JAX package's device-loop numbers on the CPU
SPILL_KW = dict(capacity=384, k=8, bound="min-out", mst_prune=False, node_ascent=0, ils_rounds=0,
                max_iters=2_000_000)
SPILL_PINNED = {"nodes_expanded": 26_900, "iterations": 3381, "cost": 3154.0,
                "lower_bound": 3154.0, "proven_optimal": True, "spill_rounds": 14,
                "spill_events": 14, "spill_full_merges": 0, "spill_bytes_to_host": 95_724,
                "spill_bytes_to_device": 95_724}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries finite in both; inf where a and b
    disagree on which entries are infinite."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return math.inf
    if not fa.any():
        return 0.0
    return float((a[fa].double() - b[fb].double()).abs().max())


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from tsp_mpi_reduction_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    _build.library()
    _build.prim_library()
    _build.push_library()
    print(f"phase 1 build: {len(libs)} libraries built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs)})")
    return smi


def phase_kernel_parity(errs):
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

    checked = 0
    for m in (1, 4, 9, 15, 16, 17):
        for dt in (torch.float32, torch.float64):
            # J = 1, 130, and one row past a whole tile (a ragged last tile);
            # g aligned to 16 bytes or one element off
            for j in (1, 130, hkk.minplus_tile_rows(m) + 1):
                for offset in (0, 1):
                    rng = np.random.default_rng(m * j)
                    g = np.round(rng.uniform(0, 100, (3, j, m)))  # rounded: many ties
                    g[rng.uniform(size=g.shape) < 0.2] = np.inf
                    d_t = np.round(rng.uniform(0, 50, (3, m, m)))
                    if j > 4:
                        g[:, 3] = np.inf  # an all-inf row: inf with parent 0
                        g[:, 4] = 7.0
                        d_t[0] = 2.0  # block 0, row 4: every candidate ties, parent 0
                    store = torch.empty(g.size + offset, dtype=dt, device="cuda")
                    gt = store[offset:].view(g.shape)
                    gt.copy_(torch.tensor(g, dtype=dt))
                    dtt = torch.tensor(d_t, dtype=dt, device="cuda")
                    c_k, p_k = hkk.relax_minplus(gt, dtt)
                    c_p, p_p = hkk.relax_minplus_reference(gt, dtt)
                    torch.cuda.synchronize()
                    require(torch.equal(c_k, c_p) and torch.equal(p_k, p_p),
                            f"relax_minplus != plain at M={m} J={j} offset={offset} {dt}")
                    errs["relax_minplus"] = max(errs["relax_minplus"], max_abs_err(c_k, c_p))
                    checked += 1
    for m in (2, 5, 9, 10, 11, 15, 17):
        for dt in (torch.float32, torch.float64):
            rng = np.random.default_rng(m)
            bsz = 4 if m < 15 else 2
            d = np.round(rng.uniform(0, 50, (bsz, m, m)))  # rounded: many ties
            d[rng.uniform(size=d.shape) < 0.05] = 0.0
            d[rng.uniform(size=d.shape) < 0.05] = np.inf
            d_sub = torch.tensor(d, dtype=dt, device="cuda")
            tab = torch.full((bsz, m, 1 << m), math.inf, dtype=dt, device="cuda")
            tab[:, :, 0] = torch.tensor(np.round(rng.uniform(0, 50, (bsz, m))), dtype=dt)
            tab[0, m - 1, 0] = math.inf
            ref = tab.clone()
            for c in range(1, m):
                ref = hkk.relax_dense_reference(ref, d_sub, c)
            got = hkk.relax_dense_sweep(tab, d_sub)
            torch.cuda.synchronize()
            require(got is tab and torch.equal(ref, tab), f"relax_dense_sweep != plain per-level loop at m={m} {dt}")
            errs["relax_dense"] = max(errs["relax_dense"], max_abs_err(tab, ref))
            checked += 1

    # first-index ties of argmin / argmax on CUDA (merge and backtrack rely on it)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 5, size=(16385 * 17,)).astype(np.float32)
    xt = torch.tensor(x, device="cuda")
    require(int(xt.argmin()) == int(np.argmin(x)), "flat argmin is not first-index on CUDA")
    rows = rng.integers(0, 3, size=(4096, 15)).astype(np.float64)
    require(torch.equal(torch.tensor(rows, device="cuda").argmin(dim=1).cpu(),
                        torch.tensor(np.argmin(rows, axis=1))), "row argmin not first-index")
    flags = rng.uniform(size=20000) < 0.01
    require(int(torch.tensor(flags, device="cuda").to(torch.int32).argmax()) == int(np.argmax(flags)),
            "argmax over int32 flags is not first-index on CUDA")
    # the B&B call sites: [k*n] flat (completions), [k, n] rows (Prim chain,
    # connection edges, 2-opt/Or-opt deltas) and int32 row argmax (start city)
    flat = rng.integers(0, 3, size=(1024 * 51,)).astype(np.float32)
    flat[rng.uniform(size=flat.shape) < 0.5] = np.inf
    require(int(torch.tensor(flat, device="cuda").argmin()) == int(np.argmin(flat)),
            "[k*n] argmin is not first-index on CUDA")
    kn = rng.integers(0, 3, size=(1024, 51)).astype(np.float32)
    kn[rng.uniform(size=kn.shape) < 0.3] = np.inf
    kn[5] = np.inf  # an all-inf row: index 0
    require(torch.equal(torch.tensor(kn, device="cuda").argmin(dim=1).cpu(),
                        torch.tensor(np.argmin(kn, axis=1))), "[k, n] row argmin not first-index")
    bits = (rng.uniform(size=(1024, 51)) < 0.3).astype(np.int32)
    bits[7] = 0  # an all-zero row: index 0
    require(torch.equal(torch.tensor(bits, device="cuda").argmax(dim=1).cpu(),
                        torch.tensor(np.argmax(bits, axis=1))), "[k, n] int32 row argmax not first-index")
    print(f"phase 2 kernel parity: {checked} exact comparisons, argmin/argmax first-index on ties")


def phase_oracle():
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_ranks
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
    from tsp_mpi_reduction_tpu_torch.ops.merge import PaddedTour, make_padded, merge_tours
    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices
    from tsp_mpi_reduction_tpu_torch.utils import cli
    from tsp_mpi_reduction_tpu_torch.utils.state import instance_from_numpy

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["10", "6", "500", "500", "--dtype=float64"])
    line = buf.getvalue().strip().splitlines()[-1]
    require(rc == 0 and line.endswith(" ms for 60 cities and the trip cost 3720.557435"),
            f"CLI 10 6 500 500: rc={rc} {line!r}")
    print(f"phase 3 cli: {line}")

    dev = torch.device("cuda")
    for name in ("full_16x200_1000x1000.json", "full_10x100_1000x1000.json"):
        g = json.loads((GOLDENS / name).read_text())
        cfg = g["config"]
        n, nb = cfg["ncpb"], cfg["nblocks"]
        _, xy = generate_instance(n, nb, cfg["gx"], cfg["gy"])
        _, dist = instance_from_numpy(xy, torch.float64, dev)
        block_d = block_distance_slices(dist, nb, n)
        for impl in ("fused", "pallas"):
            with held_karp.use_impl(impl):
                costs, tours = held_karp.solve_blocks_from_dists(block_d, torch.float64)
            gtours = tours + (torch.arange(nb, device=dev, dtype=torch.int32) * n)[:, None]
            want_c = torch.tensor([s["cost"] for s in g["block_solutions"]], dtype=torch.float64)
            want_t = torch.tensor([s["ids"] for s in g["block_solutions"]], dtype=torch.int32)
            require(torch.equal(costs.cpu(), want_c), f"{name} {impl}: block costs differ")
            require(torch.equal(gtours.cpu(), want_t), f"{name} {impl}: block tours differ")
            cap = nb * n + 1
            acc = make_padded(gtours[0], n + 1, costs[0], cap)
            length = torch.tensor(n + 1, dtype=torch.int32, device=dev)
            fold_costs = []
            for b in range(1, nb):
                acc = merge_tours(acc, PaddedTour(gtours[b], length, costs[b]), dist)
                fold_costs.append(acc.cost)
            require(torch.equal(torch.stack(fold_costs).cpu(),
                                torch.tensor(g["fold_costs"], dtype=torch.float64)),
                    f"{name} {impl}: fold costs differ")
            final_len = int(acc.length)
            require(float(acc.cost) == g["final"]["cost"]
                    and acc.ids[:final_len].cpu().tolist() == g["final"]["ids"],
                    f"{name} {impl}: final tour differs")
        print(f"phase 3 golden {name}: block costs+tours, {nb - 1} fold costs, final tour "
              f"and cost {g['final']['cost']!r} exact under fused and pallas (float64)")

    got = {}
    for impl in ("fused", "compact"):
        with held_karp.use_impl(impl):
            got[impl] = run_pipeline_ranks(10, 100, 1000, 1000, 4, dtype=torch.float64, device=dev)
    require(got["fused"].cost == got["compact"].cost
            and np.array_equal(got["fused"].tour_ids, got["compact"].tour_ids),
            "--ranks=4: fused and compact differ")
    print(f"phase 3 ranks=4 (10x100): cost {got['fused'].cost:f} under fused == compact (float64)")


def phase_full(smi, errs):
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices, run_pipeline
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt
    from tsp_mpi_reduction_tpu_torch.utils import reporting

    n, nb, m = N_FULL, B_FULL, N_FULL - 1
    dt = torch.float32
    dev = torch.device("cuda")

    # --- the main path: impl auto (relax_dense_sweep), counts reset just before
    hkk.reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(n, nb, GRID_FULL, GRID_FULL, dtype=dt, device=dev)
    elapsed_ms = int((time.perf_counter() - t0) * 1000)
    launches_main = dict(hkk.LAUNCHES)
    require(held_karp.effective_impl(dev) == "fused", "auto does not resolve to fused on CUDA")
    want_sweep = hkk.sweep_launches(m)  # h + 1, one launch per popcount of the high bits
    require(launches_main["relax_dense"] == want_sweep,
            f"main path launched relax_dense {launches_main['relax_dense']} times, want {want_sweep} "
            f"(l = {hkk.sweep_low_bits(m)})")
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in res.phase_seconds.items())
    print(f"phase 4 main path (n={n}, {nb} blocks, {GRID_FULL}x{GRID_FULL}, float32, auto=fused): {phases}")
    print(f"phase 4 {reporting.final_line(elapsed_ms, res.num_cities, res.cost)}")
    tour = res.tour_ids
    require(math.isfinite(res.cost) and tour[0] == tour[-1]
            and np.array_equal(np.sort(tour[:-1]), np.arange(n * nb)),
            "full-size tour is not a closed tour over every city")

    # --- the pallas path: relax_minplus, counts reset just before
    hkk.reset_launches()
    with held_karp.use_impl("pallas"):
        res_p = run_pipeline(n, nb, GRID_FULL, GRID_FULL, dtype=dt, device=dev)
    launches_pallas = dict(hkk.LAUNCHES)
    require(launches_pallas["relax_minplus"] == m - 1,
            f"pallas path launched relax_minplus {launches_pallas['relax_minplus']} times")
    require(res_p.cost == res.cost and np.array_equal(res_p.tour_ids, res.tour_ids),
            "pallas path differs from the fused main path")
    print(f"phase 4 pallas path: launches {launches_pallas}, result == main path")

    # --- every impl on one distance tensor: exact agreement, wall time
    block_d = block_distance_slices(res.dist, nb, n)
    del res_p
    results, walls = {}, {}
    for impl in ("compact", "dense", "fused", "pallas"):
        with held_karp.use_impl(impl):
            held_karp.solve_blocks_from_dists(block_d, dt)  # warm-up
            (c, t), walls[impl] = wall_s(lambda: held_karp.solve_blocks_from_dists(block_d, dt))
        results[impl] = (c, t)
    for impl in ("dense", "fused", "pallas"):
        require(torch.equal(results[impl][0], results["compact"][0])
                and torch.equal(results[impl][1], results["compact"][1]),
                f"{impl} differs from plain compact at full size")
    require(torch.equal(results["fused"][0].cpu(), torch.as_tensor(res.block_costs)),
            "solve on the pipeline's distances differs from the pipeline's block costs")
    # each block cost is its tour's length, summed in another order
    costs, tours = results["fused"]
    bidx = torch.arange(nb, device=dev)[:, None]
    tour_len = block_d[bidx, tours[:, :-1].long(), tours[:, 1:].long()].double().sum(dim=1)
    rel = float(((tour_len - costs.double()).abs() / tour_len).max())
    require(rel < 1e-5, f"block cost vs tour length: rel err {rel} >= 1e-5 (float32)")
    print("phase 4 impl wall times (s): " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
          + f"; fused == dense == pallas == compact exactly; block cost vs tour length rel err {rel:.2e}")
    del results

    # --- per-kernel timing at the main path's shapes: the whole sweep
    # against the per-level plain loop (exact), per solve and per launch
    d_sub = block_d[:, 1:, 1:].contiguous()
    tab = torch.full((nb, m, 1 << m), math.inf, dtype=dt, device=dev)
    tab[:, :, 0] = block_d[:, 0, 1:]
    reps = 5
    dense = kt.time_dense(d_sub, tab, reps)
    errs["relax_dense"] = max(errs["relax_dense"], dense["max_abs_err"])
    # the same exactness in float64 at full size (parity mode's type)
    d64, tab64 = d_sub.double(), torch.full((nb, m, 1 << m), math.inf, dtype=torch.float64, device=dev)
    tab64[:, :, 0] = block_d[:, 0, 1:].double()
    ref64 = tab64.clone()
    for c in range(1, m):
        ref64 = hkk.relax_dense_reference(ref64, d64, c)
    hkk.relax_dense_sweep(tab64, d64)
    torch.cuda.synchronize()
    require(torch.equal(tab64, ref64), "relax_dense_sweep != plain per-level loop at full size, float64")
    errs["relax_dense"] = max(errs["relax_dense"], max_abs_err(tab64, ref64))
    del d64, tab64, ref64
    torch.cuda.empty_cache()

    # relax_minplus on the compact inputs of every step of the pallas path,
    # rebuilt from the finished table: exact, then timed
    gs, d_t = kt.minplus_inputs(tab, d_sub)
    del tab
    mp = kt.time_minplus(gs, d_t, reps)
    errs["relax_minplus"] = max(errs["relax_minplus"], mp["max_abs_err"])
    del gs
    torch.cuda.empty_cache()

    per = dense["launches_per_solve"]
    print(f"phase 4 kernel relax_dense (relax_dense_sweep, l = {hkk.sweep_low_bits(m)}): "
          f"{dense['ms_per_solve']:.4f} ms/solve eager, {dense['device_ms_per_solve']:.4f} ms/solve by CUDA "
          f"graph replay (CUDA events, mean of {reps}) = {dense['device_ms_per_solve'] / per:.4f} ms/launch "
          f"over {per} launches; {launches_main['relax_dense']} launches on the main path; bound "
          f"{dense['bound_ms_per_solve']:.4f} ms/solve ({dense['bound_by']}, every computed state written "
          f"once); plain per-level loop {dense['plain_ms_per_solve']:.4f} ms/solve; exact in float32 "
          f"and float64")
    print(f"phase 4 kernel relax_minplus ({mp['what']}): {mp['ms']:.4f} ms/launch eager, "
          f"{mp['device_ms']:.4f} ms/launch by CUDA graph replay (CUDA events, mean of {reps}x{m - 1}), "
          f"{launches_pallas['relax_minplus']} launches per solve, bound {mp['bound_ms']:.4f} ms "
          f"({mp['bound_by']}), plain {mp['plain_ms']:.4f} ms; exact on every step")
    print(f"phase 4 card: {smi}")
    return [
        {"name": "relax_minplus", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["relax_minplus"], "launches": launches_pallas["relax_minplus"],
         "max_abs_err": errs["relax_minplus"], "ms": mp["ms"], "device_ms": mp["device_ms"],
         "plain_ms": mp["plain_ms"], "bound_ms": mp["bound_ms"], "bound_by": mp["bound_by"],
         "library_ms": None, "per": "launch"},
        # times and bound per solve: one relax_dense_sweep call, all cardinalities
        {"name": "relax_dense", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["relax_dense"], "launches": launches_main["relax_dense"],
         "max_abs_err": errs["relax_dense"], "ms": dense["ms_per_solve"],
         "device_ms": dense["device_ms_per_solve"], "plain_ms": dense["plain_ms_per_solve"],
         "bound_ms": dense["bound_ms_per_solve"], "bound_by": dense["bound_by"], "library_ms": None,
         "per": "solve", "launches_per_solve": per},
    ]


# ---------------------------------------------------------------------------
# Branch-and-bound: the prim_chain kernel, proofs, the eil51 full-size run
# ---------------------------------------------------------------------------


def prim_lanes(n: int, k: int, integral: bool, seed: int):
    """``dbar [n, n]``, ``unvis [k, n]`` (city 0 visited) and integer
    ``lam [k, n]`` on the card, from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if integral:
        d = rng.integers(1, 500, size=(n, n)).astype(np.float32)
    else:
        d = (rng.random((n, n)) * 500).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0.0)
    pi = rng.integers(-20, 20, size=n).astype(np.float32)
    unvis = rng.random((k, n)) < rng.uniform(0.2, 0.9)
    unvis[:, 0] = False
    lam = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
    dev = "cuda"
    return (torch.tensor(d + pi[None, :] + pi[:, None], device=dev),
            torch.tensor(unvis, device=dev), torch.tensor(lam, device=dev))


def prim_edge_lanes(n: int, k: int, seed: int):
    """Lanes whose |U| cycles through 0, 1, 2, n (every city, 0 included)
    and a random size; ``dbar`` carries -0.0 and +inf entries, and city
    n - 1 is reachable only from city 0 (a lane whose U holds it stalls on
    +inf and its chain takes a city outside U first)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d = rng.integers(1, 500, size=(n, n)).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0.0)
    flat = d.reshape(-1)
    flat[rng.choice(n * n, size=n, replace=False)] = -0.0
    flat[rng.choice(n * n, size=n, replace=False)] = np.inf
    d[1:, n - 1] = np.inf
    unvis = np.zeros((k, n), bool)
    for i in range(k):
        size = (0, 1, 2, n, int(rng.integers(0, n + 1)))[i % 5]
        unvis[i, rng.permutation(n)[:size]] = True
    lam = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
    return (torch.tensor(d, device="cuda"), torch.tensor(unvis, device="cuda"),
            torch.tensor(lam, device="cuda"))


def prim_compare(dbar, unvis, n, lam, what, errs):
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

    tot, deg = prim_kernels.prim_chain(dbar, unvis, n, lam)
    ref_tot, ref_deg = prim_kernels.prim_chain_reference(dbar, unvis, n, lam)
    torch.cuda.synchronize()
    require(torch.equal(tot.view(torch.int32), ref_tot.view(torch.int32)) and torch.equal(deg, ref_deg),
            f"prim_chain != plain at {what}")
    errs["prim_chain"] = max(errs["prim_chain"], max_abs_err(tot, ref_tot),
                             max_abs_err(deg.double(), ref_deg.double()))


def phase_prim_parity(errs):
    import torch

    checked = 0
    for n in (5, 14, 51, 96, 97, 100, 200):
        for k in (37, 1024):
            for integral in (True, False):
                dbar, unvis, lam = prim_lanes(n, k, integral, seed=n * k + integral)
                for use_lam in (False, True):
                    prim_compare(dbar, unvis, n, lam if use_lam else None,
                                 f"n={n} k={k} integral={integral} lam={use_lam}", errs)
                    checked += 1
    dbar, _, lam = prim_lanes(14, 4, True, seed=3)
    unvis = torch.zeros((4, 14), dtype=torch.bool, device="cuda")
    unvis[1, 3] = True  # one unvisited city; lane 0 has none
    unvis[2, 3:6] = True
    for use_lam in (False, True):
        prim_compare(dbar, unvis, 14, lam if use_lam else None, "degenerate lanes", errs)
        checked += 1
    for n in (5, 33, 51, 96, 97, 100, 200):
        dbar, unvis, lam = prim_edge_lanes(n, 300, seed=n)
        for use_lam in (False, True):
            prim_compare(dbar, unvis, n, lam if use_lam else None, f"edge lanes n={n} lam={use_lam}", errs)
            checked += 1
    print(f"phase 5 prim_chain parity: {checked} bit-exact comparisons (tot bits, deg) "
          "n in 5..200 (96/97/100 across the old shared-memory edge), k in {37, 300, 1024}, lam on/off, "
          "integer and non-integer dbar, degenerate lanes, |U| in {0, 1, 2, n} mixed, -0.0 and +inf "
          "in dbar, a city reachable only from outside U")


def run_bnb_cli(argv):
    """The B&B CLI entry point in this process -> its JSON payload."""
    from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bnb_solve.main(argv)
    require(rc == 0, f"bnb_solve {argv}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_bnb_proofs():
    for name, opt, extra in (("burma14", 3323.0, ["--k=64", "--capacity=16384"]),
                             ("ulysses16", 6859.0, []), ("berlin52", 7542.0, [])):
        out = run_bnb_cli([name, "--backend=cuda", *extra])
        require(out["proven_optimal"] and out["cost"] == opt and out["mst_kernel"] == "prim_chain",
                f"{name}: {out['cost']} proven={out['proven_optimal']} kernel={out['mst_kernel']}")
        require(out["prim_chain_launches"] == 3 * out["steps_run"] > 0
                and out["push_rows_launches"] == out["steps_run"] and out["device_loop"]
                and out["step_kernel"] == "fused",
                f"{name}: {out['prim_chain_launches']} prim_chain / {out['push_rows_launches']} "
                f"push_rows launches for {out['steps_run']} steps")
        print(f"phase 6 {name}: proved {out['cost']} in {out['nodes_expanded']} nodes, "
              f"{out['prim_chain_launches']} prim_chain + {out['push_rows_launches']} push_rows launches, "
              f"time to proof {out['time_to_proof_s']} s")
    # the host loop, whose node count at 3000 steps the JAX host loop pinned
    walk = ["ulysses16", "--backend=cuda", "--bound=min-out", "--ils-rounds=0", "--k=32",
            "--capacity=16384", "--max-iters=3000", "--device-loop=off"]
    kern = run_bnb_cli(walk + ["--mst-kernel=auto"])
    plain = run_bnb_cli(walk + ["--mst-kernel=prim"])
    require(kern["mst_kernel"] == "prim_chain" and plain["prim_chain_launches"] == 0
            and kern["push_rows_launches"] == kern["steps_run"] > 0,
            "trajectory run: kernel/plain selection")
    require(kern["nodes_expanded"] == plain["nodes_expanded"] == TRAJECTORY_NODES
            and kern["lower_bound"] == plain["lower_bound"] and kern["cost"] == plain["cost"],
            f"trajectory: kernel {kern['nodes_expanded']} / plain {plain['nodes_expanded']} nodes "
            f"(want {TRAJECTORY_NODES}), LB {kern['lower_bound']} / {plain['lower_bound']}")
    print(f"phase 6 trajectory (ulysses16 min-out, no ILS, k=32, 3000 steps): "
          f"{kern['nodes_expanded']} nodes under prim_chain == plain chain, LB {kern['lower_bound']}; "
          f"search {kern['wall_s']} s kernel vs {plain['wall_s']} s plain")


def prim_recorded(calls, what: str, errs, reps: int = 5) -> dict:
    """``prim_chain`` on a main path's recorded inputs: bit for bit against
    the plain chain on every launch, then timed (tools/kernel_times)."""
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt

    try:
        lanes = kt.prim_check(calls)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    row = kt.time_prim(calls, what, reps=reps)
    print(f"phase {what}: {len(calls)} recorded launches (n={row['n']}, k={row['k']}, {lanes} lanes) "
          f"== plain bit for bit; {row['device_ms']:.4f} ms/launch on the device (CUDA graph replay of "
          f"every recorded launch, CUDA events, mean of {reps}), {row['ms']:.4f} ms/launch eager; bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}); plain {row['plain_ms']:.4f} ms; dependent steps "
          f"(max |U| - 1 over a launch's lanes) mean {row['dependent_steps_mean']:.1f}, max "
          f"{row['dependent_steps_max']} of n - 1 = {row['n_minus_1']}; mean |U| {row['mean_U']:.1f}")
    return row


def reference_push_args(call):
    """The reference push's arguments for a recorded step: pushed flags,
    ranks and base row follow from ``dest``."""
    import torch

    shape, parents, dest, cc, cb, cs = call
    flat = dest.reshape(-1).long()
    flat_push = (flat >= 0) & (flat < shape[0])
    base = torch.where(flat_push, flat, shape[0]).min()
    return parents, cc, cb, cs, flat_push, flat - base, base


def phase_bnb_full(smi, errs):
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    name, k, cap = BNB_FULL
    base_argv = [name, "--backend=cuda", f"--k={k}", f"--capacity={cap}"]
    # the main path first (counts reset just before, read just after), then
    # the reference push and the two again in reverse order (ABBA), so the
    # search times of the two pushes are compared within one call
    runs = []
    for kernel in ("auto", "reference", "reference", "auto"):
        argv = base_argv + ([] if kernel == "auto" else ["--step-kernel=reference"])
        prim_kernels.reset_launches()
        ek.reset_launches()
        bb.reset_frontier_stats()
        out = run_bnb_cli(argv)
        out["_launches"] = {**prim_kernels.LAUNCHES, **ek.LAUNCHES}
        out["_peak"] = bb.FRONTIER_STATS["peak_count"]
        runs.append(out)
        fused = kernel == "auto"
        require(out["proven_optimal"] and out["cost"] == BNB_FULL_COST
                and out["root_lower_bound"] == BNB_FULL_ROOT_LB,
                f"eil51 {kernel}: cost {out['cost']} proven={out['proven_optimal']} "
                f"root LB {out['root_lower_bound']}")
        require(out["nodes_expanded"] == BNB_FULL_NODES,
                f"eil51 {kernel}: {out['nodes_expanded']} nodes expanded, want {BNB_FULL_NODES}")
        require(out["device_loop"] and out["mst_kernel"] == "prim_chain"
                and out["step_kernel"] == ("fused" if fused else "reference"),
                f"eil51 {kernel}: device_loop {out['device_loop']} mst_kernel {out['mst_kernel']} "
                f"step_kernel {out['step_kernel']}")
        require(out["_launches"]["prim_chain"] == out["prim_chain_launches"] == 3 * out["steps_run"] > 0,
                f"eil51 {kernel}: {out['_launches']['prim_chain']} prim_chain launches for "
                f"{out['steps_run']} steps (want 3 per step)")
        want_push = out["steps_run"] if fused else 0
        require(out["_launches"]["push_rows"] == out["push_rows_launches"] == want_push,
                f"eil51 {kernel}: {out['_launches']['push_rows']} push_rows launches for "
                f"{out['steps_run']} steps")
        require((out["lower_bound"], out["steps_run"]) == (runs[0]["lower_bound"], runs[0]["steps_run"]),
                "eil51: the reference push gives another search than the fused one")
    main = runs[0]
    launches = main["_launches"]
    print(f"phase 7 main path ({name}, k={k}, capacity={cap}, one-tree, node_ascent=2, device loop, "
          f"mst_kernel={main['mst_kernel']}, step_kernel={main['step_kernel']}): proved {main['cost']} "
          f"(root LB {main['root_lower_bound']}) in {main['nodes_expanded']} nodes, {main['steps_run']} "
          f"steps, {launches['prim_chain']} prim_chain + {launches['push_rows']} push_rows launches, "
          f"largest frontier count {main['_peak']}; --step-kernel=reference: the same nodes, cost, LB")
    for out in runs:
        print(f"phase 7 seconds ({out['step_kernel']} push): setup {out['setup_s']} (ascent "
              f"{out['setup_ascent_s']}, ILS {out['setup_ils_s']}), search {out['wall_s']}, time to "
              f"proof {out['time_to_proof_s']}; {out['nodes_per_sec']} nodes/s; largest count "
              f"{out['_peak']}")

    # --- prim_chain on synthetic half-visited eil51 lanes (k = 1024): one
    # plain and node_ascent = 2 lam launches a step
    d = tsplib.embedded(name).distance_matrix()
    n = d.shape[0]
    triple = kt.synthetic_prim_calls(k)
    for c in triple[:2]:
        prim_compare(*c, "eil51 k=1024 synthetic", errs)
    syn = kt.time_prim(triple, "synthetic", reps=50)
    print(f"phase 7 kernel prim_chain, synthetic half-visited eil51 lanes: {syn['device_ms']:.4f} ms/launch "
          f"on the device (CUDA graph replay, CUDA events, mean of 50x3 at k={k}, n={n}), "
          f"{syn['ms']:.4f} ms/launch eager; bound {syn['bound_ms']:.6f} ms ({syn['bound_by']}), plain "
          f"{syn['plain_ms']:.4f} ms; dependent steps max {syn['dependent_steps_max']}")

    # --- both B&B kernels on the main path's own inputs, launch by launch
    chains, calls, _ = kt.record_bnb_calls(base_argv)
    require(len(chains) == launches["prim_chain"],
            f"recorded {len(chains)} prim_chain launches, want {launches['prim_chain']}")
    prim_row = prim_recorded(chains, "7 kernel prim_chain, recorded eil51 inputs", errs)
    del chains
    require(len(calls) == main["steps_run"], f"recorded {len(calls)} pushes, want {main['steps_run']}")
    try:
        kt.push_check(calls, n)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    push = kt.time_push(calls, n, "push_rows recorded eil51")
    scratch = torch.zeros(calls[0][0], dtype=torch.int32, device="cuda")
    ref_args = [reference_push_args(c) for c in calls]

    def reference_all():
        for a in ref_args:
            bb._reference_push(scratch, *a[:4], a[4], a[5], a[6], n)

    reference_all()
    steps = len(calls)
    ref_eager_ms = kt.cuda_ms(reference_all, 5) / steps
    ref_push_ms = kt.graph_ms(reference_all, 5) / steps
    push_ms, push_eager_ms = push["device_ms"], push["ms"]
    print(f"phase 7 kernel push_rows: {steps} recorded eil51 launches == plain bit for bit (whole buffer); "
          f"{push_ms:.4f} ms/launch on the device (CUDA graph replay of the recorded steps, CUDA events, "
          f"mean of 5), {push_eager_ms:.4f} ms/launch eager; launch floor {push['floor_ms']:.4f} ms (an "
          f"empty kernel on the same grid, graph replay); {launches['push_rows']} launches on the main path, "
          f"bound {push['bound_ms']:.6f} ms ({push['bound_by']}; mean n_push {push['mean_n_push']:.1f}), "
          f"plain {push['plain_ms']:.4f} ms; children one parent pushes: largest "
          f"{push['children_per_parent_max_max']:.0f} (mean of the launches' largest "
          f"{push['children_per_parent_max_mean']:.1f}), mean {push['children_per_parent_mean']:.2f}")
    print(f"phase 7 push section per step: fused push_rows {push_ms:.4f} ms device / {push_eager_ms:.4f} "
          f"ms eager; reference (candidate block + compaction + index_copy_) {ref_push_ms:.4f} ms "
          f"device / {ref_eager_ms:.4f} ms eager")
    print(f"phase 7 card: {smi}")
    return [
        # times and bound per launch, on the recorded eil51 inputs
        {"name": "prim_chain", "route": "cuda", "source": PRIM_SOURCE,
         "replaces": REPLACES["prim_chain"], "launches": launches["prim_chain"],
         "max_abs_err": errs["prim_chain"], "ms": prim_row["ms"], "device_ms": prim_row["device_ms"],
         "plain_ms": prim_row["plain_ms"], "bound_ms": prim_row["bound_ms"], "bound_by": prim_row["bound_by"],
         "library_ms": None, "per": "launch"},
        {"name": "push_rows", "route": "cuda", "source": PUSH_SOURCE,
         "replaces": REPLACES["push_rows"], "launches": launches["push_rows"],
         "max_abs_err": errs["push_rows"], "ms": push_eager_ms, "device_ms": push_ms,
         "plain_ms": push["plain_ms"], "bound_ms": push["bound_ms"], "bound_by": push["bound_by"],
         "library_ms": None, "per": "launch", "floor_ms": push["floor_ms"]},
    ]


SPECIAL_BITS = (0x7FC00000, 0x7FC00123, 0x80000000, 0x7F800000, 0xFF800000)


def push_inputs(n: int, k: int, case: str, seed: int):
    """A frontier buffer, k parent rows, dest and the float columns on the
    card from a numpy seed: nothing, some (in random order, some parked at
    -1 or past F), everything pushed (then ending at row F-1), or parent 0
    pushing all n children and the others about 10%; the float columns
    carry NaN, -0.0 and inf bit patterns."""
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

    rng = np.random.default_rng(seed)
    cols = ek.row_width(n)
    pw, w = (n + 3) // 4, (n + 31) // 32
    f_rows = k * n + 17
    nodes = rng.integers(-(2**31), 2**31, size=(f_rows, cols), dtype=np.int64).astype(np.int32)
    parents = rng.integers(-(2**31), 2**31, size=(k, cols), dtype=np.int64).astype(np.int32)
    parents[:, pw + w] = rng.integers(0, n + 3, size=k)
    push = {"some": rng.random((k, n)) < 0.3, "none": np.zeros((k, n), bool),
            "all": np.ones((k, n), bool), "one-full": rng.random((k, n)) < 0.1}[case]
    push[0] |= case == "one-full"
    push = push.reshape(-1)
    n_push = int(push.sum())
    rank = np.zeros(k * n, np.int64)
    rank[rng.permutation(np.flatnonzero(push))] = np.arange(n_push)
    base = f_rows - n_push if case == "all" else int(rng.integers(0, f_rows - n_push + 1))
    dest = np.where(push, base + rank, rng.integers(f_rows, f_rows + 50, size=k * n))
    dest[~push & (rng.random(k * n) < 0.1)] = -1
    special = np.array(SPECIAL_BITS, np.uint32).view(np.int32)
    floats = []
    for _ in range(3):
        bits = rng.integers(-(2**31), 2**31, size=k * n, dtype=np.int64).astype(np.int32)
        bits[rng.integers(0, k * n, size=len(special))] = special
        floats.append(torch.tensor(bits.view(np.float32).reshape(k, n), device="cuda"))
    return (torch.tensor(nodes, device="cuda"), torch.tensor(parents, device="cuda"),
            torch.tensor(dest.reshape(k, n).astype(np.int32), device="cuda"), *floats)


def phase_push_parity(errs):
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

    checked = 0
    for n in (5, 13, 14, 33, 51, 100, 128, 200):
        for k in (1, 11, 37, 1024):
            for case in ("none", "some", "all", "one-full"):
                nodes, parents, dest, cc, cb, cs = push_inputs(n, k, case, seed=n * k + len(case))
                want = ek.push_rows_reference(nodes.clone(), parents, dest, cc, cb, cs, n)
                ek.push_rows(nodes, parents, dest, cc, cb, cs, n)
                torch.cuda.synchronize()
                require(torch.equal(nodes, want), f"push_rows != plain at n={n} k={k} {case}")
                if case == "all":
                    require(int(dest.max()) == nodes.shape[0] - 1, "no destination at row F-1")
                    flat = dest.reshape(-1).long()
                    require(all(torch.equal(nodes[flat, col], f.view(torch.int32).reshape(-1))
                                for col, f in ((-3, cc), (-2, cb), (-1, cs))),
                            f"float bit patterns changed at n={n} k={k}")
                errs["push_rows"] = max(errs["push_rows"], max_abs_err(nodes.double(), want.double()))
                checked += 1
    print(f"phase 8 push_rows parity: {checked} whole-buffer bit-exact comparisons, n in 5..200, "
          "k in {1, 11, 37, 1024}, nothing / some / everything pushed (to row F-1) / one parent pushing "
          "all n, NaN/-0.0/inf bits")


SPILL_KEYS = ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
              "spill_bytes_to_device")


def pinned_fields(out: dict, pinned: dict, what: str) -> None:
    got = {key: out[key] for key in pinned}
    require(got == pinned, f"{what}: {got} != the JAX package's {pinned}")


def phase_kroa100(smi, errs):
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt

    runs = {}
    for kernel in ("fused", "reference"):
        prim_kernels.reset_launches()
        ek.reset_launches()
        bb.reset_frontier_stats()
        out = run_bnb_cli(KRO_ARGS + ["--backend=cuda", f"--step-kernel={kernel}"])
        stats = dict(bb.FRONTIER_STATS)
        runs[kernel] = out
        pinned_fields(out, KRO_PINNED, f"kroA100 chunk, {kernel} push")
        want_push = out["steps_run"] if kernel == "fused" else 0
        require(prim_kernels.LAUNCHES["prim_chain"] == 7 * out["steps_run"] > 0
                and ek.LAUNCHES["push_rows"] == out["push_rows_launches"] == want_push,
                f"kroA100 {kernel}: {prim_kernels.LAUNCHES['prim_chain']} prim_chain / "
                f"{ek.LAUNCHES['push_rows']} push_rows launches for {out['steps_run']} steps")
        print(f"phase 9 kroA100 chunk ({kernel} push; k=1024, capacity=524288, node_ascent=6, "
              f"reorder every 16, device loop, 300 steps): {out['nodes_expanded']} nodes, "
              f"{out['steps_run']} expanded steps, cost {out['cost']}, certified LB {out['lower_bound']} "
              f"(root {out['root_lower_bound']}), spill rounds/events/full merges "
              f"{out['spill_rounds']}/{out['spill_events']}/{out['spill_full_merges']}, bytes to host "
              f"{out['spill_bytes_to_host']}, to device {out['spill_bytes_to_device']}; "
              f"{stats['reorders']} re-sorts, {stats['compactions']} compactions, largest count "
              f"{stats['peak_count']}; {ek.LAUNCHES['push_rows']} push_rows + "
              f"{prim_kernels.LAUNCHES['prim_chain']} prim_chain launches")
        print(f"phase 9 seconds ({kernel} push): setup {out['setup_s']} (ascent {out['setup_ascent_s']}, "
              f"ILS {out['setup_ils_s']}), search {out['wall_s']}; {out['nodes_per_sec']} nodes/s")
    require(runs["fused"]["steps_run"] == runs["reference"]["steps_run"],
            "kroA100: fused and reference expanded different numbers of steps")
    # push_rows on the inputs of every launch of the chunk, prim_chain on
    # those of its first steps (n = 100)
    chains, pushes, out = kt.record_bnb_calls(KRO_ARGS + ["--backend=cuda"], kt.KRO_STEPS * kt.KRO_CHAINS_PER_STEP)
    require(len(chains) == kt.KRO_STEPS * kt.KRO_CHAINS_PER_STEP,
            f"recorded {len(chains)} kroA100 prim_chain launches")
    require(len(pushes) == out["steps_run"] == runs["fused"]["steps_run"],
            f"recorded {len(pushes)} kroA100 push_rows launches for {out['steps_run']} steps")
    try:
        kt.push_check(pushes, 100)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    stats = kt.push_stats(pushes)
    del pushes
    print(f"phase 9 kernel push_rows: every one of the chunk's {out['steps_run']} recorded launches == plain "
          f"bit for bit (whole buffer); children one parent pushes: largest "
          f"{stats['children_per_parent_max_max']:.0f}, mean {stats['children_per_parent_mean']:.2f}")
    prim_recorded(chains, f"9 kernel prim_chain, recorded inputs of the first {kt.KRO_STEPS} "
                  "kroA100 steps", errs)
    print(f"phase 9 card: {smi}")


def phase_spill(smi):
    import numpy as np

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

    xy = np.random.default_rng(1).uniform(0, 100, (13, 2))
    d = np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)
    for kernel in ("fused", "reference"):
        ek.reset_launches()
        bb.reset_frontier_stats()
        res = bb.solve(d, step_kernel=kernel, device="cuda", **SPILL_KW)
        stats = dict(bb.FRONTIER_STATS)
        out = {key: getattr(res, key) for key in SPILL_PINNED}
        pinned_fields(out, SPILL_PINNED, f"spill-forcing proof, {kernel} push")
        require(res.device_loop and stats["compactions"] > 0 and res.spill_rounds > 0,
                f"spill-forcing proof ({kernel}): {stats['compactions']} compactions, "
                f"{res.spill_rounds} spill rounds")
        require(ek.LAUNCHES["push_rows"] == (res.steps_run if kernel == "fused" else 0),
                f"spill-forcing proof ({kernel}): {ek.LAUNCHES['push_rows']} push_rows launches")
        print(f"phase 10 spill-forcing proof ({kernel} push; 13 cities, k=8, capacity=384, device "
              f"loop): proved {res.cost} in {res.nodes_expanded} nodes, {res.iterations} iterations, "
              f"{stats['compactions']} compactions, spill rounds/events {res.spill_rounds}/"
              f"{res.spill_events}, bytes {res.spill_bytes_to_host} down / {res.spill_bytes_to_device} "
              f"up, largest count {stats['peak_count']}; search {res.wall_seconds:.3f} s")
    print(f"phase 10 card: {smi}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    try:
        import tsp_mpi_reduction_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errs = {"relax_minplus": 0.0, "relax_dense": 0.0, "prim_chain": 0.0, "push_rows": 0.0}
    try:
        smi = phase_build()
        phase_kernel_parity(errs)
        phase_oracle()
        kernels = phase_full(smi, errs)
        phase_prim_parity(errs)
        phase_bnb_proofs()
        kernels += phase_bnb_full(smi, errs)
        phase_push_parity(errs)
        phase_kroa100(smi, errs)
        phase_spill(smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        if k["max_abs_err"] != 0.0:
            print(f"chip_smoke: FAILED: {k['name']} max_abs_err {k['max_abs_err']}", file=sys.stderr)
            return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

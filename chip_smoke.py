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
   ``fused`` and ``pallas`` impls, the final tour also through
   ``fold_tours`` with the graph store on and under
   ``TSP_COMPILE_CACHE=off`` (bit for bit both); ``--ranks=4`` equal under
   fused/compact;
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
   the device loop, ``mst_kernel`` and ``step_kernel`` auto, the step
   replayed from its graph): burma14 3323, ulysses16 6859, berlin52 7542,
   each again under ``TSP_COMPILE_CACHE=off`` (the eager steps: the same
   search); and ulysses16 under min-out with no ILS (host loop, 500
   steps) expands the JAX package's 16,336 nodes under the kernel and
   under the plain chain. Every B&B run below counts (1 + node_ascent)
   ``prim_chain`` and one ``push_rows`` launch a step issued: its replays
   (or eager calls, a no-op tail past the stop within a dispatch's last
   run of 32 included) and a capture's warm-up steps;
7. the B&B full-size run through the default CLI: eil51 at k = 1024,
   capacity 2^18, one-tree, node_ascent 2, the device loop with the fused
   push, the step captured once and replayed — proves 426 from root bound
   423 in 153,747 nodes, with one ``push_rows`` and (1 + node_ascent)
   ``prim_chain`` launches per step issued; the same search (nodes,
   iterations, steps, replays, LB) under ``TSP_COMPILE_CACHE=off`` and
   under ``--step-kernel=reference``, ABBA, and a repeated solve with 0
   captures under ``RecompilationGuard``; setup/search/capture seconds,
   nodes/s, time to proof and the largest frontier count of each; both B&B
   kernels on the main path's recorded inputs (from its eager steps) (every launch, bit for bit
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
   iterations, cost, certified LB, every spill counter), and so does the
   chunk's eager run (``TSP_COMPILE_CACHE=off``), whose ``push_rows``
   inputs of every launch are recorded and held bit for bit, and
   ``prim_chain``'s of its first 20 steps, checked and timed;
10. a spill-forcing proof (13 random cities, capacity at the device
    loop's 4*k*(n-1) floor): compacts on the card, exchanges with the host
    reservoir and proves, fused == reference == the JAX package's pinned
    numbers; then the same proof driven by ``solve_slice`` in slices of
    1000 iterations, each resuming the last one's snapshot, ends on the
    uninterrupted proof's cost, tour and certified LB;
11. the kroA100 campaign: two 300-step chunks of phase 9's configuration
    through the port's chunked driver (``tools/bnb_chunked``), each a
    fresh process that resumes the previous chunk's snapshot: chunk 1
    equals phase 9's pins, chunk 2 the JAX package's numbers for the
    resumed chunk on the CPU, the certified LB does not fall, and both
    chunks launch ``prim_chain`` 7 times and ``push_rows`` once a step
    (each chunk process resets the counts before its solve and reports
    them after); the seconds of every save and restore and the snapshot's
    bytes on disk, and a save of chunk 2's state split into its parts
    (device-to-host copy and unpack, npz compression, atomic write); chunk
    2 reads the root ascent from the memo chunk 1 wrote
    (``ascent_memo_hits`` >= 1), and each chunk's ascent seconds print;
12. the pipeline's options at phase 4's size: the sequential, tree and
    coordinate folds of phase 4's block tours (each a closed tour of all
    16,384 cities; the coordinate tree fold equals the gather tree fold id
    for id and in cost, in float64 and float32) with their seconds;
    ``--improve`` through the CLI at 256 blocks of 16 (cut from 1024 for
    time; no dearer than the unimproved cost; at ``10 6 500 500
    --dtype=float64`` the JAX package's cost); ``--trace`` at 256 blocks
    (the trace parses and holds the pipeline's CPU ranges; its device
    kernel events and the device-busy share of the traced window);
    ``--backend=native 10 6 500 500`` (the oracle's cost); a ``--quick``
    port sweep (8 rows under the CSV header);
13. the B&B options at phase 7's size (eil51, k = 1024, capacity 2^18):
    ``--mst-kernel=boruvka`` through the CLI proves 426 in the JAX
    package's node count with 0 ``prim_chain`` and one ``push_rows`` launch
    a step; ``ascent="device"`` proves 426 from the root bound 423 (its
    ascent seconds beside a host ascent's); the step profile's components
    (``tools/step_profile``) under ``prim_chain`` and ``boruvka``, the
    guarded step eager and replayed; a ``--trace``-style capture of 20
    steps, eager and replayed (their ``bnb_step`` ranges and the
    device-busy share of the steps' window).
14. the ``serve`` entry point: an in-process ``SolveService`` at the JAX
    defaults but ``max_batch = 64`` and ``warm_shapes = (16,)`` answers,
    through ``run_jsonl``, A: 64 requests of 16 random cities (exact
    Held-Karp flushes), C: 4 of 1024 (the blocked rung: one flush of 64
    blocks, the merge fold, 6 polish rounds), D: berlin52 and 40 random
    cities (the certified B&B rung in 0.25 s preemptible slices), E: 4 of
    200 with a 0.1 ms deadline (greedy), all sent at once, then B: A again,
    translated and permuted (all cache hits). No errors, no rung failures,
    every request on its tier, every tour valid; A's tours and costs equal
    the plain ``dense`` impl's; ``relax_dense_sweep``, ``prim_chain`` and
    ``push_rows`` launched by the traffic (``launches_serve`` in the
    kernels line). Then ``python -m
    tsp_mpi_reduction_tpu_torch serve --in R --out S --stats --warm 16`` in
    a fresh process on 10 of the requests answers as the service did.
    Prints A's requests/s, latency quantiles per tier, the flushes, the
    B&B slices with their save seconds, the cache hit rate and the
    launches; then a lone 1024-city request split into flush, fold and
    polish, and C's four requests at once without the other traffic;
15. the ``fleet`` entry point: an in-process ``FleetFront`` over 2 replica
    processes (``chip_smoke.py --fleet-replica``: the port's serve CLI on
    ``--backend cuda --threads 4 --warm 16 --stats``, each with its own
    CUDA context on the one card, on a fresh shared-cache directory; each
    zeroes the launch counts when its warm-up ends and prints them at
    exit). F1: phase 14's A and D at once (every request on its tier, A
    == the plain dense impl's bit for bit and == phase 14's answers when
    it ran, D held to its certificate); F2: B, 64 hits, at least one from
    the shared tier across the replica boundary; F3: a fresh fleet under
    ``replica.kill`` then ``replica.hang`` on 16 certified n = 16 proofs
    (exactly once, a restart, a re-dispatch, a wedge verdict, and as many
    contexts in ``nvidia-smi --query-compute-apps`` after the restart as
    before the kill); F4: ``python -m tsp_mpi_reduction_tpu_torch fleet
    --replicas 2 --warm 16 --stats`` in a fresh process on 10 of A's
    requests answers as F1 did, and the card holds no context of its
    front (2 more contexts at most, its replicas'). Prints the replicas' cold
    starts and restart, F1's requests/s and latency per tier, the flushes,
    the hops and the launches (``launches_fleet`` in the kernels line).
16. the sharded B&B, the ranks batched on the card (``solve_sharded``): the
    CLI's ``eil51 --ranks=8 --k=128`` under ``pair`` and ``--balance=ring``
    (the host loop: 16,384 rows a rank is under the device loop's floor)
    and ``eil51 --ranks=4 --k=256 --capacity=1048576 --device-loop=on``,
    each held to the JAX package's CLI node for node (cost and LB 426,
    nodes, nodes per rank, spill counters, balance actions, moved rows and
    the per-dispatch rows), the round replayed from the store (the batched
    step over all ranks and the round's tail), with 1 + node_ascent
    ``prim_chain`` launches (one chain over the R*k lanes) and one
    ``push_rows`` launch (into the stacked buffer) a batched step issued;
    every launch of run 1's eager steps recorded and held bit for bit
    against the plain versions, its first 3000 / 1000 launches timed
    (``launches_sharded`` in the kernels line); then 4-rank
    ``solve_sharded`` calls held to the JAX package's numbers: the adaptive
    controller on single-rank seeding (its whole summary), a spill-forcing
    device-loop proof (nonzero spill counters), and a proof cut into a
    snapshot and a resume (outputs in ``build/chip_smoke_sharded/``) that
    lands on the uninterrupted optimum. Prints each run's seconds, nodes/s
    and per-rank split;
17. real ranks: R processes on the one card over gloo
    (``parallel/mesh.spawn_ranks``), each with its own CUDA context.
    (a) ``run_pipeline_sharded`` over 4 processes at phase 4's full size
    (and ``10 6 500 500``, ``10 100 1000 1000`` in float64): cost and tour
    equal ``run_pipeline_ranks(..., 4)`` on the card; rank 0's
    ``relax_dense_sweep`` calls held to the plain per-level loop (the
    whole table) in a pass before the timed run, which is not checked;
    the timed run's launches per rank (no ``relax_minplus`` on ``auto``). (b) ``ring_two_opt`` over 4
    processes on the merged tour of ``16 64 1000 1000`` (float64) equals
    ``BatchedRanks(4)`` on the card. (c) eil51 ``--ranks=8 --k=128`` and
    ``--ranks=4 --k=256 --capacity=1048576 --device-loop=on`` with
    ``--transport=procs``: phase 16's pins and the launches of the steps
    each rank process issued, summed (each process replays its own step
    graph, one rank a step, and runs the balance and share between
    replays; the first through the CLI's rank body on every process's
    eager steps, rank 0's ``prim_chain`` and ``push_rows`` launches
    recorded and held bit for bit, the second through the CLI itself,
    replayed). (d) 4-process 12-city solves: phase 16's
    adaptive and spill-forcing pins, a procs snapshot at 200 iterations
    resumed batched and a batched one resumed over procs (outputs in
    ``build/chip_smoke_procs/``). Prints seconds, nodes/s, collective
    seconds a round, bytes staged through the host by collective kind and
    each rank's cold start (``launches_procs`` in the kernels line).
18. the B&B line's telemetry and the runtime contracts, mostly on runs of
    earlier phases: phase 7's eil51 line carries a series (one row a
    host-loop dispatch) whose nodes add up to 153,747, ending with no open
    work, an incumbent that never rises, an ``anomalies`` block and
    ``obs.device_costs`` records of ``prim_chain`` and ``push_rows``; the
    telemetry's cost as eil51's time to proof under ``TSP_OBS`` off and
    on (ABBA); ``TSP_CONTRACTS=strict`` against ``off`` on the same solve
    (equal nodes, cost, LB); the full-size pipeline with contracts on and
    off (ABBA, wall ms and merge fold seconds); the float64 parity config
    with contracts on (``3720.557435``, goldens bit for bit); phase 16's
    and 17's eil51 ``--ranks=8`` pair runs give one ``rank_series`` and
    ``obs.rank_balance`` on both transports, per-rank series nodes equal
    ``nodes_per_rank``, with the rank hook's own meter
    (``RankSampler.METER_NS``) against the search; the 4-rank
    spill-forcing solve's per-rank spill attribution is nonzero and adds
    up to the aggregate counters on both transports.
19. the static lint and the card's own account of its host syncs:
    ``python -m tsp_mpi_reduction_tpu_torch.analysis --json --sarif
    build/lint.sarif`` in a fresh process on this tree exits 0 (per-rule
    new/baselined/waived counts and the pass's wall time beside the host's
    CPU; the SARIF parses and says 2.1.0) and importing its CLI loads
    neither torch nor jax nor the JAX package; then, under
    ``torch.cuda.set_sync_debug_mode("warn")`` (reset in a ``finally``),
    the full-size pipeline once (phase 4's size, float32: its 7
    ``relax_dense`` launches and the merge fold), eil51 through the
    default CLI (the device loop), under ``--device-loop=off`` (host-loop
    dispatches), both replaying the step's graph, and the device loop
    under ``TSP_COMPILE_CACHE=off``: no sync in ``_pop_stage`` or the
    step, and in the step loop at most one a run of 32 steps plus one a
    dispatch (the search seconds print); then the sharded loop: phase 16's
    eil51 ``--ranks=8`` pair replayed and eager (one read a round, the
    host loop) and its ``--ranks=4`` device loop replayed (at most one a
    round): no sync inside a round (the steps, the tail, the balance's
    write); every warning is attributed to its innermost
    frame in the port, the syncs a fold and a B&B step print with the
    distinct sites, and every site in a lexically hot context (a loop body
    or a hot function, by the lint's own rules) must be a lint finding
    (new, baselined or waived inline); the sites outside hot contexts
    print, and so do the sites in ``ops/merge.py`` and the merge fold's
    syncs a merge: the fold replays one captured step, so its syncs must
    stay at most ``FOLD_SYNC_LIMIT`` (the eager fold synced once a merge,
    1023 a fold). Phase 12's sweep must print the gate's pass line.
20. the bench harness (``tools/bench.py``): each of its eleven modes
    ``pipeline``, ``bnb``, ``faults``, ``obs``, ``serve``, ``spill``,
    ``shard``, ``balance``, ``step``, ``fleet`` and ``compile`` once with
    ``--quick``
    in a fresh process (``spill``, ``compile``, ``pipeline``, ``bnb``,
    ``faults`` and ``step`` last and at once, ``BENCH_OVERLAP``: none
    gates on a time), its history in
    ``build/bench_torch/history.jsonl`` (removed first) and its artifacts in
    ``build/chip_smoke_bench/``; every one exits 0 with ``ok`` true, a
    parseable last line and the card in its artifact. Pins: the ``scan``
    fold's cost at 16 x 100 is the cost ``16 100 1000 1000
    --dtype=float32`` prints through the CLI here (7 ``relax_dense``
    launches a run); ``bnb`` proves eil51 at 426 in ``bnb_solve``'s node
    count with the same arguments here (153,747, phase 7's pin) with both
    B&B kernels launched; ``faults``' two files hold identical arrays;
    ``obs`` leaves no orphan span; ``serve``'s batched tours equal its
    sequential ones. Launches, from the counts each mode writes for its
    windows (reset just before each, read just after): ``relax_dense``
    7 a pipeline run; ``prim_chain`` and ``push_rows`` in every bnb
    proof; ``push_rows`` in faults' B&B run and in both obs arms (the
    fused step); ``relax_dense`` in each of serve's four timed legs and
    ``prim_chain`` and ``push_rows`` in both service legs (the 38-city
    proof); ``relax_minplus`` in no window. ``spill``'s reservoir
    counters equal the JAX package's on its call (609 rounds, 4,206
    events); ``shard``'s nodes, nodes per rank, spill bytes and starved
    ranks equal the JAX mode's, its hook under 2%; ``balance``'s legs'
    nodes per rank, moved rows, collective dispatches, actions and
    switches equal the JAX legs', with every gate; ``step``'s legs reach
    the JAX chain's incumbent (511) at its 1,024 nodes a step; ``fleet``'s demo answers all 48 requests exactly
    once through two kills and a hang and leaves no replica context on
    the card; ``compile``'s chunk processes agree in cost and certified LB
    (the warm one reading the root ascent from the shared directory, the
    cold one not), its served tours agree, and its fold at 16 x 100 replays
    a graph captured before it (0 captures) equal to the eager fold. Launches: ``push_rows`` and no ``prim_chain`` in the spill
    solve, every shard solve and each balance leg; exactly steps x
    dispatches ``push_rows`` in step's fused leg and none in its
    reference leg (the fleet's replicas report no counts; phase 15
    counts theirs). The kernels line's ``launches_bench`` sums every
    window. Then the port's ``bench_check check`` on that history (16
    records) exits 0 with every verdict ``insufficient``, and
    ``bench_check append`` of the pipeline artifact writes one record. Each headline
    prints with the card's name and power limit.
21. the graph store (``perf/compile_cache.py``): the merge fold of phase
    4's block tours (and of 16 x 100, the bench's) on a cold key, the
    first fold capturing ``_fold_step`` once, a second fold of the same
    shapes inside ``RecompilationGuard({"fold_tours": FOLD}, limit=0)``
    and an eager fold under ``TSP_COMPILE_CACHE=off``: ids, length and cost
    equal (``torch.equal``), the capture, replayed-fold and eager-fold
    seconds and the store's ``stats_dict()`` (the one-shot CLI with and
    without the store is ``tools/bench.py --mode=compile --blocks=1024``'s
    ``cli`` leg).
22. the B&B step's graph (``models/branch_bound.STEP``): on a cold store,
    ``warm_compile_device_solver`` at eil51's shapes captures it once (a
    root row under an infinite incumbent; its seconds, the graph's static
    and pool bytes); a
    proof adopts it with 0 captures under ``RecompilationGuard``; two
    threads prove eil51 at once through it (one on its own stream; the
    second waits for the graph): the same proof three times.
23. the sharded round's graphs (``models/branch_bound.RANK_TAIL`` beside
    ``STEP``): on a cold store a short adaptive eil51 R = 8 solve captures
    the batched step and the tail with every action it can pick at setup
    (seconds a variant, the graphs' bytes); phase 16's eil51 R = 8 pair
    proof replayed and under ``TSP_COMPILE_CACHE=off``, ABBA (the same
    proof; the search seconds; 3 ``prim_chain`` and 1 ``push_rows`` a
    batched step issued; the last run 0 captures under
    ``RecompilationGuard``).

Each main path (phase 4's Held-Karp run, phase 7's eil51, phase 9's
kroA100 runs, phase 11's chunks, phase 12's ``--improve`` run, phase
13's Boruvka run, phase 14's request traffic, phase 15's F1 and F2 in
the replica processes, phase 16's three eil51 runs, phase 17's runs in
every rank process, phase 20's bench windows and phase 23's four eil51
runs, see above) runs with
the kernels' launch counts reset just before and read just after; a
kernel of the path that never launched fails the run.
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
import hashlib
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "goldens"

N_FULL, B_FULL, GRID_FULL = 16, 1024, 1000
#: phase 12's ``--improve`` and ``--trace`` depth: a quarter of the full
#: run's blocks (the polish took 88.8 s and the trace 16.9-24.9 s at 1024)
OPTIONS_BLOCKS = 256
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
# ulysses16, min-out, no ILS, k = 32, 500 steps: the JAX host loop's count
# (96,208 at 3000 steps, the depth before phase 20 grew)
TRAJECTORY_STEPS, TRAJECTORY_NODES = 500, 16_336
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
#: the campaign's second chunk: the JAX package's solve(d, k=1024,
#: capacity=1 << 19, node_ascent=6, reorder_every=16, device_loop=True,
#: max_iters=300, resume_from=<its chunk-1 snapshot>) on the CPU
KRO_CHUNK2_PINNED = {"nodes_expanded": 304_128, "iterations": 300, "cost": 21282.0,
                     "lower_bound": 21060.5, "lb_raw": 21060.5, "proven_optimal": False,
                     "spill_rounds": 5, "spill_events": 5, "spill_full_merges": 0,
                     "spill_bytes_to_host": 239_271_648, "spill_bytes_to_device": 173_015_040}
CAMPAIGN_DIR = ROOT / "build" / "chip_smoke_campaign"
OPTIONS_DIR = ROOT / "build" / "chip_smoke_options"
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"
FLEET_DIR = ROOT / "build" / "chip_smoke_fleet"
#: phase 15's hop timeout, wedge timeout and start-up grace for F1 and F2:
#: above D's 60 s deadline, so that only F3's faults cause re-dispatches
FLEET_HOP_S = 90.0
#: phase 14's traffic: group -> (requests, cities, deadline ms); D is
#: berlin52 (its TSPLIB coordinates) and one random instance of 40 cities
SERVE_GROUPS = {"A": (64, 16, 5000.0), "C": (4, 1024, 20_000.0), "D": (2, 40, 60_000.0),
                "E": (4, 200, 0.1)}
SERVE_SEED = 14
SERVE_SHIFT = (37.5, -12.25)
#: the tier each group must be answered on, and its cache provenance
SERVE_EXPECT = {"A": ("pipeline", "miss"), "B": ("pipeline", "hit"), "C": ("pipeline", "miss"),
                "D": ("bnb", "miss"), "E": ("greedy", "miss")}
#: the JAX package's ``10 6 500 500 --backend=cpu --dtype=float64 --improve``
#: (its CLI on the CPU, in a fresh process)
IMPROVED_10_6_COST = "3536.044960"
#: eil51 at k = 1024, capacity 2^18 under the Boruvka MST: the JAX package's
#: solve(d, k=1024, capacity=1 << 18, device_loop=True, mst_kernel="boruvka")
#: on the CPU (Prim's is BNB_FULL_NODES: the trees differ under ties)
BORUVKA_FULL_NODES = 152_861
SPILL_PINNED = {"nodes_expanded": 26_900, "iterations": 3381, "cost": 3154.0,
                "lower_bound": 3154.0, "proven_optimal": True, "spill_rounds": 14,
                "spill_events": 14, "spill_full_merges": 0, "spill_bytes_to_host": 95_724,
                "spill_bytes_to_device": 95_724}
SHARD_DIR = ROOT / "build" / "chip_smoke_sharded"
#: phase 16: the sharded B&B with the ranks batched on the card, through the
#: CLI, held to the JAX package's CLI on the CPU (8 virtual devices, a fresh
#: HOME each): ``python tools/bnb_solve.py <args> --backend=cpu``. R = 8 at
#: 16,384 rows a rank is under the device loop's floor 4*k*(n-1) = 25,600,
#: so auto runs the host loop there; R = 4 runs the device loop
SHARD_CLI = {
    "pair": (["eil51", "--ranks=8", "--k=128"], False, {
        "nodes_expanded": 219_111, "nodes_per_rank": [3268, 14374, 10935, 10294, 87879, 10076, 79711, 2574],
        "actions": {"pair": 22}, "moved_rows_total": 5376, "rows": "21a1fb53cb8fd24f"}),
    "ring": (["eil51", "--ranks=8", "--k=128", "--balance=ring"], False, {
        "nodes_expanded": 219_111, "nodes_per_rank": [7, 10405, 2087, 6, 87879, 15986, 79711, 23030],
        "actions": {"ring": 22}, "moved_rows_total": 5376, "rows": "a05306df1f0e3777"}),
    "device": (["eil51", "--ranks=4", "--k=256", "--capacity=1048576", "--device-loop=on"], True, {
        "nodes_expanded": 233_874, "nodes_per_rank": [84559, 46283, 81212, 21820],
        "actions": {"pair": 1}, "moved_rows_total": 4864, "rows": "cc6db87d0e6e8d2e"}),
}
#: every eil51 run above: cost and certified LB 426, proven, no spill
SHARD_CLI_COMMON = {"cost": 426.0, "lower_bound": 426.0, "proven_optimal": True, "spill_rounds": 0,
                    "spill_events": 0, "spill_full_merges": 0, "spill_bytes_to_host": 0,
                    "spill_bytes_to_device": 0}
#: the small sharded solves of phase 16: 4 ranks on rounded x10 Euclidean
#: instances of numpy-seeded points; the host loop of tests/test_balance.py
#: (``_SOLVE_KW``) and the spill-forcing device loop of the graft entry's mesh
#: run (capacity 256, k = 4, re-sort every 8 steps)
SHARD_HOST_KW = dict(capacity_per_rank=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
                     node_ascent=0, device_loop=False, max_iters=2_000_000)
SHARD_SPILL_KW = dict(capacity_per_rank=256, k=4, inner_steps=1, device_loop=True, reorder_every=8,
                      bound="min-out", mst_prune=False, node_ascent=0, max_iters=2_000_000)
#: name -> (instance (n, seed), extra arguments, the JAX package's
#: solve_sharded numbers on the CPU with the same arguments on a 4-device
#: mesh); "rows" is the sha256 prefix of the balance summary's per-dispatch rows
SHARD_SMALL = {
    "adaptive": ((12, 33), dict(SHARD_HOST_KW, balance="adaptive", seed_mode="single-rank"), {
        "cost": 2994.0, "lower_bound": 2994.0, "proven_optimal": True, "nodes_expanded": 14_786,
        "nodes_per_rank": [3736, 3668, 3698, 3684], "iterations": 469, "spill_rounds": 0,
        "spill_events": 0, "actions": {"skip": 435, "steal": 10, "pair": 24}, "switches": 41,
        "moved_rows_total": 959, "alive_probes": 9, "collective_dispatches": 34, "cv_max": 1.7321,
        "cv_last": 0.8718, "rows": "437bd37d4a46e98d"}),
    "spill": ((12, 7), dict(SHARD_SPILL_KW, balance="pair"), {
        "cost": 3561.0, "lower_bound": 3561.0, "proven_optimal": True, "nodes_expanded": 7589,
        "nodes_per_rank": [1896, 1899, 1900, 1894], "iterations": 481, "spill_rounds": 4,
        "spill_events": 12, "spill_full_merges": 0, "spill_bytes_to_host": 41_184,
        "spill_bytes_to_device": 43_840, "actions": {"pair": 5}, "moved_rows_total": 1135,
        "rows": "238b813b762b0621"}),
    "whole": ((12, 33), dict(SHARD_HOST_KW, balance="pair"), {
        "cost": 2994.0, "lower_bound": 2994.0, "proven_optimal": True, "nodes_expanded": 14_786,
        "nodes_per_rank": [3695, 3695, 3702, 3694], "iterations": 469, "spill_rounds": 9,
        "spill_events": 28, "spill_bytes_to_host": 106_560, "spill_bytes_to_device": 112_384,
        "actions": {"pair": 469}, "moved_rows_total": 1798, "rows": "62f0b13f1d0b6e3e"}),
    # "whole" cut at 200 iterations with a snapshot, then resumed from it
    # (the resumed reservoir lands on rank 0 and refills)
    "chunk1": ((12, 33), dict(SHARD_HOST_KW, balance="pair", max_iters=200), {
        "cost": 2994.0, "lower_bound": 2546.0, "proven_optimal": False, "nodes_expanded": 6379,
        "nodes_per_rank": [1595, 1595, 1595, 1594], "iterations": 200, "spill_rounds": 6,
        "spill_events": 19, "spill_bytes_to_host": 106_560, "spill_bytes_to_device": 77_824,
        "rows": "983910b6178b06d2"}),
    "chunk2": ((12, 33), dict(SHARD_HOST_KW, balance="pair"), {
        "cost": 2994.0, "lower_bound": 2994.0, "proven_optimal": True, "nodes_expanded": 8407,
        "nodes_per_rank": [2169, 2078, 2066, 2094], "iterations": 286, "spill_rounds": 8,
        "spill_events": 8, "spill_bytes_to_host": 0, "spill_bytes_to_device": 28_736,
        "moved_rows_total": 1825, "rows": "3545c3d9fb243dde"}),
}


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
    if not bool(fa.any()):
        return 0.0
    return float((a[fa].double() - b[fb].double()).abs().max())


@contextlib.contextmanager
def compile_cache_setting(value):
    """``TSP_COMPILE_CACHE`` set to ``value`` (None: unset, the graph store
    on) for the ``with`` body, restored after it."""
    saved = os.environ.get("TSP_COMPILE_CACHE")
    if value is None:
        os.environ.pop("TSP_COMPILE_CACHE", None)
    else:
        os.environ["TSP_COMPILE_CACHE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("TSP_COMPILE_CACHE", None)
        else:
            os.environ["TSP_COMPILE_CACHE"] = saved


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


def phase_kernel_parity(errs):  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R2
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


def phase_oracle():  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R1,R2
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_ranks
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
    from tsp_mpi_reduction_tpu_torch.ops.merge import PaddedTour, fold_tours, make_padded, merge_tours
    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices
    from tsp_mpi_reduction_tpu_torch.perf import compile_cache
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
            # fold_tours through the graph store and with the store off
            for setting in (None, "off"):
                misses = compile_cache.stats_dict()["aot_misses"]
                with compile_cache_setting(setting):
                    ids, length, cost = fold_tours(gtours, costs, dist)
                captured = compile_cache.stats_dict()["aot_misses"] - misses
                require(float(cost) == g["final"]["cost"]
                        and ids[: int(length)].cpu().tolist() == g["final"]["ids"],
                        f"{name} {impl}: fold_tours (TSP_COMPILE_CACHE={setting}) differs from the golden")
                require(setting is None or captured == 0, f"{name}: the store captured under off")
        print(f"phase 3 golden {name}: block costs+tours, {nb - 1} fold costs, final tour "
              f"and cost {g['final']['cost']!r} exact under fused and pallas (float64); fold_tours "
              "equal through the graph store and with TSP_COMPILE_CACHE=off")

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
    return res.phase_seconds, [
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


def step_launches(out, per_step: int, fused: bool = True, inner: int = 32) -> bool:
    """A B&B run's kernel launches are its predicated steps': ``per_step``
    ``prim_chain`` launches and (fused) one ``push_rows`` launch for each
    step it issued (the replays of the step's graph or its eager calls,
    and a capture's warm-up steps), and at most ``inner - 1`` steps issued
    a dispatch past the loop's iterations (the no-op tail of its last run)."""
    issued = out["replays"] + out["warm_steps"]
    return (out["prim_chain_launches"] == per_step * issued > 0
            and out["push_rows_launches"] == (issued if fused else 0)
            and 0 <= out["replays"] - out["iterations"] <= (inner - 1) * out["dispatches"])


#: the search fields that the graph and the eager steps must give alike
SEARCH_FIELDS = ("cost", "proven_optimal", "nodes_expanded", "iterations", "steps_run", "replays",
                 "lower_bound", "lb_raw", "spill_rounds", "spill_bytes_to_host", "spill_bytes_to_device")


def same_search(a: dict, b: dict) -> bool:
    return all(a[f] == b[f] for f in SEARCH_FIELDS)


def phase_bnb_proofs():
    for name, opt, extra in (("burma14", 3323.0, ["--k=64", "--capacity=16384"]),
                             ("ulysses16", 6859.0, []), ("berlin52", 7542.0, [])):
        out = run_bnb_cli([name, "--backend=cuda", *extra])
        require(out["proven_optimal"] and out["cost"] == opt and out["mst_kernel"] == "prim_chain",
                f"{name}: {out['cost']} proven={out['proven_optimal']} kernel={out['mst_kernel']}")
        require(step_launches(out, 3) and out["device_loop"] and out["step_kernel"] == "fused"
                and out["step_graph"],
                f"{name}: {out['prim_chain_launches']} prim_chain / {out['push_rows_launches']} "
                f"push_rows launches for {out['replays']} replays + {out['warm_steps']} warm-up steps "
                f"({out['iterations']} iterations, {out['dispatches']} dispatches, graph {out['step_graph']})")
        with compile_cache_setting("off"):
            off = run_bnb_cli([name, "--backend=cuda", *extra])
        require(same_search(off, out) and not off["step_graph"] and step_launches(off, 3),
                f"{name}: the eager steps ({ {f: off[f] for f in SEARCH_FIELDS} }) != the graph's "
                f"({ {f: out[f] for f in SEARCH_FIELDS} })")
        print(f"phase 6 {name}: proved {out['cost']} in {out['nodes_expanded']} nodes, {out['steps_run']} "
              f"steps ({out['replays']} replays of the step's graph in {out['dispatches']} dispatch(es), "
              f"{out['warm_steps']} warm-up step(s), capture {out['capture_s']} s), "
              f"{out['prim_chain_launches']} prim_chain + {out['push_rows_launches']} push_rows launches, "
              f"time to proof {out['time_to_proof_s']} s; TSP_COMPILE_CACHE=off: the same search, "
              f"search {off['wall_s']} s eager against {out['wall_s']} s replayed")
    # the host loop, whose node count the JAX host loop pinned
    walk = ["ulysses16", "--backend=cuda", "--bound=min-out", "--ils-rounds=0", "--k=32",
            "--capacity=16384", f"--max-iters={TRAJECTORY_STEPS}", "--device-loop=off"]
    kern = run_bnb_cli(walk + ["--mst-kernel=auto"])
    plain = run_bnb_cli(walk + ["--mst-kernel=prim"])
    require(kern["mst_kernel"] == "prim_chain" and plain["prim_chain_launches"] == 0
            and kern["push_rows_launches"] == kern["replays"] + kern["warm_steps"] > 0
            and kern["replays"] == kern["iterations"],
            "trajectory run: kernel/plain selection")
    require(kern["nodes_expanded"] == plain["nodes_expanded"] == TRAJECTORY_NODES
            and kern["lower_bound"] == plain["lower_bound"] and kern["cost"] == plain["cost"],
            f"trajectory: kernel {kern['nodes_expanded']} / plain {plain['nodes_expanded']} nodes "
            f"(want {TRAJECTORY_NODES}), LB {kern['lower_bound']} / {plain['lower_bound']}")
    print(f"phase 6 trajectory (ulysses16 min-out, no ILS, k=32, {TRAJECTORY_STEPS} steps): "
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

    from tsp_mpi_reduction_tpu_torch.analysis.contracts import RecompilationGuard
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    name, k, cap = BNB_FULL
    base_argv = [name, "--backend=cuda", f"--k={k}", f"--capacity={cap}"]
    # the main path first (counts reset just before, read just after: its
    # step's graph captured there, one warm-up step), then the eager steps
    # (TSP_COMPILE_CACHE=off), the reference push and the three again in
    # reverse order (ABBA), so that the search times of the graph and the
    # eager steps, and of the two pushes, are compared within one call; the
    # last run replays the stored graph under RecompilationGuard(limit=0)
    runs = []
    plan = (("auto", None), ("auto", "off"), ("reference", None), ("reference", None), ("auto", "off"),
            ("auto", None))
    for i, (kernel, cache) in enumerate(plan):
        argv = base_argv + ([] if kernel == "auto" else ["--step-kernel=reference"])
        prim_kernels.reset_launches()
        ek.reset_launches()
        bb.reset_frontier_stats()
        guard = RecompilationGuard({"bnb_step": bb.STEP}, limit=0) if i == len(plan) - 1 else None
        with compile_cache_setting(cache), guard or contextlib.nullcontext():
            out = run_bnb_cli(argv)
        out["_launches"] = {**prim_kernels.LAUNCHES, **ek.LAUNCHES}
        out["_peak"] = bb.FRONTIER_STATS["peak_count"]
        out["_cache"] = cache or "store"
        runs.append(out)
        fused = kernel == "auto"
        what = f"eil51 {kernel} ({out['_cache']})"
        require(out["proven_optimal"] and out["cost"] == BNB_FULL_COST
                and out["root_lower_bound"] == BNB_FULL_ROOT_LB,
                f"{what}: cost {out['cost']} proven={out['proven_optimal']} root LB {out['root_lower_bound']}")
        require(out["nodes_expanded"] == BNB_FULL_NODES,
                f"{what}: {out['nodes_expanded']} nodes expanded, want {BNB_FULL_NODES}")
        require(out["device_loop"] and out["mst_kernel"] == "prim_chain"
                and out["step_kernel"] == ("fused" if fused else "reference")
                and out["step_graph"] == (cache is None),
                f"{what}: device_loop {out['device_loop']} mst_kernel {out['mst_kernel']} "
                f"step_kernel {out['step_kernel']} graph {out['step_graph']}")
        require(out["_launches"]["prim_chain"] == out["prim_chain_launches"]
                and out["_launches"]["push_rows"] == out["push_rows_launches"] and step_launches(out, 3, fused),
                f"{what}: {out['_launches']} launches for {out['replays']} replays + {out['warm_steps']} "
                f"warm-up steps ({out['steps_run']} steps, {out['iterations']} iterations, "
                f"{out['dispatches']} dispatches; want 3 prim_chain a step issued)")
        require(same_search(out, runs[0]), f"{what}: another search than the main path's")
        if guard is not None:
            require(guard.misses() == {"bnb_step": 0} and out["warm_steps"] == 0,
                    f"{what}: {guard.misses()} captures in a repeated solve")
    main = runs[0]
    require(main["warm_steps"] == 1 and main["capture_s"] > 0,
            f"eil51: the main path captured {main['warm_steps']} warm-up step(s) in {main['capture_s']} s")
    SHARED["eil51"] = main  # phase 18 reads its telemetry blocks
    launches = main["_launches"]
    print(f"phase 7 main path ({name}, k={k}, capacity={cap}, one-tree, node_ascent=2, device loop, "
          f"mst_kernel={main['mst_kernel']}, step_kernel={main['step_kernel']}): proved {main['cost']} "
          f"(root LB {main['root_lower_bound']}) in {main['nodes_expanded']} nodes, {main['steps_run']} "
          f"steps, {main['replays']} replays of the step's graph in {main['dispatches']} dispatch(es) "
          f"(capture {main['capture_s']} s, {main['warm_steps']} warm-up step), {launches['prim_chain']} "
          f"prim_chain + {launches['push_rows']} push_rows launches (3 and 1 a step issued), largest "
          f"frontier count {main['_peak']}; TSP_COMPILE_CACHE=off and --step-kernel=reference: the same "
          f"nodes, iterations, steps, cost and LB; a repeated solve 0 captures under RecompilationGuard")
    for out in runs:
        print(f"phase 7 seconds ({out['step_kernel']} push, {out['_cache']}): setup {out['setup_s']} (ascent "
              f"{out['setup_ascent_s']}, ILS {out['setup_ils_s']}), search {out['wall_s']}, time to "
              f"proof {out['time_to_proof_s']}; {out['nodes_per_sec']} nodes/s; largest count "
              f"{out['_peak']}; capture {out['capture_s']} s")

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
    # (recorded from its eager steps: a replay calls no wrapper)
    chains, calls, rec = kt.record_bnb_calls(base_argv)
    require(same_search(rec, main) and len(chains) == 3 * rec["replays"],
            f"recorded {len(chains)} prim_chain launches, want 3 x {rec['replays']}")
    prim_row = prim_recorded(chains, "7 kernel prim_chain, recorded eil51 inputs", errs)
    del chains
    require(len(calls) == rec["replays"], f"recorded {len(calls)} pushes, want {rec['replays']}")
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


def push_inputs(n: int, k: int, case: str, seed: int):  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R2
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
        require(prim_kernels.LAUNCHES["prim_chain"] == out["prim_chain_launches"]
                and ek.LAUNCHES["push_rows"] == out["push_rows_launches"]
                and step_launches(out, 7, kernel == "fused") and out["step_graph"],
                f"kroA100 {kernel}: {prim_kernels.LAUNCHES['prim_chain']} prim_chain / "
                f"{ek.LAUNCHES['push_rows']} push_rows launches for {out['replays']} replays + "
                f"{out['warm_steps']} warm-up steps ({out['iterations']} iterations, {out['dispatches']} "
                f"dispatches)")
        print(f"phase 9 kroA100 chunk ({kernel} push; k=1024, capacity=524288, node_ascent=6, "
              f"reorder every 16, device loop, 300 steps): {out['nodes_expanded']} nodes, "
              f"{out['steps_run']} expanded steps, cost {out['cost']}, certified LB {out['lower_bound']} "
              f"(root {out['root_lower_bound']}), spill rounds/events/full merges "
              f"{out['spill_rounds']}/{out['spill_events']}/{out['spill_full_merges']}, bytes to host "
              f"{out['spill_bytes_to_host']}, to device {out['spill_bytes_to_device']}; "
              f"{stats['reorders']} re-sorts, {stats['compactions']} compactions, largest count "
              f"{stats['peak_count']}; {ek.LAUNCHES['push_rows']} push_rows + "
              f"{prim_kernels.LAUNCHES['prim_chain']} prim_chain launches; {out['replays']} replays of the "
              f"step's graph (2 variants: with and without the re-sort) in {out['dispatches']} dispatches, "
              f"capture {out['capture_s']} s")
        print(f"phase 9 seconds ({kernel} push): setup {out['setup_s']} (ascent {out['setup_ascent_s']}, "
              f"ILS {out['setup_ils_s']}), search {out['wall_s']}; {out['nodes_per_sec']} nodes/s")
    require(runs["fused"]["steps_run"] == runs["reference"]["steps_run"],
            "kroA100: fused and reference expanded different numbers of steps")
    # push_rows on the inputs of every launch of the chunk, prim_chain on
    # those of its first steps (n = 100)
    # (the chunk's eager steps, TSP_COMPILE_CACHE=off: the JAX pins hold there too)
    chains, pushes, out = kt.record_bnb_calls(KRO_ARGS + ["--backend=cuda"], kt.KRO_STEPS * kt.KRO_CHAINS_PER_STEP)
    pinned_fields(out, KRO_PINNED, "kroA100 chunk, eager steps")
    require(len(chains) == kt.KRO_STEPS * kt.KRO_CHAINS_PER_STEP and not out["step_graph"],
            f"recorded {len(chains)} kroA100 prim_chain launches")
    require(len(pushes) == out["replays"] == runs["fused"]["replays"] and same_search(out, runs["fused"]),
            f"recorded {len(pushes)} kroA100 push_rows launches for {out['replays']} steps issued")
    print(f"phase 9 kroA100 chunk, eager steps (TSP_COMPILE_CACHE=off, recorded): the pinned numbers, "
          f"search {out['wall_s']} s against {runs['fused']['wall_s']} s replayed")
    try:
        kt.push_check(pushes, 100)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    stats = kt.push_stats(pushes)
    del pushes
    print(f"phase 9 kernel push_rows: every one of the chunk's {out['replays']} recorded launches == plain "
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
        if kernel == "fused":
            whole = res
        stats = dict(bb.FRONTIER_STATS)
        out = {key: getattr(res, key) for key in SPILL_PINNED}
        pinned_fields(out, SPILL_PINNED, f"spill-forcing proof, {kernel} push")
        require(res.device_loop and stats["compactions"] > 0 and res.spill_rounds > 0,
                f"spill-forcing proof ({kernel}): {stats['compactions']} compactions, "
                f"{res.spill_rounds} spill rounds")
        require(ek.LAUNCHES["push_rows"] == (res.replays + res.warm_steps if kernel == "fused" else 0),
                f"spill-forcing proof ({kernel}): {ek.LAUNCHES['push_rows']} push_rows launches for "
                f"{res.replays} replays + {res.warm_steps} warm-up steps")
        print(f"phase 10 spill-forcing proof ({kernel} push; 13 cities, k=8, capacity=384, device "
              f"loop): proved {res.cost} in {res.nodes_expanded} nodes, {res.iterations} iterations, "
              f"{stats['compactions']} compactions, spill rounds/events {res.spill_rounds}/"
              f"{res.spill_events}, bytes {res.spill_bytes_to_host} down / {res.spill_bytes_to_device} "
              f"up, largest count {stats['peak_count']}; search {res.wall_seconds:.3f} s")

    # the same proof in slices of 1000 iterations, each resuming the last
    CAMPAIGN_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CAMPAIGN_DIR / "slices.npz")
    for old in CAMPAIGN_DIR.glob("slices.npz*"):
        old.unlink()
    slice_kw = dict(SPILL_KW, max_iters=1000)
    ek.reset_launches()
    res, handle = bb.solve_slice(d, 600.0, checkpoint_path=path, device="cuda", **slice_kw)
    slices, steps, issued = 1, res.steps_run, res.replays + res.warm_steps
    while handle is not None:
        require(slices < 20, "sliced spill proof: no proof in 20 slices")
        res, handle = bb.solve_slice(d, 600.0, handle, device="cuda", **slice_kw)
        slices += 1
        steps += res.steps_run
        issued += res.replays + res.warm_steps
    require(slices >= 2 and res.proven_optimal and res.cost == whole.cost
            and res.lower_bound == whole.lower_bound and (res.tour == whole.tour).all(),
            f"sliced spill proof: {slices} slices, cost {res.cost} LB {res.lower_bound} tour "
            f"{res.tour.tolist()} against {whole.cost} / {whole.lower_bound} / {whole.tour.tolist()}")
    require(ek.LAUNCHES["push_rows"] == issued > 0,
            f"sliced spill proof: {ek.LAUNCHES['push_rows']} push_rows launches for {issued} steps issued")
    print(f"phase 10 sliced spill proof (solve_slice, 1000 iterations a slice): {slices} slices, "
          f"{steps} steps, proved {res.cost} with certified LB {res.lower_bound} and the same tour "
          f"as the uninterrupted proof; {ek.LAUNCHES['push_rows']} push_rows launches")
    print(f"phase 10 card: {smi}")


def phase_campaign(smi):
    """Phase 11: the kroA100 campaign through the chunked driver."""
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.resilience import checkpoint as ck
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    CAMPAIGN_DIR.mkdir(parents=True, exist_ok=True)
    path = CAMPAIGN_DIR / "kroA100.npz"
    for old in CAMPAIGN_DIR.glob("kroA100.npz*"):
        old.unlink()
    # the chunks' root-ascent memo (bnb_chunked's default: beside the snapshot)
    shutil.rmtree(CAMPAIGN_DIR / "compile_cache", ignore_errors=True)
    argv = [a for a in KRO_ARGS if not a.startswith(("--device-loop", "--max-iters"))]
    cmd = [sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.tools.bnb_chunked", *argv,
           "--chunk-iters=300", "--max-chunks=2", f"--checkpoint={path}", "--chunk-retries=0",
           "--chunk-timeout=300", "--backend=cuda"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=700, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    require(r.returncode == 0, f"campaign: exit {r.returncode}: {r.stderr[-3000:]}")
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    require(len(lines) == 3 and lines[2].get("summary"), f"campaign printed {len(lines)} lines")
    c1, c2, summary = lines
    pinned_fields(c1, KRO_PINNED, "campaign chunk 1")
    pinned_fields(c2, KRO_CHUNK2_PINNED, "campaign chunk 2")
    require(c2["lower_bound"] >= c1["lower_bound"] and summary["lb_certified"] == c2["lb_certified"],
            f"campaign: LB {c1['lower_bound']} -> {c2['lower_bound']}, summary {summary['lb_certified']}")
    require(c1["compile_cache"]["ascent_memo_hits"] == 0 and c2["compile_cache"]["ascent_memo_hits"] >= 1,
            f"campaign: ascent memo {c1['compile_cache']} in chunk 1, {c2['compile_cache']} in chunk 2")
    for i, c in enumerate((c1, c2), 1):
        require(c["device"] != "cpu" and c["device_loop"] and c["step_kernel"] == "fused"
                and step_launches(c, 7) and c["step_graph"] and c["warm_steps"] == 2,
                f"campaign chunk {i}: {c['prim_chain_launches']} prim_chain / {c['push_rows_launches']} "
                f"push_rows launches for {c['replays']} replays + {c['warm_steps']} warm-up steps on "
                f"{c['device']}")
        print(f"phase 11 campaign chunk {i} (fresh process): {c['nodes_expanded']} nodes, "
              f"{c['steps_run']} steps, cost {c['cost']}, certified LB {c['lower_bound']} (raw "
              f"{c['lb_raw']}), spill rounds {c['spill_rounds']}, bytes {c['spill_bytes_to_host']} down / "
              f"{c['spill_bytes_to_device']} up; {c['prim_chain_launches']} prim_chain + "
              f"{c['push_rows_launches']} push_rows launches ({c['replays']} replays, capture "
              f"{c['capture_s']} s in a fresh process); setup {c['setup_s']} s (ascent "
              f"{c['setup_ascent_s']}, ascent memo {c['compile_cache']}, ILS {c['setup_ils_s']}, "
              f"restore {c['checkpoint_restore_s']}), search {c['wall_s']} s, "
              f"saves {c['checkpoint_save_s']} s, snapshot {c['checkpoint_bytes']} bytes on disk")
    print(f"phase 11 campaign: 2 chunks in {wall:.1f} s wall (driver), summary gap {summary['gap']} "
          f"(cost {summary['cost']}, certified LB {summary['lb_certified']})")

    # chunk 2's snapshot, restored on the card and saved again in parts
    d = tsplib.resolve_instance("kroA100").distance_matrix()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr, inc, tour, rv, lb = bb.restore(str(path), expect_d=d, expect_bound="one-tree", device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = bb._ckpt_payload(fr, inc, tour, d=d, bound="one-tree", reservoir=rv, lb_floor=lb)
    t_payload = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = ck.npz_bytes(**payload)
    t_npz = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.write_atomic(str(CAMPAIGN_DIR / "resave.npz"), blob, fingerprint=ck.instance_fingerprint(d))
    t_write = time.perf_counter() - t0
    logical = sum(v.nbytes for v in payload.values())
    require(float(payload["lb_certified"]) == c2["lb_certified"]
            and np.array_equal(payload["inc_tour"], np.asarray(tour.cpu())),
            "campaign: the re-saved payload differs from the snapshot")
    print(f"phase 11 save of chunk 2's state ({fr.nodes.shape[0]} rows, count {int(fr.count)}, "
          f"reservoir {len(rv)} rows): restore {t_restore:.3f} s; save = device-to-host copy and unpack "
          f"{t_payload:.3f} s + npz compression {t_npz:.3f} s ({logical} logical bytes -> {len(blob)}) + "
          f"atomic write {t_write:.3f} s")
    print(f"phase 11 card: {smi}")


# ---------------------------------------------------------------------------
# Phases 12 and 13: the options of both CLIs at full size
# ---------------------------------------------------------------------------


def trace_stats(path, window_prefix=None, device_tail: bool = False) -> dict:
    """A Chrome trace's CPU ranges, device kernel events and the device-busy
    share: the union of the kernel intervals over the window (every event
    of the trace, or the ranges named ``window_prefix*``; ``device_tail``
    runs it on to the trace's last kernel)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    # a record_function range appears twice: on the host (user_annotation)
    # and on the device's timeline (gpu_user_annotation); count the host's
    win = [e for e in events if window_prefix is None
           or (e.get("cat") == "user_annotation" and e.get("name", "").startswith(window_prefix))]
    lo = min(e["ts"] for e in win)
    hi = max(e["ts"] + e["dur"] for e in win)
    if device_tail:
        hi = max([hi] + [e["ts"] + e["dur"] for e in kernels if e["ts"] >= lo])
    busy, end = 0.0, lo
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"cpu_ops": len(cpu_ops), "kernels": len(kernels), "ranges": len(win),
            "window_ms": (hi - lo) / 1000.0, "busy_share": busy / (hi - lo) if hi > lo else 0.0,
            "names": {e.get("name", "") for e in cpu_ops}}


def cli_line(argv):
    """The pipeline CLI in this process -> (exit code, last stdout line, seconds)."""
    from tsp_mpi_reduction_tpu_torch.utils import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, lines[-1] if lines else "", time.perf_counter() - t0


def first_tree_difference(tours, costs, dist, xy):  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R1
    """The first (round, pair) where the coordinate merge and the gather
    merge of the tree fold disagree, with both results."""
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import merge as mg

    b, l = tours.shape
    cur = mg.PaddedTour(tours, torch.full((b,), l, dtype=torch.int32, device=tours.device), costs)
    rnd = 0
    while cur.ids.shape[0] > 1:
        m, p = cur.ids.shape
        pairs, pad = m // 2, p - 1
        left = mg.PaddedTour(torch.nn.functional.pad(cur.ids[0:2 * pairs:2], (0, pad)),
                             cur.length[0:2 * pairs:2], cur.cost[0:2 * pairs:2])
        right = mg.PaddedTour(cur.ids[1:2 * pairs:2], cur.length[1:2 * pairs:2], cur.cost[1:2 * pairs:2])
        g = mg.merge_tours(left, right, dist)
        x = mg.merge_tours_xy(left, right, xy)
        bad = ((g.ids != x.ids).any(dim=1) | (g.cost != x.cost)).nonzero()
        if bad.numel():
            i = int(bad[0, 0])
            return (f"round {rnd} pair {i}: gather cost {float(g.cost[i])!r}, coordinate cost "
                    f"{float(x.cost[i])!r}, ids equal {bool(torch.equal(g.ids[i], x.ids[i]))}")
        if m % 2:
            g = mg.PaddedTour(torch.cat([g.ids, torch.nn.functional.pad(cur.ids[-1:], (0, pad))]),
                              torch.cat([g.length, cur.length[-1:]]), torch.cat([g.cost, cur.cost[-1:]]))
        cur, rnd = g, rnd + 1
    return "no merge differs"


def phase_pipeline_options(smi, full_phases):  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R2
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.ops import merge as mg
    from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
    from tsp_mpi_reduction_tpu_torch.ops.held_karp import solve_blocks_from_dists
    from tsp_mpi_reduction_tpu_torch.tools import sweep
    from tsp_mpi_reduction_tpu_torch.utils import profiling

    n, nb = N_FULL, B_FULL
    dev = torch.device("cuda")
    OPTIONS_DIR.mkdir(parents=True, exist_ok=True)

    # --- the three folds of phase 4's block tours
    _, xy = generate_instance(n, nb, GRID_FULL, GRID_FULL)
    diffs = []
    for dt in (torch.float32, torch.float64):
        xy_t = torch.as_tensor(xy.reshape(-1, 2), device=dev).to(dt)
        dist = distance_matrix(xy_t)
        costs, local = solve_blocks_from_dists(block_distance_slices(dist, nb, n), dt)
        tours = local + (torch.arange(nb, dtype=torch.int32, device=dev) * n)[:, None]
        folds, secs = {}, {}
        for name, fn, ctx in (("sequential", mg.fold_tours, dist), ("tree", mg.fold_tours_tree, dist),
                              ("tree_xy", mg.fold_tours_tree_xy, xy_t)):
            folds[name], secs[name] = wall_s(lambda: fn(tours, costs, ctx))
            ids, length, cost = folds[name]
            t = ids[: int(length)].cpu().numpy()
            require(int(length) == n * nb + 1 and t[0] == t[-1]
                    and np.array_equal(np.sort(t[:-1]), np.arange(n * nb)) and math.isfinite(float(cost)),
                    f"{name} fold ({dt}) is not a closed tour over all {n * nb} cities")
        tree, txy = folds["tree"], folds["tree_xy"]
        same = torch.equal(tree[0], txy[0]) and torch.equal(tree[2].view(-1), txy[2].view(-1))
        where = "" if same else "; first differing merge: " + first_tree_difference(tours, costs, dist, xy_t)
        if not same:
            diffs.append(f"{dt}{where}")
        print(f"phase 12 folds ({dt}, {nb} blocks of {n}): sequential {secs['sequential']:.3f} s (cost "
              f"{float(folds['sequential'][2]):f}), tree {secs['tree']:.3f} s (cost {float(tree[2]):f}), "
              f"tree_xy {secs['tree_xy']:.3f} s (cost {float(txy[2]):f}); phase 4's merge_fold "
              f"{full_phases['merge_fold']:.3f} s; tree_xy == tree id for id and in cost: {same}{where}")
        del dist, folds
        torch.cuda.empty_cache()
    require(not diffs, "the coordinate tree fold differs from the gather tree fold: " + "; ".join(diffs))

    # --- --improve through the CLI, the main path's kernels counted, at
    # OPTIONS_BLOCKS blocks
    improve_size = [str(n), str(OPTIONS_BLOCKS), str(GRID_FULL), str(GRID_FULL)]
    rc, plain, plain_s = cli_line(improve_size)
    hkk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rc2, improved, improve_s = cli_line(improve_size + ["--improve"])
    launches = dict(hkk.LAUNCHES)
    cost_of = lambda line: float(line.rsplit(" ", 1)[-1])  # noqa: E731
    require(rc == rc2 == 0 and cost_of(improved) <= cost_of(plain),
            f"--improve: {improved!r} against {plain!r}")
    require(launches["relax_dense"] == hkk.sweep_launches(n - 1),
            f"--improve run launched {launches}")
    rc, small, _ = cli_line(["10", "6", "500", "500", "--dtype=float64", "--improve"])
    require(rc == 0 and small.endswith(f" for 60 cities and the trip cost {IMPROVED_10_6_COST}"),
            f"--improve 10 6 500 500 float64: {small!r}, want the JAX package's {IMPROVED_10_6_COST}")
    print(f"phase 12 --improve ({OPTIONS_BLOCKS} blocks of {n}, float32): {improved} in {improve_s:.3f} s, "
          "peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; unimproved {plain} in {plain_s:.3f} s; "
          f"launches {launches}; 10 6 500 500 float64: {small}")

    # --- --trace through the CLI
    tdir = OPTIONS_DIR / "trace"
    shutil.rmtree(tdir, ignore_errors=True)
    rc, traced, trace_s = cli_line(improve_size + [f"--trace={tdir}"])
    tfile = tdir / profiling.TRACE_FILE
    require(rc == 0 and tfile.exists(), f"--trace: exit {rc}, {tfile} missing")
    st = trace_stats(tfile)
    require(st["cpu_ops"] > 0 and any(nm.startswith("aten::") for nm in st["names"]),
            f"--trace: no CPU ranges in {tfile}")
    print(f"phase 12 --trace ({OPTIONS_BLOCKS} blocks of {n}): {traced} in {trace_s:.3f} s; {tfile.stat().st_size} bytes, "
          f"{st['cpu_ops']} CPU op ranges, {st['kernels']} device kernel events, device busy "
          f"{st['busy_share']:.4f} of the traced window ({st['window_ms']:.1f} ms)")

    # --- --backend=native and the quick sweep
    rc, native_line, native_s = cli_line(["10", "6", "500", "500", "--backend=native"])
    require(rc == 0 and native_line.endswith(" for 60 cities and the trip cost 3720.557435"),
            f"--backend=native: exit {rc} {native_line!r}")
    print(f"phase 12 --backend=native 10 6 500 500: {native_line} ({native_s:.3f} s, build included)")
    out = OPTIONS_DIR / "sweep_quick.csv"
    buf = io.StringIO()
    t0 = time.perf_counter()
    err = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = sweep.main(["--quick", f"--out={out}", "--force"])
    lines = out.read_text().splitlines()
    require(rc == 0 and lines[0] == "numCities,numBlocks,numProcs,time,cost" and len(lines) == 9,
            f"quick sweep: exit {rc}, {len(lines)} lines")
    gate = [ln for ln in err.getvalue().splitlines() if ln.startswith("graftlint: 0 new,")]
    require(len(gate) == 1, f"quick sweep: no lint gate pass line in {err.getvalue()!r}")
    print(f"phase 12 sweep's lint gate: {gate[0]}")
    print(f"phase 12 quick sweep: 8 rows in {time.perf_counter() - t0:.2f} s: " + " | ".join(lines[1:]))
    print(f"phase 12 card: {smi}")


def phase_bnb_options(smi):
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.ops.one_tree import held_karp_potentials_np
    from tsp_mpi_reduction_tpu_torch.tools import step_profile
    from tsp_mpi_reduction_tpu_torch.utils import profiling, tsplib

    name, k, cap = BNB_FULL
    d = tsplib.embedded(name).distance_matrix()

    # --- the Boruvka MST through the CLI, counts reset just before
    prim_kernels.reset_launches()
    ek.reset_launches()
    out = run_bnb_cli([name, "--backend=cuda", f"--k={k}", f"--capacity={cap}", "--mst-kernel=boruvka"])
    launches = {**prim_kernels.LAUNCHES, **ek.LAUNCHES}
    require(out["proven_optimal"] and out["cost"] == BNB_FULL_COST and out["mst_kernel"] == "boruvka"
            and out["root_lower_bound"] == BNB_FULL_ROOT_LB,
            f"eil51 boruvka: cost {out['cost']} proven={out['proven_optimal']} kernel {out['mst_kernel']}")
    require(launches["prim_chain"] == out["prim_chain_launches"] == 0
            and launches["push_rows"] == out["push_rows_launches"] == out["replays"] + out["warm_steps"] > 0,
            f"eil51 boruvka: launches {launches} for {out['replays']} replays + {out['warm_steps']} warm-up")
    require(out["nodes_expanded"] == BORUVKA_FULL_NODES,
            f"eil51 boruvka: {out['nodes_expanded']} nodes, want the JAX package's {BORUVKA_FULL_NODES}")
    print(f"phase 13 eil51 --mst-kernel=boruvka (k={k}, capacity={cap}, device loop, fused push): proved "
          f"{out['cost']} in {out['nodes_expanded']} nodes, {out['steps_run']} steps, {launches['prim_chain']} "
          f"prim_chain + {launches['push_rows']} push_rows launches; search {out['wall_s']} s, "
          f"{out['nodes_per_sec']} nodes/s, setup {out['setup_s']} s")

    # --- the device ascent
    t0 = time.perf_counter()
    held_karp_potentials_np(d, steps=400)
    host_s = time.perf_counter() - t0
    res = bb.solve(d, k=k, capacity=cap, ascent="device", device="cuda")
    require(res.proven_optimal and res.cost == BNB_FULL_COST and res.root_lower_bound == BNB_FULL_ROOT_LB,
            f"eil51 ascent=device: cost {res.cost} proven={res.proven_optimal} root LB {res.root_lower_bound}")
    print(f"phase 13 eil51 ascent=device: proved {res.cost} from root LB {res.root_lower_bound} in "
          f"{res.nodes_expanded} nodes; setup_ascent_s {res.ascent_seconds:.3f} (400 float32 steps on the "
          f"card) against a host float64 ascent of {host_s:.3f} s; search {res.wall_seconds:.3f} s")

    # --- the step profile under both MST kernels
    prof = step_profile.profile(name, k=k, node_ascent=2, device="cuda")
    comps = prof["components"]
    require(comps["full_boruvka"]["prim_chain_launches_per_unit"] == 0
            and comps["full_prim_chain"]["prim_chain_launches_per_unit"] == 3,
            "step profile: prim_chain launches per step "
            f"{comps['full_prim_chain']['prim_chain_launches_per_unit']} / "
            f"{comps['full_boruvka']['prim_chain_launches_per_unit']}")
    print(f"phase 13 step profile ({name}, k={k}, node_ascent 2, warm count {prof['warm_count']}, "
          f"{prof['method']}): " + ", ".join(
              f"{c} {v['ms_per_unit']:.4f} ms/{v['unit']}" for c, v in comps.items()))
    fine = step_profile.profile(name, k=k, node_ascent=2, device="cuda",
                                components=step_profile.FINE_COMPONENTS)
    print("phase 13 step profile --fine: " + ", ".join(
        f"{c} {v['ms_per_unit']:.4f} ms/step" for c, v in fine["components"].items())
        + f" (compact: the predicated compaction pass over {fine['capacity']} rows of {fine['row_bytes']} B)")

    # --- a trace of 20 steps, eager (TSP_COMPILE_CACHE=off) and replayed
    # from the step's graph (a range a replay on the host; the window runs
    # on to the last kernel, which the device ends after the host's ranges)
    for cache in ("off", None):
        tdir = OPTIONS_DIR / f"bnb_trace_{cache or 'store'}"
        shutil.rmtree(tdir, ignore_errors=True)
        with compile_cache_setting(cache), profiling.device_trace(str(tdir), "cuda"):
            res = bb.solve(d, k=k, capacity=cap, max_iters=20, device="cuda")
        st = trace_stats(tdir / profiling.TRACE_FILE, window_prefix="bnb_step#", device_tail=cache is None)
        require(st["ranges"] == res.replays == res.steps_run == 20 and res.step_graph == (cache is None),
                f"trace ({cache or 'store'}): {st['ranges']} bnb_step ranges, {res.replays} replays, "
                f"{res.steps_run} steps")
        busy = f"{st['busy_share']:.4f}" if st["kernels"] else "not measured (no kernel event traced)"
        print(f"phase 13 trace of {res.steps_run} eil51 steps ({'eager' if cache else 'replayed'}): "
              f"{st['ranges']} bnb_step ranges, window {st['window_ms']:.2f} ms, {st['kernels']} device "
              f"kernel events in the trace, device busy {busy} of the steps' window")
    print(f"phase 13 card: {smi}")


# ---------------------------------------------------------------------------
# Phase 14: the serve entry point
# ---------------------------------------------------------------------------


def serve_requests():
    """Phase 14's requests: the first stream (A, C, D, E) and B, A's
    instances translated by SERVE_SHIFT with their cities permuted; the
    permutations come back to check B's relabelled tours."""
    import numpy as np

    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    rng = np.random.default_rng(SERVE_SEED)
    first, perms = [], []
    for group, (count, n, deadline) in SERVE_GROUPS.items():
        for i in range(count):
            if group == "D" and i == 0:
                xy = tsplib.embedded("berlin52").coords.astype(np.float64)
            else:
                xy = rng.uniform(0, 1000, (n, 2))
            first.append({"id": f"{group}{i}", "xy": xy.tolist(), "deadline_ms": deadline})
    second = []
    for req in first[:SERVE_GROUPS["A"][0]]:
        xy = np.asarray(req["xy"])
        perm = rng.permutation(xy.shape[0])
        perms.append(perm)
        second.append({"id": "B" + req["id"][1:], "xy": (xy[perm] + np.asarray(SERVE_SHIFT)).tolist(),
                       "deadline_ms": req["deadline_ms"]})
    return first, second, perms


class _TimedSink:
    """A JSONL sink that stamps the time each response line is written."""

    def __init__(self):
        self.lines, self.stamps = [], []

    def write(self, text):
        now = time.perf_counter()
        for line in text.splitlines():
            self.lines.append(line)
            self.stamps.append(now)

    def flush(self):
        pass


def _quantile(values, q):
    import numpy as np

    return float(np.quantile(np.asarray(values, np.float64), q)) if values else float("nan")


def phase_serve(smi):
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
    from tsp_mpi_reduction_tpu_torch.serve import canonical as canon
    from tsp_mpi_reduction_tpu_torch.serve.service import ServiceConfig, SolveService, run_jsonl
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    first, second, perms = serve_requests()
    by_id = {r["id"]: r for r in first + second}
    t0 = time.perf_counter()
    svc = SolveService(ServiceConfig(max_batch=64, warm_shapes=(16,), device="cuda"))
    warm_s = time.perf_counter() - t0
    # --- the traffic, counts reset just before and read just after
    hkk.reset_launches()
    prim_kernels.reset_launches()
    ek.reset_launches()
    sink = _TimedSink()
    t_start = time.perf_counter()
    try:
        run_jsonl((json.dumps(r) for r in first), sink, service=svc)
        t_first = time.perf_counter() - t_start
        run_jsonl((json.dumps(r) for r in second), sink, service=svc)
        wall = time.perf_counter() - t_start
        stats = json.loads(svc.stats_json())
        slices = list(svc.scheduler.bnb_slice_log)
        launches = {**hkk.LAUNCHES, **prim_kernels.LAUNCHES, **ek.LAUNCHES}
    finally:
        svc.close()
    # one more 1024-city request, alone on a fresh service (the first one's
    # SLO meter now sheds the pipeline tier): the blocked rung's time
    # without the other request threads
    with SolveService(ServiceConfig(max_batch=64, device="cuda")) as solo:
        alone = solo.handle({"id": "C-alone", "deadline_ms": SERVE_GROUPS["C"][2],
                             "xy": np.random.default_rng(SERVE_SEED + 1).uniform(
                                 0, 1000, (SERVE_GROUPS["C"][1], 2)).tolist()})
        split = solo.timer.snapshot()
    require(alone.get("tier") == "pipeline", f"serve: the lone C request answered {alone}")
    # C's requests again at once on a fresh service, without the other
    # traffic: the request threads' contention alone (a 20x shorter switch
    # interval read the same; that second run was cut for the time budget)
    crowd = {}
    rng = np.random.default_rng(SERVE_SEED + 2)
    for interval in (sys.getswitchinterval(),):
        reqs = [{"id": f"C{i}", "deadline_ms": SERVE_GROUPS["C"][2],
                 "xy": rng.uniform(0, 1000, (SERVE_GROUPS["C"][1], 2)).tolist()}
                for i in range(SERVE_GROUPS["C"][0])]
        before_interval = sys.getswitchinterval()
        sys.setswitchinterval(interval)
        try:
            with SolveService(ServiceConfig(max_batch=64, device="cuda")) as solo:
                out = _TimedSink()
                run_jsonl((json.dumps(r) for r in reqs), out, service=solo)
                polish_s = solo.timer.snapshot().get("serve.polish", 0.0)
        finally:
            sys.setswitchinterval(before_interval)
        got = [json.loads(line) for line in out.lines]
        require(all(g.get("tier") == "pipeline" for g in got), f"serve: C at once answered {got[:1]}")
        crowd[interval] = ([g["latency_ms"] for g in got], polish_s)
    resp = [json.loads(line) for line in sink.lines]
    require([r.get("id") for r in resp] == [r["id"] for r in first + second],
            f"serve: responses out of input order: {[r.get('id') for r in resp][:8]}...")

    # --- every request answered on its tier with a valid tour
    require(stats["errors"] == 0 and not any("error" in r for r in resp),
            f"serve: errors {stats['errors']}: {[r for r in resp if 'error' in r][:2]}")
    require(all(v == 0 for v in stats["rung_failures"].values()),
            f"serve: rung failures {stats['rung_failures']}")
    for r in resp:
        group = r["id"][0]
        tier, cache = SERVE_EXPECT[group]
        n = len(by_id[r["id"]]["xy"])
        require(r["tier"] == tier and r["cache"] == cache and r["n"] == n,
                f"serve: {r['id']} on {r['tier']}/{r['cache']}, want {tier}/{cache}")
        tour = r["tour"]
        require(tour[0] == tour[-1] and sorted(tour[:-1]) == list(range(n)),
                f"serve: {r['id']} is not a closed tour of its {n} cities")
        require(r["cost"] == canon.tour_length_np(np.asarray(tour), np.asarray(by_id[r["id"]]["xy"])),
                f"serve: {r['id']} cost is not its tour's length")
        if group in "AB":
            require(r["certified_gap"] == 0.0, f"serve: {r['id']} gap {r['certified_gap']}")
        if group == "E":
            require(r["deadline_missed"] is True, f"serve: {r['id']} met a 0.1 ms deadline")
    resp_of = {r["id"]: r for r in resp}

    # --- B: each hit relabels A's tour into its own city order
    for i, perm in enumerate(perms):
        a, b = resp_of[f"A{i}"], resp_of[f"B{i}"]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        require(b["tour"] == [int(inv[c]) for c in a["tour"]] and abs(b["cost"] - a["cost"]) <= 1e-9 * a["cost"],
                f"serve: B{i} is not A{i}'s tour relabelled ({b['cost']} vs {a['cost']})")
    require(stats["cache"]["hits"] == len(second), f"serve: {stats['cache']['hits']} hits, want {len(second)}")

    # --- D: proven, or a certified gap with LB <= cost
    for i in range(SERVE_GROUPS["D"][0]):
        r = resp_of[f"D{i}"]
        require(r["certified_gap"] is not None and r["certified_gap"] >= 0.0,
                f"serve: D{i} carries no certificate ({r['certified_gap']}) after {r.get('latency_ms')} ms; "
                f"the B&B slices: {len(slices)}, {sum(x['seconds'] for x in slices):.3f} s in all, "
                f"{sum(x['save_s'] for x in slices):.3f} s saving, proven {sum(x['proven'] for x in slices)}")
    berlin = resp_of["D0"]
    dr = tsplib.embedded("berlin52").distance_matrix()
    bt = np.asarray(berlin["tour"])
    berlin_rounded = float(dr[bt[:-1], bt[1:]].sum())
    # the Euclidean optimum (7544.366) is TSPLIB's optimal tour: 7542 rounded
    require(berlin["certified_gap"] > 0.0 or berlin_rounded == 7542.0,
            f"serve: berlin52 proven at {berlin['cost']}, its tour {berlin_rounded} under TSPLIB's distances")

    # --- A against the plain dense impl on the same float32 matrices
    a_ids = [f"A{i}" for i in range(SERVE_GROUPS["A"][0])]
    stack = np.stack([distance_matrix_np(np.asarray(by_id[i]["xy"])) for i in a_ids])
    dev_stack = torch.as_tensor(stack, dtype=torch.float32, device="cuda")
    with held_karp.use_impl("dense"):
        pc, pt = held_karp.solve_blocks_from_dists(dev_stack, torch.float32)
    kc, kt_ = held_karp.solve_blocks_from_dists(dev_stack, torch.float32)
    require(torch.equal(pc, kc) and torch.equal(pt, kt_),
            "serve: relax_dense_sweep != plain dense on A's [64, 16, 16] stack")
    pt = pt.cpu().numpy()
    for i, rid in enumerate(a_ids):
        r = resp_of[rid]
        require(r["tour"] == pt[i].tolist()
                and r["cost"] == canon.tour_length_np(pt[i], np.asarray(by_id[rid]["xy"])),
                f"serve: {rid} differs from the plain dense impl's tour")
    for name in ("relax_dense", "prim_chain", "push_rows"):
        require(launches[name] > 0, f"serve: {name} never launched by the traffic ({launches})")

    # --- the numbers
    a_last = max(sink.stamps[i] for i, r in enumerate(resp) if r["id"][0] == "A")
    a_rps = SERVE_GROUPS["A"][0] / (a_last - t_start)
    sched = stats["scheduler"]
    print(f"phase 14 serve: {len(first)} + {len(second)} requests in {wall:.2f} s (first stream "
          f"{t_first:.2f} s), warm-up {warm_s:.3f} s ({sched['precompiled_buckets']} buckets); A "
          f"{a_rps:.1f} requests/s; errors 0, rung failures 0, tiers {stats['tiers']}")
    for group in "ABCDE":
        lat = [r["latency_ms"] for r in resp if r["id"][0] == group]
        print(f"phase 14 {group} ({len(lat)} x n={resp_of[group + '0']['n']}, tier "
              f"{resp_of[group + '0']['tier']}): latency_ms p50 {_quantile(lat, 0.5):.3f} p99 "
              f"{_quantile(lat, 0.99):.3f} max {max(lat):.3f}")
    for tier in ("pipeline", "bnb", "greedy"):
        lat = [r["latency_ms"] for r in resp if r["tier"] == tier]
        print(f"phase 14 tier {tier}: {len(lat)} answers, latency_ms p50 {_quantile(lat, 0.5):.3f} "
              f"p99 {_quantile(lat, 0.99):.3f}")
    print(f"phase 14 C alone (n={alone['n']}, tier {alone['tier']}): latency {alone['latency_ms']:.1f} ms = flush "
          f"{split.get('serve.batch_solve', 0.0):.4f} s + fold {split.get('serve.fold', 0.0):.4f} s + polish "
          f"{split.get('serve.polish', 0.0):.4f} s + the rest; the {SERVE_GROUPS['C'][0]} at once: fold "
          f"{stats['phases_s'].get('serve.fold', 0.0):.3f} s, polish {stats['phases_s'].get('serve.polish', 0.0):.3f} s "
          f"summed over the {SERVE_GROUPS['C'][0]} request threads")
    for interval, (lat, polish_s) in crowd.items():
        print(f"phase 14 C at once, alone on a fresh service (switch interval {interval * 1e3:.3f} ms): "
              f"latency_ms p50 {_quantile(lat, 0.5):.1f} max {max(lat):.1f}; polish {polish_s:.3f} s summed "
              f"over the {len(lat)} request threads")
    print(f"phase 14 HK flushes: {sched['batches']} batches, {sched['blocks_solved']} blocks in "
          f"{sched['padded_blocks']} lanes, occupancy {sched['batch_occupancy']:.4f}, mean "
          f"{sched['mean_batch_blocks']:.2f} blocks, flushes full/wait/admit {sched['full_flushes']}/"
          f"{sched['wait_flushes']}/{sched['admit_flushes']}; serve.batch_solve "
          f"{stats['phases_s'].get('serve.batch_solve', 0.0):.4f} s; queue age p50/p99 "
          f"{stats['admission']['queue_age_s']['p50']}/{stats['admission']['queue_age_s']['p99']} s")
    saves = [sl["save_s"] for sl in slices if sl["save_s"] > 0]
    walls = [sl["seconds"] for sl in slices]
    print(f"phase 14 B&B: {sched['bnb_jobs']} jobs, {sched['bnb_slices']} slices, "
          f"{sched['bnb_preemptions']} preemptions, {sched['bnb_resumes']} resumes; slice seconds p50 "
          f"{_quantile(walls, 0.5):.3f} max {max(walls) if walls else float('nan'):.3f}; per-slice save "
          f"seconds ({len(saves)} saves) p50 {_quantile(saves, 0.5):.4f} max "
          f"{max(saves) if saves else float('nan'):.4f} sum {sum(saves):.3f}")
    for i in range(SERVE_GROUPS["D"][0]):
        r = resp_of[f"D{i}"]
        print(f"phase 14 D{i} (n={r['n']}): cost {r['cost']:.4f}, certified gap {r['certified_gap']}, "
              f"latency {r['latency_ms']:.1f} ms" + (f"; the tour under TSPLIB's rounded distances "
                                                     f"{berlin_rounded:.1f} (optimum 7542)" if i == 0 else ""))
    print(f"phase 14 cache: hit rate {stats['cache']['hit_rate']:.4f} ({stats['cache']['hits']} hits, "
          f"{stats['cache']['misses']} misses); canonical sorts saved {stats['cache']['canonical_sorts_saved']}")
    print(f"phase 14 launches by the traffic: relax_dense {launches['relax_dense']}, relax_minplus "
          f"{launches['relax_minplus']}, prim_chain {launches['prim_chain']}, push_rows "
          f"{launches['push_rows']}; A == plain dense bit for bit ({len(a_ids)} tours and costs; kernel == "
          f"plain on the {list(dev_stack.shape)} stack)")

    # --- the CLI in a fresh process on 10 of the requests
    pick = [f"A{i}" for i in range(7)] + ["C0", "E0", "E1"]
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    req_path, out_path = SERVE_DIR / "requests.jsonl", SERVE_DIR / "responses.jsonl"
    req_path.write_text("".join(json.dumps(by_id[i]) + "\n" for i in pick))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "serve", "--in", str(req_path),
                        "--out", str(out_path), "--stats", "--warm", "16"],
                       capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    cli_s = time.perf_counter() - t0
    require(r.returncode == 0, f"serve CLI: exit {r.returncode}: {r.stderr[-2000:]}")
    got = [json.loads(line) for line in out_path.read_text().splitlines()]
    cli_stats = json.loads(r.stderr.strip().splitlines()[-1])
    require([g["id"] for g in got] == pick, f"serve CLI: ids {[g['id'] for g in got]}")
    for g in got:
        want = resp_of[g["id"]]
        for f in ("n", "tier", "cost", "tour", "certified_gap", "cache"):
            require(g[f] == want[f], f"serve CLI: {g['id']} {f} {g[f]!r} != in-process {want[f]!r}")
    require(cli_stats["errors"] == 0 and all(v == 0 for v in cli_stats["rung_failures"].values()),
            f"serve CLI stats: {cli_stats['errors']} errors, {cli_stats['rung_failures']}")
    print(f"phase 14 CLI (fresh process, --warm 16, {len(pick)} requests): exit 0 in {cli_s:.2f} s, "
          f"answers == in-process; warm-up {cli_stats['scheduler']['precompile_seconds']} s, "
          f"{cli_stats['scheduler']['batches']} flushes, tiers {cli_stats['tiers']}")
    print(f"phase 14 card: {smi}")
    return launches, {rid: resp_of[rid] for rid in a_ids}


# -- phase 15: the fleet ------------------------------------------------------


def fleet_replica(argv) -> int:
    """A phase 15 replica: the port's serve CLI, with two stderr lines of
    its own. When the warm-up ends it prints ``ready`` with its
    ``time.monotonic()`` (one clock for every process of the machine, so
    the front reads the cold start against the spawn time) and zeroes the
    kernels' launch counts; at exit it prints the counts of the warm-up and
    of the traffic. Stdout stays the JSONL response stream."""
    import os

    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.serve import scheduler
    from tsp_mpi_reduction_tpu_torch.serve.service import serve_cli

    def counts():
        return {**hkk.LAUNCHES, **prim_kernels.LAUNCHES, **ek.LAUNCHES}

    warm = {}
    precompile = scheduler.MicroBatchScheduler.precompile

    def precompile_then_reset(self, *args, **kwargs):
        out = precompile(self, *args, **kwargs)
        warm.update(counts())
        for mod in (hkk, prim_kernels, ek):
            mod.reset_launches()
        print(json.dumps({"fleet_replica": "ready", "pid": os.getpid(), "monotonic": time.monotonic()}),
              file=sys.stderr, flush=True)
        return out

    scheduler.MicroBatchScheduler.precompile = precompile_then_reset
    rc = serve_cli(argv)
    print(json.dumps({"fleet_replica": "exit", "pid": os.getpid(), "warm": warm, "launches": counts()}),
          file=sys.stderr, flush=True)
    return rc


def _replica_lines(rep, kind):
    """The phase 15 replica's JSON lines of one kind in its stderr tail."""
    out = []
    for line in rep.stderr_tail():
        if line.startswith('{"fleet_replica": "' + kind + '"'):
            out.append(json.loads(line))
    return out


def _replica_stats(rep):
    """The serve stats line (``--stats``) a phase 15 replica printed at exit."""
    for line in reversed(rep.stderr_tail()):
        if line.startswith('{"responses"'):
            return json.loads(line)
    return None


def _wait_for(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        require(time.monotonic() < deadline, f"fleet: {what} within {timeout_s:.0f} s")
        time.sleep(0.1)


def _cold_start_s(rep):
    """Spawn to the end of the warm-up of the replica's current process."""
    pid = rep.proc.pid
    ready = [r for r in _replica_lines(rep, "ready") if r["pid"] == pid]
    return ready[-1]["monotonic"] - rep.started_at if ready else None


def _compute_apps():
    """One ``pid, used_memory`` line per CUDA context on the card. In a
    container the pids may be the host's, not the container's, so the
    checks count the contexts."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.strip().splitlines() if line.strip()]


def _fleet_front(cfg):
    """A front whose replicas are ``chip_smoke.py --fleet-replica`` (the
    serve CLI's argv otherwise, plus ``--stats``)."""
    from tsp_mpi_reduction_tpu_torch.fleet import FleetFront, ReplicaSpec
    from tsp_mpi_reduction_tpu_torch.fleet.front import default_replica_spec

    FLEET_DIR.mkdir(parents=True, exist_ok=True)
    specs = []
    for i in range(cfg.replicas):
        spec = default_replica_spec(cfg, i, shared_cache_dir=cfg.shared_cache_dir,
                                    compile_cache_dir=str(FLEET_DIR / "ascent_memo"))
        require(spec.argv[1:4] == ["-m", "tsp_mpi_reduction_tpu_torch", "serve"], f"fleet: argv {spec.argv}")
        specs.append(ReplicaSpec(argv=[sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-replica",
                                       *spec.argv[4:], "--stats"], env=spec.env, scrape=True, meta=spec.meta))
    cfg.replica_specs = specs
    front = FleetFront(cfg)
    reps = front.supervisor.replicas
    _wait_for(lambda: all(_cold_start_s(r) is not None for r in reps), 300, "both replicas warmed up")
    return front, [_cold_start_s(r) for r in reps]


def _close_fleet(front):
    """Close the front; return each replica's exit line and serve stats."""
    front.close()
    reps = front.supervisor.replicas
    _wait_for(lambda: all(_replica_lines(r, "exit") and _replica_stats(r) for r in reps), 30,
              "every replica's exit lines")
    return [(_replica_lines(r, "exit")[-1], _replica_stats(r)) for r in reps]


def _valid_tour(r, n):
    tour = r["tour"]
    return tour[0] == tour[-1] and sorted(tour[:-1]) == list(range(n))


def phase_fleet(smi, serve_a):
    """Phase 15: the fleet entry point on the card (see the module docstring)."""
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.fleet import FleetConfig
    from tsp_mpi_reduction_tpu_torch.fleet.supervisor import SupervisorConfig
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix_np
    from tsp_mpi_reduction_tpu_torch.resilience import faults
    from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH
    from tsp_mpi_reduction_tpu_torch.serve import canonical as canon
    from tsp_mpi_reduction_tpu_torch.serve.service import run_jsonl
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    first, second, perms = serve_requests()
    by_id = {r["id"]: r for r in first + second}
    f1 = [r for r in first if r["id"][0] in "AD"]  # phase 14's order: A, then D
    a_ids = [r["id"] for r in first if r["id"][0] == "A"]
    if FLEET_DIR.exists():
        shutil.rmtree(FLEET_DIR)
    cfg = FleetConfig(replicas=2, backend="cuda", replica_threads=4, replica_args=("--warm", "16"),
                      shared_cache_dir=str(FLEET_DIR / "shared"), hop_timeout_s=FLEET_HOP_S,
                      supervisor=SupervisorConfig(wedge_timeout_s=FLEET_HOP_S, startup_grace_s=FLEET_HOP_S))
    base = len(_compute_apps())
    t0 = time.perf_counter()
    front, cold = _fleet_front(cfg)
    warm_s = time.perf_counter() - t0
    try:
        # --- F1: A and D at once; F2: B, A's instances moved and permuted
        sink = _TimedSink()
        t_start = time.perf_counter()
        run_jsonl((json.dumps(r) for r in f1), sink, service=front)
        f1_wall = time.perf_counter() - t_start
        apps_f1 = _compute_apps()
        f1_stats = json.loads(front.stats_json())
        f2_sink = _TimedSink()
        run_jsonl((json.dumps(r) for r in second), f2_sink, service=front)

        def shared_hits():
            return sum(row["scrape"].get("shared_cache_hits", 0)
                       for row in json.loads(front.stats_json())["fleet"]["replicas"])

        _wait_for(lambda: shared_hits() > 0, 15, "a shared-tier hit in the replicas' scrapes")
        stats = json.loads(front.stats_json())
    finally:
        exits = _close_fleet(front)
    resp = [json.loads(line) for line in sink.lines]
    f2 = [json.loads(line) for line in f2_sink.lines]
    resp_of = {r["id"]: r for r in resp + f2}
    require([r.get("id") for r in resp] == [r["id"] for r in f1] and [r.get("id") for r in f2] ==
             [r["id"] for r in second], "fleet: responses dropped, duplicated or out of order")
    require(stats["errors"] == 0 and not any("error" in r for r in resp + f2),
            f"fleet: errors {stats['errors']}: {[r for r in resp + f2 if 'error' in r][:2]}")
    require(not any("degraded" in r for r in resp + f2) and sum(stats["fleet"]["degraded_answers"].values()) == 0,
            f"fleet: degraded answers {stats['fleet']['degraded_answers']}")
    require(stats["fleet"]["restarts_total"] == 0, f"fleet: {stats['fleet']['restarts_total']} restarts in F1/F2")
    for exit_line, rstats in exits:
        require(rstats["errors"] == 0 and all(v == 0 for v in rstats["rung_failures"].values()),
                f"fleet: replica {exit_line['pid']} errors {rstats['errors']}, rung failures "
                f"{rstats['rung_failures']}")
    for r in resp + f2:
        tier, cache = SERVE_EXPECT[r["id"][0]]
        n = len(by_id[r["id"]]["xy"])
        require(r["tier"] == tier and r["cache"] == cache and r["n"] == n and _valid_tour(r, n),
                f"fleet: {r['id']} on {r['tier']}/{r['cache']}, want {tier}/{cache}")
        require(r["cost"] == canon.tour_length_np(np.asarray(r["tour"]), np.asarray(by_id[r["id"]]["xy"])),
                f"fleet: {r['id']} cost is not its tour's length")
    # A against the plain dense impl (and phase 14's in-process answers)
    stack = np.stack([distance_matrix_np(np.asarray(by_id[i]["xy"])) for i in a_ids])
    with held_karp.use_impl("dense"):
        _, pt = held_karp.solve_blocks_from_dists(torch.as_tensor(stack, dtype=torch.float32, device="cuda"),
                                                  torch.float32)
    pt = pt.cpu().numpy()
    for i, rid in enumerate(a_ids):
        r = resp_of[rid]
        require(r["tour"] == pt[i].tolist() and r["certified_gap"] == 0.0
                and r["cost"] == canon.tour_length_np(pt[i], np.asarray(by_id[rid]["xy"])),
                f"fleet: {rid} differs from the plain dense impl's tour")
        if serve_a:
            require(all(r[f] == serve_a[rid][f] for f in ("tour", "cost", "tier", "certified_gap")),
                    f"fleet: {rid} differs from phase 14's in-process answer")
    for i, perm in enumerate(perms):
        a, b = resp_of[f"A{i}"], resp_of[f"B{i}"]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        require(b["tour"] == [int(inv[c]) for c in a["tour"]] and abs(b["cost"] - a["cost"]) <= 1e-9 * a["cost"],
                f"fleet: B{i} is not A{i}'s tour relabelled")
    # D held to phase 14's certificate
    for i in range(SERVE_GROUPS["D"][0]):
        require(resp_of[f"D{i}"]["certified_gap"] is not None and resp_of[f"D{i}"]["certified_gap"] >= 0.0,
                f"fleet: D{i} carries no certificate")
    berlin = resp_of["D0"]
    dr = tsplib.embedded("berlin52").distance_matrix()
    bt = np.asarray(berlin["tour"])
    berlin_rounded = float(dr[bt[:-1], bt[1:]].sum())
    require(berlin["certified_gap"] > 0.0 or berlin_rounded == 7542.0,
            f"fleet: berlin52 proven at {berlin['cost']}, its tour {berlin_rounded} under TSPLIB's distances")
    shared = sum(row["scrape"].get("shared_cache_hits", 0) for row in stats["fleet"]["replicas"])
    require(shared > 0, "fleet: no hit served across the replica boundary")
    require(len(apps_f1) == base + 2, f"fleet: {len(apps_f1)} contexts on the card during F1, want {base} + 2 "
            f"replicas: {apps_f1}")
    launches = {k: sum(e["launches"][k] for e, _ in exits) for k in exits[0][0]["launches"]}
    warm_launches = {k: sum(e["warm"].get(k, 0) for e, _ in exits) for k in launches}
    for name in ("relax_dense", "prim_chain", "push_rows"):
        require(launches[name] > 0, f"fleet: {name} never launched by the replicas ({launches})")

    a_last = max(sink.stamps[i] for i, r in enumerate(resp) if r["id"][0] == "A")
    flushes = sum(s["scheduler"]["batches"] for _, s in exits)
    print(f"phase 15 fleet: 2 replicas (cuda, --replica-threads 4, --warm 16) up in {warm_s:.2f} s; cold start "
          f"(spawn to warmed service) {cold[0]:.2f} / {cold[1]:.2f} s; warm-up launches {warm_launches}")
    print(f"phase 15 F1 (A + D at once, {len(f1)} requests): {f1_wall:.2f} s; A {len(a_ids) / (a_last - t_start):.1f} "
          f"requests/s; errors 0, degraded 0, rung failures 0; tiers {f1_stats['tiers']}")
    for tier in ("pipeline", "bnb"):
        lat = [r["fleet_latency_ms"] for r in resp if r["tier"] == tier]
        print(f"phase 15 F1 tier {tier}: {len(lat)} answers, fleet_latency_ms p50 {_quantile(lat, 0.5):.3f} "
              f"p99 {_quantile(lat, 0.99):.3f} max {max(lat):.3f}")
    for i in range(SERVE_GROUPS["D"][0]):
        r = resp_of[f"D{i}"]
        print(f"phase 15 F1 D{i} (n={r['n']}): cost {r['cost']:.4f}, certified gap {r['certified_gap']}, "
              f"fleet latency {r['fleet_latency_ms']:.1f} ms" + (f"; {berlin_rounded:.1f} under TSPLIB's rounding"
                                                                if i == 0 else ""))
    lat_b = [r["fleet_latency_ms"] for r in f2]
    print(f"phase 15 F2 (B): {len(f2)} hits, fleet_latency_ms p50 {_quantile(lat_b, 0.5):.3f}; shared-tier hits "
          f"over the replicas' scrapes {shared}; A == plain dense bit for bit"
          + (" == phase 14's in-process answers" if serve_a else ""))
    for row, (e, s) in zip(stats["fleet"]["replicas"], exits):
        print(f"phase 15 replica {row['index']} (pid {row['pid']}): "
              f"dispatched {row['dispatched']}, answered {row['answered']}, flushes {s['scheduler']['batches']}, "
              f"B&B slices {s['scheduler'].get('bnb_slices')}, launches {e['launches']}, scrape {row['scrape']}")
    print(f"phase 15 launches by F1 + F2, summed over the replicas: relax_dense {launches['relax_dense']}, "
          f"relax_minplus {launches['relax_minplus']}, prim_chain {launches['prim_chain']}, push_rows "
          f"{launches['push_rows']}; {flushes} flushes; hops: redispatches {stats['fleet']['redispatches_total']}")
    print(f"phase 15 compute apps (pid, used memory) during F1: {apps_f1} ({base} before the fleet)")

    # --- F3: a kill, then a hang, each mid-flight
    hop = max(60.0, 3 * max(cold))
    grace = max(20.0, 2 * max(cold))
    cfg3 = FleetConfig(replicas=2, backend="cuda", replica_threads=4, replica_args=("--warm", "16"),
                       shared_cache_dir=str(FLEET_DIR / "shared3"), hop_timeout_s=hop, default_deadline_ms=180_000.0,
                       supervisor=SupervisorConfig(wedge_timeout_s=5.0, startup_grace_s=grace, scrape_timeout_s=1.0,
                                                   restart_backoff_base_s=0.2, restart_backoff_max_s=1.0))
    rng = np.random.default_rng(SERVE_SEED + 15)
    rounds = [[{"id": f"K{i}", "xy": rng.uniform(0, 1000, (16, 2)).tolist(), "deadline_ms": 180_000.0}
               for i in range(8)],
              [{"id": f"H{i}", "xy": rng.uniform(0, 1000, (16, 2)).tolist(), "deadline_ms": 180_000.0}
               for i in range(8)]]
    base = len(_compute_apps())
    front, cold3 = _fleet_front(cfg3)
    h0 = HEALTH.snapshot()
    f3 = []
    try:
        reps = front.supervisor.replicas
        before = {r.proc.pid: r for r in reps}
        apps_before = _compute_apps()
        for spec, reqs in zip(("replica.kill:raise,nth=3", "replica.hang:raise,nth=3"), rounds):
            out = _TimedSink()
            faults.configure(spec)
            try:
                run_jsonl((json.dumps(r) for r in reqs), out, service=front)
            finally:
                faults.clear()
            f3 += [json.loads(line) for line in out.lines]
            if spec.startswith("replica.kill"):
                _wait_for(lambda: any(r.proc.pid not in before and _cold_start_s(r) is not None for r in reps),
                          300, "the killed replica restarted and warmed up")
                killed = [pid for pid, r in before.items() if r.proc.pid != pid]
                restart_cold = [_cold_start_s(r) for r in reps if r.proc.pid not in before]
                restarted = [r.proc.pid for r in reps if r.proc.pid not in before]
                apps_after = _compute_apps()
        _wait_for(lambda: HEALTH.delta_since(h0)["stuck_restarts"] >= 1, grace + 120, "the wedge verdict")
        f3_stats = json.loads(front.stats_json())
        h = HEALTH.delta_since(h0)
    finally:
        faults.clear()
        front.close()
    want_ids = [r["id"] for rnd in rounds for r in rnd]
    require([r.get("id") for r in f3] == want_ids, "fleet chaos: responses dropped, duplicated or out of order")
    require(not any("error" in r or "degraded" in r for r in f3) and f3_stats["errors"] == 0,
            f"fleet chaos: {[r for r in f3 if 'error' in r or 'degraded' in r][:2]}")
    # n = 16 under a long deadline goes to the certified rung: each proof
    # ends on the float64 Held-Karp optimum (the plain dense impl's) up to
    # the B&B's float32 distances (1e-6 relative)
    xy3 = {r["id"]: r["xy"] for rnd in rounds for r in rnd}
    with held_karp.use_impl("dense"):
        opt, _ = held_karp.solve_blocks_from_dists(torch.as_tensor(
            np.stack([distance_matrix_np(np.asarray(xy3[i])) for i in want_ids]), device="cuda"), torch.float64)
    for r, c in zip(f3, opt.cpu().tolist()):
        require(r["tier"] == "bnb" and r["certified_gap"] == 0.0 and _valid_tour(r, 16)
                and abs(r["cost"] - c) <= 1e-6 * c, f"fleet chaos: {r['id']} on {r['tier']}, cost {r['cost']}, "
                f"the Held-Karp optimum {c}")
    require(h["faults_injected"].get("replica.kill") == 1 and h["faults_injected"].get("replica.hang") == 1,
            f"fleet chaos: injected {h['faults_injected']}")
    require(h["fleet_redispatches"] >= 1 and h["fleet_replica_restarts"] >= 1 and h["stuck_restarts"] >= 1,
            f"fleet chaos: health {h}")
    # a killed replica's context is torn down: the count stays at 2 replicas
    require(len(killed) == 1 and len(apps_before) == len(apps_after) == base + 2,
            f"fleet chaos: killed {killed}, restarted {restarted}; contexts before the kill {apps_before}, after "
            f"the restart {apps_after} ({base} before the fleet)")
    print(f"phase 15 F3 (chaos, {len(want_ids)} requests of n=16; kill at the 3rd dispatch, then a hang at the "
          f"3rd): exactly once, errors 0, degraded 0; restarts {f3_stats['fleet']['restarts_total']}, "
          f"redispatches {h['fleet_redispatches']}, wedge verdicts {h['stuck_restarts']}; cold start "
          f"{cold3[0]:.2f} / {cold3[1]:.2f} s, the killed replica's restart {restart_cold[0]:.2f} s (spawn to "
          f"warmed service; hop {hop:.0f} s, grace {grace:.0f} s)")
    print(f"phase 15 F3 compute apps (pid, used memory) before the kill {apps_before}; after the restart "
          f"{apps_after} (killed pid {killed}, restarted as {restarted}; {base} before the fleet)")

    # --- F4: the CLI in a fresh process on 10 of F1's requests
    pick = a_ids[:10]
    req_path, out_path = FLEET_DIR / "requests.jsonl", FLEET_DIR / "responses.jsonl"
    req_path.write_text("".join(json.dumps(by_id[i]) + "\n" for i in pick))
    # the front dispatches at once and a request's deadline runs while a
    # cold replica starts: the requests go in after the measured cold start
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch", "fleet", "--replicas", "2",
                             "--warm", "16", "--stats", "--out", str(out_path)], stdin=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    base = len(_compute_apps())
    most = []
    try:
        hold_until = time.monotonic() + 2 * max(cold) + 5
        while time.monotonic() < hold_until:
            most = max(most, _compute_apps(), key=len)
            time.sleep(0.5)
        proc.stdin.write(req_path.read_text())
        proc.stdin.close()
        while proc.poll() is None:
            most = max(most, _compute_apps(), key=len)
            time.sleep(0.5)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"fleet CLI: exit {proc.returncode}: {err[-2000:]}")
    got = [json.loads(line) for line in out_path.read_text().splitlines()]
    cli_stats = json.loads(err.strip().splitlines()[-1])
    require([g["id"] for g in got] == pick, f"fleet CLI: ids {[g['id'] for g in got]}")
    for g in got:
        for f in ("n", "tier", "cost", "tour", "certified_gap", "cache"):
            require(g[f] == resp_of[g["id"]][f], f"fleet CLI: {g['id']} {f} {g[f]!r} != F1's {resp_of[g['id']][f]!r}")
    cli_pids = [row["pid"] for row in cli_stats["fleet"]["replicas"]]
    require(cli_stats["errors"] == 0 and sum(cli_stats["fleet"]["degraded_answers"].values()) == 0,
            f"fleet CLI stats: {cli_stats['errors']} errors, degraded {cli_stats['fleet']['degraded_answers']}")
    # the front creates no context: the most the card held was the 2 replicas'
    require(len(most) == base + 2, f"fleet CLI: at most {len(most)} contexts on the card, want {base} + 2 "
            f"replicas (the front {proc.pid} none): {most}")
    print(f"phase 15 F4 CLI (fresh process, --replicas 2 --warm 16, {len(pick)} requests): exit 0 in {cli_s:.2f} s, "
          f"answers == F1; contexts on the card at most {most} ({base} before): the front (pid {proc.pid}) held "
          f"none, its replicas {cli_pids} one each")
    print(f"phase 15 card: {smi}")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the sharded B&B, the ranks batched on the one card
# ---------------------------------------------------------------------------


def rows_digest(rows) -> str:
    """sha256 prefix of a balance summary's per-dispatch rows."""
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def shard_fields(out: dict, balance: dict) -> dict:
    """A sharded run's pinned fields: the payload's, the balance summary's
    and the digest of its rows."""
    return {**out, **balance, "rows": rows_digest(balance["rows"])}


def phase_sharded(smi, errs):
    """Phase 16 (see the module docstring); returns the kernels' launches
    in run 1 (eil51 R = 8 under pair, the main path of this phase)."""
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.obs import rankview
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt

    # --- eil51 through the CLI, counts reset just before each run; the
    # rank hook's own meter on (phase 18 reads it)
    outs = {}
    for name, (argv, loop, pinned) in SHARD_CLI.items():
        prim_kernels.reset_launches()
        ek.reset_launches()
        bb.reset_frontier_stats()
        rankview.RankSampler.METER_NS = [0]
        try:
            out = run_bnb_cli(argv + ["--backend=cuda"])
        finally:
            hook_ns, rankview.RankSampler.METER_NS = rankview.RankSampler.METER_NS[0], None
        out["_rank_hook_ns"] = hook_ns
        launches = {**prim_kernels.LAUNCHES, **ek.LAUNCHES}
        outs[name] = (out, launches, bb.FRONTIER_STATS["peak_count"])
        bal = out["obs"]["balance"]
        pinned_fields(shard_fields(out, bal), {**SHARD_CLI_COMMON, **pinned}, f"sharded {' '.join(argv)}")
        ranks = len(pinned["nodes_per_rank"])
        require(out["ranks"] == ranks and out["balance"] == ("ring" if name == "ring" else "pair")
                and out["device_loop"] == loop and out["mst_kernel"] == "prim_chain"
                and out["step_kernel"] == "fused",
                f"sharded {name}: ranks {out['ranks']} balance {out['balance']} loop {out['device_loop']} "
                f"kernels {out['mst_kernel']}/{out['step_kernel']}")
        # 1 + node_ascent prim_chain launches (one chain over the R*k lanes)
        # and one push_rows launch (into the stacked [R*F, C] buffer) a
        # batched step issued: its replays and a capture's warm-up steps;
        # the host loop issues inner_steps steps a round, the device loop up
        # to a run of no-op rounds past its stop
        issued = out["replays"] + out["warm_steps"]
        require(launches["prim_chain"] == out["prim_chain_launches"] == 3 * issued > 0
                and launches["push_rows"] == out["push_rows_launches"] == issued
                and out["replays"] >= out["iterations"] and (loop or out["replays"] == out["iterations"])
                and out["step_graph"],
                f"sharded {name}: {launches['prim_chain']} prim_chain / {launches['push_rows']} push_rows "
                f"launches for {out['replays']} batched steps issued + {out['warm_steps']} warm-up "
                f"({out['iterations']} iterations, {out['steps_run']} rank-steps expanded)")
        print(f"phase 16 eil51 {' '.join(argv[1:])} ({'device' if loop else 'host'} loop, fused push, "
              f"prim_chain): proved {out['cost']} (LB {out['lower_bound']}) in {out['nodes_expanded']} nodes "
              f"== the JAX package's, per rank {out['nodes_per_rank']}; {out['iterations']} iterations, "
              f"{out['steps_run']} rank-steps in {out['replays']} batched steps issued over {out['dispatches']} "
              f"dispatches, balance {bal['actions']} moving {bal['moved_rows_total']} rows; "
              f"{launches['prim_chain']} prim_chain + {launches['push_rows']} push_rows launches "
              f"({out['warm_steps']} warm-up steps, capture {out['capture_s']} s); largest rank count "
              f"{outs[name][2]}")
        print(f"phase 16 seconds ({name}): setup {out['setup_s']} (ascent {out['setup_ascent_s']}, ILS "
              f"{out['setup_ils_s']}), search {out['wall_s']}, time to proof {out['time_to_proof_s']}; "
              f"{out['nodes_per_sec']} nodes/s")
    main_out, main_launches, _ = outs["pair"]
    SHARED["pair_batched"] = main_out

    # --- both kernels on run 1's recorded inputs (its eager steps: the same
    # batched steps, R*k lanes a launch), launch by launch
    argv = SHARD_CLI["pair"][0] + ["--backend=cuda"]
    chains, pushes, out = kt.record_bnb_calls(argv)
    require(out["nodes_expanded"] == main_out["nodes_expanded"] and out["replays"] == main_out["replays"]
            and len(chains) == 3 * out["replays"] and len(pushes) == out["replays"]
            and chains[0][1].shape[0] == 8 * 128 and pushes[0][0][0] == 8 * (16_384 + 128 * 51),
            f"recorded run: {out['nodes_expanded']} nodes, {len(chains)} prim_chain / {len(pushes)} push_rows "
            f"launches, want 3 x / 1 x {main_out['replays']} batched steps of 1024 lanes")
    try:
        lanes = kt.prim_check(chains)
        kt.push_check(pushes, 51)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    sample = chains[: 3 * 1000]
    prim_row = kt.time_prim(sample, "sharded", reps=3)
    push = kt.time_push(pushes[:1000], 51, "sharded", reps=3)
    print(f"phase 16 kernels on run 1's recorded inputs: all {len(chains)} prim_chain launches ({lanes} lanes) "
          f"and all {len(pushes)} push_rows launches == plain bit for bit; on the first {len(sample)} / "
          f"{min(len(pushes), 1000)} (8 ranks x k=128 lanes, n=51): prim_chain {prim_row['device_ms']:.4f} ms/launch device "
          f"(graph replay), {prim_row['ms']:.4f} eager, bound {prim_row['bound_ms']:.6f} ms, plain "
          f"{prim_row['plain_ms']:.4f}; push_rows {push['device_ms']:.4f} ms/launch device, {push['ms']:.4f} "
          f"eager, bound {push['bound_ms']:.6f} ms, plain {push['plain_ms']:.4f}, mean n_push "
          f"{push['mean_n_push']:.1f}")
    del chains, pushes

    # --- the small sharded solves: adaptive controller, spills, resume
    SHARD_DIR.mkdir(parents=True, exist_ok=True)
    ck = str(SHARD_DIR / "sharded.npz")
    for old in SHARD_DIR.glob("sharded.npz*"):
        old.unlink()
    got = {}
    for name, ((n, seed), kw, pinned) in SHARD_SMALL.items():
        xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
        d = np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)
        extra = {}
        if name == "chunk1":
            extra = dict(checkpoint_path=ck)
        elif name == "chunk2":
            extra = dict(checkpoint_path=ck, resume_from=ck)
        t0 = time.perf_counter()
        res = bb.solve_sharded(d, 4, device="cuda", **kw, **extra)
        wall = time.perf_counter() - t0
        got[name] = res
        fields = {"cost": res.cost, "lower_bound": res.lower_bound, "proven_optimal": res.proven_optimal,
                  "nodes_expanded": res.nodes_expanded, "nodes_per_rank": [int(x) for x in res.nodes_per_rank],
                  "iterations": res.iterations, "spill_rounds": res.spill_rounds,
                  "spill_events": res.spill_events, "spill_full_merges": res.spill_full_merges,
                  "spill_bytes_to_host": res.spill_bytes_to_host,
                  "spill_bytes_to_device": res.spill_bytes_to_device}
        pinned_fields(shard_fields(fields, res.balance), pinned, f"sharded {name}")
        print(f"phase 16 {name} (4 ranks, {n} cities, {kw.get('balance')}, "
              f"{'device' if res.device_loop else 'host'} loop): cost {res.cost}, LB {res.lower_bound}, "
              f"proven {res.proven_optimal}, {res.nodes_expanded} nodes {fields['nodes_per_rank']}, "
              f"{res.iterations} iterations, spill rounds/events {res.spill_rounds}/{res.spill_events}, "
              f"balance {res.balance['actions']} ({res.balance['switches']} switches, "
              f"{res.balance['moved_rows_total']} rows moved) == the JAX package's; {wall:.2f} s")
    SHARED["spill_batched"] = got["spill"]
    whole, chunk2 = got["whole"], got["chunk2"]
    require(chunk2.cost == whole.cost and chunk2.lower_bound == whole.lower_bound
            and np.array_equal(chunk2.tour, whole.tour) and got["chunk1"].checkpoint_save_s,
            "sharded resume: chunk 2 does not land on the uninterrupted optimum")
    print(f"phase 16 sharded checkpoint -> resume on the card: chunk 1 saved in "
          f"{got['chunk1'].checkpoint_save_s[-1]:.4f} s, chunk 2 restored in {chunk2.checkpoint_restore_s:.4f} s "
          f"and proved {chunk2.cost} with certified LB {chunk2.lower_bound} and the uninterrupted tour")
    print(f"phase 16 card: {smi}")
    torch.cuda.synchronize()
    return main_launches


# ---------------------------------------------------------------------------
# Phase 17: real ranks, one process a rank over gloo, all on the one card
# ---------------------------------------------------------------------------

PROCS_DIR = ROOT / "build" / "chip_smoke_procs"
#: every rank group of phase 17 must finish within this (cold starts included)
PROCS_DEADLINE_S = 400.0
#: phase 17's pipeline runs over 4 ranks: (n, blocks, grid, dtype)
PROCS_PIPE = [(N_FULL, B_FULL, GRID_FULL, "float32"), (10, 6, 500, "float64"), (10, 100, 1000, "float64")]
#: phase 17's ring: the merged tour of 16 64 1000 1000 (1,024 cities), float64
PROCS_RING = (16, 64, 1000)


def _launch_counts() -> dict:
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

    return {"relax_minplus": hkk.LAUNCHES["relax_minplus"], "relax_dense": hkk.LAUNCHES["relax_dense"],
            "prim_chain": prim_kernels.LAUNCHES["prim_chain"], "push_rows": ek.LAUNCHES["push_rows"]}


def _reset_launches() -> None:
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

    hkk.reset_launches()
    prim_kernels.reset_launches()
    ek.reset_launches()


def procs_mesh_rank(ranks, ring_xy, ring_tour):
    """A phase 17 rank process for (a) and (b): ``run_pipeline_sharded`` on
    every case of ``PROCS_PIPE`` twice, first with rank 0's sweeps recorded
    and held to the plain per-level loop (the whole table), then timed with
    no check and its launches counted; then ``ring_two_opt`` of
    ``ring_tour``. Returns rank 0's results with every rank's launches,
    seconds and collective counters."""
    import torch

    from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_sharded
    from tsp_mpi_reduction_tpu_torch.ops import held_karp
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.parallel.seq_improve import ring_two_opt
    from tsp_mpi_reduction_tpu_torch.utils.state import instance_from_numpy

    dev = ranks.device
    real, checked = held_karp.relax_dense_sweep, []

    def recorder(cost, d_sub):
        before = cost.clone()
        out = real(cost, d_sub)
        ref = before
        for c in range(1, cost.shape[1]):
            ref = hkk.relax_dense_reference(ref, d_sub, c)
        checked.append((tuple(cost.shape), bool(torch.equal(out, ref))))
        return out

    pipes = []
    for n, nb, grid, dtype in PROCS_PIPE:
        if ranks.is_root:
            held_karp.relax_dense_sweep = recorder
        try:
            run_pipeline_sharded(n, nb, grid, grid, ranks, dtype=dtype, device=dev)
        finally:
            held_karp.relax_dense_sweep = real
        _reset_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_pipeline_sharded(n, nb, grid, grid, ranks, dtype=dtype, device=dev)
        wall = time.perf_counter() - t0
        per_rank = ranks.gather_objects((_launch_counts(), wall, torch.cuda.max_memory_allocated(dev)))
        if res is not None:
            pipes.append({"cost": res.cost, "ids": res.tour_ids, "solve_reduce": res.phase_seconds["solve_reduce"],
                          "per_rank": per_rank})
    _, dist = instance_from_numpy(ring_xy, torch.float64, dev)
    _reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ring = ring_two_opt(torch.as_tensor(ring_tour, device=dev), dist, ranks)
    torch.cuda.synchronize(dev)
    ring_s = time.perf_counter() - t0
    stats = ranks.gather_objects(ranks.stats())
    if not ranks.is_root:
        return None
    return {"pipes": pipes, "checked": checked, "ring": ring.cpu().numpy(), "ring_s": ring_s, "stats": stats}


def procs_bnb_rank(ranks, argv):
    """A phase 17 rank process of the B&B CLI (``bnb_solve --transport=procs``'s
    own rank body) with rank 0's ``prim_chain`` and ``push_rows`` launches
    recorded, then held bit for bit against the plain versions."""
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.tools import bnb_solve
    from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt

    from tsp_mpi_reduction_tpu_torch.obs import rankview

    if not ranks.is_root:
        return bnb_solve._solve_rank(ranks, argv)
    rankview.RankSampler.METER_NS = [0]  # rank 0's rank hook, for phase 18
    with kt.recorded(prim_kernels, "prim_chain", kt.keep_prim) as chains, \
            kt.recorded(ek, "push_rows", kt.keep_push) as pushes:
        out = bnb_solve._solve_rank(ranks, argv)
    hook_ns = rankview.RankSampler.METER_NS[0]
    lanes = kt.prim_check(chains)
    kt.push_check(pushes, out[0]["dimension"])
    return out, {"prim_chain": len(chains), "push_rows": len(pushes), "lanes": lanes, "rank_hook_ns": hook_ns}


def procs_small_rank(ranks, cases):
    """A phase 17 rank process for (d): 4-rank ``solve_sharded`` of each case
    ``(name, d, kw)`` -> rank 0's results, seconds, every rank's launches
    and collective counters."""
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb

    out = {}
    for name, d, kw in cases:
        _reset_launches()
        before = ranks.stats()
        torch.cuda.synchronize(ranks.device)
        t0 = time.perf_counter()
        res = bb.solve_sharded(d, ranks.num_ranks, device=ranks.device, ranks=ranks, **kw)
        wall = time.perf_counter() - t0
        after = ranks.stats()
        coll = sum(after["seconds"].values()) - sum(before["seconds"].values())
        per_rank = ranks.gather_objects((_launch_counts(), coll))
        out[name] = (res, wall, per_rank)
    stats = ranks.gather_objects(ranks.stats())
    return (out, stats) if ranks.is_root else None


def run_bnb_cli_procs(argv):
    """The B&B CLI in this process with ``--transport=procs`` (it spawns the
    ranks) -> (payload, its ``transport:`` stderr line)."""
    from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bnb_solve.main(argv)
    require(rc == 0, f"bnb_solve {argv}: exit {rc}: {err.getvalue()[-2000:]}")
    info = [line for line in err.getvalue().splitlines() if line.startswith("transport: ")]
    return json.loads(out.getvalue().strip().splitlines()[-1]), json.loads(info[-1].split(": ", 1)[1])


def _staged_summary(stats) -> str:
    """Bytes staged through the host a collective kind, summed over ranks,
    and the ranks' cold starts."""
    kinds = {}
    for st in stats:
        for k, v in st["staged_bytes"].items():
            if v:
                kinds[k] = kinds.get(k, 0) + v
    colds = [round(st["cold_start_s"], 2) for st in stats]
    return f"staged bytes {kinds}, cold start per rank {colds} s"


def phase_procs(smi):
    """Phase 17: the port's real ranks, R processes on the one card over
    gloo (the module docstring); returns the launches of the phase's main
    paths summed over the ranks."""
    import numpy as np
    import torch

    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.models.distributed import run_pipeline_ranks
    from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
    from tsp_mpi_reduction_tpu_torch.ops.local_search import tour_length
    from tsp_mpi_reduction_tpu_torch.parallel import mesh
    from tsp_mpi_reduction_tpu_torch.parallel.seq_improve import ring_two_opt

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # --- (a) pipeline and (b) ring improver: one group of 4 rank processes
    n_r, nb_r, grid_r = PROCS_RING
    ring_in = run_pipeline(n_r, nb_r, grid_r, grid_r, dtype=torch.float64, device=dev)
    ring_tour = ring_in.tour_ids[:-1].astype(np.int64)
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance

    _, ring_xy = generate_instance(n_r, nb_r, grid_r, grid_r)
    t0 = time.perf_counter()
    got = mesh.spawn_ranks(procs_mesh_rank, 4, args=(ring_xy, ring_tour), timeout_s=PROCS_DEADLINE_S)
    group_s = time.perf_counter() - t0
    require(got["checked"] and all(ok for _, ok in got["checked"]),
            f"relax_dense_sweep != the plain per-level loop on rank 0's launches: {got['checked']}")
    launches = {}
    for (n, nb, grid, dtype), pipe in zip(PROCS_PIPE, got["pipes"]):
        t0 = time.perf_counter()
        want = run_pipeline_ranks(n, nb, grid, grid, 4, dtype=dtype, device=dev)
        one_s = time.perf_counter() - t0
        require(pipe["cost"] == want.cost and np.array_equal(pipe["ids"], want.tour_ids),
                f"pipeline {n} {nb} {grid} {dtype} over 4 processes: cost {pipe['cost']!r} != run_pipeline_ranks "
                f"{want.cost!r} or the tour differs")
        dense = [lc["relax_dense"] for lc, _, _ in pipe["per_rank"]]
        minplus = [lc["relax_minplus"] for lc, _, _ in pipe["per_rank"]]
        require(all(x > 0 for x in dense), f"pipeline {n} {nb}: a rank launched no relax_dense_sweep: {dense}")
        require(not any(minplus), f"pipeline {n} {nb}: impl auto launched relax_minplus: {minplus}")
        if n == N_FULL:
            launches.update(relax_dense=sum(dense), relax_minplus=sum(minplus))
        print(f"phase 17 pipeline {n} {nb} {grid} {grid} {dtype} over 4 rank processes: cost {pipe['cost']:f} "
              f"and tour == run_pipeline_ranks(..., 4) on the card; solve_reduce {pipe['solve_reduce']:.4f} s "
              f"(rank 0) against {want.phase_seconds['solve_reduce']:.4f} s batched on one device ({one_s:.2f} s "
              f"wall); relax_dense_sweep launches per rank {dense}, relax_minplus {minplus}; per-rank wall "
              f"{[round(w, 3) for _, w, _ in pipe['per_rank']]} s, peak memory "
              f"{[round(m / 2**30, 2) for _, _, m in pipe['per_rank']]} GiB")
    print(f"phase 17 rank 0's {len(got['checked'])} relax_dense_sweep calls (tables "
          f"{sorted({s for s, _ in got['checked']})}) == the plain per-level loop, whole table")
    dist = ring_in.dist
    t0 = time.perf_counter()
    want_ring = ring_two_opt(torch.as_tensor(ring_tour, device=dev), dist, mesh.BatchedRanks(4))
    torch.cuda.synchronize()
    batched_ring_s = time.perf_counter() - t0
    ring = torch.as_tensor(got["ring"], device=dev)
    before = float(tour_length(torch.as_tensor(ring_tour, device=dev)[None], dist)[0])
    after = float(tour_length(ring[None], dist)[0])
    require(torch.equal(ring, want_ring) and after <= before,
            f"ring_two_opt over 4 processes != BatchedRanks(4) on the card, or dearer ({after} > {before})")
    print(f"phase 17 ring_two_opt ({nb_r * n_r} cities, float64, 4 rank processes) == BatchedRanks(4) element "
          f"for element; length {before:.6f} -> {after:.6f}; {got['ring_s']:.3f} s over processes, "
          f"{batched_ring_s:.3f} s batched; (a)+(b) group {group_s:.1f} s with {_staged_summary(got['stats'])}")

    # --- (c) eil51 at the JAX width through the CLI's procs transport
    for name, (argv, loop, pinned) in SHARD_CLI.items():
        if name == "ring":
            continue
        r = len(pinned["nodes_per_rank"])
        cli = argv + ["--backend=cuda", "--transport=procs"]
        t0 = time.perf_counter()
        if name == "pair":  # rank 0's launches recorded and held bit for bit: every rank takes the
            # eager steps (a replay calls no wrapper), the steps a replay issues
            with compile_cache_setting("off"):
                (out, info), rec = mesh.spawn_ranks(procs_bnb_rank, r, args=(cli,), timeout_s=PROCS_DEADLINE_S)
        else:
            (out, info), rec = run_bnb_cli_procs(cli), None
        wall = time.perf_counter() - t0
        bal = out["obs"]["balance"]
        pinned_fields(shard_fields(out, bal), {**SHARD_CLI_COMMON, **pinned}, f"procs {' '.join(argv)}")
        per_rank = info["launches_per_rank"]
        # each rank process replays its own step graph, one rank a step:
        # 3 prim_chain and 1 push_rows a step it issued, summed over the R
        want_push = r * (out["replays"] + out["warm_steps"])
        want_prim = 3 * want_push
        require(info["transport"] == "procs" and info["backend"] == "gloo" and out["ranks"] == r
                and out["prim_chain_launches"] == sum(x["prim_chain"] for x in per_rank) == want_prim
                and out["push_rows_launches"] == sum(x["push_rows"] for x in per_rank) == want_push
                and all(x["prim_chain"] > 0 and x["push_rows"] > 0 for x in per_rank),
                f"procs {name}: launches {per_rank}, want {want_prim} / {want_push} summed")
        if rec is not None:
            require(rec["prim_chain"] == per_rank[0]["prim_chain"] and rec["push_rows"] == per_rank[0]["push_rows"],
                    f"procs {name}: recorded {rec} != rank 0's launches {per_rank[0]}")
            launches.update(prim_chain=out["prim_chain_launches"], push_rows=out["push_rows_launches"])
            out["_rank_hook_ns"] = rec["rank_hook_ns"]
            SHARED["pair_procs"] = out
        rounds = max(out["iterations"] // 32, 1)
        # a rank's collective seconds include its wait for the slowest rank
        coll = [sum(st["seconds"].values()) for st in info["collectives_per_rank"]]
        print(f"phase 17 eil51 {' '.join(argv[1:])} --transport=procs ({'device' if loop else 'host'} loop): proved "
              f"{out['cost']} (LB {out['lower_bound']}) in {out['nodes_expanded']} nodes == phase 16 / the JAX "
              f"package's, per rank {out['nodes_per_rank']}; balance {bal['actions']} moving "
              f"{bal['moved_rows_total']} rows; launches per rank prim_chain "
              f"{[x['prim_chain'] for x in per_rank]} push_rows {[x['push_rows'] for x in per_rank]} (summed "
              f"{want_prim} / {want_push})" + (f"; rank 0's {rec['prim_chain']} prim_chain ({rec['lanes']} lanes) "
                                                 f"and {rec['push_rows']} push_rows launches == plain bit for bit"
                                                 if rec else ""))
        print(f"phase 17 seconds ({name}, procs): setup {out['setup_s']}, search {out['wall_s']}, time to proof "
              f"{out['time_to_proof_s']}; {out['nodes_per_sec']} nodes/s; {wall:.1f} s with the spawn; collectives "
              f"{min(coll) / rounds * 1e3:.2f}-{max(coll) / rounds * 1e3:.2f} ms a round (the rank that waits "
              f"least - most, {rounds} rounds); "
              f"{_staged_summary(info['collectives_per_rank'])}")

    # --- (d) 4-rank 12-city solves: adaptive, spill, snapshots both ways
    PROCS_DIR.mkdir(parents=True, exist_ok=True)
    for old in PROCS_DIR.glob("*.npz*"):
        old.unlink()
    bpath, ppath = str(PROCS_DIR / "batched.npz"), str(PROCS_DIR / "procs.npz")

    def inst(n, seed):
        xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
        return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)

    (n1, s1), kw1, _ = SHARD_SMALL["chunk1"]
    bb.solve_sharded(inst(n1, s1), 4, device="cuda", checkpoint_path=bpath, **kw1)
    cases = [("adaptive", SHARD_SMALL["adaptive"]), ("spill", SHARD_SMALL["spill"]),
             ("chunk1", SHARD_SMALL["chunk1"]), ("chunk2", SHARD_SMALL["chunk2"])]
    extra = {"chunk1": dict(checkpoint_path=ppath), "chunk2": dict(resume_from=bpath)}
    runs = [(name, inst(*nseed), dict(kw, **extra.get(name, {}))) for name, (nseed, kw, _) in cases]
    t0 = time.perf_counter()
    small, stats = mesh.spawn_ranks(procs_small_rank, 4, args=(runs,), timeout_s=PROCS_DEADLINE_S)
    group_s = time.perf_counter() - t0
    SHARED["spill_procs"] = small["spill"][0]
    for name, (nseed, kw, pinned) in cases:
        res, wall, per_rank = small[name]
        fields = {"cost": res.cost, "lower_bound": res.lower_bound, "proven_optimal": res.proven_optimal,
                  "nodes_expanded": res.nodes_expanded, "nodes_per_rank": [int(x) for x in res.nodes_per_rank],
                  "iterations": res.iterations, "spill_rounds": res.spill_rounds,
                  "spill_events": res.spill_events, "spill_full_merges": res.spill_full_merges,
                  "spill_bytes_to_host": res.spill_bytes_to_host,
                  "spill_bytes_to_device": res.spill_bytes_to_device}
        pinned_fields(shard_fields(fields, res.balance), pinned, f"procs {name}")
        pushes = [lc["push_rows"] for lc, _ in per_rank]
        require(all(x > 0 for x in pushes), f"procs {name}: a rank launched no push_rows: {pushes}")
        rounds = max(res.iterations // kw.get("inner_steps", 32), 1)
        print(f"phase 17 {name} (4 rank processes, {nseed[0]} cities, {kw.get('balance')}): cost {res.cost}, LB "
              f"{res.lower_bound}, proven {res.proven_optimal}, {res.nodes_expanded} nodes {fields['nodes_per_rank']}, "
              f"spill rounds/events {res.spill_rounds}/{res.spill_events}, balance {res.balance['actions']} == phase "
              f"16 / the JAX package's; {wall:.2f} s ({res.nodes_per_sec:.1f} nodes/s), collectives "
              f"{min(c for _, c in per_rank) / rounds * 1e3:.2f}-{max(c for _, c in per_rank) / rounds * 1e3:.2f} "
              f"ms a round; push_rows per rank {pushes}")
    t0 = time.perf_counter()
    back = bb.solve_sharded(inst(*SHARD_SMALL["chunk2"][0]), 4, device="cuda", resume_from=ppath,
                            **SHARD_SMALL["chunk2"][1])
    resume_s = time.perf_counter() - t0
    whole = SHARD_SMALL["whole"][2]
    for what, res in (("batched snapshot -> procs", small["chunk2"][0]), ("procs snapshot -> batched", back)):
        require(res.proven_optimal and res.cost == whole["cost"] and res.lower_bound == whole["lower_bound"],
                f"{what}: does not land on the uninterrupted optimum")
    require(np.array_equal(back.tour, small["chunk2"][0].tour) and back.nodes_expanded
            == SHARD_SMALL["chunk2"][2]["nodes_expanded"], "procs snapshot -> batched: not the JAX resume")
    print(f"phase 17 snapshots: the procs 200-iteration snapshot resumed batched ({resume_s:.2f} s) and the batched "
          f"one resumed over procs both prove {back.cost} with LB {back.lower_bound} ({back.nodes_expanded} nodes, "
          f"the JAX resume); (d) group {group_s:.1f} s with {_staged_summary(stats)}")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s; card: {smi}")
    torch.cuda.synchronize()
    return launches

# ---------------------------------------------------------------------------
# Phase 18: the B&B line's telemetry and the runtime contracts
# ---------------------------------------------------------------------------

#: what earlier phases hand to phase 18 (it runs what is missing itself):
#: phase 7's eil51 payload, phase 16's R = 8 pair payload and spill-forcing
#: result, phase 17's procs R = 8 pair payload and spill-forcing result
SHARED = {}


def small_instance(n: int, seed: int):
    """The rounded x10 Euclidean instance of phases 16-17's small solves."""
    import numpy as np

    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


def _shared(key, make):
    if key not in SHARED:
        SHARED[key] = make()
    return SHARED[key]


def _median(values):
    v = sorted(values)
    return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2


def _check_rank_view(what: str, rank_series: dict, bal: dict, nodes_per_rank, spill: dict) -> None:
    """Per rank, the series' node windows add up to ``nodes_per_rank`` and
    the balance block's spill vectors to the aggregate counters."""
    cols, rows = rank_series["columns"], rank_series["rows"]
    require(rank_series["samples_dropped"] == 0, f"{what}: the rank ring dropped windows")
    i = cols.index("nodes")
    sums = [sum(r[i][q] for r in rows) for q in range(rank_series["ranks"])]
    require(sums == [int(x) for x in nodes_per_rank] == bal["nodes_per_rank"],
            f"{what}: rank_series nodes {sums} != nodes_per_rank {list(nodes_per_rank)}")
    for col, per, total in (("spill_events", "spill_events_per_rank", spill["events"]),
                            ("spill_to_host", "spill_bytes_to_host_per_rank", spill["to_host"]),
                            ("spill_to_device", "spill_bytes_to_device_per_rank", spill["to_device"])):
        j = cols.index(col)
        require(sum(bal[per]) == sum(sum(r[j]) for r in rows) == total,
                f"{what}: {per} {bal[per]} does not add up to {total}")


def phase_telemetry(smi):
    """Phase 18 (see the module docstring)."""
    import os

    import torch

    from tsp_mpi_reduction_tpu_torch import obs
    from tsp_mpi_reduction_tpu_torch.analysis import contracts
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
    from tsp_mpi_reduction_tpu_torch.obs import timeseries
    from tsp_mpi_reduction_tpu_torch.parallel import mesh
    from tsp_mpi_reduction_tpu_torch.utils import cli

    t_phase = time.perf_counter()
    name, k, cap = BNB_FULL
    base_argv = [name, "--backend=cuda", f"--k={k}", f"--capacity={cap}"]

    # --- (a) phase 7's main path: the series, the sentinels, device_costs
    main = _shared("eil51", lambda: run_bnb_cli(base_argv))
    series, rows = main["series"], main["series"]["rows"]
    cols = series["columns"]
    require(cols == list(timeseries.COLUMNS) and series["samples_dropped"] == 0, "eil51: series schema")
    nodes_i, inc_i = cols.index("nodes"), cols.index("incumbent")
    require(sum(r[nodes_i] for r in rows) == main["nodes_expanded"] == BNB_FULL_NODES,
            f"eil51: series nodes {sum(r[nodes_i] for r in rows)} != {main['nodes_expanded']}")
    require(rows[-1][cols.index("frontier")] + rows[-1][cols.index("reservoir")] == 0,
            "eil51: the proof's last series row still has open work")
    incs = [r[inc_i] for r in rows if r[inc_i] is not None]
    require(all(b <= a for a, b in zip(incs, incs[1:])), f"eil51: the incumbent rose: {incs}")
    require(isinstance(main["anomalies"], dict) and main["anomalies"]["fired"] == len(main["anomalies"]["events"]),
            f"eil51: anomalies {main['anomalies']!r}")
    # the process-global records of the first launch at each shape; the
    # ones at eil51's shapes (k = 1024, n = 51) may come from an earlier
    # phase's launch at the same shape
    entries = main["obs"]["device_costs"]["entries"]
    recs = {}
    for entry, rec in entries.items():
        if rec["shape"].get("k") == k and rec["shape"].get("n") == 51:
            recs.setdefault(rec["kernel"], []).append((entry, rec))
    require({"prim_chain", "push_rows"} <= set(recs), f"eil51: device_costs has {sorted(entries)}")
    print(f"phase 18 eil51 (phase 7's main path, device loop): series {len(rows)} row(s) (one a host-loop "
          f"dispatch), nodes {sum(r[nodes_i] for r in rows)} == nodes_expanded, last row frontier + reservoir 0, "
          f"incumbent never rises {incs[:1]} -> {incs[-1:]}; anomalies fired {main['anomalies']['fired']}")
    for kernel in ("prim_chain", "push_rows"):
        for entry, rec in recs[kernel]:
            print(f"phase 18 device_costs {entry} ({len(entries)} entries in all): {rec['flops']:.0f} operations, "
                  f"{rec['bytes_accessed']:.0f} bytes, "
                  f"intensity {rec['arithmetic_intensity']}, roofline est. {rec['roofline_utilization_est']} "
                  f"({rec['bound']}-bound against the data-sheet row), bound {rec['bound_ms']:.6f} ms "
                  f"({rec['bound_by']}); card {rec['card']}")

    # --- (b) the telemetry's cost: eil51 to proof with TSP_OBS off and on,
    # ABBA twice (host-bound runs spread by tens of percent between calls)
    obs_runs = []
    timeseries.StepSampler.METER_NS = [0]
    try:
        for on in (False, True, True, False) * 2:
            obs.set_enabled(on)
            try:
                out = run_bnb_cli(base_argv)
            finally:
                obs.set_enabled(None)
            require(out["nodes_expanded"] == BNB_FULL_NODES and out["cost"] == BNB_FULL_COST,
                    f"eil51 TSP_OBS={'on' if on else 'off'}: {out['nodes_expanded']} nodes")
            require((out["series"] is not None) == on and (out["anomalies"] is not None) == on,
                    f"eil51 TSP_OBS={'on' if on else 'off'}: telemetry blocks {out['series'] is not None}")
            obs_runs.append((on, out["time_to_proof_s"], out["wall_s"]))
        sampler_ns = timeseries.StepSampler.METER_NS[0]
    finally:
        timeseries.StepSampler.METER_NS = None
    for col, what in ((1, "time to proof"), (2, "search")):
        off = sorted(r[col] for r in obs_runs if not r[0])
        on_ = sorted(r[col] for r in obs_runs if r[0])
        print(f"phase 18 TSP_OBS cost, eil51 {what} (s), ABBA x2 off/on/on/off: {[r[col] for r in obs_runs]}; "
              f"off median {_median(off):.3f} (spread {off[0]}-{off[-1]}), on median {_median(on_):.3f} (spread "
              f"{on_[0]}-{on_[-1]}), on - off {(_median(on_) - _median(off)) / _median(off) * 100:+.1f}%; card {smi}")
    print(f"phase 18 TSP_OBS: the sampler's own meter (StepSampler.METER_NS) {sampler_ns / 1e3:.1f} us over the "
          f"four on runs ({sampler_ns / 4 / 1e9 / _median([r[2] for r in obs_runs if r[0]]) * 100:.5f}% of a search)")

    # --- (c) TSP_CONTRACTS strict against off on the same eil51 solve
    ct = {}
    for lv in ("strict", "off"):
        os.environ["TSP_CONTRACTS"] = lv
        try:
            ct[lv] = run_bnb_cli(base_argv)
        finally:
            os.environ.pop("TSP_CONTRACTS", None)
    require(all(ct["strict"][f] == ct["off"][f] for f in ("nodes_expanded", "cost", "lower_bound", "steps_run")),
            "eil51: TSP_CONTRACTS=strict and off give different searches")
    print(f"phase 18 TSP_CONTRACTS eil51: strict == off ({ct['off']['nodes_expanded']} nodes, cost "
          f"{ct['off']['cost']}, LB {ct['off']['lower_bound']}); time to proof strict {ct['strict']['time_to_proof_s']} "
          f"s, off {ct['off']['time_to_proof_s']} s; card {smi}")

    # --- (d) the full-size pipeline with contracts on and off (ABBA), and
    # the float64 parity config with contracts on
    pipe = []
    for lv in ("on", "off", "off", "on") * 2:
        os.environ["TSP_CONTRACTS"] = lv
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_pipeline(N_FULL, B_FULL, GRID_FULL, GRID_FULL, dtype=torch.float32, device="cuda")
            pipe.append((lv, (time.perf_counter() - t0) * 1e3, res.phase_seconds["merge_fold"], res.cost))
        finally:
            os.environ.pop("TSP_CONTRACTS", None)
    require(len({c for *_, c in pipe}) == 1, "pipeline: contracts on and off give different costs")
    folds = {lv: sorted(mf for x, _, mf, _ in pipe if x == lv) for lv in ("on", "off")}
    print("phase 18 TSP_CONTRACTS pipeline at full size (wall ms / merge fold s), ABBA x2 on/off/off/on: "
          + ", ".join(f"{lv} {ms:.1f} / {mf:.4f}" for lv, ms, mf, _ in pipe)
          + f"; merge fold median on {_median(folds['on']):.4f} s, off {_median(folds['off']):.4f} s; card {smi}")
    # the checks' own host time: an eager fold's (TSP_COMPILE_CACHE=off)
    # 2 x 1023 checks on the fold's operand types (a 16,385-slot tour on
    # the card); the replayed fold runs the step's 2 at capture and 2 at
    # its boundary
    from tsp_mpi_reduction_tpu_torch.ops.merge import PaddedTour

    tour = PaddedTour(torch.zeros(N_FULL * B_FULL + 1, dtype=torch.int32, device="cuda"),
                      torch.tensor(N_FULL + 1, dtype=torch.int32, device="cuda"),
                      torch.tensor(1.0, device="cuda"))
    os.environ["TSP_CONTRACTS"] = "on"
    try:
        t0 = time.perf_counter()
        for _ in range(2 * (B_FULL - 1)):
            contracts.check_padded_tour(tour, where="merge_tours.t1")
        checks_ms = (time.perf_counter() - t0) * 1e3
    finally:
        os.environ.pop("TSP_CONTRACTS", None)
    print(f"phase 18 TSP_CONTRACTS=on: an eager fold's (TSP_COMPILE_CACHE=off) {2 * (B_FULL - 1)} metadata checks "
          f"take {checks_ms:.2f} ms of host time ({checks_ms / 2 / (B_FULL - 1) * 1e3:.2f} us a check), "
          f"{checks_ms / 1e3 / _median(folds['off']) * 100:.2f}% of the replayed fold's median with contracts off; "
          "the replayed fold runs 2 at its capture and 2 at its boundary")
    os.environ["TSP_CONTRACTS"] = "on"
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["10", "6", "500", "500", "--dtype=float64"])
        line = buf.getvalue().strip().splitlines()[-1]
        require(rc == 0 and line.endswith(" and the trip cost 3720.557435"), f"contracts on: {line!r}")
        g = json.loads((GOLDENS / "full_10x6_500x500.json").read_text())
        res = run_pipeline(10, 6, 500, 500, dtype=torch.float64, device="cuda")
        require(res.cost == g["final"]["cost"] and list(res.tour_ids) == g["final"]["ids"]
                and res.block_costs.tolist() == [b["cost"] for b in g["block_solutions"]],
                "contracts on: the float64 pipeline differs from goldens/full_10x6_500x500.json")
        require(contracts.level() == "on", "TSP_CONTRACTS=on not in force")
    finally:
        os.environ.pop("TSP_CONTRACTS", None)
    print(f"phase 18 contracts on, float64: {line.split(' ms ')[-1]}; goldens/full_10x6_500x500.json "
          "block costs, final tour and cost bit for bit")

    # --- (e) eil51 R = 8 pair, batched and over processes: one rank view
    pair_argv = SHARD_CLI["pair"][0] + ["--backend=cuda"]

    def pair_batched():
        from tsp_mpi_reduction_tpu_torch.obs import rankview

        rankview.RankSampler.METER_NS = [0]
        try:
            out = run_bnb_cli(pair_argv)
        finally:
            hook, rankview.RankSampler.METER_NS = rankview.RankSampler.METER_NS[0], None
        out["_rank_hook_ns"] = hook
        return out

    def pair_procs():
        (out, _), rec = mesh.spawn_ranks(procs_bnb_rank, 8, args=(pair_argv + ["--transport=procs"],),
                                         timeout_s=PROCS_DEADLINE_S)
        out["_rank_hook_ns"] = rec["rank_hook_ns"]
        return out

    views = {"batched": _shared("pair_batched", pair_batched), "procs": _shared("pair_procs", pair_procs)}
    for tr, out in views.items():
        _check_rank_view(f"eil51 R=8 {tr}", out["rank_series"], out["obs"]["rank_balance"], out["nodes_per_rank"],
                         {"events": out["spill_events"], "to_host": out["spill_bytes_to_host"],
                          "to_device": out["spill_bytes_to_device"]})
    require(views["batched"]["rank_series"] == views["procs"]["rank_series"],
            "eil51 R=8: rank_series differs between the transports")
    require(views["batched"]["obs"]["rank_balance"] == views["procs"]["obs"]["rank_balance"],
            "eil51 R=8: obs.rank_balance differs between the transports")
    bal = views["batched"]["obs"]["rank_balance"]
    hooks = {tr: (out["_rank_hook_ns"], out["wall_s"]) for tr, out in views.items()}
    print(f"phase 18 eil51 --ranks=8 --k=128 pair: rank_series ({len(views['batched']['rank_series']['rows'])} "
          f"windows of {views['batched']['rank_series']['window']} dispatches) and obs.rank_balance equal batched "
          f"and over 8 processes; per-rank series nodes == nodes_per_rank {bal['nodes_per_rank']}; straggler rank "
          f"{bal['straggler_rank']} score {bal['straggler_score']}, occupancy CV {bal['occupancy_cv']}, starved "
          f"{bal['starved_ranks']}; rank hook (RankSampler.METER_NS, rank 0) "
          + ", ".join(f"{tr} {ns / 1e6:.2f} ms of a {w} s search ({ns / 1e9 / w * 100:.3f}%)"
                      for tr, (ns, w) in hooks.items()) + f"; card {smi}")

    # --- (f) the 4-rank spill-forcing 12-city solve on both transports
    (n_s, seed_s), kw_s, pinned_s = SHARD_SMALL["spill"]
    d_s = small_instance(n_s, seed_s)

    def spill_procs():
        small, _ = mesh.spawn_ranks(procs_small_rank, 4, args=([("spill", d_s, kw_s)],),
                                    timeout_s=PROCS_DEADLINE_S)
        return small["spill"][0]

    spills = {"batched": _shared("spill_batched", lambda: bb.solve_sharded(d_s, 4, device="cuda", **kw_s)),
              "procs": _shared("spill_procs", spill_procs)}
    for tr, res in spills.items():
        require(res.spill_events == pinned_s["spill_events"] and res.nodes_expanded == pinned_s["nodes_expanded"],
                f"spill {tr}: not phase 16's pins")
        _check_rank_view(f"spill {tr}", res.rank_series, res.rank_balance, res.nodes_per_rank,
                         {"events": res.spill_events, "to_host": res.spill_bytes_to_host,
                          "to_device": res.spill_bytes_to_device})
        require(all(sum(res.rank_balance[key]) > 0 for key in ("spill_events_per_rank",
                                                               "spill_bytes_to_host_per_rank",
                                                               "spill_bytes_to_device_per_rank")),
                f"spill {tr}: the per-rank spill attribution is zero")
    require(spills["batched"].rank_series == spills["procs"].rank_series
            and spills["batched"].rank_balance == spills["procs"].rank_balance,
            "spill: the rank view differs between the transports")
    b = spills["batched"].rank_balance
    print(f"phase 18 spill-forcing 12-city (4 ranks): per-rank spill events {b['spill_events_per_rank']}, bytes to "
          f"host {b['spill_bytes_to_host_per_rank']}, to device {b['spill_bytes_to_device_per_rank']} add up to "
          f"{spills['batched'].spill_events} / {spills['batched'].spill_bytes_to_host} / "
          f"{spills['batched'].spill_bytes_to_device} on both transports, rank views equal")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s; card: {smi}")
    torch.cuda.synchronize()


LINT_SARIF = ROOT / "build" / "lint.sarif"
#: the merge fold's host syncs a phase 19 pipeline may show: a small
#: constant (a capture's own), where the eager fold synced once a merge
FOLD_SYNC_LIMIT = 16
SYNC_TEXT = "synchronizing CUDA operation"
PORT_DIR = ROOT / "tsp_mpi_reduction_tpu_torch"


def host_cpu() -> str:
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``), its
    architecture and this process's core count."""
    import os
    import platform

    name = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.strip().lower().startswith("model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if name is None:
        try:
            name = next((ln.split(":", 1)[1].strip() for ln in
                         pathlib.Path("/proc/cpuinfo").read_text().splitlines()
                         if ln.lower().startswith("model name")), None)
        except OSError:
            pass
    return f"{name or 'CPU model not reported'} ({platform.machine()}, {os.cpu_count()} cores)"


def statement_span(source: str, line: int):
    """The lines of the innermost statement holding ``line``: a simple
    statement whole, a compound one its header only (``if``/``while``
    test lines, not the body)."""
    import ast

    best = None
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.stmt) and node.lineno <= line <= node.end_lineno:
            if best is None or node.lineno >= best.lineno and node.end_lineno <= best.end_lineno:
                best = node
    if best is None:
        return range(line, line + 1)
    body = getattr(best, "body", None)
    end = best.end_lineno
    if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
        end = body[0].lineno - 1
        if isinstance(best, ast.If) and best.orelse and line >= best.orelse[0].lineno:
            return range(line, line + 1)
    return range(best.lineno, max(end, best.lineno) + 1)


def capture_syncs(fn, marks=()):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` with
    every warning recorded. Returns ``(fn's result, sites, marked,
    at_warning)``: ``sites`` counts each sync by its innermost frame under
    the port package (``path:line``), ``marked[name]`` the syncs whose
    stack passes through a port function of that name, ``at_warning`` how
    many warnings' own filename/lineno named the same port line."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    marked = collections.Counter()
    at_warning = [0, 0]
    prefix = str(PORT_DIR) + "/"

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_TEXT not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(prefix)]
        if port:
            inner = port[-1]
            key = f"{pathlib.Path(inner.filename).relative_to(ROOT).as_posix()}:{inner.lineno}"
            at_warning[0] += 1
            at_warning[1] += int(filename == inner.filename and lineno == inner.lineno)
        else:
            key = f"<outside the port> {filename}:{lineno}"
        sites[key] += 1
        names = {f.name for f in port}
        for m in marks:
            if m in names:
                marked[m] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sites, marked, at_warning


def phase_lint(smi):
    """Phase 19: the lint CLI on this tree, then the card's sync reports
    held against the lint's findings."""
    import torch

    from tsp_mpi_reduction_tpu_torch.analysis import graftlint
    from tsp_mpi_reduction_tpu_torch.analysis.__main__ import _DEFAULT_TARGETS, run_analyses
    from tsp_mpi_reduction_tpu_torch.models.pipeline import run_pipeline
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
    from tsp_mpi_reduction_tpu_torch.perf import compile_cache

    # --- the CLI in a fresh process, and what importing it loads
    LINT_SARIF.parent.mkdir(parents=True, exist_ok=True)
    LINT_SARIF.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.analysis", "--json",
                           "--sarif", str(LINT_SARIF)], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"lint CLI exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    sarif = json.loads(LINT_SARIF.read_text())
    require(sarif.get("version") == "2.1.0" and len(sarif.get("runs", [])) == 1,
            f"SARIF: version {sarif.get('version')!r}, {len(sarif.get('runs', []))} runs")
    probe = subprocess.run([sys.executable, "-c", "import sys, json; "
                            "import tsp_mpi_reduction_tpu_torch.analysis.__main__; "
                            "print(json.dumps(sorted(m for m in ('torch', 'jax', 'tsp_mpi_reduction_tpu') "
                            "if m in sys.modules)))"], cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
    loaded = json.loads(probe.stdout.strip().splitlines()[-1]) if probe.returncode == 0 else None
    require(loaded == [], f"importing the lint CLI loaded {loaded} (exit {probe.returncode}: {probe.stderr[-500:]})")
    per_rule = " ".join(f"{r} {c['new']}/{c['baselined']}/{c['waived']}"
                        for r, c in sorted(rep["per_rule"].items(), key=lambda kv: int(kv[0][1:])))
    print(f"phase 19 lint CLI: exit 0, {rep['new']} new, {rep['baselined']} baselined, stale "
          f"{len(rep['stale'])}, dead {len(rep['dead'])}; per rule new/baselined/waived: {per_rule}")
    print(f"phase 19 lint CLI wall {wall:.3f} s (both passes, the process's start included) on "
          f"{host_cpu()}; SARIF {sarif['version']} with {len(sarif['runs'][0]['results'])} results; "
          "the CLI's import loads no torch, jax or tsp_mpi_reduction_tpu")

    # --- the lint's findings (new, baselined and waived) and its hot lines
    waived = []
    findings = run_analyses([p for p in _DEFAULT_TARGETS if p.exists()], set(graftlint.RULES) | {
        "R9", "R10", "R11", "R12"}, waived)
    found = {}
    for v in findings + waived:
        found.setdefault(v.path, []).append(v)
    sources, hot = {}, {}

    def judge(site):
        path, _, line = site.rpartition(":")
        line = int(line)
        if path not in sources:
            sources[path] = (ROOT / path).read_text()
            hot[path] = graftlint.hot_lines(sources[path])
        span = statement_span(sources[path], line)
        hits = [f"{v.rule}{' (waived)' if v in waived else ''}" for v in found.get(path, ())
                if v.line in span]
        return line in hot[path], hits

    # --- the three runs under the card's sync reports
    n, nb = N_FULL, B_FULL
    hkk.reset_launches()
    misses = compile_cache.stats_dict()["aot_misses"]
    res, fold_sites, fold_marked, fold_attr = capture_syncs(
        lambda: run_pipeline(n, nb, GRID_FULL, GRID_FULL, dtype=torch.float32, device=torch.device("cuda")),
        marks=("fold_tours",))
    launches = dict(hkk.LAUNCHES)
    fold_captures = compile_cache.stats_dict()["aot_misses"] - misses
    require(launches["relax_dense"] == hkk.sweep_launches(n - 1),
            f"phase 19 pipeline launched relax_dense {launches['relax_dense']} times")
    require(math.isfinite(res.cost) and res.num_cities == n * nb, f"phase 19 pipeline: {res.cost}, {res.num_cities}")
    argv = ["eil51", "--backend=cuda", "--k=1024", "--capacity=262144"]
    # every B&B configuration below once before it is watched: its graphs
    # captured and its kernels' first-launch cost records taken (a record
    # reads the device once a shape), as the earlier phases do in a full run
    for warm in (argv, argv + ["--device-loop=off"], SHARD_CLI["pair"][0] + ["--backend=cuda"],
                 SHARD_CLI["device"][0] + ["--backend=cuda"]):
        run_bnb_cli(warm)
    marks = ("dispatch", "_pop_stage", "_search_step", "solve")
    dev_out, dev_sites, dev_marked, dev_attr = capture_syncs(lambda: run_bnb_cli(argv), marks=marks)
    host_out, host_sites, host_marked, host_attr = capture_syncs(
        lambda: run_bnb_cli(argv + ["--device-loop=off"]), marks=marks)
    with compile_cache_setting("off"):
        eager_out, eager_sites, eager_marked, eager_attr = capture_syncs(lambda: run_bnb_cli(argv), marks=marks)
    for what, out in (("device loop", dev_out), ("host loop", host_out)):
        require(out["proven_optimal"] and out["cost"] == BNB_FULL_COST,
                f"phase 19 eil51 ({what}): {out.get('cost')} proven {out.get('proven_optimal')}")
    require(dev_out["device_loop"] and not host_out["device_loop"],
            f"phase 19: device_loop {dev_out['device_loop']} / {host_out['device_loop']}")
    fold_syncs = fold_marked["fold_tours"]
    print(f"phase 19 pipeline ({n} {nb} {GRID_FULL} {GRID_FULL}, float32): {sum(fold_sites.values())} syncs, "
          f"{fold_syncs} of them in the merge fold ({nb - 1} merges: {fold_syncs / (nb - 1):.4f} a merge; "
          f"{fold_captures} graph capture(s) in the fold); launches {launches}; cost {res.cost:f}")
    # the fold replays one captured step: its syncs are a constant, not one a merge
    require(fold_syncs <= FOLD_SYNC_LIMIT,
            f"phase 19: {fold_syncs} syncs in the merge fold (limit {FOLD_SYNC_LIMIT}, {nb - 1} merges)")
    for what, out, sites, marked in (("device loop, replayed", dev_out, dev_sites, dev_marked),
                                     ("host loop, replayed", host_out, host_sites, host_marked),
                                     ("device loop, eager (TSP_COMPILE_CACHE=off)", eager_out, eager_sites,
                                      eager_marked)):
        steps = out["iterations"]
        search = marked["dispatch"]
        # one read a run of 32 steps: at most replays / 32 + one a dispatch
        reads = out["replays"] / 32 + out["dispatches"]
        print(f"phase 19 eil51 {what}: {out['nodes_expanded']} nodes in {steps} steps, {out['replays']} "
              f"steps issued in {out['dispatches']} dispatch(es); {sum(sites.values())} syncs, "
              f"{marked['solve']} in solve(), {search} in its step loop ({search / max(steps, 1):.3f} a "
              f"step, the bound {reads:.2f}), {marked['_pop_stage']} in _pop_stage, "
              f"{marked['_search_step']} in the step; search {out['wall_s']} s")
        require(marked["_pop_stage"] == 0 and marked["_search_step"] == 0 and search <= reads
                and out["proven_optimal"] and out["nodes_expanded"] == BNB_FULL_NODES,
                f"phase 19 eil51 {what}: {marked['_pop_stage']} syncs in _pop_stage, {marked['_search_step']} "
                f"in the step, {search} in the step loop for {out['replays']} steps issued in "
                f"{out['dispatches']} dispatches")
    # --- the sharded loop's host reads: eil51 R = 8 pair (the host loop: one
    # read a round) replayed and eager, and the R = 4 device loop replayed
    # (one read a run of rounds); no sync inside a round
    shard_marks = ("dispatch", "_round", "_rank_tail", "_receive", "_search_step", "_pop_stage", "solve_sharded")
    shard_sites, shard_attr = {}, [0, 0]
    for tag, what, argv_s, cache in (("R8-host", "R = 8 pair, host loop, replayed", SHARD_CLI["pair"][0], None),
                                     ("R8-eager", "R = 8 pair, host loop, eager (TSP_COMPILE_CACHE=off)",
                                      SHARD_CLI["pair"][0], "off"),
                                     ("R4-device", "R = 4 pair, device loop, replayed", SHARD_CLI["device"][0],
                                      None)):
        with compile_cache_setting(cache):
            out, sites, marked, attr = capture_syncs(lambda: run_bnb_cli(argv_s + ["--backend=cuda"]),
                                                     marks=shard_marks)
        shard_sites[tag] = sites
        shard_attr = [shard_attr[0] + attr[0], shard_attr[1] + attr[1]]
        rounds = out["iterations"] // 32
        reads = marked["dispatch"]
        inside = {m: marked[m] for m in ("_round", "_rank_tail", "_receive", "_search_step", "_pop_stage")}
        print(f"phase 19 eil51 {what}: {out['nodes_expanded']} nodes, {rounds} rounds in {out['dispatches']} "
              f"dispatch(es), {out['replays']} batched steps issued; {sum(sites.values())} syncs, "
              f"{marked['solve_sharded']} in solve_sharded, {reads} in the round program's dispatches "
              f"({reads / max(rounds, 1):.3f} a round), inside a round {inside}; search {out['wall_s']} s")
        loop = out["device_loop"]
        require(out["proven_optimal"] and out["nodes_expanded"] == SHARD_CLI["pair" if not loop else "device"][2][
                    "nodes_expanded"] and not any(inside.values())
                and (out["dispatches"] <= reads <= out["replays"] // 32 if loop else reads == out["dispatches"]),
                f"phase 19 eil51 {what}: {reads} reads for {out['dispatches']} dispatches of {out['replays']} "
                f"steps, syncs inside a round {inside}")
    attributed = fold_attr[0] + dev_attr[0] + host_attr[0] + eager_attr[0] + shard_attr[0]
    same = fold_attr[1] + dev_attr[1] + host_attr[1] + eager_attr[1] + shard_attr[1]
    print(f"phase 19 attribution: {same} of {attributed} port-attributed warnings carried the port line "
          "itself as their filename/lineno (the rest: a torch frame above it)")

    all_sites = {}
    for tag, sites in (("fold", fold_sites), ("eil51-device", dev_sites), ("eil51-host", host_sites),
                       ("eil51-eager", eager_sites), *shard_sites.items()):
        for site, c in sites.items():
            all_sites.setdefault(site, {})[tag] = c
    misses, cold = [], []
    for site in sorted(all_sites):
        counts = ", ".join(f"{k} {v}" for k, v in sorted(all_sites[site].items()))
        if site.startswith("<outside"):
            cold.append(site)
            print(f"phase 19 sync site {site} [{counts}]: outside the port")
            continue
        is_hot, hits = judge(site)
        tag = "hot" if is_hot else "cold"
        code = (ROOT / site.rpartition(":")[0]).read_text().splitlines()[int(site.rpartition(":")[2]) - 1].strip()
        print(f"phase 19 sync site {site} [{counts}] {tag}, lint: {', '.join(hits) or 'none'}: {code[:100]}")
        if is_hot and not hits:
            misses.append(site)
        elif not is_hot:
            cold.append(site)
    print(f"phase 19 {len(all_sites)} distinct sync sites: {len(all_sites) - len(cold)} in hot contexts, all "
          f"lint findings: {not misses}; {len(cold)} outside hot contexts")
    merge_sites = {site: c for site, c in all_sites.items() if "/ops/merge.py:" in site}
    print(f"phase 19 sync sites in ops/merge.py: {merge_sites or 'none'}; the merge fold's syncs a merge "
          f"{fold_syncs / (nb - 1):.4f}")
    print(f"phase 19 card: {smi}")
    require(not misses, f"sync sites in hot contexts that the lint does not name: {misses}")


# -- phase 20: the bench harness ----------------------------------------------

BENCH_DIR = ROOT / "build" / "chip_smoke_bench"
BENCH_HISTORY = ROOT / "build" / "bench_torch" / "history.jsonl"
BENCH_MODES = ("pipeline", "bnb", "faults", "obs", "serve", "spill", "shard", "balance", "step", "fleet",
               "compile")
#: modes phase 20 runs at once, after the others, for the time budget:
#: none gates on a time (their pins are counts and equalities: costs,
#: nodes, incumbents, payloads), and each keeps about one core of the
#: card's host busy. Their seconds in the log are not measurements; the
#: modes whose gates read a time (obs, serve, shard, balance, fleet) run
#: alone
BENCH_OVERLAP = ("spill", "compile", "pipeline", "bnb", "faults", "step")
#: the JAX package's ``bench.py`` spill call (8 ranks, 14 cities, 96 rows a
#: rank) on the CPU: its reservoir counters
BENCH_SPILL_PINS = {"spill_rounds": 609, "spill_events": 4206, "spill_full_merges": 153,
                    "spill_bytes_to_host": 7260264, "spill_bytes_to_device": 7265412}
#: the JAX shard configuration (4 ranks, 12 cities, ring, 4-row slab)
BENCH_SHARD_PINS = {"cost": 2913.0, "nodes_expanded": 22852, "nodes_per_rank": [8740, 7914, 4753, 1445],
                    "spill_bytes_to_host": 939232, "spill_bytes_to_device": 939232, "starved_ranks": [2, 3],
                    "starvation_events": 12}
#: the JAX balance legs: cost, nodes per rank, moved rows, collective
#: dispatches, actions, switches
#: the JAX step chain (eil51, k 1024, 6 dispatches of 8 steps from 10 warm
#: steps, capacity 409,600): its final incumbent and nodes a step
BENCH_STEP_PINS = (511.0, 1024)
BENCH_BALANCE_PINS = {
    "ring": (2913.0, [8740, 7914, 4753, 1445], 7377, 1119, {"ring": 1119}, 1),
    "adaptive": (2913.0, [6011, 5776, 5676, 5389], 2800, 177, {"steal": 75, "pair": 102, "skip": 606}, 202),
    "balanced": (3077.0, [13, 3, 13, 3], 0, 0, {"skip": 6}, 0),
}


def start_bench_mode(mode: str):
    """Start ``tools/bench --mode=<mode> --quick`` in a fresh process on the
    card, its output in unnamed temporary files (no pipe to fill while
    another mode is waited for) -> (process, start time, the two files)."""
    import tempfile

    env = dict(os.environ, TSP_BENCH_HISTORY=str(BENCH_HISTORY))
    files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.tools.bench",
                             f"--mode={mode}", "--quick", f"--out-dir={BENCH_DIR}"],
                            cwd=ROOT, stdout=files[0], stderr=files[1], text=True, env=env)
    return proc, time.perf_counter(), files


def finish_bench_mode(mode: str, started):
    """Wait for a mode started by :func:`start_bench_mode` -> (its last line,
    its seconds); a failed, hung or unparseable run fails the phase."""
    proc, t0, files = started

    def text(f) -> str:
        f.seek(0)
        out = f.read()
        f.close()
        return out

    try:
        proc.wait(timeout=max(600 - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        text(files[0])
        raise SmokeFailure(f"bench --mode={mode} --quick: no end within 600 s, stderr {text(files[1])[-2000:]}")
    secs = time.perf_counter() - t0
    stdout, stderr = text(files[0]), text(files[1])
    try:
        last = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        last = None
    require(proc.returncode == 0 and last is not None and last.get("ok") is True,
            f"bench --mode={mode} --quick: exit {proc.returncode}, last line {stdout[-1500:]!r}, "
            f"stderr {stderr[-2000:]}")
    return last, secs


def run_bench_mode(mode: str):
    """``tools/bench --mode=<mode> --quick`` in a fresh process on the card
    -> (its last line, seconds)."""
    return finish_bench_mode(mode, start_bench_mode(mode))


def bench_windows(mode: str, art) -> dict:
    """A bench artifact's launch-count windows -> {window: {kernel: count}};
    each window's counts were reset just before it and read just after."""
    if mode == "pipeline":
        return {"timed runs": art["launches"]}
    if mode == "bnb":
        return {f"proof {i}": r["launches"] for i, r in enumerate(art["runs"])}
    if mode == "obs":
        return {**{f"telemetry {arm}": c for arm, c in art["bnb"]["launches"].items()},
                "serve session": art["serve"]["launches"]}
    if mode == "spill":
        return {"solve": art["launches"]}
    if mode in ("fleet", "compile"):
        # fleet: the replicas are serve CLI processes, which report no
        # counts; compile: its children neither, and its fold runs no hand kernel
        return {}
    # faults: seed solve and saves; serve: its five legs; shard: each run;
    # balance: each leg; step: each leg
    return dict(art["launches"])


#: the history records of one run of every mode: a governed series each
#: (pipeline, bnb, faults, spill, step, fleet, compile 1; obs, shard,
#: balance 2; serve 3)
BENCH_RECORDS = 16


def bench_pins_new_modes(out, windows):
    """Phase 20's pins of the spill, shard, balance, step and fleet modes:
    the JAX package's counters, every gate, and each window's kernels."""
    spill, shard, bal, step, fleet = (out[m] for m in ("spill", "shard", "balance", "step", "fleet"))
    require(all(spill[k] == v for k, v in BENCH_SPILL_PINS.items()) and spill["proven_optimal"],
            f"spill: {[(k, spill[k]) for k in BENCH_SPILL_PINS]}, want the JAX package's {BENCH_SPILL_PINS}")
    got = {k: shard[k] for k in BENCH_SHARD_PINS}
    require(got == BENCH_SHARD_PINS and shard["coherent"] and shard["bnb"]["ok"],
            f"shard: {got}, coherent {shard['coherent']}, hook gate {shard['bnb']}; want {BENCH_SHARD_PINS}")
    for leg, (cost, per_rank, moved, coll, actions, switches) in BENCH_BALANCE_PINS.items():
        g = bal["legs"][leg]
        require((g["cost"], g["nodes_per_rank"], g["moved_rows"], g["collective_dispatches"], g["actions"],
                 g["switches"], g["runs_agree"]) == (cost, per_rank, moved, coll, actions, switches, True),
                f"balance {leg}: {g}")
    require(all(bal["gates"][k] for k in ("imbalance_reduction_ok", "wall_ratio_ok", "exactness_ok",
                                           "balanced_zero_dispatches_ok")), f"balance gates: {bal['gates']}")
    ref, fus = step["reference"], step["fused"]
    require(step["incumbent_match"] and step["row_bytes_packed"] == 76 and step["fused_mode"] == "cuda"
            and all((leg["final_incumbent"], leg["nodes_per_step"]) == BENCH_STEP_PINS for leg in (ref, fus)),
            f"step: incumbents {ref['final_incumbent']} / {fus['final_incumbent']}, nodes a step "
            f"{ref['nodes_per_step']} / {fus['nodes_per_step']}, rows {step['row_bytes_packed']} B")
    demo = fleet["demo"]
    require(fleet["ok"] and demo["answered_exactly_once"] and demo["valid_tours"] == demo["requests"]
            and fleet["gpu_contexts"]["none_left"] and fleet["launches"] is None,
            f"fleet: demo {demo}, contexts {fleet['gpu_contexts']}")
    # the launch windows: the fused step pushes in every sharded solve; no
    # window of a min-out bound or an MST-free step runs prim_chain
    for name, c in windows.items():
        if name.startswith(("spill", "shard", "balance")):
            require(c["push_rows"] > 0 and c["prim_chain"] == 0, f"{name}: launches {c}")
    steps_timed = step["steps"] * step["dispatches"]
    require(step["launches"]["fused"]["push_rows"] == steps_timed and step["launches"]["fused"]["prim_chain"] == 0
            and step["launches"]["reference"]["push_rows"] == step["launches"]["reference"]["prim_chain"] == 0,
            f"step: launches {step['launches']}, want push_rows {steps_timed} in the fused leg only")
    print(f"phase 20 spill: {spill['value']:.1f} bytes a round over {spill['spill_rounds']} rounds (the JAX "
          f"package's counters), solve {spill['solve_s']:.3f} s; shard: metered {shard['value']:.4f}%, "
          f"{shard['bnb']['us_per_dispatch']:.3f} us a dispatch, starved {shard['starved_ranks']}; balance: "
          f"imbalance {bal['legs']['ring']['imbalance']:.3f} -> {bal['value']:.3f}, wall ratio "
          f"{bal['wall_ratio']:.3f}; step: reference {ref['ms_per_step']:.4f} / fused {fus['ms_per_step']:.4f} "
          f"ms a step ({step['value']:.3f}x), incumbent {fus['final_incumbent']}; fleet: demo "
          f"{demo['valid_tours']}/{demo['requests']} exactly once, restarts {demo['restarts']}, re-dispatches "
          f"{demo['redispatches']}, contexts {fleet['gpu_contexts']['before']} -> "
          f"{fleet['gpu_contexts']['after']}")


def run_bench_check(*argv):
    """The port's ``bench_check`` in a fresh process -> (exit code, stdout)."""
    proc = subprocess.run([sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.tools.bench_check", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


def phase_bench(smi):
    """Phase 20: every mode of the port's bench harness once with --quick,
    its pins, and the history's gate."""
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    BENCH_HISTORY.unlink(missing_ok=True)
    out, secs = {}, {}

    def report(mode):
        print(f"phase 20 bench {mode}: {out[mode]['metric']} = {out[mode]['value']} {out[mode]['unit']} "
              f"(vs_baseline {out[mode]['vs_baseline']}) in {secs[mode]:.1f} s on {smi}"
              + (" (beside the other overlapped modes)" if mode in BENCH_OVERLAP else ""))
        require(out[mode]["device"]["name"] and out[mode]["device"]["backend"] == "cuda",
                f"{mode}: the artifact names no card: {out[mode]['device']}")

    t_modes = time.perf_counter()
    for mode in BENCH_MODES:
        if mode not in BENCH_OVERLAP:
            out[mode], secs[mode] = run_bench_mode(mode)
            report(mode)
    started = {mode: start_bench_mode(mode) for mode in BENCH_OVERLAP}
    for mode in BENCH_OVERLAP:
        out[mode], secs[mode] = finish_bench_mode(mode, started[mode])
        report(mode)
    modes_s = time.perf_counter() - t_modes

    # --- pipeline: the scan fold is the CLI's instance and fold
    pipe = out["pipeline"]
    rc, line, _ = cli_line(["16", "100", "1000", "1000", "--dtype=float32"])
    require(rc == 0 and "trip cost" in line, f"pipeline CLI: exit {rc}, {line!r}")
    scan = pipe["folds"]["scan"]
    require(f"{scan['cost']:f}" == line.rpartition("trip cost ")[2],
            f"bench scan cost {scan['cost']:f} != the CLI's {line!r}")
    require(pipe["relax_dense_launches_per_run"] == 7 and pipe["launches"]["relax_dense"] == 7 * pipe["runs"],
            f"pipeline: {pipe['launches']} over {pipe['runs']} runs, not 7 relax_dense launches a run")
    print("phase 20 pipeline folds (quick, ms median [min, max] over reps): " + ", ".join(
        f"{k} {v['ms']:.3f} [{v['ms_min']:.3f}, {v['ms_max']:.3f}] x{v['reps']} cost {v['cost']:f}"
        for k, v in pipe["folds"].items()) + f"; scan == the CLI's {line.rpartition('trip cost ')[2]}")

    # --- bnb: eil51 proved at 426 in the CLI's nodes
    bnb = out["bnb"]
    cli = run_bnb_cli(["eil51", f"--k={bnb['k']}", f"--capacity={bnb['capacity']}",
                       f"--node-ascent={bnb['node_ascent']}"])
    require(bnb["cost"] == BNB_FULL_COST and bnb["proven_optimal"], f"bench bnb: cost {bnb['cost']}, "
            f"proven {bnb['proven_optimal']}")
    require(bnb["nodes_expanded"] == cli["nodes_expanded"] == BNB_FULL_NODES,
            f"bench bnb nodes {bnb['nodes_expanded']}, bnb_solve {cli['nodes_expanded']}, "
            f"pinned {BNB_FULL_NODES}")
    require(bnb["device_loop"] and all(r["launches"]["prim_chain"] > 0 and r["launches"]["push_rows"] > 0
                                       for r in bnb["runs"]),
            f"bench bnb: launches {[r['launches'] for r in bnb['runs']]}, device loop {bnb['device_loop']}")
    print(f"phase 20 bnb eil51 (k={bnb['k']}, capacity={bnb['capacity']}): {bnb['nodes_expanded']} nodes "
          f"== bnb_solve's {cli['nodes_expanded']}, time to proof {bnb['time_to_proof_s']:.3f} s (bnb_solve "
          f"{cli['time_to_proof_s']} s), launches prim_chain {bnb['prim_chain_launches']}, push_rows "
          f"{bnb['push_rows_launches']}")

    # --- faults, obs, serve: each B&B leg pushes through push_rows (the
    # fused step is the default on CUDA), serve's legs flush Held-Karp
    # batches through relax_dense and its 38-city proof runs both B&B kernels
    faults, obs, serve = out["faults"], out["obs"], out["serve"]
    require(faults["step_kernel"] == "fused" and faults["launches"]["seed_solve"]["push_rows"] > 0,
            f"faults: step kernel {faults['step_kernel']}, launches {faults['launches']}")
    require(obs["bnb"]["step_kernel"] == "fused"
            and all(obs["bnb"]["launches"][arm]["push_rows"] > 0 for arm in ("on", "off")),
            f"obs: step kernel {obs['bnb']['step_kernel']}, launches {obs['bnb']['launches']}")
    legs = serve["launches"]
    require(all(legs[leg]["relax_dense"] > 0 for leg in
                ("sequential", "microbatch", "request_level", "iteration_level")),
            f"serve: a leg flushed no relax_dense launch: {legs}")
    require(all(legs[leg][k] > 0 for leg in ("request_level", "iteration_level")
                for k in ("prim_chain", "push_rows")),
            f"serve: the proof did not run both B&B kernels in each leg: {legs}")
    windows = {f"{mode} {w}": c for mode in BENCH_MODES for w, c in bench_windows(mode, out[mode]).items()}
    totals = {k: sum(c[k] for c in windows.values()) for k in ("relax_dense", "relax_minplus", "prim_chain",
                                                               "push_rows")}
    require(totals["relax_minplus"] == 0, "impl auto launched relax_minplus in a bench window: " + ", ".join(
        f"{w} {c['relax_minplus']}" for w, c in windows.items() if c["relax_minplus"]))
    print("phase 20 launches by window: " + "; ".join(
        f"{w} " + " ".join(f"{k} {v}" for k, v in c.items()) for w, c in windows.items()))
    require(out["faults"]["payload_identical"] is True, "faults: payloads differ")
    require(out["obs"]["serve"]["orphan_spans"] == 0, f"obs: {out['obs']['serve']['orphan_spans']} orphan spans")
    require(out["serve"]["tours_match"] is True, "serve: batched tours != sequential tours")
    print(f"phase 20 faults: atomic {out['faults']['atomic_ms']:.3f} ms / direct {out['faults']['direct_ms']:.3f} "
          f"ms a save over {out['faults']['reps']} pairs, payloads identical; obs: metered "
          f"{out['obs']['bnb']['overhead_pct']:.4f}%, {out['obs']['bnb']['us_per_dispatch']:.3f} us a dispatch, "
          f"0 orphan spans; serve: microbatch {out['serve']['value']:.3f}x, service "
          f"{out['serve']['service_ratio']:.3f}x, tours equal, iteration-level latency p50 / max "
          f"{out['serve']['iteration_level']['latency_ms']['p50']:.1f} / "
          f"{out['serve']['iteration_level']['latency_ms']['max']:.1f} ms behind "
          f"{len(out['serve']['iteration_level']['bnb_slice_s'])} proof slices of at most "
          f"{max(out['serve']['iteration_level']['bnb_slice_s']):.3f} s")

    bench_pins_new_modes(out, windows)

    # --- compile: the chunk and serve legs agree, the warm chunk reads the
    # ascent memo, and the fold replays a graph captured before it
    comp = out["compile"]
    chunk, fold = comp["chunk"], comp["fold"]
    require(chunk["costs_equal"] and chunk["lb_equal"] and comp["serve"]["tours_match"]
            and chunk["warm_compile_cache"]["ascent_memo_hits"] >= 1
            and chunk["cold_compile_cache"]["ascent_memo_hits"] == 0,
            f"compile: chunk {chunk}, serve {comp['serve']}")
    require(fold["graph"] and fold["equal"] and fold["captures_in_fold"] == 0 and fold["capture_s"] > 0,
            f"compile: fold {fold}")
    # the B&B step's graph: one capture a chunk process with the store, none
    # off; in the mode's own process a capture, then a stored key
    step = comp["step"]
    require(chunk["cold_step_captures"] == [0] * len(chunk["cold_step_captures"])
            and chunk["warm_step_captures"] == [1] * len(chunk["warm_step_captures"])
            and step is not None and (step["first_captures"], step["again_captures"]) == (1, 0),
            f"compile: step captures cold {chunk['cold_step_captures']} warm {chunk['warm_step_captures']}, "
            f"leg {step}")
    print(f"phase 20 compile: chunk cold {chunk['cold_startup_s']:.3f} s / warm {chunk['warm_startup_s']:.3f} s "
          f"({comp['value']:.3f}x), setup {chunk['cold_setup_s']:.3f} / {chunk['warm_setup_s']:.3f} s; serve "
          f"first flush cold {comp['serve']['cold_first_flush_s']:.3f} / warm "
          f"{comp['serve']['warm_first_flush_s']:.3f} s; fold {fold['n']} x {fold['blocks']}: capture "
          f"{fold['capture_s']:.4f} s, replayed {fold['replayed_fold_s']:.4f} s, eager {fold['eager_fold_s']:.4f} s; "
          f"B&B step: {step['first_captures']} capture in {step['first_s']:.4f} s, then "
          f"{step['again_captures']} in {step['again_s']:.4f} s (eil51 k = {step['k']}); chunk processes "
          f"capture {chunk['warm_step_captures']} with the store, {chunk['cold_step_captures']} off")

    # --- the gate on this history, and an append of the pipeline artifact
    rc, text = run_bench_check("check", "--history", str(BENCH_HISTORY), "--json")
    doc = json.loads(text)
    statuses = sorted({v["status"] for v in doc["verdicts"]})
    require(rc == 0 and statuses == ["insufficient"] and doc["records"] == BENCH_RECORDS,
            f"bench_check check: exit {rc}, {doc['records']} records, statuses {statuses}")
    tmp_hist = BENCH_DIR / "append.jsonl"
    tmp_hist.unlink(missing_ok=True)
    rc, _ = run_bench_check("append", str(BENCH_DIR / "BENCH_PIPELINE.json"), "--mode", "pipeline",
                            "--backend", "cuda", "--history", str(tmp_hist))
    lines = tmp_hist.read_text().splitlines() if tmp_hist.exists() else []
    require(rc == 0 and len(lines) == 1 and json.loads(lines[0])["metric"] == pipe["metric"],
            f"bench_check append: exit {rc}, {len(lines)} records")
    print(f"phase 20 bench_check: exit 0 on {doc['records']} records, every verdict insufficient; append "
          f"of BENCH_PIPELINE.json gave 1 record; modes {modes_s:.1f} s wall ({sum(secs.values()):.1f} s "
          f"summed)")
    print(f"phase 20 card: {smi}")
    return totals


# -- phase 21: the graph store --------------------------------------------------

#: phase 21's fold sizes: the full size and the bench pipeline's 16 x 100
STORE_FOLDS = ((N_FULL, B_FULL), (16, 100))


def phase_store(smi):  # a check harness: it builds inputs and reads results once a case  # graftlint: disable=R2
    """Phase 21: the merge fold through the graph store against the eager
    fold, and the recompilation guard on a second fold."""
    import torch

    from tsp_mpi_reduction_tpu_torch.analysis.contracts import RecompilationGuard
    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices
    from tsp_mpi_reduction_tpu_torch.ops import merge as mg
    from tsp_mpi_reduction_tpu_torch.ops.distance import distance_matrix
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
    from tsp_mpi_reduction_tpu_torch.ops.held_karp import solve_blocks_from_dists
    from tsp_mpi_reduction_tpu_torch.perf import compile_cache

    dev = torch.device("cuda")
    for n, nb in STORE_FOLDS:
        _, xy = generate_instance(n, nb, GRID_FULL, GRID_FULL)
        dist = distance_matrix(torch.as_tensor(xy.reshape(-1, 2), device=dev).to(torch.float32))
        costs, local = solve_blocks_from_dists(block_distance_slices(dist, nb, n), torch.float32)
        tours = local + (torch.arange(nb, dtype=torch.int32, device=dev) * n)[:, None]
        compile_cache.clear()  # a cold key: the first fold captures
        before = compile_cache.stats_dict()
        first, first_s = wall_s(lambda: mg.fold_tours(tours, costs, dist))
        mid = compile_cache.stats_dict()
        capture_s = (mid["entries"]["fold_tours"]["seconds"]
                     - before["entries"].get("fold_tours", {}).get("seconds", 0.0))
        with RecompilationGuard({"fold_tours": mg.FOLD}, limit=0) as guard:
            second, replay_s = wall_s(lambda: mg.fold_tours(tours, costs, dist))
        with compile_cache_setting("off"):
            eager, eager_s = wall_s(lambda: mg.fold_tours(tours, costs, dist))
        after = compile_cache.stats_dict()
        require(mid["aot_misses"] == before["aot_misses"] + 1 and after["aot_hits"] == mid["aot_hits"] + 1
                and after["aot_misses"] == mid["aot_misses"] and guard.misses() == {"fold_tours": 0},
                f"phase 21 {n}x{nb}: store counters {before} -> {mid} -> {after}, guard {guard.misses()}")
        for what, got in (("first", first), ("second", second)):
            require(all(torch.equal(a, b) for a, b in zip(got, eager)),
                    f"phase 21 {n}x{nb}: the {what} fold through the store != the eager fold")
        t = first[0][: int(first[1])].cpu().numpy()
        require(int(first[1]) == n * nb + 1 and t[0] == t[-1] and len(set(t[:-1].tolist())) == n * nb,
                f"phase 21 {n}x{nb}: not a closed tour over every city")
        print(f"phase 21 fold {n} x {nb} (float32): first fold {first_s:.4f} s (capture {capture_s:.4f} s "
              f"of it), replayed fold {replay_s:.4f} s with 0 captures under RecompilationGuard(limit=0), "
              f"eager fold (TSP_COMPILE_CACHE=off) {eager_s:.4f} s; ids, length and cost equal "
              f"(torch.equal); cost {float(first[2]):f}")
        del dist, costs, local, tours, first, second, eager
        compile_cache.clear()
        torch.cuda.empty_cache()
    print(f"phase 21 store: {json.dumps(compile_cache.stats_dict())}")
    print(f"phase 21 card: {smi}")


# -- phase 22: the B&B step's graph ---------------------------------------------


def phase_step_graph(smi):
    """Phase 22: the B&B step's entry in the graph store at eil51's shapes:
    ``warm_compile_device_solver``'s capture (seconds; the graph's static
    and pool bytes), a proof that adopts the stored graph (0 captures under
    ``RecompilationGuard``), then two threads proving the same instance at
    once, one on a stream of its own: the second waits for the graph the
    first holds, and both proofs are the main path's."""
    import threading

    import torch

    from tsp_mpi_reduction_tpu_torch.analysis.contracts import RecompilationGuard
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.perf import compile_cache
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    name, k, cap = BNB_FULL
    d = tsplib.embedded(name).distance_matrix()
    n = d.shape[0]
    compile_cache.clear()  # a cold key: the warm-up captures
    before = bb.STEP._cache_size()
    _, warm_s = wall_s(lambda: bb.warm_compile_device_solver(n, cap, k, device="cuda"))
    graphs = [g for g in compile_cache._STORE._graphs.values() if g.name == "bnb_step"]
    require(bb.STEP._cache_size() == before + 1 and len(graphs) == 1,
            f"phase 22: {bb.STEP._cache_size() - before} captures, {len(graphs)} stored step graphs")
    g = graphs[0]
    with RecompilationGuard({"bnb_step": bb.STEP}, limit=0) as guard:
        res = bb.solve(d, k=k, capacity=cap, device="cuda")
        out = [None, None]
        errors = []

        def prove(i):
            try:
                with torch.cuda.stream(torch.cuda.Stream()) if i else contextlib.nullcontext():
                    out[i] = bb.solve(d, k=k, capacity=cap, device="cuda")
            except Exception as e:  # noqa: BLE001 — reported by the check below
                errors.append(repr(e))

        threads = [threading.Thread(target=prove, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        both_s = time.perf_counter() - t0
    require(guard.misses() == {"bnb_step": 0} and not errors,
            f"phase 22: captures {guard.misses()}, errors {errors}")
    for r in (res, *out):
        require(r is not None and r.proven_optimal and r.cost == BNB_FULL_COST
                and r.nodes_expanded == BNB_FULL_NODES and r.step_graph and r.warm_steps == 0
                and (r.tour == res.tour).all() and r.replays == res.replays,
                f"phase 22: a proof through the stored graph: {r}")
    print(f"phase 22 step graph ({name}, k={k}, capacity={cap}): warm_compile_device_solver {warm_s:.4f} s "
          f"(capture {g.capture_s:.4f} s: the warm-up step from a root row and the capture), 1 graph of "
          f"{g.nbytes} bytes ({g.pool_bytes} of them its memory pool, the rest the adopted static state)")
    print(f"phase 22 a proof adopting the stored graph: {res.nodes_expanded} nodes, {res.replays} replays, "
          f"search {res.wall_seconds:.4f} s, setup {res.setup_seconds:.4f} s, 0 captures under "
          f"RecompilationGuard(limit=0); two threads at once (one on its own stream): both proofs equal, "
          f"{both_s:.3f} s for both, searches {out[0].wall_seconds:.4f} s / {out[1].wall_seconds:.4f} s "
          f"(the graph is held for a whole search, so the second waits)")
    print(f"phase 22 store: {json.dumps(compile_cache.stats_dict()['entries'].get('bnb_step'))}, "
          f"{json.dumps(compile_cache.store_info())}")
    print(f"phase 22 card: {smi}")


# -- phase 23: the sharded round's graphs ---------------------------------------


def phase_rank_graph(smi):
    """Phase 23: the sharded round program in the graph store. On a cold
    store, a short adaptive eil51 R = 8 solve captures the batched step
    and the round's tail with every action it can pick (skip, pair,
    steal) at setup: captures per action, their seconds, the graphs'
    bytes. Then phase 16's eil51 R = 8 pair proof through the CLI,
    replayed and under ``TSP_COMPILE_CACHE=off`` in ABBA order, with the
    kernels' counts reset just before each run and read just after: the
    same proof, its search seconds, and the replayed runs' launches (one
    ``prim_chain`` chain of 3 and one ``push_rows`` a batched step
    issued), the second with 0 captures under ``RecompilationGuard``."""
    from tsp_mpi_reduction_tpu_torch.analysis.contracts import RecompilationGuard
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels
    from tsp_mpi_reduction_tpu_torch.perf import compile_cache
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    argv, _, pinned = SHARD_CLI["pair"]
    d = tsplib.embedded(argv[0]).distance_matrix()
    compile_cache.clear()  # a cold store: every capture below is this phase's
    steps0, tails0 = bb.STEP._cache_size(), bb.RANK_TAIL._cache_size()
    res, setup_wall = wall_s(lambda: bb.solve_sharded(d, 8, capacity_per_rank=(1 << 17) // 8, k=128,
                                                      balance="adaptive", max_iters=64, device="cuda"))
    graphs = {g.name: g for g in compile_cache._STORE._graphs.values()}
    step, tail = graphs.get("bnb_step"), graphs.get("bnb_rank_tail")
    require(step is not None and tail is not None and bb.STEP._cache_size() == steps0 + 1
            and bb.RANK_TAIL._cache_size() == tails0 + 1 and len(tail.graphs) == 3 and res.warm_steps == 1,
            f"phase 23: captures step {bb.STEP._cache_size() - steps0} tail {bb.RANK_TAIL._cache_size() - tails0}, "
            f"stored {sorted(graphs)}")
    actions = ("skip", "pair", "steal")
    per_action = ", ".join(f"{a} {t:.4f} s" for a, t in zip(actions, tail.variant_s))
    print(f"phase 23 captures at setup (eil51, 8 ranks x k=128, 16,384 rows a rank, adaptive, a 64-step "
          f"solve in {setup_wall:.3f} s): the batched step 1 variant in {step.capture_s:.4f} s (warm-up step "
          f"and capture), {step.nbytes} bytes ({step.pool_bytes} of them its memory pool, the rest the adopted "
          f"state); the round tail, one variant an action: {per_action} ({tail.capture_s:.4f} s in all), "
          f"{tail.nbytes} bytes ({tail.pool_bytes} pool; it borrows the step's buffers); solve's "
          f"capture_seconds {res.capture_seconds:.4f}")

    # --- the pair proof, replayed and eager, ABBA
    cli = argv + ["--backend=cuda"]
    runs = []
    for i, cache in enumerate((None, "off", "off", None)):
        prim_kernels.reset_launches()
        ek.reset_launches()
        guard = RecompilationGuard({"bnb_step": bb.STEP, "bnb_rank_tail": bb.RANK_TAIL}, limit=0)
        with compile_cache_setting(cache), (guard if i == 3 else contextlib.nullcontext()):
            out = run_bnb_cli(cli)
        launches = {**prim_kernels.LAUNCHES, **ek.LAUNCHES}
        pinned_fields(shard_fields(out, out["obs"]["balance"]), {**SHARD_CLI_COMMON, **pinned},
                      f"phase 23 {'eager' if cache else 'replayed'}")
        issued = out["replays"] + out["warm_steps"]
        require(out["step_graph"] == (cache is None) and launches["prim_chain"] == 3 * issued > 0
                and launches["push_rows"] == issued,
                f"phase 23 run {i}: step_graph {out['step_graph']}, launches {launches} for {issued} steps")
        runs.append((cache, out))
    require(runs[3][1]["warm_steps"] == 0 and runs[3][1]["capture_s"] == 0.0,
            f"phase 23: the last replayed run captured ({runs[3][1]['warm_steps']} warm-up steps)")
    replayed = [o["wall_s"] for c, o in runs if c is None]
    eager = [o["wall_s"] for c, o in runs if c == "off"]
    print(f"phase 23 eil51 --ranks=8 --k=128 pair, ABBA (replayed, eager, eager, replayed): search "
          f"{replayed[0]} / {eager[0]} / {eager[1]} / {replayed[1]} s; {runs[0][1]['replays']} batched steps "
          f"issued in {runs[0][1]['dispatches']} dispatches, {runs[0][1]['nodes_expanded']} nodes (== phase 16, "
          f"the JAX package's) every run; setup {runs[0][1]['setup_s']} / {runs[1][1]['setup_s']} / "
          f"{runs[2][1]['setup_s']} / {runs[3][1]['setup_s']} s; the second replayed run 0 captures under "
          f"RecompilationGuard(limit=0)")
    print(f"phase 23 store: {json.dumps({k: v for k, v in compile_cache.stats_dict()['entries'].items() if k in ('bnb_step', 'bnb_rank_tail')})}, "
          f"{json.dumps(compile_cache.store_info())}")
    print(f"phase 23 card: {smi}")


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--fleet-replica"]:  # a phase 15 replica process
        return fleet_replica(argv[1:])
    import torch

    ap = argparse.ArgumentParser(description="smoke run of the PyTorch/CUDA port on one GPU")
    ap.add_argument("--phases", default=None, metavar="LIST",
                    help="comma-separated phases (2-23) to run after phase 1 (default: all); a "
                    "partial run prints no result line")
    args = ap.parse_args(argv)
    only = None if args.phases is None else {int(x) for x in args.phases.split(",") if x.strip()}
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

    def want(phase: int) -> bool:
        return only is None or phase in only

    kernels = []
    secs = {}  # seconds by phase, for the time budget

    def timed(phase: int, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            secs[phase] = round(time.perf_counter() - t, 1)

    try:
        smi = timed(1, phase_build)
        if want(2):
            timed(2, phase_kernel_parity, errs)
        if want(3):
            timed(3, phase_oracle)
        full_phases = None
        if want(4) or want(12):
            full_phases, kernels = timed(4, phase_full, smi, errs)
        if want(5):
            timed(5, phase_prim_parity, errs)
        if want(6):
            timed(6, phase_bnb_proofs)
        if want(7):
            kernels += timed(7, phase_bnb_full, smi, errs)
        if want(8):
            timed(8, phase_push_parity, errs)
        if want(9):
            timed(9, phase_kroa100, smi, errs)
        if want(10):
            timed(10, phase_spill, smi)
        if want(11):
            timed(11, phase_campaign, smi)
        if want(12):
            timed(12, phase_pipeline_options, smi, full_phases)
        if want(13):
            timed(13, phase_bnb_options, smi)
        serve_a = None
        if want(14):
            serve_launches, serve_a = timed(14, phase_serve, smi)
            for k in kernels:  # the serve traffic's own counts beside the main paths'
                k["launches_serve"] = serve_launches[k["name"]]
        if want(15):
            fleet_launches = timed(15, phase_fleet, smi, serve_a)
            for k in kernels:  # summed over the fleet's replica processes
                k["launches_fleet"] = fleet_launches[k["name"]]
        if want(16):
            sharded_launches = timed(16, phase_sharded, smi, errs)
            for k in kernels:  # run 1 of phase 16 (eil51, 8 ranks, pair)
                k["launches_sharded"] = sharded_launches.get(k["name"], 0)
        if want(17):
            procs_launches = timed(17, phase_procs, smi)
            for k in kernels:  # summed over the rank processes of phase 17's main paths
                k["launches_procs"] = procs_launches[k["name"]]
        if want(18):
            timed(18, phase_telemetry, smi)
        if want(19):
            timed(19, phase_lint, smi)
        if want(20):
            bench_launches = timed(20, phase_bench, smi)
            for k in kernels:  # summed over every counted window of the five modes
                k["launches_bench"] = bench_launches[k["name"]]
        if want(21):
            timed(21, phase_store, smi)
        if want(22):
            timed(22, phase_step_graph, smi)
        if want(23):
            timed(23, phase_rank_graph, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"chip_smoke: seconds by phase {secs}")
    for k in kernels:
        if k["max_abs_err"] != 0.0:
            print(f"chip_smoke: FAILED: {k['name']} max_abs_err {k['max_abs_err']}", file=sys.stderr)
            return 1
    if only is not None:
        print(f"chip_smoke: phases {sorted(only | {1})} passed in {time.perf_counter() - t0:.1f} s "
              "(a partial run: no result line)")
        return 0
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

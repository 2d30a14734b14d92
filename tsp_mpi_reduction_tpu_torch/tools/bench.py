"""The port's bench harness: one JSON line per run, the JAX bench's modes.

    python -m tsp_mpi_reduction_tpu_torch.tools.bench --mode=M [--backend=auto|cuda|cpu] \
        [--quick] [--out-dir=DIR] [--n=16 --blocks=100]

Counterpart of the root ``bench.py``. ``--mode`` (or ``TSP_BENCH=M``)
picks one of the five modes below; each measures on the card what the JAX
mode measures on its device (the same workload, headline metric name,
unit and ``vs_baseline``):

- ``pipeline`` (``bench.py:2099-2370``): the blocked pipeline at 16 cities
  x 100 blocks on 1000x1000 (``--n``, ``--blocks``; metric
  ``pipeline_{n}x{B}_wall_ms``), the instance of the reference's glibc
  ``rand()`` at seed 0. The timed span is the JAX ``make_step``: per-block
  distances, ``solve_blocks_from_dists`` (impl ``auto``: the
  ``relax_dense_sweep`` kernel on CUDA), the fold with its context (the
  full distance matrix, or the coordinates for the ``tree_xy`` folds),
  then ``tour_length`` (after ``polish(max_rounds=6)`` for
  ``tree_xy_polish``). Generation is excluded. The folds ``tree_xy``,
  ``tree``, ``scan`` and ``tree_xy_polish`` (``--quick``: ``tree`` and
  ``scan``; ``TSP_BENCH_FOLD``: one) run round-robin in ABBA order in one
  process; the headline is the fastest fold's median, disclosed in
  ``fold``; ``folds`` holds every fold's ``{ms, ms_min, ms_max, cost,
  measured, layers}``. ``vs_baseline`` = 69,997 ms / value at 16 x 100:
  the C++ reference, single rank on a CPU host (``BASELINE.md``). float32
  on CUDA, float64 on the CPU (the port's dtype policy).
- ``bnb`` (``bench.py:442-565``): ``TSP_BENCH_INSTANCE`` (eil51) to a
  proof at ``TSP_BENCH_K`` (1024), capacity ``max(2^17, 8k(n-1))``,
  ``TSP_BENCH_NODE_ASCENT`` (2), the default MST kernel and loop
  (``prim_chain`` and the device loop on CUDA, the plain chain and the
  host loop on the CPU). A warm-up solve first (excluded), then
  ``TSP_BENCH_BNB_REPS`` (3; ``--quick`` 1) timed proofs: median, min and
  max. ``vs_baseline`` = nodes/s over ``BNB_CPU_8RANK_ANCHOR``.
- ``faults`` (``bench_faults``, ``bench.py:171-243``): the crash-safe
  checkpoint store against a direct ``np.savez_compressed`` of the same
  payload on a mid-search burma14 frontier, ``TSP_BENCH_FAULTS_REPS``
  (30; ``--quick`` 5) interleaved pairs; metric
  ``atomic_checkpoint_overhead`` (ms a save), ``vs_baseline`` = direct /
  atomic.
- ``obs`` (``bench_obs``, ``bench.py:1146-1418``): full telemetry against
  ``TSP_OBS=off`` on the JAX config (``random:12:33`` x10 rounded, host
  loop) in 2 x ``TSP_BENCH_OBS_REPS`` (7; ``--quick`` 1) order-alternating
  pairs; the gated figure is the metered hook time over the rest of the
  solve's wall (at most 2%), ``obs_us_per_dispatch`` its second series;
  then a traced multi-request serve session must have no orphan span.
- ``serve`` (``bench_serve``, ``bench.py:817-1145``): ``TSP_BENCH_SERVE_REQS``
  (48) unique ``TSP_BENCH_SERVE_N`` (8) city instances, 900 ms deadlines:
  one ``solve_blocks_from_dists`` call and readback per instance against
  the micro-batched scheduler (tours bit-identical); a
  ``TSP_BENCH_SERVE_BNB_N`` (38) city proof at the head of the line,
  request-level against iteration-level (proven and equal in both); the
  350 ms and 0.001 ms deadline cohorts (every response valid).

Timing: each timed run starts after a device synchronize and ends with one
and the read of its result, on the host clock; the kernels' build and the
first launches are timed apart (``warmup_s``, on stderr). Every time is
reported with its spread (median, min, max, reps).

Launches: every mode writes the four hand kernels' launch counts of its
windows into ``launches``, each window's counts reset just before it and
read just after: pipeline's timed runs, each timed bnb proof, faults' B&B
run and its timed saves, each obs arm and its serve session, and serve's
five legs. On the CPU they are 0 (the wrappers count CUDA launches only).

Always-print rule: the run lives under a wall budget from process start
(``TSP_BENCH_BUDGET_S``, 600 s; the build counts against it). Work that
does not fit is skipped and listed in ``skipped``; the last line of
stdout is always one JSON object with ``metric``, ``value``, ``unit``,
``vs_baseline`` and ``ok``. Exit 0 when ``ok``, 1 when not, 2 when the
backend is unusable: ``auto`` and ``cuda`` need a card (no fallback to
the CPU), ``--backend=cpu`` runs on the host and records say so.

Outputs: the artifact (``BENCH_<MODE>.json``, or ``TSP_BENCH_FAULTS_OUT``,
``_OBS_OUT`` and ``_SERVE_OUT`` as in the JAX bench) is written atomically under ``--out-dir``
(``build/bench_torch/`` of the checkout), never over the JAX package's
root ``BENCH_*.json``; one history record per governed metric goes to
``bench_history_torch.jsonl`` (``TSP_BENCH_HISTORY``: another path, or
``off``); ``tools/bench_check.py`` gates on it. Every artifact and record
names the card (``torch.cuda.get_device_name(0)``, the device count, the
power limit).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: process-start anchor of the wall budget
_T0 = time.monotonic()

MODES = ("pipeline", "bnb", "faults", "obs", "serve")
#: the C++ reference at 16 cities x 100 blocks, single rank, on a CPU host
#: (``BASELINE.md``; the JAX bench's ``BASELINE_MS``)
BASELINE_MS = 69997.0
#: the reference's own cost of that instance (its sequential fold order)
BASELINE_COST = 34367.048
N, BLOCKS, GRID = 16, 100, 1000
#: the JAX engine's single-rank CPU nodes/s on eil51 (16,283; proof in 9.4 s
#: on its CPU host, ``bench.py:118-126`` and ``BENCHMARKS.md``) times 8 ranks:
#: an anchor that assumes perfect 8-way MPI scaling. Not a TPU number.
BNB_CPU_8RANK_ANCHOR = 8 * 16283.0
VALID_FOLDS = ("tree_xy", "tree", "scan", "tree_xy_polish")
POLISH_MAX_ROUNDS = 6
#: mode -> (artifact file, env knob that overrides its path: the JAX
#: bench's, so none for pipeline and bnb)
ARTIFACTS = {
    "pipeline": ("BENCH_PIPELINE.json", None),
    "bnb": ("BENCH_BNB.json", None),
    "faults": ("BENCH_FAULTS.json", "TSP_BENCH_FAULTS_OUT"),
    "obs": ("BENCH_OBS.json", "TSP_BENCH_OBS_OUT"),
    "serve": ("BENCH_SERVE.json", "TSP_BENCH_SERVE_OUT"),
}
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT_DIR = os.path.join(REPO_ROOT, "build", "bench_torch")


class Budget:
    """The wall budget from process start (``TSP_BENCH_BUDGET_S``)."""

    def __init__(self, seconds: float) -> None:
        self.seconds = seconds
        self.deadline = _T0 + seconds

    def left(self) -> float:
        return self.deadline - time.monotonic()

    def fits(self, need_s: float = 0.0) -> bool:
        """Is there time for work expected to take ``need_s``?"""
        return self.left() > need_s


@dataclass
class Run:
    """What a mode gets: the device and the run's settings."""

    device: Any  # torch.device
    quick: bool
    budget: Budget
    n: int = N
    blocks: int = BLOCKS


@dataclass
class Outcome:
    """What a mode returns: the artifact (headline keys included), the
    knobs that define its history group, and further governed series."""

    artifact: Dict[str, Any]
    config: Dict[str, Any]
    series: List[Dict[str, Any]] = field(default_factory=list)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


def _spread(values: List[float]) -> Dict[str, Any]:
    """Median, min, max and count of a list of timings."""
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "reps": len(values)}


def headline(mode: str, n: int = N, blocks: int = BLOCKS) -> tuple:
    """(metric, unit) of a mode's last line."""
    return {
        "pipeline": (f"pipeline_{n}x{blocks}_wall_ms", "ms"),
        "bnb": (f"bnb_{os.environ.get('TSP_BENCH_INSTANCE', 'eil51')}_nodes_per_sec", "nodes/s"),
        "faults": ("atomic_checkpoint_overhead", "ms/save"),
        "obs": ("obs_overhead", "pct"),
        "serve": ("serve_microbatch_vs_sequential_throughput", "x"),
    }[mode]


def failed(mode: str, error: str, run: Optional[Run] = None, **extra) -> Dict[str, Any]:
    """The last line of a run that measured nothing."""
    metric, unit = headline(mode, run.n, run.blocks) if run else headline(mode)
    return {"metric": metric, "value": None, "unit": unit, "vs_baseline": None, "ok": False,
            "error": error, **extra}


def _synced(device, fn: Callable[[], Any]) -> tuple:
    """``fn()`` between two device synchronizes -> (result, seconds)."""
    from ..utils.backend import synchronize

    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def reset_launches() -> None:
    """Zero the four hand kernels' launch counts (each wrapper counts its
    CUDA launches only, so on the CPU they stay 0)."""
    from ..ops import expand_kernels, held_karp_kernels, prim_kernels

    for mod in (held_karp_kernels, prim_kernels, expand_kernels):
        mod.reset_launches()


def read_launches() -> Dict[str, int]:
    """The four kernels' launch counts since the last :func:`reset_launches`."""
    from ..ops import expand_kernels, held_karp_kernels, prim_kernels

    return {**held_karp_kernels.LAUNCHES, **prim_kernels.LAUNCHES, **expand_kernels.LAUNCHES}


@contextlib.contextmanager
def counted(into: Dict[str, int]):
    """Add the kernels' launches of the ``with`` body to ``into``: the
    counts are reset just before the body and read just after it."""
    reset_launches()
    try:
        yield into
    finally:
        for name, count in read_launches().items():
            into[name] = into.get(name, 0) + count


def _build_kernels(device) -> float:
    """Build (or load) the kernel libraries on CUDA -> seconds; 0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    from ..kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    print(f"bench: kernel build {secs:.2f} s", file=sys.stderr)
    return secs


# -- pipeline ------------------------------------------------------------------


def bench_pipeline(run: Run) -> Outcome:
    import torch

    from ..ops.distance import distance_matrix
    from ..ops.generator import generate_instance
    from ..ops.held_karp import build_plan, solve_blocks_from_dists
    from ..ops.local_search import polish, tour_length
    from ..ops.merge import fold_tours, fold_tours_tree, fold_tours_tree_xy
    from ..utils.backend import default_dtype
    from ..utils.profiling import PhaseTimer

    device, n, nb = run.device, run.n, run.blocks
    metric, _ = headline("pipeline", n, nb)
    dtype = default_dtype(device)
    total = n * nb
    folds = {
        "tree_xy": (fold_tours_tree_xy, True, False),
        "tree": (fold_tours_tree, False, False),
        "scan": (fold_tours, False, False),
        "tree_xy_polish": (fold_tours_tree_xy, True, True),
    }
    pin = os.environ.get("TSP_BENCH_FOLD")
    if pin is not None and pin not in VALID_FOLDS:
        print(f"bench: ignoring unrecognized TSP_BENCH_FOLD={pin!r} (expected one of "
              f"{VALID_FOLDS}); measuring all", file=sys.stderr)
        pin = None
    names = (pin,) if pin else (("tree", "scan") if run.quick else VALID_FOLDS)
    reps = _env_int("TSP_BENCH_REPS", 2 if run.quick else (20 if device.type == "cuda" else 3))

    _, xy = generate_instance(n, nb, GRID, GRID)  # glibc rand(), seed 0; not timed
    xy_blocks = torch.as_tensor(xy, device=device).to(dtype)  # [B, n, 2]

    def step(name: str, timer: Optional[PhaseTimer] = None):
        """The JAX ``make_step``: -> (ids, cost, measured) device tensors."""
        fold, from_xy, do_polish = folds[name]
        phase = timer.phase if timer is not None else (lambda _: contextlib.nullcontext())
        with phase("distances"):
            flat = xy_blocks.reshape(-1, 2)
            block_d = distance_matrix(xy_blocks)
        with phase("solve"):
            costs, local_tours = solve_blocks_from_dists(block_d, dtype)
        with phase("merge_fold"):
            offsets = (torch.arange(nb, dtype=torch.int32, device=device) * n)[:, None]
            ctx = flat if from_xy else distance_matrix(flat)
            ids, _, cost = fold(local_tours + offsets, costs, ctx)
        # the measured length of the open tour, after the polish for the
        # polish fold (the fold's own cost is the reference's formula)
        with phase("polish"):
            dist = distance_matrix(flat) if from_xy else ctx
            t_open = ids[:total].long()[None]
            if do_polish:
                t_open, _ = polish(t_open, dist, max_rounds=POLISH_MAX_ROUNDS)
            measured = tour_length(t_open, dist)[0]
        return t_open[0], cost, measured

    build_s = _build_kernels(device)
    skipped: List[str] = []
    warm_s: Dict[str, float] = {}
    for name in names:
        if not run.budget.fits():
            skipped.append(name)
            continue
        _, warm_s[name] = _synced(device, lambda: step(name))
        print(f"bench: {name} warm-up (first launches) {warm_s[name]:.3f} s", file=sys.stderr)
    live = [nm for nm in names if nm in warm_s]
    times: Dict[str, List[float]] = {nm: [] for nm in live}
    results: Dict[str, tuple] = {}
    launches: Dict[str, int] = {}
    with counted(launches):  # the timed runs only
        for r in range(reps):
            # ABBA: forward on even rounds, backward on odd ones
            for name in (live if r % 2 == 0 else live[::-1]):
                need = times[name][-1] if times[name] else warm_s[name]
                if not run.budget.fits(need):
                    skipped.append(f"{name}#{r}")
                    continue
                (_, cost, measured), secs = _synced(device, lambda: step(name))
                results[name] = (float(cost), float(measured))
                times[name].append(secs * 1000.0)
    runs_done = sum(len(v) for v in times.values())
    measured_folds = [nm for nm in live if times[nm]]
    if not measured_folds:
        return Outcome(failed("pipeline", f"no fold completed within the {run.budget.seconds:g} s "
                              "budget", run, skipped=skipped), {})
    table: Dict[str, Any] = {}
    valid = True
    for name in measured_folds:
        # one more, untimed run split by layer; it also checks the tour
        timer = PhaseTimer(device)
        t_open, _, _ = step(name, timer)
        perm = bool(torch.equal(torch.sort(t_open).values, torch.arange(total, device=device)))
        cost, measured = results[name]
        valid = valid and perm and math.isfinite(cost) and math.isfinite(measured)
        sp = _spread(times[name])
        table[name] = {"ms": sp["median"], "ms_min": sp["min"], "ms_max": sp["max"],
                       "reps": sp["reps"], "cost": cost, "measured": measured,
                       "tour_is_permutation": perm, "warmup_s": warm_s[name],
                       "layers": timer.snapshot()}
        print(f"bench: {name}: {sp['median']:.3f} ms median over {sp['reps']} runs "
              f"[{sp['min']:.3f}, {sp['max']:.3f}], cost={cost:.3f}, measured={measured:.3f}",
              file=sys.stderr)
    best = min(table, key=lambda nm: table[nm]["ms"])
    ms = table[best]["ms"]
    ref_size = (n, nb) == (N, BLOCKS)
    artifact = {
        "metric": metric,
        "value": ms,
        "unit": "ms",
        # the reference's wall time exists for its 16 x 100 instance only
        "vs_baseline": BASELINE_MS / ms if ref_size else None,
        "ok": valid,
        "fold": best,
        "cost": table[best]["cost"],
        "measured": table[best]["measured"],
        "baseline_cost": BASELINE_COST if ref_size else None,
        "folds": table,
        "n": n, "blocks": nb, "grid": GRID, "dtype": str(dtype).replace("torch.", ""),
        "reps": reps,
        "dp_transitions_per_s": build_plan(n).dp_transitions * nb / (ms / 1000.0),
        "relax_dense_launches_per_run": launches["relax_dense"] / max(runs_done, 1),
        # the four kernels' launches over the timed runs (``runs``)
        "launches": launches,
        "runs": runs_done,
        "build_s": build_s,
        "skipped": skipped,
    }
    config = {"folds": sorted(measured_folds), "quick": run.quick, "n": n, "blocks": nb,
              "dtype": artifact["dtype"]}
    return Outcome(artifact, config)


# -- bnb -----------------------------------------------------------------------


def bench_bnb(run: Run) -> Outcome:
    from ..models import branch_bound as bb
    from ..obs import costs as obs_costs
    from ..utils import tsplib

    device = run.device
    name = os.environ.get("TSP_BENCH_INSTANCE", "eil51")
    inst = tsplib.embedded(name)
    d = inst.distance_matrix()
    n = d.shape[0]
    k = _env_int("TSP_BENCH_K", 1024)
    capacity = max(1 << 17, 8 * k * (n - 1))
    na = _env_int("TSP_BENCH_NODE_ASCENT", 2)
    reps = _env_int("TSP_BENCH_BNB_REPS", 1 if run.quick else 3)
    kw = dict(capacity=capacity, k=k, node_ascent=na, device=device)

    build_s = _build_kernels(device)
    if not run.budget.fits():
        return Outcome(failed("bnb", "no time left for the warm-up", run, skipped=["warmup"]), {})
    t0 = time.perf_counter()
    bb.solve(d, max_iters=8, **kw)  # first launches, the ascent memo's entry
    warm_s = time.perf_counter() - t0
    print(f"bench: bnb warm-up {warm_s:.2f} s", file=sys.stderr)

    runs: List[Dict[str, Any]] = []
    skipped: List[str] = []
    for r in range(reps):
        need = (runs[-1]["time_to_proof_s"] or 0.0) if runs else 0.0
        if not run.budget.fits(need):
            skipped.append(f"run#{r}")
            continue
        launches: Dict[str, int] = {}
        with counted(launches):
            res = bb.solve(d, time_limit_s=min(600.0, run.budget.left()), max_iters=5_000_000, **kw)
        runs.append({
            "nodes_per_sec": res.nodes_per_sec,
            "nodes_expanded": res.nodes_expanded,
            "cost": res.cost,
            "proven_optimal": bool(res.proven_optimal),
            "wall_s": res.wall_seconds,
            "setup_s": res.setup_seconds,
            "setup_ascent_s": res.ascent_seconds,
            "setup_ils_s": res.ils_seconds,
            "time_to_proof_s": res.setup_seconds + res.wall_seconds if res.proven_optimal else None,
            "prim_chain_launches": launches["prim_chain"],
            "push_rows_launches": launches["push_rows"],
            "launches": launches,
            "mst_kernel": res.mst_kernel, "step_kernel": res.step_kernel,
            "device_loop": res.device_loop,
        })
        print(f"bench: {name} run {r}: cost={res.cost} (known {inst.known_optimum}) "
              f"proven={res.proven_optimal} nodes={res.nodes_expanded} wall={res.wall_seconds:.3f} s "
              f"setup={res.setup_seconds:.3f} s", file=sys.stderr)
    if not runs:
        return Outcome(failed("bnb", "no proof fit in the budget", run, skipped=skipped), {})
    rate = _spread([r["nodes_per_sec"] for r in runs])
    proofs = [r["time_to_proof_s"] for r in runs]
    proven = all(p is not None for p in proofs)
    ttp = _spread(proofs) if proven else None
    first = runs[0]
    artifact = {
        "metric": f"bnb_{name}_nodes_per_sec",
        "value": rate["median"],
        "unit": "nodes/s",
        "vs_baseline": rate["median"] / BNB_CPU_8RANK_ANCHOR,
        "ok": proven and all(r["cost"] == inst.known_optimum for r in runs),
        "nodes_per_sec_min": rate["min"],
        "nodes_per_sec_max": rate["max"],
        "reps": len(runs),
        "proven_optimal": proven,
        "cost": first["cost"],
        "known_optimum": inst.known_optimum,
        # the end-to-end time: bound setup + incumbent + search; null
        # unless every run proved
        "time_to_proof_s": ttp["median"] if ttp else None,
        "time_to_proof_s_min": ttp["min"] if ttp else None,
        "time_to_proof_s_max": ttp["max"] if ttp else None,
        "setup_s": statistics.median(r["setup_s"] for r in runs),
        "setup_ascent_s": statistics.median(r["setup_ascent_s"] for r in runs),
        "setup_ils_s": statistics.median(r["setup_ils_s"] for r in runs),
        "nodes_expanded": first["nodes_expanded"],
        "prim_chain_launches": first["prim_chain_launches"],
        "push_rows_launches": first["push_rows_launches"],
        # the four kernels' launches in the first timed proof
        "launches": first["launches"],
        "mst_kernel": first["mst_kernel"],
        "step_kernel": first["step_kernel"],
        "device_loop": first["device_loop"],
        "push_order": "best-first",
        "push_block": 0,
        "k": k, "capacity": capacity, "node_ascent": na,
        "anchor": "the JAX engine's 1-rank CPU rate x8 (assumes perfect 8-way MPI scaling)",
        "runs": runs,
        "warmup_s": warm_s,
        "build_s": build_s,
        "skipped": skipped,
        "obs": {"device_costs": obs_costs.device_costs_block()},
    }
    config = {"instance": name, "k": k, "capacity": capacity, "node_ascent": na,
              "mst_kernel": first["mst_kernel"], "push_order": "best-first", "push_block": 0,
              "device_loop": first["device_loop"]}
    return Outcome(artifact, config)


# -- faults --------------------------------------------------------------------


def _same_arrays(a, b) -> bool:
    """Two npz files hold the same keys, dtypes, shapes and bytes."""
    if sorted(a.files) != sorted(b.files):
        return False
    return all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
               and a[k].tobytes() == b[k].tobytes() for k in a.files)


def bench_faults(run: Run) -> Outcome:
    import shutil

    import numpy as np

    from ..models import branch_bound as bb
    from ..resilience import checkpoint as ck_store
    from ..utils import tsplib

    device = run.device
    reps = _env_int("TSP_BENCH_FAULTS_REPS", 5 if run.quick else 30)
    if not run.budget.fits():
        return Outcome(failed("faults", "no time left to start", run, skipped=["faults"]), {})
    d = tsplib.embedded("burma14").distance_matrix()
    workdir = tempfile.mkdtemp(prefix="bench_faults_")
    try:
        seed_ck = os.path.join(workdir, "seed.npz")
        # a real mid-search frontier (unproven, so the engine's final save runs)
        solve_launches: Dict[str, int] = {}
        with counted(solve_launches):
            res = bb.solve(d, capacity=4096, k=64, inner_steps=4, max_iters=6, bound="min-out",
                           node_ascent=0, device_loop=False, checkpoint_path=seed_ck, device=device)
        if res.proven_optimal:
            raise RuntimeError("the seed run proved early; shrink max_iters")
        fr, ic, itour, _resv, lb = bb.restore(seed_ck, expect_d=d, expect_bound="min-out",
                                              device=device)
        save_kw = dict(d=d, bound="min-out", lb_floor=lb)
        payload = bb._ckpt_payload(fr, ic, itour, **save_kw)
        atomic_path = os.path.join(workdir, "atomic.npz")
        direct_path = os.path.join(workdir, "direct.npz")

        def atomic():
            bb.save(atomic_path, fr, ic, itour, **save_kw)  # payload build + atomic publish

        def direct():
            bb._ckpt_payload(fr, ic, itour, **save_kw)
            np.savez_compressed(direct_path, **payload)  # graftlint: disable=R6 — the measured baseline

        atomic_ms: List[float] = []
        direct_ms: List[float] = []
        skipped: List[str] = []
        save_launches: Dict[str, int] = {}
        with counted(save_launches):
            for r in range(reps):
                need = (atomic_ms[-1] + direct_ms[-1]) / 1000.0 if atomic_ms else 0.0
                if not run.budget.fits(need):
                    skipped.append(f"pair#{r}")
                    continue
                pair = ((atomic, atomic_ms), (direct, direct_ms))
                for fn, out in (pair if r % 2 == 0 else pair[::-1]):
                    t0 = time.perf_counter()
                    fn()
                    out.append((time.perf_counter() - t0) * 1000.0)
        if not atomic_ms:
            return Outcome(failed("faults", "no save pair fit in the budget", run, skipped=skipped), {})
        with open(atomic_path, "rb") as fh:
            _header, blob = ck_store.unpack(fh.read())
        with np.load(io.BytesIO(blob)) as a, np.load(direct_path) as b:
            identical = _same_arrays(a, b)
        a_mean, d_mean = statistics.fmean(atomic_ms), statistics.fmean(direct_ms)
        a_sp, d_sp = _spread(atomic_ms), _spread(direct_ms)
        artifact = {
            "metric": "atomic_checkpoint_overhead",
            "unit": "ms/save",
            # the JAX bench's estimator: the mean of the reps
            "value": a_mean,
            "vs_baseline": d_mean / a_mean,
            "ok": identical,
            "instance": "burma14",
            "payload_identical": identical,
            "payload_bytes": os.path.getsize(direct_path),
            "file_bytes": os.path.getsize(atomic_path),
            "reps": len(atomic_ms),
            "order": "interleaved, alternating which store goes first",
            "rotation_keep": ck_store.default_keep(),
            "direct_ms": d_mean,
            "atomic_ms": a_mean,
            "direct_ms_median": d_sp["median"], "direct_ms_min": d_sp["min"],
            "direct_ms_max": d_sp["max"],
            "atomic_ms_median": a_sp["median"], "atomic_ms_min": a_sp["min"],
            "atomic_ms_max": a_sp["max"],
            "overhead_ms": a_mean - d_mean,
            "overhead_pct": (a_mean / d_mean - 1.0) * 100.0,
            # the kernels' launches: the B&B run that made the frontier, and
            # the timed saves (which launch none)
            "launches": {"seed_solve": solve_launches, "saves": save_launches},
            "step_kernel": res.step_kernel,
            "skipped": skipped,
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"bench: faults: atomic {a_mean:.3f} ms, direct {d_mean:.3f} ms over {len(atomic_ms)} "
          f"pairs, payload identical {identical}", file=sys.stderr)
    return Outcome(artifact, {"reps": reps, "instance": "burma14"})


# -- obs -----------------------------------------------------------------------


def bench_obs(run: Run) -> Outcome:
    import shutil

    workdir = tempfile.mkdtemp(prefix="bench_obs_")
    try:
        return _obs_legs(run, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _obs_legs(run: Run, workdir: str) -> Outcome:
    import numpy as np

    from .. import obs
    from ..models import branch_bound as bb
    from ..obs import anomaly as obs_anomaly
    from ..obs import costs as obs_costs
    from ..obs import timeseries as obs_ts
    from ..obs import tracing
    from ..serve.service import ServiceConfig, run_jsonl
    from ..utils import tsplib

    device = run.device
    reps = _env_int("TSP_BENCH_OBS_REPS", 1 if run.quick else 7)
    if not run.budget.fits():
        return Outcome(failed("obs", "no time left for the warm-up", run, skipped=["obs"]), {})
    spec = os.environ.get("TSP_BENCH_OBS_INSTANCE", "random:12:33")
    inst = tsplib.resolve_instance(spec)
    d = np.rint(inst.distance_matrix() * 10)
    # the JAX config: dense host-loop sampling (inner_steps 4) with
    # dispatches large enough that the ratio prices telemetry
    kw = dict(capacity=2048, k=8, inner_steps=4, bound="min-out", mst_prune=False,
              node_ascent=0, device_loop=False, device=device)
    _build_kernels(device)
    t0 = time.perf_counter()
    bb.solve(d, **kw)  # first launches, out of both arms
    print(f"bench: obs warm-up {time.perf_counter() - t0:.2f} s", file=sys.stderr)

    # the hook meter: the per-dispatch sampler self-times through its native
    # METER_NS; the once-a-solve surfaces (series flush, sentinel summary,
    # trace-sink writes) are wrapped. Armed for both arms; the off arm never
    # enters any of it.
    meter_ns = [0]
    hook = {"s": 0.0}

    def _metered(fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                hook["s"] += time.perf_counter() - t
        return wrapper

    patched = [(obs_ts.StepSampler, "series"), (obs_anomaly.StallSentinel, "summary"),
               (tracing.Tracer, "emit")]
    saved = [(o, nm, getattr(o, nm)) for o, nm in patched]

    def hook_s() -> float:
        return hook["s"] + meter_ns[0] * 1e-9

    last = {}
    # the kernels' launches of each arm, summed over its timed solves
    arm_launches: Dict[str, Dict[str, int]] = {"on": {}, "off": {}}

    def run_once(enabled: bool) -> tuple:
        obs.set_enabled(enabled)
        tracing.configure(os.path.join(workdir, "bnb_trace.jsonl") if enabled else None)
        h0 = hook_s()
        t0 = time.perf_counter()
        with counted(arm_launches["on" if enabled else "off"]), \
                tracing.span("bnb.solve", instance=inst.name):
            res = bb.solve(d, **kw)
        wall = time.perf_counter() - t0
        if not res.proven_optimal or (res.series is not None) != enabled:
            raise RuntimeError(f"obs leg: proven {res.proven_optimal}, series "
                               f"{res.series is not None} with telemetry {enabled}")
        if enabled:
            last["res"] = res
        return wall, hook_s() - h0

    on_walls: List[float] = []
    off_walls: List[float] = []
    on_hooks: List[float] = []
    skipped: List[str] = []
    try:
        obs_ts.StepSampler.METER_NS = meter_ns
        for obj, nm, fn in saved:
            setattr(obj, nm, _metered(fn))
        # order-alternating pairs: the second slot of a pair runs warmer
        for pair in range(2 * reps):
            need = on_walls[-1] + off_walls[-1] if on_walls else 0.0
            if not run.budget.fits(need):
                skipped.append(f"pair#{pair}")
                continue
            if pair % 2 == 0:
                off_w, _ = run_once(False)
                on_w, on_h = run_once(True)
            else:
                on_w, on_h = run_once(True)
                off_w, _ = run_once(False)
            off_walls.append(off_w)
            on_walls.append(on_w)
            on_hooks.append(on_h)
    finally:
        obs_ts.StepSampler.METER_NS = None
        for obj, nm, fn in saved:
            setattr(obj, nm, fn)
        obs.set_enabled(None)
        tracing.configure(None)
    if not on_walls:
        return Outcome(failed("obs", "no pair fit in the budget", run, skipped=skipped), {})
    on_ms = statistics.median(on_walls) * 1000.0
    off_ms = statistics.median(off_walls) * 1000.0
    # the gated estimator: serial obs time over the non-obs wall, per run
    per_run_pct = [h / max(w - h, 1e-9) * 100.0 for w, h in zip(on_walls, on_hooks)]
    overhead_pct = statistics.median(per_run_pct)
    hook_ms = statistics.median(on_hooks) * 1000.0
    bnb_ok = overhead_pct <= 2.0
    # the A/B wall ratio: reported, not gated (pair noise dwarfs 2%)
    pair_ratios = [on_w / off_w for on_w, off_w in zip(on_walls, off_walls)]
    wall_ratio_pct = (statistics.median(pair_ratios) - 1.0) * 100.0

    # -- the serve span tree
    trace_path = os.path.join(workdir, "serve_trace.jsonl")
    tracing.configure(trace_path)
    rng = np.random.default_rng(7)
    lines = []
    for i in range(12):
        req = {"id": f"r{i}", "xy": (rng.random((8, 2)) * 50).tolist()}
        if i == 5:
            req["deadline_ms"] = 0.001  # the degraded path must trace too
        lines.append(json.dumps(req))
    lines.insert(3, "this is not json")
    out = io.StringIO()
    serve_launches: Dict[str, int] = {}
    try:
        with counted(serve_launches):
            svc = run_jsonl(lines, out, ServiceConfig(threads=4, max_wait_ms=1.0, device=str(device)))
    finally:
        tracing.configure(None)
    responses = len(out.getvalue().strip().splitlines())
    spans = tracing.read_trace(trace_path)
    trees = tracing.build_trees(spans)
    orphans = tracing.orphan_spans(spans)
    roots = [nd for t in trees.values() for nd in t["roots"] if nd["span"]["name"] == "serve.request"]
    incomplete = [nd for nd in roots if not nd["children"]]
    serve_ok = responses == 13 and len(roots) == 12 and not orphans and not incomplete

    dispatches = int(last["res"].series["samples_total"])
    us_per_dispatch = hook_ms * 1000.0 / max(dispatches, 1)
    artifact = {
        "metric": "obs_overhead",
        "unit": "pct",
        "value": overhead_pct,
        "vs_baseline": off_ms / on_ms,
        "ok": bnb_ok and serve_ok,
        "instance": inst.name,
        "reps_per_arm": len(on_walls),
        "bnb": {
            "on_ms": on_ms, "off_ms": off_ms,
            "on_ms_min": min(on_walls) * 1000.0, "on_ms_max": max(on_walls) * 1000.0,
            "off_ms_min": min(off_walls) * 1000.0, "off_ms_max": max(off_walls) * 1000.0,
            "hook_ms": hook_ms,
            "overhead_pct": overhead_pct,
            "overhead_pct_min": min(per_run_pct), "overhead_pct_max": max(per_run_pct),
            "wall_ratio_pct": wall_ratio_pct,
            "wall_ratio_pct_min": (min(pair_ratios) - 1.0) * 100.0,
            "wall_ratio_pct_max": (max(pair_ratios) - 1.0) * 100.0,
            "us_per_dispatch": us_per_dispatch,
            "series_rows": dispatches,
            "step_kernel": last["res"].step_kernel,
            "launches": arm_launches,
            "estimator": "metered-hooks",
            "acceptance_max_pct": 2.0,
            "ok": bnb_ok,
        },
        "serve": {
            "requests": 12,
            "responses": responses,
            "spans": len(spans),
            "traces": len(trees),
            "request_roots": len(roots),
            "orphan_spans": len(orphans),
            "incomplete_trees": len(incomplete),
            "stats_health": json.loads(svc.stats_json())["health"],
            "launches": serve_launches,
            "ok": serve_ok,
        },
        "skipped": skipped,
        # the hand kernels' analytic costs where the B&B leg launched them
        "obs": {"device_costs": obs_costs.device_costs_block()},
    }
    print(f"bench: obs: metered {overhead_pct:.4f}% (wall ratio {wall_ratio_pct:+.2f}%), "
          f"{us_per_dispatch:.3f} us a dispatch, {len(orphans)} orphan spans", file=sys.stderr)
    config = {"instance": inst.name, "reps": reps, "inner_steps": kw["inner_steps"],
              "pair_order": "alternating", "estimator": "metered-hooks"}
    series = [{"metric": "obs_us_per_dispatch", "value": us_per_dispatch, "unit": "us",
               "ok": bnb_ok}]
    return Outcome(artifact, config, series)


# -- serve ---------------------------------------------------------------------


def bench_serve(run: Run) -> Outcome:
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from ..models import branch_bound as bb
    from ..obs import tracing
    from ..ops.distance import distance_matrix_np
    from ..ops.held_karp import solve_blocks_from_dists
    from ..serve import LadderConfig, MicroBatchScheduler, ServiceConfig, SolveService

    device = run.device
    dev = str(device)
    n = _env_int("TSP_BENCH_SERVE_N", 8)
    reqs_total = _env_int("TSP_BENCH_SERVE_REQS", 48)
    if not run.budget.fits():
        return Outcome(failed("serve", "no time left to start", run, skipped=["serve"]), {})
    rng = np.random.default_rng(7)
    instances = [rng.uniform(0, 1000, (n, 2)) for _ in range(reqs_total)]
    dists = [distance_matrix_np(xy) for xy in instances]
    # sub-second deadlines keep the cohort on the exact pipeline rung
    requests = [{"id": i, "xy": inst.tolist(), "deadline_ms": 900.0}
                for i, inst in enumerate(instances)]
    ladder_cfg = LadderConfig(bnb_max_n=40, bnb_capacity=4096, bnb_k=32, bnb_slice_s=0.05)
    bnb_n = _env_int("TSP_BENCH_SERVE_BNB_N", 38)
    bnb_xy = np.random.default_rng(3).uniform(0, 1000, (bnb_n, 2))
    bnb_req = {"id": "proof", "xy": bnb_xy.tolist(), "deadline_ms": 30_000.0}

    def solve_batch(stack):
        costs, tours = solve_blocks_from_dists(
            torch.as_tensor(stack, dtype=torch.float32, device=device), torch.float32)
        return costs.cpu().numpy(), tours.cpu().numpy()

    # warm both batch shapes, the certified rung and the ascent memo outside
    # the timed windows
    build_s = _build_kernels(device)
    t0 = time.perf_counter()
    warm = np.stack(dists)
    for shape in (warm[:1], warm):  # two warm-up shapes, not a hot loop  # graftlint: disable=R4
        solve_batch(shape)
    bb.solve(distance_matrix_np(bnb_xy), time_limit_s=0.05, capacity=ladder_cfg.bnb_capacity,
             k=ladder_cfg.bnb_k, device_loop=False, device=device)
    warm_s = time.perf_counter() - t0
    print(f"bench: serve warm-up {warm_s:.2f} s", file=sys.stderr)

    # the kernels' launches of each timed window
    launches: Dict[str, Dict[str, int]] = {
        leg: {} for leg in ("sequential", "microbatch", "request_level", "iteration_level",
                            "deadline")}

    # -- leg A: one call and readback per instance
    t0 = time.perf_counter()
    with counted(launches["sequential"]):
        seq_tours = [solve_batch(d[None])[1][0] for d in dists]
    seq_wall = time.perf_counter() - t0
    seq_rps = reqs_total / seq_wall

    # -- leg B: the same instances as scheduler tickets, flushed batched
    with MicroBatchScheduler(max_batch=reqs_total, max_wait_ms=20.0, device=dev) as sched:
        t0 = time.perf_counter()
        with counted(launches["microbatch"]):
            tickets = [sched.submit(d[None]) for d in dists]
            bat_tours = [t.wait(timeout=120.0)[1][0] for t in tickets]
        bat_wall = time.perf_counter() - t0
        sched_stats = sched.stats()
    bat_rps = reqs_total / bat_wall
    tours_match = all(np.array_equal(s, b) for s, b in zip(seq_tours, bat_tours))

    # -- the mixed workload: the head-of-line proof and the requests,
    # request-level (one at a time, each to completion) against
    # iteration-level (the proof preempted at slice boundaries)
    seq_cfg = ServiceConfig(max_batch=1, max_wait_ms=0.0, threads=1, ladder=ladder_cfg, device=dev)
    svc_seq_responses = {}
    with SolveService(seq_cfg) as svc_seq:
        t0 = time.perf_counter()
        with counted(launches["request_level"]):
            seq_bnb_resp = svc_seq.handle(bnb_req)
            for req in requests:
                resp = svc_seq.handle(req)
                svc_seq_responses[resp["id"]] = resp
        seq_service_wall = time.perf_counter() - t0
    seq_service_rps = reqs_total / seq_service_wall

    trace_dir = tempfile.mkdtemp(prefix="bench_serve_")
    try:
        trace_path = os.path.join(trace_dir, "serve_trace.jsonl")
        tracing.configure(trace_path)
        bat_cfg = ServiceConfig(max_batch=reqs_total, max_wait_ms=20.0, threads=reqs_total,
                                ladder=ladder_cfg, device=dev)
        svc = SolveService(bat_cfg)
        try:
            with ThreadPoolExecutor(max_workers=reqs_total + 1) as pool:
                list(pool.map(lambda _: None, range(reqs_total + 1)))  # threads up before timing
                t0 = time.perf_counter()
                with counted(launches["iteration_level"]):
                    bnb_future = pool.submit(svc.handle, bnb_req)
                    futures = [pool.submit(svc.handle, r) for r in requests]
                    bat_responses = {}
                    for f in futures:
                        r = f.result(timeout=120.0)
                        bat_responses[r["id"]] = r
                    bat_service_wall = time.perf_counter() - t0
                    bat_bnb_resp = bnb_future.result(timeout=120.0)
                    bat_total_wall = time.perf_counter() - t0
            bat_service_rps = reqs_total / bat_service_wall
            service_tours_match = all(
                svc_seq_responses[i]["tour"] == bat_responses[i]["tour"]
                and list(bat_responses[i]["tour"][:-1]) == list(map(int, seq_tours[i][:-1]))
                for i in range(reqs_total)
            )
            bnb_identical = (
                seq_bnb_resp["tier"] == "bnb" and bat_bnb_resp["tier"] == "bnb"
                and seq_bnb_resp["certified_gap"] == 0.0 and bat_bnb_resp["certified_gap"] == 0.0
                and seq_bnb_resp["cost"] == bat_bnb_resp["cost"]
                and seq_bnb_resp["tour"] == bat_bnb_resp["tour"]
            )

            # -- resubmission, permuted and translated: every one a cache hit
            hits_before = svc.cache.stats()["hits"]
            for i, inst in enumerate(instances):
                shuffled = inst[rng.permutation(n)] + rng.integers(-500, 500)
                svc.handle({"id": f"dup{i}", "xy": shuffled.tolist(), "deadline_ms": 900.0})
            hit_rate = (svc.cache.stats()["hits"] - hits_before) / reqs_total

            # -- deadline routing: feasible-but-tight budgets answered exactly,
            # impossible ones still a valid closed tour
            tight_reqs, impossible_reqs = 24, 8
            deadline_reqs = tight_reqs + impossible_reqs
            deadline_valid = tight_exact = 0
            deadline_tiers: Dict[str, int] = {}
            with counted(launches["deadline"]):
                for i in range(deadline_reqs):
                    xy = rng.uniform(0, 1000, (n, 2))
                    tight = i < tight_reqs
                    resp = svc.handle({"id": f"dl{i}", "xy": xy.tolist(),
                                       "deadline_ms": 350.0 if tight else 0.001})
                    tour = resp.get("tour", [])
                    if ("error" not in resp and tour and tour[0] == tour[-1]
                            and sorted(tour[:-1]) == list(range(n))):
                        deadline_valid += 1
                    if (tight and resp.get("tier") in ("bnb", "pipeline")
                            and resp.get("certified_gap") == 0.0):
                        tight_exact += 1
                    tier = resp.get("tier", "error")
                    deadline_tiers[tier] = deadline_tiers.get(tier, 0) + 1
            tight_exact_rate = tight_exact / tight_reqs
            stats = json.loads(svc.stats_json())
        finally:
            svc.close()
            tracing.configure(None)
        slice_spans = [s for s in tracing.read_trace(trace_path) if s.get("name") == "bnb.slice"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    preempt_spans = sum(1 for s in slice_spans if s.get("attrs", {}).get("preempted"))
    resume_spans = sum(1 for s in slice_spans if s.get("attrs", {}).get("resumed"))

    admission = stats.get("admission", {})
    ratio = bat_rps / seq_rps
    service_ratio = bat_service_rps / seq_service_rps
    # correctness gates the run; the JAX bench's speed targets (set on its
    # CPU host) are reported beside the ratios and not gated
    targets = {"microbatch_ratio_min": 2.0, "service_ratio_min": 3.0, "tight_exact_rate_min": 0.9}
    ok = (
        tours_match and service_tours_match and bnb_identical and hit_rate >= 1.0
        and deadline_valid == deadline_reqs
        and int(admission.get("preemptions", 0)) >= 1 and int(admission.get("resumes", 0)) >= 1
        and preempt_spans >= 1 and resume_spans >= 1
    )
    artifact = {
        "metric": "serve_microbatch_vs_sequential_throughput",
        "value": ratio,
        "unit": "x",
        # the JAX serve mode has none: the ratio is its own comparison
        "vs_baseline": None,
        "ok": bool(ok),
        "sequential_rps": seq_rps,
        "batched_rps": bat_rps,
        "sequential_service_rps": seq_service_rps,
        "batched_service_rps": bat_service_rps,
        "service_ratio": service_ratio,
        "requests": reqs_total,
        "n": n,
        "bnb_n": bnb_n,
        "bnb_identical": bool(bnb_identical),
        "bnb_cost": float(bat_bnb_resp["cost"]),
        "bnb_answers": {leg: {key: resp.get(key) for key in ("tier", "cost", "certified_gap")}
                        for leg, resp in (("request_level", seq_bnb_resp),
                                          ("iteration_level", bat_bnb_resp))},
        "bnb_wall_batched_s": bat_total_wall,
        "tours_match": bool(tours_match),
        "service_tours_match": bool(service_tours_match),
        "cache_hit_rate_resubmit": hit_rate,
        "deadline_requests": deadline_reqs,
        "deadline_valid_responses": deadline_valid,
        "deadline_misses": stats["deadline_misses"],
        "deadline_tiers": deadline_tiers,
        "tight_deadline_requests": tight_reqs,
        "tight_deadline_exact_rate": tight_exact_rate,
        "targets": targets,
        "targets_met": {"microbatch_ratio": ratio >= targets["microbatch_ratio_min"],
                        "service_ratio": service_ratio >= targets["service_ratio_min"],
                        "tight_exact_rate": tight_exact_rate >= targets["tight_exact_rate_min"]},
        "preempt_spans": preempt_spans,
        "resume_spans": resume_spans,
        "launches": launches,
        "admission": admission,
        "microbatch_scheduler": sched_stats,
        "service_scheduler": stats["scheduler"],
        "cache": stats["cache"],
        "tiers": stats["tiers"],
        "warmup_s": warm_s,
        "build_s": build_s,
        "skipped": [],
    }
    print(f"bench: serve: microbatch {ratio:.3f}x ({seq_rps:.1f} -> {bat_rps:.1f} req/s), service "
          f"{service_ratio:.3f}x, tight exact {tight_exact_rate:.3f}, preemptions "
          f"{admission.get('preemptions', 0)}", file=sys.stderr)
    config = {"requests": reqs_total, "n": n, "bnb_n": bnb_n}
    series = [
        {"metric": "serve_service_ratio", "value": service_ratio, "unit": "x", "ok": bool(ok)},
        {"metric": "serve_tight_deadline_exact_rate", "value": tight_exact_rate, "unit": "rate",
         "ok": bool(ok)},
    ]
    return Outcome(artifact, config, series)


RUNNERS: Dict[str, Callable[[Run], Outcome]] = {
    "pipeline": bench_pipeline, "bnb": bench_bnb, "faults": bench_faults, "obs": bench_obs,
    "serve": bench_serve,
}


# -- the core ------------------------------------------------------------------


def artifact_path(mode: str, out_dir: Optional[str]) -> str:
    """Where a mode's artifact goes: its ``TSP_BENCH_<MODE>_OUT`` where it
    has one, else ``<out_dir>/BENCH_<MODE>.json`` (default
    ``build/bench_torch/``)."""
    fname, knob = ARTIFACTS[mode]
    return (knob and os.environ.get(knob)) or os.path.join(out_dir or DEFAULT_OUT_DIR, fname)


def card_of(device) -> Dict[str, Any]:
    """The card a run measured: torch's name and count, nvidia-smi's power
    limit; nulls for a run on the CPU."""
    if device.type != "cuda":
        return {"device_name": None, "power_limit_w": None, "device_count": 0}
    import torch

    from ..obs import bench_history as bh

    return {"device_name": torch.cuda.get_device_name(0),
            "power_limit_w": bh.card_fingerprint()["power_limit_w"],
            "device_count": torch.cuda.device_count()}


def history_append(mode: str, outcome: Outcome, backend: str, card: Dict[str, Any],
                   rev: Optional[str] = None) -> None:
    """One record per governed series of the run; ``rev`` names the
    commit where git cannot (a copy of the tree without ``.git``)."""
    from ..obs import bench_history as bh

    path = bh.resolve_history_path(REPO_ROOT)
    if path is None:
        return
    for art in [outcome.artifact] + outcome.series:
        if art.get("value") is None:
            continue
        rec = bh.make_record(mode, art, config=outcome.config, backend=backend, card=card)
        if rec["git_rev"] is None:
            rec["git_rev"] = rev
        bh.append(path, rec)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench", description="the port's bench harness: one JSON line")
    ap.add_argument("--mode", default=os.environ.get("TSP_BENCH", "pipeline"), choices=MODES)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "cpu"])
    ap.add_argument("--quick", action="store_true", default=os.environ.get("TSP_BENCH_QUICK") == "1",
                    help="a smoke run: fewer folds and reps (also TSP_BENCH_QUICK=1)")
    ap.add_argument("--out-dir", default=None, metavar="DIR",
                    help="artifact directory (default build/bench_torch/ of the checkout)")
    ap.add_argument("--n", type=int, default=N, help="pipeline: cities a block")
    ap.add_argument("--blocks", type=int, default=BLOCKS, help="pipeline: blocks")
    ap.add_argument("--git-rev", default=None, metavar="REV",
                    help="the commit measured, for the history records where git cannot tell "
                    "(a copy of the tree without .git)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    mode = args.mode
    budget = Budget(float(os.environ.get("TSP_BENCH_BUDGET_S", "600")))
    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        metric, unit = headline(mode, args.n, args.blocks)
        print(json.dumps({"metric": metric, "value": None, "unit": unit, "vs_baseline": None,
                          "ok": False, "error": str(e), "backend": args.backend}))
        return 2
    card = card_of(device)
    run = Run(device=device, quick=args.quick, budget=budget, n=args.n, blocks=args.blocks)
    try:
        outcome = RUNNERS[mode](run)
    except Exception as e:  # noqa: BLE001 — the last line must be printed whatever failed
        traceback.print_exc()
        outcome = Outcome(failed(mode, f"{type(e).__name__}: {e}", run), {})
    art = outcome.artifact
    art["device"] = {"backend": device.type, "name": card["device_name"],
                     "count": card["device_count"], "power_limit_w": card["power_limit_w"]}
    art.update(mode=mode, quick=args.quick, budget_s=budget.seconds,
               wall_s=time.monotonic() - _T0)
    path = artifact_path(mode, args.out_dir)
    from ..resilience.checkpoint import write_json_atomic

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_json_atomic(path, art)
    history_append(mode, outcome, device.type, card, args.git_rev)
    if art.get("skipped"):
        print(f"bench: skipped for the {budget.seconds:g} s budget: {art['skipped']}",
              file=sys.stderr)
    print(json.dumps(art))
    return 0 if art.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

"""Device times of the port's four hand kernels on the main paths' own inputs.

    python -m tsp_mpi_reduction_tpu_torch.tools.kernel_times [--out FILE]

Needs one CUDA device. It measures, and prints as one JSON line:

- ``prim_chain`` on the inputs of every launch of the eil51 full-size
  solve (k = 1024, capacity 2^18, the default CLI: one-tree, node_ascent
  2, device loop), on those of the first 20 steps of one kroA100 campaign
  chunk (k = 1024, capacity 2^19, node_ascent 6, re-sort every 16), and on
  synthetic half-visited eil51 lanes; per launch: eager and CUDA-graph
  replay ms, the plain chain's ms on a sample, the byte bound, and the
  dependent steps the batch needs (max |U| - 1 over its lanes);
- ``push_rows`` on the inputs of every launch of the same eil51 solve and
  of the kroA100 chunk's first 20 steps: per launch eager and graph-replay
  ms, the plain push's ms, the byte bound, the children one parent pushes
  (largest and mean, per launch) and, where the kernel library has it, the
  launch floor (graph replay of an empty kernel on push_rows' grid);
- ``relax_dense``'s whole DP at the pipeline's full size (n = 16 cities
  per block, 1024 blocks, 1000x1000, float32): ms per solve and per
  launch, eager and by graph replay, the plain per-level loop's ms, and the
  bound of the whole sweep;
- ``relax_minplus`` on the 14 compact steps of the same solve (the
  ``--impl=pallas`` path), rebuilt from the finished dense table: ms per
  launch, eager and by graph replay, the plain step's ms and the bound.

Every recorded or rebuilt input is checked bit for bit against the plain
versions. The functions are shared with ``chip_smoke.py``. The module
measures whatever ``tsp_mpi_reduction_tpu_torch`` it imports, so a copy
dropped into an older checkout of the port (with ``obs/costs.py``, which
holds the counts and the peak row, where that checkout lacks it) times
that checkout's kernels (the per-level ``relax_dense`` before
``relax_dense_sweep``): that is how two trees are compared within one
call on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
from typing import Callable, List, Optional

import torch

# the H100 SXM data-sheet peak row, the bound formula and the kernels'
# byte and operation counts live in obs/costs.py, which the kernel
# wrappers' roofline records (obs.device_costs) read as well
from tsp_mpi_reduction_tpu_torch.obs import costs
from tsp_mpi_reduction_tpu_torch.obs.costs import bound_ms
from tsp_mpi_reduction_tpu_torch.resilience.checkpoint import write_json_atomic

EIL51_ARGV = ["eil51", "--backend=cuda", "--k=1024", "--capacity=262144"]
KRO_ARGV = ["kroA100", "--backend=cuda", "--k=1024", "--capacity=524288", "--node-ascent=6",
            "--reorder-every=16", "--device-loop=on"]
KRO_STEPS, KRO_CHAINS_PER_STEP = 20, 7  # 1 + node_ascent chains a step
DENSE_FULL = (16, 1024, 1000)  # cities per block, blocks, grid side


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of one replay of ``fn`` captured in a CUDA graph,
    by CUDA events: the device time of its launches without the host's
    launch gaps (what a run of tiny launches in eager mode cannot show)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return cuda_ms(graph.replay, reps)


@contextlib.contextmanager
def recorded(module, name: str, keep: Callable, limit: Optional[int] = None):
    """Wrap ``module.name`` for the ``with`` block: each call (the first
    ``limit`` ones) appends ``keep(*args)`` to the yielded list, then runs
    the real function."""
    calls, real = [], getattr(module, name)

    def recorder(*args):
        if limit is None or len(calls) < limit:
            calls.append(keep(*args))
        return real(*args)

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def keep_push(nodes, parents, dest, ccost, cbound, csum, n):
    """A recorded ``push_rows`` launch: the frontier's shape and copies of
    the inputs (the frontier itself is written in place)."""
    return (tuple(nodes.shape), parents.clone(), dest.clone(), ccost.clone(), cbound.clone(), csum.clone())


def keep_prim(dbar, unvis, n, lam=None):
    """A recorded launch: ``dbar`` (the solve's bound table, never written,
    so shared by all launches), copies of ``unvis`` and ``lam``."""
    return dbar, unvis.clone(), n, None if lam is None else lam.clone()


def run_bnb_cli(argv: List[str]) -> dict:
    """The B&B CLI entry point in this process -> its JSON payload."""
    from tsp_mpi_reduction_tpu_torch.tools import bnb_solve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bnb_solve.main(argv)
    if rc != 0:
        raise RuntimeError(f"bnb_solve {argv}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def record_bnb_calls(argv: List[str], prim_limit: Optional[int] = None):
    """The ``prim_chain`` inputs (its first ``prim_limit`` launches) and
    the ``push_rows`` inputs of a B&B CLI run, and the run's payload. The
    run takes its eager steps (``TSP_COMPILE_CACHE=off``): a replayed
    graph calls no wrapper, so only an eager step's inputs can be
    recorded, launch by launch (the same steps, so the same inputs)."""
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels, prim_kernels

    saved = os.environ.get("TSP_COMPILE_CACHE")
    os.environ["TSP_COMPILE_CACHE"] = "off"
    try:
        with recorded(prim_kernels, "prim_chain", keep_prim, prim_limit) as chains, \
                recorded(expand_kernels, "push_rows", keep_push) as pushes:
            out = run_bnb_cli(argv)
    finally:
        if saved is None:
            os.environ.pop("TSP_COMPILE_CACHE", None)
        else:
            os.environ["TSP_COMPILE_CACHE"] = saved
    return chains, pushes, out


def synthetic_prim_calls(k: int = 1024):
    """The eil51 step's three chains (one plain, node_ascent = 2 with
    ``lam``) on random half-visited lanes (torch seed 0)."""
    from tsp_mpi_reduction_tpu_torch.models import branch_bound as bb
    from tsp_mpi_reduction_tpu_torch.utils import tsplib

    d = tsplib.embedded("eil51").distance_matrix()
    n = d.shape[0]
    bd = bb._bound_setup(d, "one-tree", node_ascent=2, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    unvis = (torch.rand((k, n), generator=gen) < 0.5).cuda()
    unvis[:, 0] = False
    lam = torch.randint(-8, 8, (k, n), generator=gen).float().cuda() * float(bd.ascent_step)
    return [(bd.dbar, unvis, n, None), (bd.dbar, unvis, n, lam), (bd.dbar, unvis, n, lam)]


def prim_check(calls) -> int:
    """Hold the kernel against the plain chain on every recorded launch,
    bit for bit (``tot`` as int32 bits, ``deg`` exactly); the plain chain
    runs once per group of launches that share ``n`` and ``dbar`` and
    whether they carry ``lam`` (its lanes are independent). Returns the
    number of lanes compared; raises on a difference."""
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

    groups = {}
    for dbar, unvis, n, lam in calls:
        key = (n, dbar.data_ptr(), lam is None)
        groups.setdefault(key, []).append((dbar, unvis, n, lam))
    lanes = 0
    for group in groups.values():
        dbar, _, n, lam0 = group[0]
        got = [prim_kernels.prim_chain(*c) for c in group]
        unvis = torch.cat([c[1] for c in group])
        lam = None if lam0 is None else torch.cat([c[3] for c in group])
        ref_tot, ref_deg = prim_kernels.prim_chain_reference(dbar, unvis, n, lam)
        tot = torch.cat([t for t, _ in got])
        deg = torch.cat([g for _, g in got])
        torch.cuda.synchronize()
        if not (torch.equal(tot.view(torch.int32), ref_tot.view(torch.int32)) and torch.equal(deg, ref_deg)):
            # a failed check counts the differing lanes once  # graftlint: disable=R1
            bad = int((tot.view(torch.int32) != ref_tot.view(torch.int32)).sum())
            raise RuntimeError(f"prim_chain != plain on recorded inputs (n={n}, {bad} lanes' tot differ)")
        lanes += unvis.shape[0]
    return lanes


def time_prim(calls, what: str, reps: int = 5, plain_sample: int = 12) -> dict:
    """Per-launch times of ``prim_chain`` over the recorded ``calls``."""
    from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

    def kernel_all():
        for c in calls:
            prim_kernels.prim_chain(*c)

    stride = max(1, len(calls) // plain_sample)
    sample = calls[::stride][:plain_sample]

    def plain_some():
        for c in sample:
            prim_kernels.prim_chain_reference(*c)

    kernel_all()
    plain_some()
    eager = cuda_ms(kernel_all, reps) / len(calls)
    device = graph_ms(kernel_all, reps) / len(calls)
    plain = cuda_ms(plain_some, 1) / len(sample)
    bounds = [costs.prim_chain_counts(c[1], c[3] is not None) for c in calls]
    b_ms, b_by = bound_ms(sum(b for b, _ in bounds) / len(calls), sum(o for _, o in bounds) / len(calls),
                          "float32")
    steps = [int((c[1].sum(dim=1).max() - 1).clamp(min=0)) for c in calls]
    sizes = torch.cat([c[1].sum(dim=1) for c in calls]).double()
    return {"what": what, "launches": len(calls), "n": calls[0][2], "k": calls[0][1].shape[0],
            "ms": eager, "device_ms": device, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "dependent_steps_mean": sum(steps) / len(steps), "dependent_steps_max": max(steps),
            "n_minus_1": calls[0][2] - 1, "mean_U": float(sizes.mean())}


def push_bound(calls, k: int, n: int):
    """Bytes and operations one ``push_rows`` launch needs
    (``obs.costs.push_rows_counts``) at the mean n_push of the recorded
    steps. Returns (bytes, ops, n_push)."""
    cols = calls[0][1].shape[1]
    n_push = sum(int(((c[2] >= 0) & (c[2] < c[0][0])).sum()) for c in calls) / len(calls)
    return (*costs.push_rows_counts(k, n, cols, n_push), n_push)


def push_stats(calls) -> dict:
    """The children one parent pushes, per recorded launch: the largest
    and the mean over the k parents (and over the parents that push any),
    then their mean and largest over the launches."""
    per = []
    for shape, _, dest, *_ in calls:
        cnt = ((dest >= 0) & (dest < shape[0])).sum(dim=1).double()
        busy = cnt[cnt > 0]
        per.append((float(cnt.max()), float(cnt.mean()), float(busy.mean()) if busy.numel() else 0.0))
    return {"children_per_parent_max_mean": sum(p[0] for p in per) / len(per),
            "children_per_parent_max_max": max(p[0] for p in per),
            "children_per_parent_mean": sum(p[1] for p in per) / len(per),
            "children_per_pushing_parent_mean": sum(p[2] for p in per) / len(per)}


def push_check(calls, n: int) -> None:
    """Hold the kernel against the plain push on every recorded launch,
    the whole frontier buffer bit for bit; raises on a difference."""
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

    scratch = torch.zeros(calls[0][0], dtype=torch.int32, device="cuda")
    for i, call in enumerate(calls):
        got, want = scratch.clone(), scratch.clone()
        ek.push_rows(got, *call[1:], n)
        ek.push_rows_reference(want, *call[1:], n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"push_rows != plain on recorded launch {i} (n={n})")


def push_floor_ms(k: int, n: int, reps: int, launches: int) -> Optional[float]:
    """Graph-replay ms of an empty kernel on push_rows' grid for k parents
    of n cities, per launch, or None where the library has no such kernel
    (an older checkout)."""
    from tsp_mpi_reduction_tpu_torch.kernels import _build

    lib = _build.push_library()
    if not hasattr(lib, "push_rows_floor_launch"):
        return None

    def floor_all():
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(launches):
            code = lib.push_rows_floor_launch(k, n, stream)
            if code != 0:
                raise RuntimeError(f"push_rows_floor_launch: CUDA error {code}")

    return graph_ms(floor_all, reps) / launches


def time_push(calls, n: int, what: str, reps: int = 5) -> dict:
    """Per-launch times of ``push_rows`` over the recorded ``calls`` into
    one scratch frontier, beside the plain push, the bound and the floor."""
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels as ek

    scratch = torch.zeros(calls[0][0], dtype=torch.int32, device="cuda")
    k = calls[0][1].shape[0]

    def kernel_all():
        for c in calls:
            ek.push_rows(scratch, *c[1:], n)

    def plain_all():
        for c in calls:
            ek.push_rows_reference(scratch, *c[1:], n)

    kernel_all()
    plain_all()
    eager = cuda_ms(kernel_all, reps) / len(calls)
    device = graph_ms(kernel_all, reps) / len(calls)
    plain = cuda_ms(plain_all, 2) / len(calls)
    nbytes, ops, mean_push = push_bound(calls, k, n)
    b_ms, b_by = bound_ms(nbytes, ops, "float32")
    return {"what": what, "launches": len(calls), "n": n, "k": k, "ms": eager, "device_ms": device,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "mean_n_push": mean_push,
            "floor_ms": push_floor_ms(k, n, reps, len(calls)), **push_stats(calls)}


def minplus_inputs(tab, d_sub):
    """The compact step inputs ``g`` of every step of the ``--impl=pallas``
    solve (m - 1 of them, each padded to the widest cardinality), rebuilt
    from the finished dense table ``tab [B, m, 2^m]``, and ``d_t``."""
    from tsp_mpi_reduction_tpu_torch.ops import held_karp

    nb, m, _ = tab.shape
    dev, dt = tab.device, tab.dtype
    _, prev_idx, member = held_karp._plan_tensors(m + 1, str(dev))
    inf_row = torch.full((nb, 1, m), math.inf, dtype=dt, device=dev)
    table_c = torch.cat([tab.permute(0, 2, 1), inf_row], dim=1)  # [B, 2^m + 1, m]
    cols = torch.arange(m, device=dev)
    inf = torch.tensor(math.inf, dtype=dt, device=dev)
    gs = [torch.where(member[s], table_c[:, prev_idx[s], cols], inf) for s in range(m - 1)]
    return gs, d_sub.transpose(1, 2).contiguous()


def time_minplus(gs, d_t, reps: int = 5) -> dict:
    """``relax_minplus`` on every compact step: bit for bit against the
    plain step, then per launch eager and by graph replay."""
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

    plain = []
    for g in gs:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        c_p, p_p = hkk.relax_minplus_reference(g, d_t)
        e1.record()
        c_k, p_k = hkk.relax_minplus(g, d_t)
        torch.cuda.synchronize()
        plain.append(e0.elapsed_time(e1))
        if not (torch.equal(c_k, c_p) and torch.equal(p_k, p_p)):
            raise RuntimeError("relax_minplus != plain step on the full-size compact inputs")
        del c_p, p_p, c_k, p_k

    def minplus_all():
        for g in gs:
            hkk.relax_minplus(g, d_t)

    eager = cuda_ms(minplus_all, reps) / len(gs)
    device = graph_ms(minplus_all, reps) / len(gs)
    bsz, j, m = gs[0].shape
    dt_name = str(gs[0].dtype).removeprefix("torch.")
    b_ms, b_by = bound_ms(*costs.relax_minplus_counts(bsz, j, m, gs[0].element_size()), dt_name)
    return {"what": f"relax_minplus m={m} J={j} B={bsz} {dt_name}", "launches": len(gs), "ms": eager,
            "device_ms": device, "plain_ms": sum(plain) / len(plain), "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": 0.0}


def dense_inputs(n: int, nb: int, grid: int, dtype=torch.float32):
    """``d_sub [B, m, m]`` and the initial table ``[B, m, 2^m]`` of the
    pipeline's blocks on the card."""
    from tsp_mpi_reduction_tpu_torch.models.pipeline import block_distance_slices
    from tsp_mpi_reduction_tpu_torch.ops.generator import generate_instance
    from tsp_mpi_reduction_tpu_torch.utils.state import instance_from_numpy

    _, xy = generate_instance(n, nb, grid, grid)
    _, dist = instance_from_numpy(xy, dtype, torch.device("cuda"))
    block_d = block_distance_slices(dist, nb, n)
    del dist
    m = n - 1
    d_sub = block_d[:, 1:, 1:].contiguous()
    tab = torch.full((nb, m, 1 << m), math.inf, dtype=dtype, device="cuda")
    tab[:, :, 0] = block_d[:, 0, 1:]
    return d_sub, tab


def dense_solve_fn(tab, d_sub):
    """The whole dense DP on ``tab`` in place through the kernel wrapper(s)
    of the imported port, and its launches per solve."""
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

    m = tab.shape[1]
    if hasattr(hkk, "relax_dense_sweep"):
        return (lambda: hkk.relax_dense_sweep(tab, d_sub)), hkk.sweep_launches(m)
    return (lambda: [hkk.relax_dense(tab, d_sub, c) for c in range(1, m)]), m - 1


def time_dense(d_sub, tab, reps: int = 5) -> dict:
    """The dense DP on ``tab`` (the initial table, left finished): the
    kernel(s) against the plain per-level loop, exactly, then timed per
    solve and per launch (the kernels are idempotent on a finished table)."""
    from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk

    bsz, m, _ = tab.shape
    ref = tab.clone()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for c in range(1, m):
        ref = hkk.relax_dense_reference(ref, d_sub, c)
    e1.record()
    solve, launches = dense_solve_fn(tab, d_sub)
    solve()
    torch.cuda.synchronize()
    plain = e0.elapsed_time(e1)
    if not torch.equal(tab, ref):
        raise RuntimeError("relax_dense != plain per-level loop at full size")
    del ref
    eager = cuda_ms(solve, reps)
    device = graph_ms(solve, reps)
    dt_name = str(tab.dtype).removeprefix("torch.")
    b_ms, b_by = bound_ms(*costs.relax_dense_counts(bsz, m, tab.element_size()), dt_name)
    return {"what": f"relax_dense m={m} B={bsz} {dt_name}", "launches_per_solve": launches,
            "ms_per_solve": eager, "device_ms_per_solve": device, "plain_ms_per_solve": plain,
            "bound_ms_per_solve": b_ms, "bound_by": b_by, "max_abs_err": 0.0}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    eil, eil_push, _ = record_bnb_calls(EIL51_ARGV)
    kro, kro_push, _ = record_bnb_calls(KRO_ARGV + [f"--max-iters={KRO_STEPS}"], KRO_STEPS * KRO_CHAINS_PER_STEP)
    lanes = prim_check(eil) + prim_check(kro)
    print(f"prim_chain == plain on {len(eil)} + {len(kro)} recorded launches ({lanes} lanes)", flush=True)
    push_check(eil_push, 51)
    push_check(kro_push, 100)
    print(f"push_rows == plain on {len(eil_push)} + {len(kro_push)} recorded launches", flush=True)
    rows = [time_prim(eil, "prim_chain recorded eil51"), time_prim(kro, "prim_chain recorded kroA100 20 steps"),
            time_prim(synthetic_prim_calls(), "prim_chain synthetic eil51 half-visited", reps=50),
            time_push(eil_push, 51, "push_rows recorded eil51"),
            time_push(kro_push, 100, "push_rows recorded kroA100 20 steps")]
    del eil, kro, eil_push, kro_push
    torch.cuda.empty_cache()
    d_sub, tab = dense_inputs(*DENSE_FULL)
    rows.append(time_dense(d_sub, tab))  # leaves tab finished
    gs, d_t = minplus_inputs(tab, d_sub)
    del tab
    rows.append(time_minplus(gs, d_t))
    del gs
    torch.cuda.empty_cache()
    for r in rows:
        print(json.dumps(r), flush=True)
    result = {"card": smi, "kernel_times": rows}
    line = json.dumps(result)
    if args.out:
        write_json_atomic(args.out, result, indent=None)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

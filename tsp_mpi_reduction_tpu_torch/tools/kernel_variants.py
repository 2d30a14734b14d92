"""Schedule variants of ``relax_minplus`` and ``push_rows``, timed on the card.

    python -m tsp_mpi_reduction_tpu_torch.tools.kernel_variants [--out FILE]

Needs one CUDA device. It rebuilds copies of the committed kernel sources
with other schedule constants (or, for ``push_rows``, with the float
columns read speculatively in the first round) into
``build/torch_ext/variants/``, holds every variant against the plain
version, bit for bit, and times it by CUDA-graph replay on the inputs
``kernel_times`` uses: ``relax_minplus`` on the 14 compact steps of the
full-size pipeline solve, ``push_rows`` on the recorded launches of the
eil51 solve and of the kroA100 chunk's first 20 steps, each beside the
launch floor of its own grid. The committed constants are the first entry
of each list. It prints one JSON line; this is how those constants were
chosen (``PERF.md`` §6).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import List, Optional

import torch

from ..kernels import _build
from ..resilience.checkpoint import write_json_atomic
from . import kernel_times as kt

MINPLUS_PASSES = "constexpr int kMinplusPasses = 16;"
MINPLUS_THREADS = "constexpr int kMinplusMaxThreads = 256;"
#: name -> list of (text in held_karp_relax.cu, its replacement)
MINPLUS_VARIANTS = {
    "16 passes, 256 threads": [],
    "8 passes, 256 threads": [(MINPLUS_PASSES, "constexpr int kMinplusPasses = 8;")],
    "16 passes, 128 threads": [(MINPLUS_THREADS, "constexpr int kMinplusMaxThreads = 128;")],
    "32 passes, 128 threads": [(MINPLUS_PASSES, "constexpr int kMinplusPasses = 32;"),
                               (MINPLUS_THREADS, "constexpr int kMinplusMaxThreads = 128;")],
}
PUSH_SPLIT = "constexpr int kSplit = 2;"
PUSH_ROUND2 = """  uint32_t fc = 0u, fb = 0u, fs = 0u;
  if (pushed) {
    fc = static_cast<uint32_t>(ccost[at]);
    fb = static_cast<uint32_t>(cbound[at]);
    fs = static_cast<uint32_t>(csum[at]);
  }
"""
PUSH_ROUND1 = "  bool pushed = my_dst >= 0 && my_dst < f_rows;\n"
PUSH_SPECULATIVE = ("  uint32_t fc = 0u, fb = 0u, fs = 0u;\n"
                    "  if (c0 + lane < n) { fc = ccost[at]; fb = cbound[at]; fs = csum[at]; }\n")
#: name -> list of (text in push_rows.cu, its replacement)
PUSH_VARIANTS = {
    "split 2": [],
    "split 1": [(PUSH_SPLIT, "constexpr int kSplit = 1;")],
    "split 4": [(PUSH_SPLIT, "constexpr int kSplit = 4;")],
    "split 8": [(PUSH_SPLIT, "constexpr int kSplit = 8;")],
    # every child's float columns read with dest: one dependent round less,
    # 3 * k * n * 4 bytes read where the pushed children need 3 * n_push * 4
    "split 2, floats read speculatively": [(PUSH_ROUND2, ""), (PUSH_ROUND1, PUSH_SPECULATIVE + PUSH_ROUND1)],
}


def variant_library(source, name: str, edits) -> ctypes.CDLL:
    """Build ``source`` with ``edits`` applied under a name of its own."""
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"kernel_variants: {source.name} no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "variants" / f"{source.stem}_{name.replace(' ', '_').replace(',', '')}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return ctypes.CDLL(str(_build.build(out)))


def time_minplus_variants(gs, d_t, reps: int = 5) -> List[dict]:
    from ..ops import held_karp_kernels as hkk

    vp, i = ctypes.c_void_p, ctypes.c_int
    bsz, j, m = gs[0].shape
    rows = []
    for name, edits in MINPLUS_VARIANTS.items():
        lib = variant_library(_build.SOURCES[0], name, edits)
        lib.hk_relax_minplus.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        cost = torch.empty_like(gs[0])
        parent = torch.empty(gs[0].shape, dtype=torch.int32, device=gs[0].device)

        def step(g, lib=lib, cost=cost, parent=parent):
            code = lib.hk_relax_minplus(g.data_ptr(), d_t.data_ptr(), cost.data_ptr(), parent.data_ptr(),
                                        bsz, j, m, 0, torch.cuda.current_stream().cuda_stream)
            _build.check(code, f"relax_minplus variant {name}")

        for g in gs:
            step(g)
            c_w, p_w = hkk.relax_minplus_reference(g, d_t)
            if not (torch.equal(cost, c_w) and torch.equal(parent, p_w)):
                raise RuntimeError(f"relax_minplus variant {name} != plain step")
            del c_w, p_w
        device = kt.graph_ms(lambda: [step(g) for g in gs], reps) / len(gs)
        rows.append({"kernel": "relax_minplus", "variant": name, "device_ms": device})
    return rows


def time_push_variants(calls, n: int, what: str, reps: int = 5) -> List[dict]:
    from ..ops import expand_kernels as ek

    vp, i = ctypes.c_void_p, ctypes.c_int
    (f_rows, cols), k = calls[0][0], calls[0][1].shape[0]
    scratch = torch.zeros((f_rows, cols), dtype=torch.int32, device="cuda")
    rows = []
    for name, edits in PUSH_VARIANTS.items():
        lib = variant_library(_build.SOURCES[2], name, edits)
        lib.push_rows_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.push_rows_floor_launch.argtypes = [i, i, vp]

        def push(buf, c, lib=lib):
            code = lib.push_rows_launch(buf.data_ptr(), *(t.data_ptr() for t in c[1:]), f_rows, cols, k, n,
                                        torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"push_rows variant {name}: CUDA error {code}")

        for c in calls:
            got, want = scratch.clone(), scratch.clone()
            push(got, c)
            ek.push_rows_reference(want, *c[1:], n)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"push_rows variant {name} != plain push ({what})")

        def floor_all(lib=lib):
            for _ in calls:
                lib.push_rows_floor_launch(k, n, torch.cuda.current_stream().cuda_stream)

        rows.append({"kernel": "push_rows", "variant": name, "inputs": what,
                     "device_ms": kt.graph_ms(lambda: [push(scratch, c) for c in calls], reps) / len(calls),
                     "floor_ms": kt.graph_ms(floor_all, reps) / len(calls)})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import held_karp_kernels as hkk

    smi = kt.card()
    print(smi, flush=True)
    _, eil, _ = kt.record_bnb_calls(kt.EIL51_ARGV, 0)
    _, kro, _ = kt.record_bnb_calls(kt.KRO_ARGV + [f"--max-iters={kt.KRO_STEPS}"], 0)
    rows = time_push_variants(eil, 51, "recorded eil51") + time_push_variants(kro, 100, "recorded kroA100 20 steps")
    del eil, kro
    d_sub, tab = kt.dense_inputs(*kt.DENSE_FULL)
    hkk.relax_dense_sweep(tab, d_sub)
    gs, d_t = kt.minplus_inputs(tab, d_sub)
    del tab
    rows += time_minplus_variants(gs, d_t)
    for r in rows:
        print(json.dumps(r), flush=True)
    result = {"card": smi, "kernel_variants": rows}
    line = json.dumps(result)
    if args.out:
        write_json_atomic(args.out, result, indent=None)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

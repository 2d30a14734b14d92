"""Long-run B&B campaign of the port: chunks of search in FRESH processes.

    python -m tsp_mpi_reduction_tpu_torch.tools.bnb_chunked kroA100 --chunk-iters=300 \\
        --max-chunks=20 --checkpoint=camp.npz --k=1024 --capacity=524288 \\
        --node-ascent=6 --reorder-every=16 [other bnb_solve args passed through]

Counterpart of ``tools/bnb_chunked.py``. Every chunk is one
``python -m tsp_mpi_reduction_tpu_torch.tools.bnb_solve <instance>
--device-loop=on --max-iters=<chunk-iters> --checkpoint=P [--resume=P]``
subprocess: it resumes the previous chunk's snapshot and leaves its own,
so a campaign survives the loss of any one process, and each chunk is a
unit a scheduler can place, time out and retry. Arguments the driver does
not know (``--backend``, ``--k``, ...) pass through to every chunk
unchanged; ``bnb_solve``'s default backend demands a GPU, so a campaign
on the CPU says ``--backend=cpu``.

Prints one JSON line per chunk (``bnb_solve``'s) and a final summary
line. The campaign opens a ``bnb.campaign`` span and one
``campaign.chunk`` span per attempt; each chunk process attaches its
``bnb.solve`` span under its attempt through ``TSP_TRACE_PARENT``, so a
campaign traced to ``TSP_TRACE`` is one span tree. Unlike the JAX
driver's, the summary carries no compile-cache block: the port's kernels
are built once into ``build/torch_ext/`` and loaded by every chunk. The
chunks share one root-ascent memo directory (``TSP_COMPILE_CACHE``, by
default ``compile_cache/`` beside the checkpoint), so chunk 2 onwards
reads the ascent's potentials instead of running it; each chunk's line
carries the memo's hits and misses.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

from ..obs import tracing as _tracing
from ..perf import ascent_memo as _memo
from ..resilience import checkpoint as _ck

#: the directory that holds the package, for the chunks' ``python -m``
_ROOT = str(pathlib.Path(__file__).resolve().parents[2])


def _ckpt_candidates(ckpt_path: str) -> list:
    """Existing snapshots in the rotation chain, newest first. A writer
    killed inside the store's rotation window leaves the primary path
    missing while ``.1`` still holds the campaign, so the chain counts,
    not the primary alone."""
    return [p for p in _ck.rotation_paths(ckpt_path) if os.path.exists(p)]


def _verify_resume_fingerprint(ckpt_path: str, instance_spec: str) -> str:
    """Pre-flight of ``--resume-existing``: a snapshot whose header names
    another instance's fingerprint is refused before any chunk runs.
    Returns "" when the resume is safe, else the error message. A
    headerless (legacy) snapshot skips the pre-flight; the solver's
    payload fingerprint still guards it inside the chunk."""
    from ..utils import tsplib

    header = None
    for cand in _ckpt_candidates(ckpt_path):
        try:
            header = _ck.read_header(cand)
            break
        except (_ck.CheckpointError, OSError):
            # a corrupt candidate is the rotation fallback's business
            # inside the chunk, not a mismatch: try an older header
            continue
    if not header or not header.get("fingerprint"):
        return ""
    try:
        inst = tsplib.resolve_instance(instance_spec)
    except (ValueError, OSError) as e:
        return f"error: cannot resolve instance {instance_spec!r}: {e}"
    want = _ck.instance_fingerprint(inst.distance_matrix())
    if header["fingerprint"] != want:
        return (
            f"error: checkpoint {ckpt_path!r} was written for a different instance "
            f"(fingerprint {header['fingerprint']} != {want} for {instance_spec!r}); "
            "resuming it would continue the wrong search: point --checkpoint "
            "elsewhere or remove the file"
        )
    return ""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bnb_chunked", description="chunked B&B campaign (PyTorch/CUDA)")
    ap.add_argument("instance")
    ap.add_argument("--chunk-iters", type=int, default=200_000,
                    help="expansion-step budget per chunk (= subprocess)")
    ap.add_argument("--max-chunks", type=int, default=10)
    ap.add_argument("--time-limit", type=float, default=None,
                    help="total wall budget across chunks (seconds)")
    ap.add_argument("--checkpoint", default=None, help="checkpoint path (default: a temp file)")
    ap.add_argument("--resume-existing", action="store_true",
                    help="continue from a pre-existing checkpoint at --checkpoint instead of "
                    "refusing it")
    ap.add_argument("--chunk-timeout", type=float, default=3600.0,
                    help="hard per-chunk wall cap")
    ap.add_argument("--chunk-retries", type=int, default=1,
                    help="re-run a crashed or hung chunk this many times before aborting the "
                    "campaign; the retry resumes from the newest valid snapshot")
    ap.add_argument("--lb-stall-gain", type=float, default=None,
                    help="stop when the certified lower bound gains less than this per chunk, "
                    "averaged over the last --lb-stall-chunks chunks")
    ap.add_argument("--lb-stall-chunks", type=int, default=5)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, passthrough = ap.parse_known_args(argv)
    if args.max_chunks < 1:
        ap.error("--max-chunks must be >= 1")

    ckpt = args.checkpoint or os.path.join(tempfile.mkdtemp(prefix="bnb_chunked_"), "chunk.npz")
    ckpt_real = ckpt if ckpt.endswith(".npz") else ckpt + ".npz"
    if _ckpt_candidates(ckpt_real) and not args.resume_existing:
        print(f"error: checkpoint {ckpt_real!r} already exists (or its rotation snapshots do); "
              "a fresh run would continue it: pass --resume-existing to do that intentionally, "
              "or remove the file(s)", file=sys.stderr)
        return 2
    if _ckpt_candidates(ckpt_real) and args.resume_existing:
        err = _verify_resume_fingerprint(ckpt_real, args.instance)
        if err:
            print(err, file=sys.stderr)
            return 2
    t0 = time.perf_counter()
    last = None
    lb_history: list = []
    stalled = False
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, child_env.get("PYTHONPATH")) if p)
    # every chunk shares one memo dir: chunk 1 writes the root ascent's
    # potentials, later chunks read them (a campaign-local dir next to the
    # checkpoint unless TSP_COMPILE_CACHE says otherwise, "off" included)
    if _memo.ENV_VAR not in child_env:
        child_env[_memo.ENV_VAR] = os.path.join(os.path.dirname(os.path.abspath(ckpt_real)) or ".",
                                                "compile_cache")
    # one campaign = one span tree: the root opens here (under a caller's
    # TSP_TRACE_PARENT, if any), each chunk attempt is a child span, and
    # each chunk process's bnb.solve span attaches under its attempt
    campaign_cm = _tracing.span("bnb.campaign", parent=_tracing.parent_from_env(),
                                instance=args.instance, max_chunks=args.max_chunks)
    with campaign_cm as campaign:
        for chunk in range(1, args.max_chunks + 1):
            line = None
            # a failed attempt is re-run: the store keeps the newest VALID
            # snapshot on disk, so the retry resumes from it. The command is
            # rebuilt per attempt: the first crash may have just created the
            # snapshot to resume
            for attempt in range(args.chunk_retries + 1):
                # a retry never overruns the campaign's wall budget
                chunk_cap = args.chunk_timeout
                if args.time_limit is not None:
                    remaining = args.time_limit - (time.perf_counter() - t0)
                    if remaining <= 0:
                        print(f"chunk {chunk}: wall budget exhausted (no retry attempted)",
                              file=sys.stderr)
                        break
                    chunk_cap = min(chunk_cap, remaining + 30.0)  # grace: JSON flush
                cmd = [sys.executable, "-m", "tsp_mpi_reduction_tpu_torch.tools.bnb_solve",
                       args.instance, "--device-loop=on", f"--max-iters={args.chunk_iters}",
                       f"--checkpoint={ckpt}"]
                if _ckpt_candidates(ckpt_real):
                    # restore falls back through the rotation chain, so
                    # --resume is right even when the primary file was lost
                    cmd.append(f"--resume={ckpt}")
                if args.time_limit is not None:
                    cmd.append(f"--time-limit={max(remaining, 1.0)}")
                cmd += passthrough
                retry_note = (f" — retrying ({attempt + 1}/{args.chunk_retries})"
                              if attempt < args.chunk_retries else "")
                with _tracing.span("campaign.chunk", chunk=chunk, attempt=attempt) as csp:
                    parent_token = _tracing.format_parent(csp.context)
                    if parent_token is not None:
                        child_env[_tracing.ENV_PARENT] = parent_token
                    try:
                        r = subprocess.run(cmd, capture_output=True, text=True, timeout=chunk_cap,
                                           env=child_env)
                    except subprocess.TimeoutExpired:
                        csp.set("timeout_s", round(chunk_cap, 1))
                        csp.event("chunk_timeout")
                        print(f"chunk {chunk}: timed out after {chunk_cap:.0f}s{retry_note}",
                              file=sys.stderr)
                        continue
                    csp.set("rc", r.returncode)
                sys.stderr.write(r.stderr[-2000:])
                out = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
                if r.returncode == 0 and out.startswith("{"):
                    line = out
                    break
                campaign.event("chunk_retry", chunk=chunk, rc=r.returncode)
                print(f"chunk {chunk}: solver failed rc={r.returncode}{retry_note}", file=sys.stderr)
            if line is None:
                return 1
            last = json.loads(line)
            print(line, flush=True)
            elapsed = time.perf_counter() - t0
            if last["proven_optimal"]:
                break
            if args.time_limit is not None and elapsed > args.time_limit:
                break
            # the stall rule reads the CERTIFIED (monotone) LB, which the
            # snapshot carries from chunk to chunk
            lb_cert = last.get("lb_certified", last["lower_bound"])
            if args.lb_stall_gain is not None and lb_cert is not None:
                lb_history.append(float(lb_cert))
                w = args.lb_stall_chunks
                if len(lb_history) > w and lb_history[-1] - lb_history[-1 - w] < args.lb_stall_gain * w:
                    stalled = True
                    print(f"chunk {chunk}: LB climb flattened "
                          f"(+{lb_history[-1] - lb_history[-1 - w]:.2f} over the last {w} chunks "
                          f"< {args.lb_stall_gain}/chunk) — stopping at exhaustion", file=sys.stderr)
                    break
        assert last is not None
        # the summary's certified LB is also the max over every chunk seen
        lb_final = last.get("lb_certified", last["lower_bound"])
        if lb_history:
            lb_final = max([lb_final] + lb_history) if lb_final is not None else max(lb_history)
        print(json.dumps({
            "summary": True,
            "instance": last["instance"],
            "chunks": chunk,
            "cost": last["cost"],
            "proven_optimal": last["proven_optimal"],
            "lower_bound": lb_final,
            "lb_raw": last.get("lb_raw"),
            "lb_certified": lb_final,
            "gap": round(last["cost"] - lb_final, 3) if lb_final is not None else None,
            "lb_stalled": stalled,
            "total_wall_s": round(time.perf_counter() - t0, 1),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

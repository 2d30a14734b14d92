"""The port's bench-history gate and history appender (torch-free).

Counterpart of the root ``tools/bench_check.py``, on the port's history
(``bench_history_torch.jsonl``, ``obs/bench_history.py``). Two
subcommands (default: ``check``):

``check``   read the history, evaluate every governed metric's newest
            sample against its prior samples in its group (median + MAD,
            ``obs.bench_history.DEFAULT_RULES`` merged under ``--rules``),
            print a verdict table (``--json``: one JSON object), exit 1 on
            any regression and 0 when every verdict is ``ok`` or
            ``insufficient``.
``append``  turn a ``BENCH_*.json`` artifact into one history record
            (``--mode``, ``--backend``) through the same locked appender
            the harness uses. ``TSP_BENCH_HISTORY=off`` skips it unless
            ``--history`` names a file; exit 2 for an unreadable artifact
            or one without a ``metric``.

Usage:
    python -m tsp_mpi_reduction_tpu_torch.tools.bench_check [check] [--history PATH] \
        [--rules RULES.json] [--json]
    python -m tsp_mpi_reduction_tpu_torch.tools.bench_check append \
        build/bench_torch/BENCH_PIPELINE.json --mode pipeline [--backend cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..obs import bench_history as bh

#: the checkout's root, where the default history lives
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_check(history: str, rules_path: Optional[str], as_json: bool) -> int:
    rules = bh.load_rules(rules_path) if rules_path else None
    records = bh.read(history)
    verdicts = bh.check(records, rules)
    regressions = [v for v in verdicts if v.status == "regression"]
    if as_json:
        print(json.dumps({
            "history": history,
            "records": len(records),
            "verdicts": [v.as_dict() for v in verdicts],
            "regressions": len(regressions),
            "ok": not regressions,
        }))
        return 1 if regressions else 0
    if not records:
        print(f"bench-check: no history at {history}: nothing to gate "
              "(run the port's tools/bench.py to start one)")
        return 0
    print(f"bench-check: {len(records)} records in {history}")
    mark = {"ok": "ok ", "regression": "FAIL", "insufficient": "n/a ", "no_value": "n/a "}
    for v in verdicts:
        print(f"  [{mark.get(v.status, '?')}] {v.metric} ({v.group}, {v.samples} samples): "
              f"{v.detail or v.status}")
    if regressions:
        print(f"bench-check: {len(regressions)} regression(s): the newest sample is worse "
              "than its history allows")
        return 1
    print("bench-check: no regressions")
    return 0


def run_append(artifact_path: str, mode: str, history: str, backend: Optional[str]) -> int:
    try:
        with open(artifact_path, encoding="utf-8") as fh:
            artifact = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read artifact {artifact_path!r}: {e}", file=sys.stderr)
        return 2
    if not isinstance(artifact, dict) or artifact.get("metric") is None:
        print(f"error: {artifact_path!r} has no 'metric' headline: not a bench artifact",
              file=sys.stderr)
        return 2
    record = bh.make_record(
        mode, artifact,
        config={"artifact": os.path.basename(artifact_path)},
        backend=backend or "unknown",
    )
    bh.append(history, record)
    print(f"appended {artifact['metric']}={artifact.get('value')} -> {history}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        argv.insert(0, "check")
    ap = argparse.ArgumentParser(prog="bench_check",
                                 description="the port's bench-history gate / history appender")
    sub = ap.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="gate on the history (default)")
    chk.add_argument("--history", default=None, metavar="PATH")
    chk.add_argument("--rules", default=None, metavar="RULES.json",
                     help="per-metric overrides merged over the defaults")
    chk.add_argument("--json", action="store_true", dest="as_json")
    app = sub.add_parser("append", help="append a BENCH_*.json artifact")
    app.add_argument("artifact")
    app.add_argument("--mode", required=True, help="bench mode that produced the artifact")
    app.add_argument("--history", default=None, metavar="PATH")
    app.add_argument("--backend", default=None, help="backend label (cuda, cpu)")
    args = ap.parse_args(argv)
    resolved = bh.resolve_history_path(REPO_ROOT)
    if args.cmd == "append":
        history = args.history or resolved
        if history is None:
            # TSP_BENCH_HISTORY=off silences appends; it does not disable the gate
            print("history disabled (TSP_BENCH_HISTORY=off): append skipped")
            return 0
        return run_append(args.artifact, args.mode, history, args.backend)
    history = args.history or resolved or os.path.join(REPO_ROOT, bh.DEFAULT_PATH)
    return run_check(history, args.rules, args.as_json)


if __name__ == "__main__":
    sys.exit(main())

"""CLI: ``python -m tsp_mpi_reduction_tpu_torch.analysis [paths...]``.

Runs BOTH analysis passes over the same surface against one shared
baseline: graftlint (per-node AST rules R1-R8, R13, R14) and graftflow (the
interprocedural dataflow rules R9-R12), each re-targeted at the port's
torch/CUDA hazards. The default surface is the port package (its
``tools/`` included) and ``chip_smoke.py``. Exit status 0 when the tree
is clean modulo the checked-in baseline, 1 when new violations or dead
baseline entries exist, 2 on usage errors. Runs stdlib-only (no torch
import), so it is safe as the first stage of the port's sweep even on a
machine with no device.

Machine-readable outputs:

- ``--json``: one JSON object on stdout with PER-RULE new/baselined/
  waived counts plus stale/dead fingerprints, so a ratchet can tell "new
  R9 finding" from "stale baseline entry" without scraping the text
  report (``waived``: sites an inline ``# graftlint: disable`` accepts).
- ``--sarif PATH``: the combined run's NEW findings as a SARIF 2.1.0 log
  (CI annotation ingestion; rule catalog embedded).
"""

from __future__ import annotations

import json
import pathlib
import sys

from .graftflow import FLOW_RULES, flow_project
from .graftlint import (
    RULES,
    _iter_py_files,
    apply_baseline,
    find_dead_scopes,
    lint_text,
    load_baseline,
    write_baseline,
)

ALL_RULES = {**RULES, **FLOW_RULES}

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent  # the package
_REPO_ROOT = _PKG_DIR.parent
_DEFAULT_BASELINE = pathlib.Path(__file__).resolve().parent / "graftlint_baseline.json"
#: default lint surface: the package (its tools/ included) plus the card
#: smoke script, which drives the same paths (tests are excluded — their
#: fixtures intentionally contain violating snippets)
_DEFAULT_TARGETS = [_PKG_DIR, _REPO_ROOT / "chip_smoke.py"]


def run_analyses(targets, rules, waived=None):
    """Both passes over ``targets``; one combined, ordered violation list.

    The surface is read ONCE and the {path: source} map is fed to both
    passes, so the two-pass gate pays file I/O and ``ast.parse`` once a
    file per pass. The per-node pass's inline-waived violations are
    appended to ``waived`` when a list is given."""
    lint_rules = rules & set(RULES)
    flow_rules = rules & set(FLOW_RULES)
    sources = {}
    for f in _iter_py_files(targets):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        try:
            rel = f.resolve().relative_to(_REPO_ROOT.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        sources[rel] = source
    violations = []
    if lint_rules:
        for rel, source in sources.items():
            try:
                violations.extend(lint_text(source, rel, rules=lint_rules, waived=waived))
            except SyntaxError:
                continue
    if flow_rules:
        violations.extend(flow_project(sources, rules=flow_rules))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations


def _per_rule_counts(res, waived=()) -> dict:
    out = {rid: {"new": 0, "baselined": 0, "waived": 0} for rid in sorted(ALL_RULES)}
    for key, group in (("new", res.new), ("baselined", res.accepted), ("waived", waived)):
        for v in group:
            out.setdefault(v.rule, {"new": 0, "baselined": 0, "waived": 0})[key] += 1
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="torch/CUDA-hazard lint of the port: graftlint (R1-R8, R13, R14) + "
        "graftflow (R9-R12)",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        type=pathlib.Path,
        help="files/dirs to lint (default: the port package and chip_smoke.py)",
    )
    ap.add_argument(
        "--rules",
        default=",".join(sorted(ALL_RULES)),
        help="comma-separated rule subset (default: all of R1-R14)",
    )
    ap.add_argument(
        "--baseline",
        type=pathlib.Path,
        default=_DEFAULT_BASELINE,
        help="baseline JSON of accepted sites (shared by both passes)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every violation, ignoring the baseline",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept the current violations as the new baseline",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="machine-readable summary with per-rule counts on stdout",
    )
    ap.add_argument(
        "--sarif",
        type=pathlib.Path,
        default=None,
        metavar="PATH",
        help="write NEW findings as a SARIF 2.1.0 log for CI annotations",
    )
    ap.add_argument(
        "--quiet", action="store_true", help="summary line only"
    )
    args = ap.parse_args(argv)

    rules = {r.strip() for r in args.rules.split(",") if r.strip()}
    unknown = rules - set(ALL_RULES)
    if unknown:
        print(f"graftlint: unknown rule(s): {', '.join(sorted(unknown))}")
        return 2

    if args.paths:
        # an explicit path that doesn't exist is a usage error, not a
        # clean run — a typo'd CI invocation must not turn the gate green
        missing = [p for p in args.paths if not p.exists()]
        if missing:
            print(
                "graftlint: no such path(s): "
                + ", ".join(str(p) for p in missing)
            )
            return 2
        targets = list(args.paths)
    else:
        targets = [p for p in _DEFAULT_TARGETS if p.exists()]
    waived = []
    violations = run_analyses(targets, rules, waived)

    if args.write_baseline:
        if args.json or args.sarif is not None:
            # --write-baseline short-circuits reporting: honoring the
            # combination silently (no SARIF file, non-JSON stdout) would
            # break whatever pipeline asked for it — refuse loudly
            print(
                "graftlint: --write-baseline cannot be combined with "
                "--json/--sarif (it writes the baseline and exits)"
            )
            return 2
        if args.paths and args.baseline == _DEFAULT_BASELINE:
            # a partial lint surface must not clobber the repo-wide
            # baseline (it would drop every accepted site outside `paths`)
            print(
                "graftlint: refusing --write-baseline for explicit paths "
                "into the default baseline; pass --baseline PATH"
            )
            return 2
        write_baseline(args.baseline, violations)
        print(
            f"graftlint: baseline written to {args.baseline} "
            f"({len(violations)} accepted sites)"
        )
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    res = apply_baseline(violations, baseline)
    # stale-DEBT detector: a baseline entry whose file/scope is gone from
    # the source can never be repaid — it only masks a future violation
    # that happens to reuse the fingerprint. Fail, don't warn. A dead
    # entry necessarily also matched no violation, so drop it from the
    # (warn-only) stale list — one entry, one verdict. Applies to both
    # passes: the fingerprints share one grammar and one file.
    dead = find_dead_scopes(baseline, _REPO_ROOT)
    stale = [fp for fp in res.stale if fp not in set(dead)]

    if args.sarif is not None:
        from .sarif import write_sarif

        write_sarif(args.sarif, res.new, ALL_RULES)

    if args.json:
        print(
            json.dumps(
                {
                    "new": len(res.new),
                    "baselined": len(res.accepted),
                    "stale": stale,
                    "dead": dead,
                    "per_rule": _per_rule_counts(res, waived),
                    "targets": len(targets),
                    "rules": sorted(rules),
                    "violations": [
                        {
                            "path": v.path,
                            "line": v.line,
                            "rule": v.rule,
                            "scope": v.scope,
                            "message": v.message,
                        }
                        for v in res.new
                    ],
                },
                indent=2,
            )
        )
        return 1 if (res.new or dead) else 0

    if not args.quiet:
        for v in res.new:
            print(v.render())
        for fp in stale:
            print(f"graftlint: stale baseline entry (fixed? regenerate): {fp}")
    for fp in dead:
        print(
            "graftlint: DEAD baseline entry (scope gone from source — "
            f"delete it or regenerate the baseline): {fp}"
        )
    print(
        f"graftlint: {len(res.new)} new, {len(res.accepted)} baselined, "
        f"{len(stale)} stale, {len(dead)} dead baseline entries "
        f"({len(targets)} target(s), rules {','.join(sorted(rules))})"
    )
    return 1 if (res.new or dead) else 0


if __name__ == "__main__":
    sys.exit(main())

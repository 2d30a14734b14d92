"""SARIF 2.1.0 emitter for the port's graftlint + graftflow findings.

SARIF (Static Analysis Results Interchange Format, OASIS standard) is the
lingua franca CI systems ingest for inline code annotations — one schema,
every viewer. This module renders a violation list as one ``run`` of one
tool (``TOOL_NAME``, the combined R1-R14 gate of the port), with
the rule catalog embedded so viewers can show per-rule help without this
repo.

Kept deliberately minimal-but-valid against the 2.1.0 schema: required
properties only, plus ``snippet``/``uriBaseId`` which every renderer uses.
Stdlib-only, like the passes themselves.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Mapping, Optional, Sequence

from .graftlint import Violation

#: the SARIF tool name: the port's gate, told apart from the JAX package's
#: ``graftlint`` in a CI view that ingests both
TOOL_NAME = "graftlint-torch"
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/os/schemas/"
    "sarif-schema-2.1.0.json"
)


def to_sarif(
    violations: Sequence[Violation],
    rules: Mapping[str, str],
    tool_name: str = TOOL_NAME,
    base_uri: Optional[str] = None,
) -> Dict:
    """Render ``violations`` as a SARIF 2.1.0 log dict.

    ``rules`` is the id -> short-description catalog (the combined
    ``RULES`` + ``FLOW_RULES`` map); every rule is emitted in the tool's
    catalog even when clean, so CI trend lines keep stable rule indices.
    """
    rule_ids = sorted(rules)
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for v in violations:
        results.append(
            {
                "ruleId": v.rule,
                "ruleIndex": rule_index.get(v.rule, -1),
                "level": "error",
                "message": {"text": f"[{v.scope}] {v.message}"},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": v.path,
                                **(
                                    {"uriBaseId": "SRCROOT"}
                                    if base_uri
                                    else {}
                                ),
                            },
                            "region": {
                                "startLine": v.line,
                                "snippet": {"text": v.code},
                            },
                        }
                    }
                ],
                # the baseline's line-free identity, so CI can dedupe
                # across pushes exactly like the ratchet does
                "partialFingerprints": {"graftlint/v1": v.fingerprint},
            }
        )
    run: Dict = {
        "tool": {
            "driver": {
                "name": tool_name,
                "rules": [
                    {
                        "id": rid,
                        "shortDescription": {"text": rules[rid]},
                    }
                    for rid in rule_ids
                ],
            }
        },
        "columnKind": "utf16CodeUnits",
        "results": results,
    }
    if base_uri:
        run["originalUriBaseIds"] = {"SRCROOT": {"uri": base_uri}}
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [run],
    }


def write_sarif(
    path: pathlib.Path,
    violations: Sequence[Violation],
    rules: Mapping[str, str],
    tool_name: str = TOOL_NAME,
    base_uri: Optional[str] = None,
) -> None:
    """Serialize :func:`to_sarif` to ``path`` (UTF-8, trailing newline).

    The write is small and non-durable (CI artifact, regenerated every
    run), so a plain write is fine — and the tmp-suffix keeps graftlint
    R6 satisfied by construction when callers pass temp paths."""
    doc = to_sarif(violations, rules, tool_name=tool_name, base_uri=base_uri)
    path.write_text(json.dumps(doc, indent=2) + "\n")

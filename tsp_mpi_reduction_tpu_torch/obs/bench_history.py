"""Bench history of the port and its median/MAD regression gate.

Counterpart of ``tsp_mpi_reduction_tpu/obs/bench_history.py``, stdlib
only: importing it loads neither torch nor jax (versions are read from
``sys.modules`` when the caller already loaded them, the card from
``nvidia-smi``).

Every run of the port's harness (``tools/bench.py``) appends one
fingerprinted record to ``bench_history_torch.jsonl``: what was measured
(``metric``/``value``/``unit``, the headline of its ``BENCH_*.json``
artifact) and under which conditions (git rev, torch and CUDA versions,
backend, the card's name and power limit, a hash of the bench's config
knobs). ``tools/bench_check.py`` compares the newest sample of every
governed metric against the median of its prior samples in the same
group and fails on a regression.

The port writes its own file, never the JAX package's
``bench_history.jsonl``: the metric names are shared on purpose, so the
two histories stay apart by file and, when a user points both packages at
one file, by group: :func:`check` groups on (framework, backend, card
name, power limit, config hash, host). A record without ``framework`` is
the JAX package's. A port record never votes with a JAX record, and one
card (or one card at another power limit) never votes with another.

Append discipline: one ``O_APPEND`` write of one complete line under an
``flock``, then ``fsync``: concurrent writers interleave whole lines, and a
torn tail from a hard kill is skipped by :func:`read`.

Detection model (:func:`check`), as in the JAX module: per metric and
group, the newest value regresses when its direction-adjusted deviation
from the median of the PRIOR samples exceeds
``max(rel_threshold * |median|, abs_threshold, mad_k * 1.4826 * MAD)``.
Below ``min_samples`` prior samples the verdict is ``insufficient``,
recorded and never failing.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from statistics import median as _median
from typing import Any, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1

#: the history path, or "off" to disable appending; the JAX package's
#: variable, so one setting (the test suite's "off") covers both packages
ENV_VAR = "TSP_BENCH_HISTORY"
_DISABLED = ("off", "0", "none", "disabled")
#: the port's own file beside the JAX package's ``bench_history.jsonl``
DEFAULT_PATH = "bench_history_torch.jsonl"
FRAMEWORK = "torch"

#: seconds ``nvidia-smi`` may take before the card counts as absent
_SMI_TIMEOUT_S = 10.0


def resolve_history_path(default_dir: Optional[str] = None) -> Optional[str]:
    """The configured history path, or None when appending is disabled."""
    val = os.environ.get(ENV_VAR)
    if val is None:
        base = default_dir if default_dir is not None else os.getcwd()
        return os.path.join(base, DEFAULT_PATH)
    val = val.strip()
    if not val or val.lower() in _DISABLED:
        return None
    return val


# -- fingerprinting ------------------------------------------------------------


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Short rev of the working tree the bench ran in (None outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10.0,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def config_hash(config: Dict[str, Any]) -> str:
    """Stable digest of the bench's config knobs: two records compare only
    when they measured the same thing the same way."""
    payload = json.dumps(config, sort_keys=True, default=str)
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def host_fingerprint() -> str:
    """Digest of the measuring host's hardware class: arch + logical cores
    + CPU model string, not the hostname (the JAX module's digest, so the
    two agree on one host). The card is not in it: it has its own keys."""
    model = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for line in fh:
                if line.lower().startswith(("model name", "hardware", "cpu model")):
                    model = line.partition(":")[2].strip()
                    break
    except OSError:
        pass
    import platform

    payload = f"{platform.machine()}|{os.cpu_count()}|{model}"
    return hashlib.blake2b(payload.encode(), digest_size=6).hexdigest()


def _parse_watts(text: str) -> Optional[float]:
    """``"700.00 W"`` -> 700.0; None for ``[N/A]`` or anything else."""
    try:
        return float(text.strip().split()[0])
    except (IndexError, ValueError):
        return None


def card_fingerprint() -> Dict[str, Any]:
    """The cards ``nvidia-smi --query-gpu=name,power.limit`` lists: the
    first one's name and power limit (W) and how many there are; nulls and
    0 without a card or when ``nvidia-smi`` does not answer in time."""
    none = {"device_name": None, "power_limit_w": None, "device_count": 0}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=_SMI_TIMEOUT_S,
        )
    except (OSError, subprocess.TimeoutExpired):
        return none
    rows = [r for r in out.stdout.strip().splitlines() if r.strip()]
    if out.returncode != 0 or not rows:
        return none
    name, _, watts = rows[0].rpartition(",")
    return {"device_name": name.strip() or None, "power_limit_w": _parse_watts(watts),
            "device_count": len(rows)}


def _torch_versions() -> Dict[str, Optional[str]]:
    """torch and CUDA versions without importing torch: read them only if
    the caller already loaded it."""
    torch = sys.modules.get("torch")
    return {
        "torch": getattr(torch, "__version__", None),
        "cuda": getattr(getattr(torch, "version", None), "cuda", None),
    }


def _live_backend() -> str:
    """"cuda" or "cpu" when torch is loaded (a card present or not), else
    "unknown"."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "unknown"
    try:
        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:  # noqa: BLE001 — a broken driver is not a reason to drop history
        return "unknown"


def make_record(
    mode: str,
    artifact: Dict[str, Any],
    *,
    config: Optional[Dict[str, Any]] = None,
    backend: Optional[str] = None,
    ts: Optional[float] = None,
    card: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One history line from a bench artifact: the headline triple plus
    the fingerprint. ``config``: the knobs that define what was measured;
    ``backend`` defaults to the live torch backend when torch is loaded;
    ``card``: ``device_name``, ``power_limit_w`` and ``device_count``
    (default :func:`card_fingerprint`)."""
    cfg = dict(config or {})
    card = card_fingerprint() if card is None else card
    rec: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "ts": round(time.time(), 3) if ts is None else ts,
        "mode": mode,
        "metric": artifact.get("metric"),
        "value": artifact.get("value"),
        "unit": artifact.get("unit"),
        "ok": artifact.get("ok"),
        "vs_baseline": artifact.get("vs_baseline"),
        "git_rev": git_rev(),
        "backend": _live_backend() if backend is None else backend,
        "host": host_fingerprint(),
        "config": cfg,
        "config_hash": config_hash(cfg),
        "framework": FRAMEWORK,
        "device_name": card.get("device_name"),
        "power_limit_w": card.get("power_limit_w"),
        "device_count": card.get("device_count"),
    }
    rec.update(_torch_versions())
    return rec


# -- the locked append ---------------------------------------------------------


def append(path: str, record: Dict[str, Any]) -> None:
    """Append one record as one line (``O_APPEND`` + ``flock`` + ``fsync``).
    Raises only for a non-dict record; IO errors are swallowed: history is
    an observer."""
    if not isinstance(record, dict):
        raise TypeError(f"history record must be a dict, got {type(record).__name__}")
    line = json.dumps(record) + "\n"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            try:
                import fcntl

                fcntl.flock(fd, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock (non-POSIX): O_APPEND alone is still line-atomic for short lines
            os.write(fd, line.encode())
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def read(path: str) -> List[Dict[str, Any]]:
    """All parseable records with a metric, in append order. Malformed
    lines (a torn tail from a hard kill) are skipped."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("metric") is not None:
                    records.append(rec)
    except OSError:
        return []
    return records


# -- regression detection ------------------------------------------------------


@dataclass(frozen=True)
class MetricRule:
    """Per-metric regression policy (the JAX module's).

    ``direction``: "lower" = smaller is better, "higher" = bigger is
    better. ``rel_threshold`` / ``abs_threshold``: the explicit band;
    ``mad_k`` scales the history's own MAD (x1.4826 = sigma-consistent)
    into a noise floor. ``min_samples``: prior samples required before the
    rule can fail anything."""

    direction: str = "lower"
    rel_threshold: float = 0.20
    abs_threshold: float = 0.0
    mad_k: float = 3.0
    min_samples: int = 4

    def __post_init__(self):
        if self.direction not in ("lower", "higher"):
            raise ValueError(f"direction must be lower|higher, got {self.direction!r}")


#: the governed metrics the port's harness emits, each with the JAX
#: module's direction and thresholds (``bench_history.py:250-336`` there):
#: every JAX rule.
DEFAULT_RULES: Dict[str, MetricRule] = {
    "pipeline_16x100_wall_ms": MetricRule(direction="lower", rel_threshold=0.15),
    "bnb_eil51_nodes_per_sec": MetricRule(direction="higher", rel_threshold=0.15),
    "bnb_burma14_nodes_per_sec": MetricRule(direction="higher", rel_threshold=0.15),
    "serve_microbatch_vs_sequential_throughput": MetricRule(
        direction="higher", rel_threshold=0.15
    ),
    "compile_once_warm_start": MetricRule(direction="higher", rel_threshold=0.30),
    # percentages and per-dispatch microseconds near zero: absolute bands
    "obs_overhead": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=2.5, min_samples=4
    ),
    "obs_us_per_dispatch": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=4.0, min_samples=4
    ),
    "atomic_checkpoint_overhead": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=5.0, min_samples=4
    ),
    "serve_service_ratio": MetricRule(direction="higher", rel_threshold=0.15),
    # a counter whose healthy value is 1.0: the small absolute band is the gate
    "serve_tight_deadline_exact_rate": MetricRule(
        direction="higher", rel_threshold=0.0, abs_threshold=0.02, min_samples=4
    ),
    "sharded_spill_transfer_bytes_per_round": MetricRule(direction="lower", rel_threshold=0.15),
    "fused_vs_reference_expansion_step": MetricRule(direction="higher", rel_threshold=0.15),
    "shard_rank_obs_overhead": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=2.5, min_samples=4
    ),
    "shard_rank_us_per_dispatch": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=8.0, min_samples=4
    ),
    # answered exactly once under kills and hangs: any dropped or doubled
    # request fails the gate
    "fleet_chaos_answered_rate": MetricRule(
        direction="higher", rel_threshold=0.0, abs_threshold=0.001, min_samples=4
    ),
    # a ratio near 1 when healthy (the stranded ring measures ~6): absolute
    "shard_balance_imbalance": MetricRule(
        direction="lower", rel_threshold=0.0, abs_threshold=5.0, min_samples=4
    ),
    "shard_steal_bytes_per_node": MetricRule(direction="lower", rel_threshold=0.50, min_samples=4),
}


@dataclass
class Verdict:
    metric: str
    group: str  # "framework/backend/card@watts/config_hash/host"
    status: str  # "ok" | "regression" | "insufficient" | "no_value"
    latest: Optional[float] = None
    median: Optional[float] = None
    mad: Optional[float] = None
    allowed: Optional[float] = None
    deviation: Optional[float] = None
    samples: int = 0
    detail: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}


def _group_key(rec: Dict[str, Any]) -> tuple:
    """The conditions a sample is compared under. A record without
    ``framework`` is the JAX package's; ``str`` keeps the key sortable
    when a card field is null."""
    return (
        str(rec.get("framework", "jax")),
        str(rec.get("backend", "unknown")),
        str(rec.get("device_name")),
        str(rec.get("power_limit_w")),
        str(rec.get("config_hash", "")),
        str(rec.get("host", "?")),
    )


def check(
    records: Iterable[Dict[str, Any]],
    rules: Optional[Dict[str, MetricRule]] = None,
) -> List[Verdict]:
    """Evaluate the newest sample of every governed metric against its
    prior samples, per group (:func:`_group_key`). One Verdict per
    (metric, group) with at least one sample; callers fail on any
    ``status == "regression"``."""
    rules = DEFAULT_RULES if rules is None else rules
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for rec in records:
        metric = rec.get("metric")
        if metric not in rules:
            continue
        groups.setdefault((metric,) + _group_key(rec), []).append(rec)

    verdicts: List[Verdict] = []
    for key, recs in sorted(groups.items()):
        metric, (framework, backend, card, watts, cfg, host) = key[0], key[1:]
        rule = rules[metric]
        group = f"{framework}/{backend}/{card}@{watts}/{cfg or '-'}/{host}"
        vals = [
            float(r["value"])
            for r in recs
            if isinstance(r.get("value"), (int, float))
        ]
        if not vals:
            verdicts.append(Verdict(metric, group, "no_value", samples=len(recs),
                                    detail="no numeric samples"))
            continue
        latest, prior = vals[-1], vals[:-1]
        if len(prior) < rule.min_samples:
            verdicts.append(Verdict(
                metric, group, "insufficient", latest=latest, samples=len(vals),
                detail=f"{len(prior)} prior < min_samples={rule.min_samples}",
            ))
            continue
        med = _median(prior)
        mad = _median([abs(v - med) for v in prior])
        allowed = max(
            rule.rel_threshold * abs(med),
            rule.abs_threshold,
            rule.mad_k * 1.4826 * mad,
        )
        # positive deviation == worse, whatever the metric's direction
        deviation = (latest - med) if rule.direction == "lower" else (med - latest)
        status = "regression" if deviation > allowed else "ok"
        verdicts.append(Verdict(
            metric, group, status, latest=latest, median=round(med, 6),
            mad=round(mad, 6), allowed=round(allowed, 6),
            deviation=round(deviation, 6), samples=len(vals),
            detail=(
                f"latest {latest:g} vs median {med:g} "
                f"({'+' if deviation >= 0 else ''}{deviation:g} worse, "
                f"allowed {allowed:g})"
            ),
        ))
    return verdicts


def load_rules(path: str) -> Dict[str, MetricRule]:
    """Rules from a JSON file ``{metric: {direction, rel_threshold, ...}}``
    merged over the defaults (``null`` drops a default metric)."""
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    rules = dict(DEFAULT_RULES)
    for metric, spec in raw.items():
        if spec is None:
            rules.pop(metric, None)
            continue
        rules[metric] = MetricRule(**spec)
    return rules

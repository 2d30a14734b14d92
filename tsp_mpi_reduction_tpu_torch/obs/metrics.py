"""Process-global metrics registry: labeled counters/gauges/histograms.

One :data:`REGISTRY` per process. Series are identified by (metric name,
sorted label items); recording is a locked dict update — cheap enough for
per-request / per-flush / per-dispatch call sites; it stays out of the
per-step loop.

Snapshot/delta semantics: :meth:`MetricsRegistry.snapshot` is a frozen
point-in-time view; :meth:`MetricsRegistry.delta` subtracts a prior
snapshot from the live registry (counters and histograms subtract, gauges
report their current value), which is how back-to-back serve sessions and
repeated tests stop seeing each other's counts.

Exporters: :meth:`Snapshot.as_dict` (structured JSON — the stats-JSON
building block) and :func:`to_prometheus` (text exposition format, served
over HTTP by :func:`serve_metrics_http` for the serve CLI's
``--metrics-port``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

#: default latency buckets (seconds) — wide enough for compile costs
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    # the serve hot path records 4-6 series per request, almost all with
    # zero or one label — skip the sort (and its genexp frame) for those
    if not labels:
        return ()
    if len(labels) == 1:
        [(k, v)] = labels.items()
        return ((k, str(v)),)
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):  # noqa: B007 — index reused
            if value <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def as_dict(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


class _Metric:
    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name: str, kind: str, help: str, buckets):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        #: LabelKey -> float (counter/gauge) or _Hist (histogram)
        self.series: Dict[LabelKey, Any] = {}


class Snapshot:
    """Frozen point-in-time view of (a subset of) the registry.

    ``data`` maps metric name -> {"kind", "help", "series": {LabelKey:
    float | hist-dict}}. Values are plain Python — safe to hold across
    further recording.
    """

    def __init__(self, data: Dict[str, Dict[str, Any]], taken_at: float):
        self.data = data
        self.taken_at = taken_at

    def value(self, name: str, **labels: Any) -> float:
        m = self.data.get(name)
        if m is None:
            return 0.0
        v = m["series"].get(_label_key(labels), 0.0)
        return v["sum"] if isinstance(v, dict) else v

    def series(self, name: str) -> Dict[LabelKey, Any]:
        m = self.data.get(name)
        return dict(m["series"]) if m else {}

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready nested form: name -> kind/help + a list of
        ``{"labels": {...}, "value"|"hist": ...}`` series entries."""
        out: Dict[str, Any] = {}
        for name in sorted(self.data):
            m = self.data[name]
            entries: List[Dict[str, Any]] = []
            for key in sorted(m["series"]):
                v = m["series"][key]
                entry: Dict[str, Any] = {"labels": dict(key)}
                if isinstance(v, dict):
                    entry["hist"] = v
                else:
                    entry["value"] = v
                entries.append(entry)
            out[name] = {"kind": m["kind"], "help": m["help"], "series": entries}
        return out

    def to_json(self) -> str:
        return json.dumps(self.as_dict())


class MetricsRegistry:
    """Thread-safe registry. Metric kind is fixed by first use (or an
    explicit :meth:`declare`); recording under a different kind raises —
    a silent kind flip would corrupt every scraper downstream."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- declaration / recording --------------------------------------------

    def _metric(
        self, name: str, kind: str, help: str = "", buckets=None
    ) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(name, kind, help, tuple(buckets or DEFAULT_BUCKETS))
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} is a {m.kind}, not a {kind} — one name, "
                "one kind (declare() it once if the first-use site is "
                "ambiguous)"
            )
        return m

    def declare(
        self, name: str, kind: str, help: str = "", buckets=None
    ) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r} (one of {_KINDS})")
        with self._lock:
            m = self._metric(name, kind, help, buckets)
            if help and not m.help:
                m.help = help

    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        """Add to a counter series (monotone; negative increments raise)."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0")
        key = _label_key(labels)
        with self._lock:
            m = self._metric(name, "counter")
            m.series[key] = m.series.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            m = self._metric(name, "gauge")
            m.series[key] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        """Record one histogram observation."""
        key = _label_key(labels)
        with self._lock:
            m = self._metric(name, "histogram")
            h = m.series.get(key)
            if h is None:
                h = m.series[key] = _Hist(m.buckets)
            h.observe(float(value))

    # -- reads ---------------------------------------------------------------

    def value(self, name: str, **labels: Any) -> float:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return 0.0
            v = m.series.get(_label_key(labels))
            if v is None:
                return 0.0
            return v.sum if isinstance(v, _Hist) else v

    def series(self, name: str) -> Dict[LabelKey, float]:
        """Scalar view of one metric's series (histograms report sums)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return {}
            return {
                k: (v.sum if isinstance(v, _Hist) else v)
                for k, v in m.series.items()
            }

    def snapshot(self, prefix: Optional[str] = None) -> Snapshot:
        with self._lock:
            data: Dict[str, Dict[str, Any]] = {}
            for name, m in self._metrics.items():
                if prefix is not None and not name.startswith(prefix):
                    continue
                data[name] = {
                    "kind": m.kind,
                    "help": m.help,
                    "series": {
                        k: (v.as_dict() if isinstance(v, _Hist) else v)
                        for k, v in m.series.items()
                    },
                }
        return Snapshot(data, time.time())

    def delta(self, since: Snapshot, prefix: Optional[str] = None) -> Snapshot:
        """Live registry minus ``since``: counters/histograms subtract
        (clamped at zero, so a mid-window reset cannot go negative),
        gauges report their current value. Series absent from ``since``
        count in full."""
        now = self.snapshot(prefix)
        for name, m in now.data.items():
            if m["kind"] == "gauge":
                continue
            old = since.data.get(name, {}).get("series", {})
            for key, v in m["series"].items():
                prev = old.get(key)
                if prev is None:
                    continue
                if isinstance(v, dict):
                    v["sum"] = max(v["sum"] - prev.get("sum", 0.0), 0.0)
                    v["count"] = max(v["count"] - prev.get("count", 0), 0)
                    v["counts"] = [
                        max(a - b, 0)
                        for a, b in zip(v["counts"], prev.get("counts", []))
                    ] if prev.get("counts") else v["counts"]
                else:
                    m["series"][key] = max(v - prev, 0.0)
        return now

    # -- lifecycle -----------------------------------------------------------

    def clear_metric(self, name: str) -> None:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                m.series.clear()

    def reset_for_testing(self, prefix: Optional[str] = None) -> None:
        """Drop every series (optionally only names under ``prefix``) —
        the snapshot boundary repeated tests need (conftest wires this
        per-test for the health metrics)."""
        with self._lock:
            for name, m in self._metrics.items():
                if prefix is None or name.startswith(prefix):
                    m.series.clear()


#: the process-global registry every layer records into
REGISTRY = MetricsRegistry()


def hist_quantile(hist: Mapping[str, Any], q: float) -> Optional[float]:
    """Bucket-interpolated quantile from a histogram dict
    (:meth:`_Hist.as_dict` shape — also what :meth:`Snapshot.series`
    yields for histograms). Linear interpolation inside the bucket the
    quantile falls in, the same honesty trade as ``obs.slo``'s
    attainment; observations in the +Inf bucket clamp to the last finite
    edge (a quantile cannot invent an upper bound the histogram never
    recorded). None when empty or ``q`` is out of (0, 1]."""
    count = int(hist.get("count", 0))
    if count <= 0 or not 0.0 < q <= 1.0:
        return None
    buckets = list(hist.get("buckets", ()))
    counts = list(hist.get("counts", ()))
    rank = q * count
    cum = 0.0
    lo = 0.0
    for edge, c in zip(buckets, counts):
        if cum + c >= rank:
            frac = (rank - cum) / c if c > 0 else 0.0
            return lo + (edge - lo) * frac
        cum += c
        lo = edge
    return buckets[-1] if buckets else None


# -- Prometheus text exposition ------------------------------------------------


def _prom_labels(key: LabelKey) -> str:
    if not key:
        return ""
    esc = lambda s: s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")  # noqa: E731
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


def to_prometheus(snapshot: Optional[Snapshot] = None) -> str:
    """Render a snapshot (default: a fresh one of :data:`REGISTRY`) in the
    Prometheus text exposition format (version 0.0.4)."""
    snap = snapshot or REGISTRY.snapshot()
    lines: List[str] = []
    for name in sorted(snap.data):
        m = snap.data[name]
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for key in sorted(m["series"]):
            v = m["series"][key]
            if isinstance(v, dict):  # histogram
                cum = 0
                edges = list(v["buckets"]) + ["+Inf"]
                for edge, c in zip(edges, v["counts"]):
                    cum += c
                    lk = key + (("le", str(edge)),)
                    lines.append(f"{name}_bucket{_prom_labels(lk)} {cum}")
                lines.append(f"{name}_sum{_prom_labels(key)} {v['sum']}")
                lines.append(f"{name}_count{_prom_labels(key)} {v['count']}")
            else:
                out = int(v) if float(v).is_integer() else v
                lines.append(f"{name}{_prom_labels(key)} {out}")
    return "\n".join(lines) + "\n"


# -- HTTP exporter -------------------------------------------------------------


def serve_metrics_http(port: int, host: str = "127.0.0.1"):
    """Start a daemon-thread HTTP server exposing ``/metrics`` (Prometheus
    text) and ``/metrics.json`` (the structured snapshot).

    Port 0 binds an EPHEMERAL port — the supported spelling for tests and
    multi-instance runs, which were colliding on fixed ports; read the
    actually-bound port back from ``server.port`` (it also surfaces in
    the serve stats ``obs.metrics_port``). Returns the server; callers
    ``.close()`` it on exit — :meth:`close` is the graceful shutdown:
    ``shutdown()`` stops the serve loop AND ``server_close()`` releases
    the listening socket, so the port is immediately rebindable (bare
    ``shutdown()``, the old contract, leaked the socket until GC)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path.split("?")[0] == "/metrics":
                body = to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/metrics.json":
                body = REGISTRY.snapshot().to_json().encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # noqa: D102 — silence per-scrape spam
            pass

    class MetricsServer(ThreadingHTTPServer):
        #: in-flight scrape threads must not block process exit
        daemon_threads = True

        @property
        def port(self) -> int:
            """The BOUND port (== the requested one unless it was 0)."""
            return self.server_address[1]

        def close(self) -> None:
            self.shutdown()
            self.server_close()

        def __enter__(self) -> "MetricsServer":
            return self

        def __exit__(self, *exc) -> None:
            self.close()

    server = MetricsServer((host, port), Handler)
    threading.Thread(
        target=server.serve_forever, name="obs-metrics-http", daemon=True
    ).start()
    return server


# -- solver fold helper --------------------------------------------------------


def fold_bnb_solve(nodes: int, wall_s: float, spill_stats) -> None:
    """Fold one finished B&B solve's totals into the registry (called once
    per solve from ``models.branch_bound`` — never from inside the loop)."""
    REGISTRY.inc("bnb_nodes_expanded_total", int(nodes))
    REGISTRY.inc("bnb_solve_seconds_total", float(max(wall_s, 0.0)))
    REGISTRY.inc("bnb_solves_total")
    REGISTRY.inc("bnb_spill_rounds_total", spill_stats.rounds)
    REGISTRY.inc("bnb_spill_events_total", spill_stats.events)
    REGISTRY.inc("bnb_spill_full_merges_total", spill_stats.full_merges)
    REGISTRY.inc(
        "bnb_spill_bytes_total", spill_stats.bytes_to_host, direction="to_host"
    )
    REGISTRY.inc(
        "bnb_spill_bytes_total",
        spill_stats.bytes_to_device,
        direction="to_device",
    )

"""Lightweight span tracing with propagated trace/span IDs.

One serve request produces one *trace*: a root ``serve.request`` span plus
children for each pipeline stage (canonicalize, cache lookup, queue wait,
flush, ladder rung, device dispatch, respond). Spans are emitted as JSONL
(one object per line, written at span END) to the sink configured by
:func:`configure` — or the ``TSP_TRACE`` env var — and reconstructed into
trees by :func:`build_trees` (tests assert no orphan spans; the
``tools/obs_report.py`` renderer prints them).

Span record schema::

    {"type": "span", "trace_id": "…", "span_id": "…", "parent_id": "…"|null,
     "name": "sched.flush", "ts": 1754300000.123,      # epoch start
     "dur_ms": 1.87, "attrs": {…},
     "events": [{"name": "fault_injected", "ts": …, "attrs": {…}}, …]}

Propagation: each thread carries a span stack (``threading.local``);
:func:`span` parents to the top of the stack. Cross-thread hops (request
thread → scheduler worker) carry an explicit ``(trace_id, span_id)``
context captured with :func:`current_context` — the worker then emits
completed spans directly via :func:`emit_span` without touching any
stack. Injected faults (``resilience.faults``) call :func:`add_event`,
annotating whatever span the firing thread currently has open, so a chaos
run's faults land in the same trace as the request they hit.

When no sink is configured (the default) every entry point is a cheap
no-op — :func:`span` yields a shared null span, :func:`add_event` returns
immediately — so production paths pay one attribute check.

Counterpart of ``tsp_mpi_reduction_tpu/obs/tracing.py``. Its profiler
step annotations (:func:`step_annotation_factory`) are
``torch.profiler.record_function("bnb_step")`` ranges here, present only
while a ``utils.profiling.device_trace`` capture runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import enabled as _obs_enabled

#: (trace_id, span_id) — the cross-thread propagation token
SpanContext = Tuple[str, str]

#: the cross-PROCESS propagation contract: a parent process
#: stamps ``TSP_TRACE_PARENT=<trace_id>:<span_id>`` into a child's env,
#: and the child's driver opens its root span under that context — so a
#: chunked campaign's N subprocesses (retries, fallback restores, compile
#: phases included) reconstruct as ONE span tree instead of N trace
#: islands. ``bnb_chunked.py`` stamps it per chunk; ``bnb_solve.py`` (and
#: anything that calls :func:`parent_from_env`) honors it.
ENV_PARENT = "TSP_TRACE_PARENT"

_HEX = frozenset("0123456789abcdef")


def parse_parent_token(raw) -> Optional[SpanContext]:
    """Parse a ``<trace_id>:<span_id>`` propagation token (the
    ``TSP_TRACE_PARENT`` encoding) into a SpanContext, or None when
    missing or malformed — a garbled token must degrade to a fresh root
    trace, never crash a request. The fleet front stamps this token into
    each replica-bound request line (``trace_parent`` field), the same
    contract the env var carries process-to-process."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip().lower()
    if not raw or ":" not in raw:
        return None
    trace_id, _, span_id = raw.partition(":")
    if not trace_id or not span_id:
        return None
    if not (set(trace_id) <= _HEX and set(span_id) <= _HEX):
        return None
    return (trace_id, span_id)


def parent_from_env() -> Optional[SpanContext]:
    """Parse ``TSP_TRACE_PARENT`` into a SpanContext, or None when unset
    or malformed."""
    return parse_parent_token(os.environ.get(ENV_PARENT, ""))


def format_parent(ctx: Optional[SpanContext]) -> Optional[str]:
    """The env-var encoding of a context (None in, None out — callers
    stamp the child env only when tracing is actually on)."""
    if ctx is None:
        return None
    return f"{ctx[0]}:{ctx[1]}"


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One in-flight span; mutate via :meth:`set` / :meth:`event`."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attrs", "events",
        "ts", "_t0", "announced",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str],
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.announced = False

    @property
    def context(self) -> SpanContext:
        return (self.trace_id, self.span_id)

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        self.events.append(
            {"name": name, "ts": time.time(), "attrs": attrs}
        )

    def _record(self) -> Dict[str, Any]:
        return {
            "type": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "ts": round(self.ts, 6),
            "dur_ms": round((time.perf_counter() - self._t0) * 1000.0, 4),
            "attrs": self.attrs,
            "events": self.events,
        }


class _NullSpan:
    """Shared no-op stand-in when tracing is off (set/event swallow)."""

    __slots__ = ()
    trace_id = span_id = parent_id = ""
    context: Optional[SpanContext] = None

    def set(self, key: str, value: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """JSONL span sink + per-thread span stacks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fh = None
        self._path: Optional[str] = None
        self._tls = threading.local()
        self._env_checked = False

    # -- configuration -------------------------------------------------------

    def configure(self, path: Optional[str]) -> None:
        """Point the tracer at a JSONL sink (append mode — a restarted
        service extends the log); None closes it."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self._path = path
            self._env_checked = True
            if path:
                self._fh = open(path, "a", encoding="utf-8")

    def _maybe_env_configure(self) -> None:
        # lazy TSP_TRACE pickup, mirroring the faults registry: drivers
        # and benches opt in by env without touching every entry point.
        # The flag is set only once the sink is open: a thread that reads
        # it lock-free must never see "checked" with the file not yet open
        # (the first requests of a fresh replica arrive on several threads
        # at once, and one of them would go untraced)
        if self._env_checked:
            return
        with self._lock:
            if self._env_checked:
                return
            path = os.environ.get("TSP_TRACE", "").strip()
            if path:
                try:
                    self._fh = open(path, "a", encoding="utf-8")
                    self._path = path
                except OSError:
                    pass
            self._env_checked = True

    @property
    def active(self) -> bool:
        self._maybe_env_configure()
        # double-checked: the lock-free read keeps the tracing-OFF fast
        # path (every span()/add_event gate) off the lock emit() holds
        # across file writes; the locked re-read below makes the
        # tracing-ON answer consistent with a concurrent configure()
        if self._fh is None:
            return False
        with self._lock:
            fh = self._fh
        return fh is not None and _obs_enabled()

    @property
    def path(self) -> Optional[str]:
        """The configured sink path, read under the lock (``configure``
        rebinds it from whichever thread reconfigures)."""
        with self._lock:
            return self._path

    # -- stacks --------------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    # -- emission ------------------------------------------------------------

    def emit(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        # encode OUTSIDE the lock: under load every request thread ends
        # ~8 spans, and json.dumps inside the critical section would
        # serialize them all on CPU work, not just on the file append
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(line)
                self._fh.flush()
            except (OSError, ValueError):
                pass  # a torn sink must never take a request down


TRACER = Tracer()


def configure(path: Optional[str]) -> None:
    TRACER.configure(path)


def current_span() -> Optional[Span]:
    return TRACER.current()


def current_context() -> Optional[SpanContext]:
    """The active span's (trace_id, span_id), for cross-thread handoff."""
    sp = TRACER.current()
    return sp.context if sp is not None else None


#: cap on the per-thread pending-event buffer (threads that never drain
#: — e.g. a watchdog firing faults with no span — must stay bounded)
_PENDING_CAP = 16


def add_event(name: str, **attrs: Any) -> None:
    """Annotate the calling thread's active span — the hook
    ``resilience.faults`` fires on every injected fault, so chaos events
    land inside the span they actually hit. On a thread with NO active
    span (the scheduler worker emits its spans retrospectively via
    :func:`emit_span`), the event parks in a per-thread pending buffer
    instead, for that thread to attach via :func:`drain_pending` — a
    worker-seam injection must not vanish from the trace."""
    sp = TRACER.current()
    if sp is not None:
        sp.event(name, **attrs)
        return
    if not TRACER.active:
        return
    pending = getattr(TRACER._tls, "pending", None)
    if pending is None:
        pending = TRACER._tls.pending = []
    if len(pending) < _PENDING_CAP:
        pending.append({"name": name, "ts": time.time(), "attrs": attrs})


def drain_pending() -> List[Dict[str, Any]]:
    """Take (and clear) the calling thread's parked events — spanless
    emitters attach them to their next :func:`emit_span`."""
    pending = getattr(TRACER._tls, "pending", None)
    if not pending:
        return []
    TRACER._tls.pending = []
    return pending


@contextlib.contextmanager
def span(
    name: str,
    parent: Optional[SpanContext] = None,
    announce: bool = False,
    **attrs: Any,
) -> Iterator[Any]:
    """Open a span: child of ``parent`` if given, else of the thread's
    current span, else the root of a fresh trace. Yields the Span (or the
    shared null span when tracing is off). An escaping exception is
    recorded as ``attrs.error`` and re-raised — degraded/failed requests
    still close their spans, so their trees stay complete.

    ``announce=True`` additionally emits a PROVISIONAL record (same
    span_id, ``partial: true``, zero duration) at span OPEN. The final
    record at close overwrites it in reconstruction (``build_trees``
    keys nodes by span_id, last record wins). This is the fleet
    contract: a replica process may be killed mid-request, and without
    the announcement its already-closed child spans (canonicalize,
    cache.lookup, …) would orphan — the provisional parent keeps every
    stitched tree complete even when the process that owned the real
    close dies. Every span opened under an announced one on the thread's
    stack is announced too: a kill can land between a grandchild's close
    and its parent's (a ``sched.flush`` the worker emitted under a
    ``sched.wait`` still open, a ``sched.wait`` under its ``ladder.rung``),
    and the JAX package, which announces the root only, orphans those."""
    if not TRACER.active:
        yield NULL_SPAN
        return
    if parent is not None:
        trace_id, parent_id = parent
    else:
        cur = TRACER.current()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
            announce = announce or cur.announced
        else:
            trace_id, parent_id = _new_id(16), None
    sp = Span(name, trace_id, parent_id, attrs)
    sp.announced = announce
    if announce:
        TRACER.emit(
            {
                "type": "span",
                "trace_id": sp.trace_id,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "name": name,
                "ts": round(sp.ts, 6),
                "dur_ms": 0.0,
                "attrs": dict(sp.attrs, partial=True),
                "events": [],
            }
        )
    stack = TRACER._stack()
    stack.append(sp)
    try:
        yield sp
    except BaseException as e:
        sp.set("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        if stack and stack[-1] is sp:
            stack.pop()
        else:  # unbalanced exit (never expected): drop without corrupting
            try:
                stack.remove(sp)
            except ValueError:
                pass
        TRACER.emit(sp._record())


def emit_span(
    name: str,
    parent: Optional[SpanContext],
    ts: float,
    dur_s: float,
    attrs: Optional[Dict[str, Any]] = None,
    events: Optional[List[Dict[str, Any]]] = None,
) -> Optional[SpanContext]:
    """Emit a COMPLETED span directly (no thread stack) — the scheduler
    worker's path: it measures a flush that belongs to a request thread's
    trace, so it parents to the ticket's carried context. Returns the new
    span's context (for chaining a child), or None when tracing is off or
    there is no trace to attach to."""
    if parent is None or not TRACER.active:
        return None
    trace_id, parent_id = parent
    span_id = _new_id()
    TRACER.emit(
        {
            "type": "span",
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "name": name,
            "ts": round(ts, 6),
            "dur_ms": round(dur_s * 1000.0, 4),
            "attrs": attrs or {},
            "events": events or [],
        }
    )
    return (trace_id, span_id)


# -- profiler step annotations ---------------------------------------------------

#: shared reusable null context (nullcontext instances are re-enterable);
#: the untraced hot path must not allocate one per step
_NULL_CTX = contextlib.nullcontext()


def _null_annotation(step: int):
    return _NULL_CTX


def step_annotation(step: int):
    """A ``bnb_step`` profiler range for one B&B expansion step, active ONLY
    while a ``device_trace`` capture is running (and obs is enabled)."""
    return step_annotation_factory()(step)


def step_annotation_factory():
    """Resolve the per-step annotation ONCE per solve: the capture wraps the
    whole call, so its state cannot change inside a solve. Untraced, every
    step pays one call that returns a shared nullcontext."""
    from ..utils import profiling

    if not (profiling.trace_active() and _obs_enabled()):
        return _null_annotation
    import torch

    return lambda step: torch.profiler.record_function(f"bnb_step#{int(step)}")


# -- reconstruction ------------------------------------------------------------


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace log; malformed lines are skipped (a crashed
    writer may leave a torn tail — the surviving spans still matter)."""
    spans: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("type") == "span":
                spans.append(rec)
    return spans


def read_traces(paths: List[str]) -> List[Dict[str, Any]]:
    """Stitch several JSONL sinks into one span list (a chunked campaign
    leaves the parent's spans and every chunk subprocess's spans in the
    SAME file via append mode, but retries/relocated sinks can split them
    — the reconstruction only needs the union; trace_ids do the rest).
    Unreadable files are skipped like malformed lines."""
    spans: List[Dict[str, Any]] = []
    for path in paths:
        try:
            spans.extend(read_trace(path))
        except OSError:
            continue
    return spans


def build_trees(spans: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Group spans into per-trace trees.

    Returns ``{trace_id: {"roots": [node…], "orphans": [span…],
    "spans": {span_id: node}}}`` where each node is ``{"span": record,
    "children": [node…]}``. An *orphan* is a span whose ``parent_id``
    names a span absent from its trace — the acceptance criterion is that
    a serve session produces none."""
    traces: Dict[str, Dict[str, Any]] = {}
    for rec in spans:
        t = traces.setdefault(
            rec["trace_id"], {"roots": [], "orphans": [], "spans": {}}
        )
        t["spans"][rec["span_id"]] = {"span": rec, "children": []}
    for t in traces.values():
        for node in t["spans"].values():
            pid = node["span"].get("parent_id")
            if pid is None:
                t["roots"].append(node)
            elif pid in t["spans"]:
                t["spans"][pid]["children"].append(node)
            else:
                t["orphans"].append(node["span"])
        for nodes in t["spans"].values():
            nodes["children"].sort(key=lambda nd: nd["span"]["ts"])
        t["roots"].sort(key=lambda nd: nd["span"]["ts"])
    return traces


def orphan_spans(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every span whose parent is missing from its own trace."""
    out: List[Dict[str, Any]] = []
    for t in build_trees(spans).values():
        out.extend(t["orphans"])
    return out

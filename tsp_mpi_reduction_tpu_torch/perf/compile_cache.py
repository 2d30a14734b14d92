"""Compile-once dispatch of the port: a store of captured CUDA graphs.

Counterpart of ``tsp_mpi_reduction_tpu/perf/compile_cache.py``. The JAX
module makes each hot entry one compiled XLA program, built once per
(entry, statics, shapes, version, backend) and dispatched as one call. On
the card the counterpart is a CUDA graph: the entry's torch ops captured
once per key and replayed. The JAX module's three layers:

1. the jax persistent compilation cache (``enable``'s jax config) has no
   counterpart: torch ops compile nothing at run time, and the hand
   kernels are built by ``nvcc`` once per checkout into ``build/torch_ext``
   (``kernels/_build.py``);
2. the AOT serialized-executable store becomes the **graph store** below.
   CUDA graphs cannot be serialized, so the store lives in the process;
   it has no disk tier (``_aot_paths``, ``_tree_to_meta`` /
   ``_tree_from_meta``, ``_cost_memo_*`` and ``compile_phase_seconds``
   have no counterpart);
3. the host-setup memo is ``perf/ascent_memo.py``, re-exported here.

The store. :func:`aot_load_or_compile` captures ``fn(*inputs, **statics)``
once per :func:`entry_key` and hands back a :class:`CapturedGraph`.
Each graph owns static copies of its inputs. A call copies the caller's
tensors in, replays the graph (``replays`` times: an entry that updates
its own inputs in place, as the merge fold's step does, is a loop on the
device), and clones the outputs out, so a later replay never overwrites a
result a caller still holds. A per-graph lock covers copy-in to clone-out
(serve's blocked rung folds from request threads), and a call waits on
the device for the previous call's clone-out when the two run on
different streams. A capture runs one eager warm-up on its own stream
first, then captures there with ``capture_error_mode="thread_local"``
(other threads keep launching); captures are serialized by one lock.
The capture is :func:`capture_region`, not ``torch.cuda.graph``: the
latter starts with a device-wide synchronize and empties the caching
allocator, which would stall every serve thread and make them allocate
afresh each time a new request size is captured. A capture or replay
that fails raises :class:`GraphStoreError` naming the key; nothing falls
back to eager dispatch.

``TSP_COMPILE_CACHE`` is the JAX package's knob: ``off``, ``0``, ``none``
or ``disabled`` turns every layer off (no graph is stored, and callers run
their eager dispatch, explicitly); anything else is the ascent memo's
directory (unset: ``build/torch_cache`` of the checkout, where the JAX
package uses ``~/.cache``; the port writes nothing outside its checkout).

An entry that runs a loop on the device over state it owns (the B&B
step, ``models/branch_bound.py``) captures one graph per ``variants``
entry on the same static buffers, and its caller adopts those buffers:
it takes the graph's lock (:meth:`CapturedGraph.acquire`), writes its
state into ``inputs`` once, calls :meth:`CapturedGraph.replay` as often
as it needs and reads the buffers itself, with no copy in or out per
call. The capture warms up on the graph's own copy of the inputs, so a
live state is never stepped outside the caller's loop; ``on_capture``
tells the caller that its call captured (its warm-up launched kernels).

An entry that runs on another graph's buffers (the sharded B&B round's
tail, which balances and shares the incumbent on the step graph's
frontier) BORROWS them: ``borrow=b`` makes the first b inputs the
caller's own tensors, not copies (they are the owner graph's static
inputs; the key names them by address), and its warm-up runs on copies
of them, so the owner's state is never stepped. The rest of its inputs
are its own static copies, as for any entry, which a caller that hits
the stored graph takes from ``inputs``.

A captured kernel launch runs at each replay, not at the capture: the
kernel wrappers count their launches through :func:`count_launch`,
which, while the calling thread captures, records the launch for the
graph instead, and each replay adds the graph's recorded launches once.

The store holds at most :data:`MAX_ENTRIES` graphs whose static buffers
and private memory pools sum to at most :data:`MAX_BYTES`, least
recently used out first; the newest graph is always kept. Its worst
case is therefore the larger of :data:`MAX_BYTES` (4 GiB) and one entry:
the full-size float64 merge fold (16,384 cities), whose distance buffer
alone is 16,384^2 x 8 B = 2.15 GB (float32: 1.07 GB). A graph's private
pool holds the step's temporaries (the fold's: O(capacity x L), about
2 MB at full size; the B&B step's: about one more copy of its frontier,
for the compaction's gather) and is counted by the device memory torch
reserved while the capture ran. The count bound is set by serve's
traffic, where every request size is a key: bench ``compile``'s
``serve_store`` leg sends phase 14's mix and a stream of 16 pipeline-tier
sizes (``tools/bench.py``), and 32 keeps them all. :func:`clear` drops
every graph.

:data:`STATS` keeps the JAX counters and ``stats_dict()`` keys, meaning
here:

- ``aot_misses``: captures; ``compile_seconds_paid``: their seconds
  (warm-up and capture, the device synchronize the capture starts with
  included);
- ``aot_hits``: calls served by a graph captured earlier in the process;
  ``compile_seconds_saved``: the recorded capture seconds of each hit;
- ``aot_errors``: captures or replays that failed (each also raised);
- ``aot_unsupported``: always 0 (a graph is never written to disk);
- ``ascent_memo_hits`` / ``ascent_memo_misses``: ``perf/ascent_memo.py``'s;
- ``canonical_sorts_saved``: ``serve/canonical.py``'s fast-path hits;
- ``entries``: per entry name, hits, misses, errors and seconds (for the
  B&B step, ``bnb_step``, a hit is one solve that adopted a stored graph);
- ``dir``: the ascent memo's enabled directory.

Outcomes are mirrored onto the port's ``REGISTRY`` under the JAX names
(``compile_cache_outcomes_total``, ``compile_seconds_total``), always
outside a capture region.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..obs.metrics import REGISTRY as _REGISTRY
from . import ascent_memo as _ascent_memo
from .ascent_memo import (  # noqa: F401  layer 3, re-exported
    ascent_key,
    ascent_memo_get,
    ascent_memo_put,
    ascent_memo_reset_memory,
    enable,
    enabled_dir,
)

#: the cache setting shared with the JAX package
ENV_VAR = _ascent_memo.ENV_VAR
_DISABLED = _ascent_memo._DISABLED
default_cache_dir = _ascent_memo.default_cache_dir
resolve_cache_dir = _ascent_memo.resolve_cache_dir

#: graphs the store keeps (least recently used out first), and the bytes
#: of static buffers they may hold together; see the module docstring
MAX_ENTRIES = 32
MAX_BYTES = 4 << 30


class GraphStoreError(RuntimeError):
    """A capture or a replay failed; the message names the entry and key."""


def store_enabled() -> bool:
    """Is the graph store on (``TSP_COMPILE_CACHE`` not off)? Read at
    every call, so a process may switch it between calls."""
    return resolve_cache_dir() is not None


# -- counters --------------------------------------------------------------------


@dataclass
class CompileCacheStats:
    """Process-global store accounting (thread-safe); the JAX fields."""

    aot_hits: int = 0
    aot_misses: int = 0
    aot_errors: int = 0
    aot_unsupported: int = 0
    compile_seconds_paid: float = 0.0
    compile_seconds_saved: float = 0.0
    canonical_sorts_saved: int = 0
    entries: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, name: str, outcome: str, seconds: float = 0.0) -> None:
        """Count one outcome ("hit", "miss" or "error") of entry ``name``."""
        _REGISTRY.inc("compile_cache_outcomes_total", 1, entry=name, outcome=outcome)
        if outcome in ("hit", "miss"):
            _REGISTRY.inc("compile_seconds_total", max(seconds, 0.0), entry=name,
                          kind="saved" if outcome == "hit" else "paid")
        with self._lock:
            e = self.entries.setdefault(name, {"hits": 0, "misses": 0, "errors": 0, "seconds": 0.0})
            if outcome == "hit":
                self.aot_hits += 1
                e["hits"] += 1
                self.compile_seconds_saved += seconds
            elif outcome == "miss":
                self.aot_misses += 1
                e["misses"] += 1
                self.compile_seconds_paid += seconds
            else:
                self.aot_errors += 1
                e["errors"] += 1
            e["seconds"] += seconds

    def incr(self, counter: str, n: int = 1) -> None:
        _REGISTRY.inc("compile_cache_events_total", n, event=counter)
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def snapshot(self) -> Dict[str, Any]:
        memo = _ascent_memo.STATS.snapshot()
        with self._lock:
            return {
                "dir": enabled_dir(),
                "aot_hits": self.aot_hits,
                "aot_misses": self.aot_misses,
                "aot_errors": self.aot_errors,
                "aot_unsupported": self.aot_unsupported,
                "compile_seconds_paid": round(self.compile_seconds_paid, 3),
                "compile_seconds_saved": round(self.compile_seconds_saved, 3),
                "ascent_memo_hits": memo["ascent_memo_hits"],
                "ascent_memo_misses": memo["ascent_memo_misses"],
                "canonical_sorts_saved": self.canonical_sorts_saved,
                "entries": {k: dict(v) for k, v in sorted(self.entries.items())},
            }


STATS = CompileCacheStats()


def stats_dict() -> Dict[str, Any]:
    """The compile-cache block of the solver CLIs' and the service's JSON: the
    store's counters and the ascent memo's."""
    return STATS.snapshot()


# -- keys ------------------------------------------------------------------------


def runtime_version() -> str:
    """The torch and CUDA runtime versions a graph was captured under."""
    return f"torch {torch.__version__}+cuda {torch.version.cuda}"


def _leaf_sig(x: Any) -> str:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a store entry's inputs are tensors, got {type(x).__name__}")
    return f"{tuple(x.shape)}:{x.dtype}:{tuple(x.stride())}"


def entry_key(
    name: str,
    args: Tuple[Any, ...],
    statics: Dict[str, Any],
    *,
    device: Optional[str] = None,
    version: Optional[str] = None,
) -> str:
    """Content key of one graph: any change to the entry name, an input's
    shape, dtype or strides, a static's value or set, the torch/CUDA
    runtime versions or the device yields another key. ``device`` and
    ``version`` default to the inputs' device and the live runtime; tests
    pass them to prove invalidation."""
    if device is None:
        device = str(args[0].device) if args else "none"
    if version is None:
        version = runtime_version()
    parts = [
        "graph-v1",
        name,
        version,
        device,
        ";".join(_leaf_sig(x) for x in args),
        ";".join(f"{k}={statics[k]!r}" for k in sorted(statics)),
    ]
    h = hashlib.blake2b(digest_size=16)
    h.update("\x1f".join(parts).encode())
    return h.hexdigest()


# -- the graph store ---------------------------------------------------------------


# -- launch counts under replay ----------------------------------------------------

_RECORDING = threading.local()


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Count one launch of kernel ``name`` in its module's ``launches``
    dict. While this thread captures a graph nothing launches: the launch
    is recorded for the graph, whose every replay counts it once."""
    rec = getattr(_RECORDING, "launches", None)
    if rec is None:
        launches[name] += 1
    else:
        rec.append((launches, name))


class CapturedGraph:
    """One captured graph with its static inputs and outputs (and, for an
    entry with variants, one graph per variant over the same buffers)."""

    def __init__(self, name: str, key: str, graph, inputs: Tuple[torch.Tensor, ...],
                 outputs: Tuple[torch.Tensor, ...], capture_s: float, *, graphs=None,
                 launches=None, pool_bytes: int = 0, borrow: int = 0, variant_s=None) -> None:
        self.name = name
        self.key = key
        self.graph = graph
        #: the captured variants, in the order of the entry's ``variants``
        self.graphs = tuple(graphs) if graphs is not None else (graph,)
        #: per variant, the seconds of its warm-up and its capture
        self.variant_s = list(variant_s) if variant_s is not None else [capture_s]
        #: per variant, the kernel launches one replay makes
        self.launches = launches if launches is not None else [[] for _ in self.graphs]
        self.inputs = inputs
        self.outputs = outputs
        self.capture_s = capture_s
        #: device bytes of the static buffers the graph pins (not the ones it
        #: borrows from another graph), and of its private memory pool
        pinned = [*inputs[borrow:], *(o for o in outputs if not any(o is i for i in inputs))]
        self.pool_bytes = pool_bytes
        self.nbytes = sum(t.numel() * t.element_size() for t in pinned) + pool_bytes
        self.lock = threading.Lock()
        #: the last call's end on its stream: a call from another stream
        #: waits for it before it overwrites the static buffers
        self._done = None

    def acquire(self) -> None:
        """Take the graph and its buffers for a run of :meth:`replay` calls
        (the adopting caller's; blocks while another thread holds them).
        Work on the current stream waits for the last holder's."""
        self.lock.acquire()
        if self._done is not None:
            torch.cuda.current_stream(self.inputs[0].device).wait_event(self._done)

    def release(self) -> None:
        """Give the graph back after :meth:`acquire`."""
        self._done = torch.cuda.current_stream(self.inputs[0].device).record_event()
        self.lock.release()

    def replay(self, times: int = 1, variant: int = 0) -> None:
        """Replay variant ``variant`` ``times`` times on the static buffers
        as they stand; the caller holds the graph (:meth:`acquire`). Each
        replay counts the variant's captured kernel launches."""
        g = self.graphs[variant]
        try:
            for _ in range(times):
                g.replay()
        except RuntimeError as e:
            STATS.record(self.name, "error")
            raise GraphStoreError(f"replay of {self.name} [{self.key}] failed: {e}") from e
        for counts, kernel in self.launches[variant]:
            counts[kernel] += times

    def __call__(self, *args: torch.Tensor, replays: int = 1) -> Tuple[torch.Tensor, ...]:
        """Copy ``args`` into the static inputs, replay ``replays`` times and
        return clones of the outputs. ``args`` are not written."""
        if len(args) != len(self.inputs) or any(
                a.shape != s.shape or a.dtype != s.dtype or a.device != s.device
                for a, s in zip(args, self.inputs)):
            raise ValueError(f"{self.name} [{self.key}]: inputs do not match the captured ones")
        with self.lock:
            try:
                stream = torch.cuda.current_stream(self.inputs[0].device)
                if self._done is not None:
                    stream.wait_event(self._done)
                for s, a in zip(self.inputs, args):
                    s.copy_(a)
            except RuntimeError as e:
                STATS.record(self.name, "error")
                raise GraphStoreError(f"replay of {self.name} [{self.key}] failed: {e}") from e
            self.replay(replays)
            try:
                out = tuple(o.clone() for o in self.outputs)
                self._done = stream.record_event()
            except RuntimeError as e:
                STATS.record(self.name, "error")
                raise GraphStoreError(f"replay of {self.name} [{self.key}] failed: {e}") from e
            return out


@contextlib.contextmanager
def capture_region(graph, stream):
    """Capture the work issued in the block on ``stream`` into ``graph``:
    ``torch.cuda.graph`` without its device synchronize and its emptying
    of the caching allocator (see the module docstring). Other threads
    keep launching (``thread_local``)."""
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


def _capture(name: str, key: str, fn: Callable, args: Tuple[torch.Tensor, ...],
             statics: Dict[str, Any], variants=None, borrow: int = 0) -> CapturedGraph:
    """Warm ``fn`` up once on a side stream, then capture it there; with
    ``variants`` (dicts of further statics), once per variant over the
    same static inputs, each with its own memory pool. The first
    ``borrow`` inputs are ``args``' own tensors (the warm-up runs on
    copies of them)."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: a graph is captured from CUDA tensors, got {dev}")
    variants = tuple(variants) if variants else ({},)
    t0 = time.perf_counter()
    graphs, launches, variant_s = [], [], []
    try:
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        inputs = tuple(args[:borrow]) + tuple(torch.empty_like(a) for a in args[borrow:])
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # the borrowed buffers hold a live state: the warm-up steps copies
            warm = tuple(torch.empty_like(a) for a in args[:borrow]) + inputs[borrow:]
            for extra in variants:
                tv = time.perf_counter()
                for s, a in zip(warm, args):
                    s.copy_(a)
                fn(*warm, **statics, **extra)  # the warm-up: first launches, lazy init
                variant_s.append(time.perf_counter() - tv)
            del warm
            for s, a in zip(inputs[borrow:], args[borrow:]):
                s.copy_(a)  # undo what the warm-up wrote in place
        reserved = torch.cuda.memory_reserved(dev)
        for i, extra in enumerate(variants):
            tv = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            _RECORDING.launches = []
            try:
                with capture_region(graph, side):
                    outputs = fn(*inputs, **statics, **extra)
            finally:
                launches.append(_RECORDING.launches)
                _RECORDING.launches = None
            graphs.append(graph)
            variant_s[i] += time.perf_counter() - tv
        current.wait_stream(side)
        pool_bytes = max(torch.cuda.memory_reserved(dev) - reserved, 0)
    except RuntimeError as e:
        STATS.record(name, "error")
        raise GraphStoreError(f"capture of {name} [{key}] failed: {e}") from e
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    return CapturedGraph(name, key, graphs[0], inputs, tuple(outputs), time.perf_counter() - t0,
                         graphs=graphs, launches=launches, pool_bytes=pool_bytes, borrow=borrow,
                         variant_s=variant_s)


class _GraphStore:
    """The process's graphs by key, bounded, least recently used out."""

    def __init__(self, max_entries: int, max_bytes: int) -> None:
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._graphs: "OrderedDict[str, CapturedGraph]" = OrderedDict()
        self._lock = threading.Lock()
        self._capture_lock = threading.Lock()
        #: captures made by entry name and by key, evicted graphs included
        self.captures: Dict[str, int] = {}
        self.key_captures: Dict[str, int] = {}
        #: graphs dropped to keep within the bounds
        self.evictions = 0

    def lookup(self, key: str) -> Optional[CapturedGraph]:
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
            return g

    def nbytes(self) -> int:
        with self._lock:
            return sum(g.nbytes for g in self._graphs.values())

    def insert(self, key: str, g: CapturedGraph) -> None:
        """Keep ``g`` as the most recent graph; drop the least recent ones
        while the store is over either bound (``g`` itself stays)."""
        with self._lock:
            self._graphs[key] = g
            self._graphs.move_to_end(key)
            total = sum(x.nbytes for x in self._graphs.values())
            while len(self._graphs) > 1 and (len(self._graphs) > self.max_entries or total > self.max_bytes):
                _, old = self._graphs.popitem(last=False)
                total -= old.nbytes
                self.evictions += 1

    def capture(self, name: str, key: str, fn, args, statics, store: bool,
                variants=None, borrow: int = 0) -> Tuple[CapturedGraph, bool]:
        """-> (graph, captured now). Serialized: a graph another thread
        captured while this one waited is returned as found."""
        with self._capture_lock:
            if store:
                g = self.lookup(key)
                if g is not None:
                    return g, False
            g = _capture(name, key, fn, args, statics, variants, borrow)
            with self._lock:
                self.captures[name] = self.captures.get(name, 0) + 1
                self.key_captures[key] = self.key_captures.get(key, 0) + 1
            if store:
                self.insert(key, g)
            return g, True

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()


_STORE = _GraphStore(MAX_ENTRIES, MAX_BYTES)


def clear() -> None:
    """Drop every stored graph (their device memory goes back to torch's
    caching allocator)."""
    _STORE.clear()


def store_info() -> Dict[str, int]:
    """The store's size now: graphs kept, the bytes of their static
    buffers, and the graphs dropped so far to keep within the bounds."""
    with _STORE._lock:
        graphs = len(_STORE._graphs)
    return {"graphs": graphs, "bytes": _STORE.nbytes(), "evictions": _STORE.evictions}


def _on_cuda(args) -> bool:
    return bool(args) and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda"


def aot_load_or_compile(name: str, fn: Callable, args: Tuple[torch.Tensor, ...],
                        statics: Optional[Dict[str, Any]] = None, *, variants=None,
                        on_capture: Optional[Callable[[], None]] = None,
                        borrow: int = 0) -> Optional[CapturedGraph]:
    """The stored graph of ``(name, key)``, captured on a miss; None when
    the store is off or the inputs are not on a CUDA device (the caller
    then runs its eager dispatch). ``variants``: dicts of further statics,
    one graph each over the same buffers. ``on_capture()`` runs when this
    call captured. ``borrow``: the number of leading inputs that are the
    caller's buffers themselves (the module docstring)."""
    statics = statics or {}
    if not store_enabled() or not _on_cuda(args):
        return None
    key_statics = dict(statics)
    if variants is not None:
        key_statics["variants"] = variants
    if borrow:
        # a borrowed buffer is alive while a stored graph holds it, so its
        # address names it
        key_statics["borrow"] = tuple(a.data_ptr() for a in args[:borrow])
    key = entry_key(name, args, key_statics)
    g = _STORE.lookup(key)
    if g is None:
        g, fresh = _STORE.capture(name, key, fn, args, statics, store=True, variants=variants, borrow=borrow)
        if fresh:
            STATS.record(name, "miss", g.capture_s)
            if on_capture is not None:
                on_capture()
            return g
    STATS.record(name, "hit", g.capture_s)
    return g


def load_or_build(name: str, fn: Callable, args: Tuple[torch.Tensor, ...],
                  statics: Optional[Dict[str, Any]] = None) -> CapturedGraph:
    """Like :func:`aot_load_or_compile`, but always a graph: with the store
    off it captures one that is not stored (as the JAX function compiles
    without its store). The inputs must be CUDA tensors."""
    g = aot_load_or_compile(name, fn, args, statics)
    if g is None:
        statics = statics or {}
        g, _ = _STORE.capture(name, entry_key(name, args, statics), fn, args, statics, store=False)
    return g


def warm_entry(name: str, fn: Callable, args: Tuple[torch.Tensor, ...],
               statics: Optional[Dict[str, Any]] = None) -> float:
    """Capture one entry without replaying it (serve warm-up, bench legs)
    -> wall seconds spent: a lookup on a stored key, a capture otherwise."""
    t0 = time.perf_counter()
    load_or_build(name, fn, args, statics)
    return time.perf_counter() - t0


class GraphEntry:
    """A named entry point of the store, the counterpart of a jitted
    callable. ``entry.graph(*args, **statics)`` is the stored graph of
    ``fn`` for these inputs (captured on a miss), or None when the store is
    off or the inputs lie on the CPU, where the caller runs ``fn`` eagerly.
    ``_cache_size()`` is the number of captures made under its name in
    this process, which ``analysis.contracts.RecompilationGuard`` reads as
    it reads a jit's cache."""

    def __init__(self, name: str, fn: Callable) -> None:
        self.name = name
        self.fn = fn

    def graph(self, *args: torch.Tensor, variants=None, on_capture: Optional[Callable[[], None]] = None,
              borrow: int = 0, **statics) -> Optional[CapturedGraph]:
        return aot_load_or_compile(self.name, self.fn, args, statics, variants=variants,
                                   on_capture=on_capture, borrow=borrow)

    def _cache_size(self) -> int:
        with _STORE._lock:
            return _STORE.captures.get(self.name, 0)


class KeyCaptures:
    """The captures made of one key in this process, as a guard entry
    (``_cache_size()``): a loop that holds a graph of this key must not
    capture it again, whatever other keys of its entry other threads
    capture meanwhile."""

    def __init__(self, key: str) -> None:
        self.key = key

    def _cache_size(self) -> int:
        with _STORE._lock:
            return _STORE.key_captures.get(self.key, 0)

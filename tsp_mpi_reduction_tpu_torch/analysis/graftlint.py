"""graftlint: AST lint pass for the torch/CUDA hazard classes of the port.

Counterpart of ``tsp_mpi_reduction_tpu/analysis/graftlint.py``. A rule id
names the same hazard class in both packages; the JAX rules R1-R4, R7 and
R8 are re-targeted at their torch/CUDA form, R5, R6 and R13 are carried
unchanged. Each hazard is mechanically detectable from the AST:

  R1  host-pull-in-hot-loop: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
      ``.numpy()`` / ``.to("cpu")`` / ``np.asarray`` / ``np.array`` /
      ``int()`` / ``float()`` / ``bool()`` of a device tensor inside a loop
      body or a known hot-path function: every occurrence is a
      device-to-host copy that waits for the stream, on the search's
      critical path. So is an op whose output size depends on the data
      (``torch.nonzero``, one-argument ``torch.where``, ``unique``,
      ``masked_select``, ``repeat_interleave`` without ``output_size``, a
      boolean-mask subscript): the host reads the count back to size it.
  R2  round-trip-reupload / host constant upload: ``torch.tensor`` /
      ``torch.as_tensor`` / ``torch.from_numpy(..).to(dev)`` / ``.cuda()``
      of a value pulled from the device earlier in the same function (the
      down-modify-up pattern), or a device tensor built from host data
      (``torch.tensor(x, device=dev)``) in a hot context: a synchronous
      host-to-device copy per iteration. A sliced write-back
      ``buf[:k].copy_(torch.from_numpy(rows))`` uploads only the mutated
      prefix and is the sanctioned form.
  R3  implicit-bool-of-a-device-tensor: ``if`` / ``while`` / ``assert`` /
      ``and`` / ``or`` / ``not`` / a ternary whose test is a device tensor
      calls ``Tensor.__bool__``: a hidden device-to-host sync, and a break
      in any CUDA-graph capture. An explicit ``bool()`` / ``int()`` /
      ``.item()`` makes the read visible (and R1 judges it).
  R4  torch-launches-in-a-python-loop: a ``for`` / ``while`` loop in a hot
      function whose body launches torch work on device tensors relaunches
      those kernels every iteration, each paying the host's launch cost;
      reported once per loop, anchored on the loop statement.
  R5  early-return-drops-state: a function overwrites ``self.<attr>`` state,
      computes locals from it, then has an early ``return None`` path that
      writes nothing back — the ``_partition`` ``take==0`` bug class.
  R6  non-atomic-durable-write: ``open(path, "w")`` / ``np.savez*`` /
      ``torch.save`` straight to a final path in a scope with no
      ``os.replace``: a crash mid-write leaves a truncated artifact. Writes
      to in-memory buffers and temp-named paths are exempt, as is any scope
      that ``os.replace``-publishes; use
      ``resilience.checkpoint.write_json_atomic`` / ``write_atomic``.
  R7  frontier-not-in-place: a function that takes a frontier (a parameter
      annotated ``Frontier`` or named ``fr`` / ``fr_stacked`` /
      ``frontier`` / ``nodes``) builds a NEW frontier buffer —
      ``Frontier(<fresh tensor>, ..)`` or ``fr.nodes = <fresh tensor>``,
      where fresh is a torch factory (``cat``, ``stack``, ``empty``,
      ``zeros``, ``full``, ...), an out-of-place ``torch.where``,
      ``.clone()``, ``.contiguous()`` or ``.to(<dtype>)``. The
      reservoir-sized buffer is written in place; this is the static form
      of ``contracts.check_donated``. A harness that copies on purpose opts
      out with an inline disable.
  R8  recording-inside-graph-capture: a telemetry recording (``REGISTRY``,
      spans, the samplers) inside a CUDA-graph capture region — a
      ``with torch.cuda.graph(..):`` or ``with capture_region(..):`` (the
      graph store's) body, or a def handed by name to
      ``torch.cuda.make_graphed_callables`` — runs once at capture and
      never at replay.
  R13 unbounded metric-label cardinality at a registry call site.
  R14 index-by-a-0-d-device-tensor: a subscript, read or write, whose
      index is a 0-d device tensor (``x[t.argmin()]``, ``row[i // n] = v``
      with ``i`` bound from a full reduction) calls ``Tensor.__index__``:
      the host reads the index back (a hidden sync, and a break in any
      CUDA-graph capture). ``gather`` / ``index_select`` / ``scatter_`` /
      ``index_put_`` with a 1-element index tensor keep it on the device.
      A 0-d value is a full reduction (``argmin`` / ``argmax`` / ``sum`` /
      ``amin`` ... with no ``dim``), or arithmetic, a cast, a clamp or a
      0-d-indexed read of one; a port-only rule (the JAX lint has no counterpart: a traced
      index never reads the host).

Escape hatches (both are honored, in this order):

- ``# graftlint: disable=R1,R4`` on the flagged line, the line above, or the
  ``def`` line of the enclosing function (which disables for the whole body);
  bare ``# graftlint: disable`` silences every rule.
- a checked-in baseline (``graftlint_baseline.json`` next to this module):
  accepted pre-existing sites, keyed by (path, rule, scope, code-text) so
  line-number churn never invalidates it. ``--write-baseline`` regenerates.

``# graftlint: hot`` on a ``def`` line marks that function as a hot path, so
R1, R2 and R4 apply to its whole body (not only lexical loop bodies); the
functions in ``DEFAULT_HOT_PATHS`` are hot by default.

Without types, a value counts as a device tensor when it reads a
``DEVICE_ATTRS`` field, is a name bound from a ``torch.*`` call, a kernel
wrapper or another device expression, or is a parameter annotated
``torch.Tensor`` / ``Frontier`` / ``PaddedTour``.

The pass is stdlib-only (``ast`` + ``tokenize``): it runs before any device
exists (the sweep's gate) and must never import torch.
"""

from __future__ import annotations

import ast
import io
import json
import pathlib
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = {
    "R1": "device->host pull inside a hot loop",
    "R2": "synchronous host->device upload in a hot context",
    "R3": "Python control flow on a device tensor (implicit __bool__ sync)",
    "R4": "torch launches inside a Python loop of a hot function",
    "R5": "early return None drops mutated self state",
    "R6": "non-atomic write of a durable artifact",
    "R7": "frontier function builds a new frontier buffer",
    "R8": "metric/trace recording inside a CUDA-graph capture",
    "R13": "unbounded metric-label cardinality at a registry call site",
    "R14": "indexing or assigning by a 0-d device tensor (a hidden read of the index)",
}

#: functions whose WHOLE body R1, R2 and R4 treat as a hot loop: the
#: reservoir spill/refill machinery runs once per spill event inside the
#: solve loop, the B&B loops once per step, and the fold's per-merge
#: functions 1023 times a 1024-block fold
DEFAULT_HOT_PATHS = frozenset(
    {
        "exchange",
        "refill",
        "_keep_live_only",
        "spill_refill",
        "_fetch_live_rows",  # the ONE accepted live-prefix fetch site
        "_apply_keeps",
        "_rank_counts",
        "_expand_loop",
        "_guarded_expand_steps",
        "_pop_stage",  # the step's pop: inside the step's graph, no host read
        "_read_counters",  # the B&B loop's one read a run of inner_steps steps
        "_search_step",  # the B&B step's captured graph: replayed every step
        "fold_tours",
        "_fold_step",  # the fold's captured step: replayed 1023 times a fold
        "merge_tours",
        "_merge",
        "_merge_from_sc",
    }
)

#: attribute names that name device-resident tensors in this codebase
#: (Frontier / PaddedTour fields) — ``int(fr.count)`` is a device read
#: even though ``fr`` itself is just a parameter name to the AST.
DEVICE_ATTRS = frozenset({"nodes", "count", "overflow", "ids", "length", "cost"})
#: tensor attributes that are host metadata, never a device value
_META_ATTRS = frozenset(
    {"shape", "dtype", "device", "ndim", "is_cuda", "layout", "type",
     "requires_grad", "is_leaf", "names", "itemsize", "nbytes"}
)
#: tensor methods that return host values or metadata, not device tensors
_HOST_METHODS = frozenset(
    {"item", "tolist", "cpu", "numpy", "size", "dim", "numel", "data_ptr",
     "element_size", "stride", "storage_offset", "is_contiguous",
     "get_device", "untyped_storage", "nelement", "ndimension"}
)
#: torch calls that produce host data or no tensor at all
_TORCH_HOST_CALLS = frozenset(
    {"torch.from_numpy", "torch.device", "torch.Generator", "torch.manual_seed",
     "torch.set_num_threads", "torch.get_num_threads", "torch.finfo", "torch.iinfo",
     "torch.is_tensor", "torch.equal", "torch.allclose", "torch.save", "torch.load",
     "torch.no_grad", "torch.inference_mode", "torch.Size", "torch.dtype"}
)
#: torch sub-namespaces that are not tensor math
_TORCH_NON_TENSOR = ("torch.cuda.", "torch.backends.", "torch.profiler.",
                     "torch.distributed.", "torch.multiprocessing.", "torch.utils.",
                     "torch.autograd.", "torch.testing.", "torch.library.")
#: the hand kernels' wrappers: their results live on the device
_KERNEL_WRAPPERS = frozenset(
    {"relax_minplus", "relax_dense_sweep", "prim_chain", "push_rows", "child_rows"}
)
#: calls that take tensors but launch nothing (R4)
_NON_LAUNCH_CALLS = frozenset(
    {"len", "isinstance", "print", "id", "type", "repr", "str", "getattr",
     "hasattr", "tuple", "list", "dict", "zip", "enumerate", "range", "sorted",
     "min", "max", "int", "float", "bool"}
)
#: module roots whose calls produce device tensors
_DEVICE_MODULES = ("torch",)
#: host-pull callables (R1) — dotted names
_HOST_PULL_CALLS = frozenset({"np.asarray", "np.array", "numpy.asarray", "numpy.array"})
#: host-pull tensor methods (R1)
_HOST_PULL_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: torch ops whose output size depends on the data (R1): the host reads
#: the count back before it can allocate the result
_DATA_SHAPED_CALLS = frozenset(
    {"torch.nonzero", "torch.argwhere", "torch.unique", "torch.unique_consecutive",
     "torch.masked_select", "torch.repeat_interleave"}
)
_DATA_SHAPED_METHODS = frozenset(
    {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
     "repeat_interleave"}
)
#: reductions that make a 0-d tensor when given no ``dim`` (R14)
_FULL_REDUCTIONS = frozenset(
    {"argmin", "argmax", "sum", "prod", "mean", "amin", "amax", "min", "max", "any", "all",
     "count_nonzero"}
)
#: tensor methods that keep a 0-d value 0-d (R14)
_ZEROD_KEEPING = frozenset(
    {"to", "long", "int", "float", "double", "clone", "detach", "clamp", "clamp_min",
     "clamp_max", "abs", "neg"}
)
#: calls that make a device bool mask (R1's boolean-mask subscripts)
_MASK_CALLS = frozenset(
    {"torch.isfinite", "torch.isnan", "torch.isinf", "torch.logical_and",
     "torch.logical_or", "torch.logical_not", "torch.logical_xor", "torch.isin"}
)
#: scalar conversions that read a device tensor's value (R1) and make a
#: test explicit (R3)
_SCALAR_CONVERSIONS = frozenset({"float", "int", "bool"})
_SCALAR_CONVERSION_ATTRS = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array", "np.float64"}
)
#: device-upload callables (R2)
_UPLOAD_CALLS = frozenset({"torch.tensor", "torch.as_tensor"})
#: numpy/torch artifact writers that publish durable bytes to a path (R6)
_DURABLE_NP_WRITES = frozenset(
    {
        "np.save",
        "np.savez",
        "np.savez_compressed",
        "numpy.save",
        "numpy.savez",
        "numpy.savez_compressed",
        "torch.save",
    }
)
#: in-memory buffer factories whose "writes" are not durable (R6 exempt)
_BUFFER_FACTORIES = frozenset(
    {"io.BytesIO", "BytesIO", "io.StringIO", "StringIO"}
)
#: calls that make the enclosing scope an atomic-publish pattern (R6)
_ATOMIC_PUBLISH_CALLS = frozenset({"os.replace", "os.rename"})
#: parameter names that denote a frontier/reservoir-sized device buffer
#: (R7); a parameter ANNOTATED ``Frontier`` counts regardless of name
_FRONTIER_PARAMS = frozenset({"fr", "fr_stacked", "frontier", "nodes"})
#: torch calls that allocate a fresh tensor (R7)
_FRESH_TORCH_CALLS = frozenset(
    {"cat", "concat", "stack", "empty", "zeros", "ones", "full", "empty_like",
     "zeros_like", "ones_like", "full_like", "where", "tensor", "as_tensor",
     "clone", "vstack", "hstack", "arange"}
)
#: tensor methods that return a copy, not a view (R7)
_COPY_METHODS = frozenset({"clone", "contiguous"})
#: CUDA-graph capture spellings (R8); ``capture_region`` is the graph
#: store's (``perf/compile_cache.py``)
_GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph", "graph", "capture_region",
                             "compile_cache.capture_region"})
_GRAPHED_CALLABLES = frozenset(
    {"torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
     "make_graphed_callables"}
)
#: obs recorder receivers (R8): the dotted ROOT names the telemetry
#: layer's globals/modules are bound to across the codebase, however
#: aliased at import
_OBS_RECORDER_ROOTS = frozenset(
    {
        "REGISTRY", "_REGISTRY", "HEALTH", "TRACER", "STATS",
        "metrics", "tracing", "timeseries", "obs",
        "_obs_metrics", "_obs_tracing", "_obs_series",
        "_metrics", "_tracing", "_obs_rank", "_obs_anomaly", "rankview",
        "_costs", "costs", "obs_costs", "_slo", "slo",
    }
)
#: recorder method names (R8) — only flagged on the roots above
_OBS_RECORDER_VERBS = frozenset(
    {
        "inc", "set_gauge", "observe", "incr", "incr_fault",
        "add_event", "record", "sample", "span", "emit_span", "event",
        "fold_bnb_solve", "step_annotation", "record_launch",
    }
)
#: bare-name recorder calls (``from obs.tracing import span``)
_OBS_BARE_CALLS = frozenset({"span", "add_event", "emit_span"})
#: registry receivers R13 governs — label kwargs at these call sites must
#: have BOUNDED value sets; the registry keeps one series per distinct
#: label tuple forever, so an f-string / loop-variable / per-request
#: label is an unbounded-memory + scrape-size leak
_R13_REGISTRY_ROOTS = frozenset({"REGISTRY", "_REGISTRY"})
#: recording verbs whose keyword args are label values
_R13_RECORD_VERBS = frozenset({"inc", "set_gauge", "observe"})
#: kwargs of those verbs that are NOT labels
_R13_NON_LABEL_KWARGS = frozenset({"value"})
#: names that hold a per-request payload (a label drawn from one has
#: request-cardinality by construction)
_R13_REQUEST_NAMES = frozenset({"request", "req"})


@dataclass(frozen=True)
class Violation:
    path: str  # repo-relative posix path
    line: int
    rule: str
    scope: str  # qualified function name, or "<module>"
    code: str  # stripped source of the flagged line
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline (stable across
        unrelated edits; moves with the code text itself)."""
        return f"{self.path}::{self.rule}::{self.scope}::{self.code}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.scope}] "
            f"{self.message}\n    {self.code}"
        )


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _walk_own(root: ast.AST):
    """ast.walk over ``root``'s OWN code: nested function/lambda bodies are
    pruned (ast.walk's flat iteration would attribute their statements to
    the enclosing scope — they get their own visit instead)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            stack.append(child)


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an attribute/subscript/call chain."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


class _Directives:
    """Per-line ``# graftlint: ...`` comment directives, via tokenize (the
    AST drops comments). ``disable[line]`` is a rule set; ``{"*"}`` = all."""

    def __init__(self, source: str):
        self.disable: Dict[int, Set[str]] = {}
        self.hot_lines: Set[int] = set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                # the directive may trail prose in the same comment:
                # "# one read a step  # graftlint: disable=R1"
                marker = tok.string.find("graftlint:")
                if marker < 0:
                    continue
                body = tok.string[marker + len("graftlint:"):].strip()
                if body.startswith("disable"):
                    _, _, spec = body.partition("=")
                    rules = (
                        {r.strip().split()[0] for r in spec.split(",") if r.strip()}
                        if "=" in body
                        else {"*"}
                    )
                    self.disable.setdefault(tok.start[0], set()).update(rules)
                elif body.startswith("hot"):
                    self.hot_lines.add(tok.start[0])
        except tokenize.TokenError:
            pass

    def suppressed(self, line: int, rule: str, def_line: Optional[int]) -> bool:
        for ln in (line, line - 1, def_line):
            if ln is None:
                continue
            rules = self.disable.get(ln)
            if rules and ("*" in rules or rule in rules):
                return True
        return False


def _ann_tail(ann: Optional[ast.AST]) -> str:
    """The last dotted part of an annotation, through ``Optional[X]``."""
    if ann is None:
        return ""
    if isinstance(ann, ast.Subscript):
        ann = ann.slice
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.rsplit(".", 1)[-1]
    return (_dotted(ann) or "").rsplit(".", 1)[-1]


def _all_args(args: ast.arguments) -> List[ast.arg]:
    return list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)


def _frontier_param(args: ast.arguments) -> Optional[str]:
    """The first parameter naming/annotating a frontier-sized buffer, or
    None. Annotation ``Frontier`` (any dotting) counts regardless of the
    parameter's name; otherwise the name itself must be one of
    ``_FRONTIER_PARAMS``."""
    for a in _all_args(args):
        if a.arg in _FRONTIER_PARAMS or _ann_tail(a.annotation) == "Frontier":
            return a.arg
    return None


def _device_params(args: ast.arguments) -> Set[str]:
    """Parameters annotated as device tensors (``torch.Tensor``,
    ``Frontier``, ``PaddedTour``, ``Optional`` of those)."""
    return {
        a.arg
        for a in _all_args(args)
        if _ann_tail(a.annotation) in ("Tensor", "Frontier", "PaddedTour")
    }


def _graph_captured_names(tree: ast.Module) -> Set[str]:
    """Def names handed to ``torch.cuda.make_graphed_callables`` (R8):
    their bodies run at capture only. Name-matched per module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in _GRAPHED_CALLABLES:
            for arg in node.args:
                elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
                for el in elts:
                    if isinstance(el, ast.Name):
                        out.add(el.id)
    return out


class _FileLinter(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        source: str,
        tree: ast.Module,
        rules: Set[str],
        hot_paths: Set[str],
    ):
        self.path = path
        self.lines = source.splitlines()
        self.tree = tree
        self.rules = rules
        self.hot_paths = hot_paths
        self.directives = _Directives(source)
        self.captured_callees = _graph_captured_names(tree)
        self.violations: List[Violation] = []
        #: violations an inline ``# graftlint: disable`` waived
        self.waived: List[Violation] = []
        # lexical state
        self.scope: List[str] = []
        self.def_lines: List[int] = []
        self.loop_depth = 0
        self.hot = False
        #: is the current code inside a CUDA-graph capture region (R8)?
        self.capture_scope = False
        self.device_names: Set[str] = set()  # bound from device expressions
        self.pulled_names: Set[str] = set()  # bound from host pulls
        self.fresh_names: Set[str] = set()  # bound from fresh tensors (R7)
        self.mask_names: Set[str] = set()  # bound from device bool masks (R1)
        self.zerod_names: Set[str] = set()  # bound from 0-d device values (R14)
        self.buffer_names: Set[str] = set()  # assigned from io.BytesIO etc.
        self.loop_targets: Set[str] = set()  # names bound by enclosing fors (R13)
        #: the subset of loop_targets bound by ``for x in range(...)``
        #: loops — bounded cardinality by construction (R13 exemption:
        #: rank ids from range(num_ranks) can never outgrow the mesh)
        self.bounded_targets: Set[str] = set()
        #: the current function's frontier parameter (R7), or None
        self.frontier_param: Optional[str] = None
        #: ids of upload calls that are the argument of a sliced
        #: ``buf[..].copy_(..)`` write-back (R2 exempt)
        self.sliced_writebacks: Set[int] = set()
        #: does the current scope os.replace-publish (the atomic pattern)?
        self.atomic_scope = self._scope_is_atomic(tree)

    # -- reporting ---------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 1)
        def_line = self.def_lines[-1] if self.def_lines else None
        code = (
            self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""
        )
        scope = ".".join(self.scope) if self.scope else "<module>"
        v = Violation(self.path, line, rule, scope, code, message)
        if self.directives.suppressed(line, rule, def_line):
            self.waived.append(v)
            return
        self.violations.append(v)

    @property
    def in_hot(self) -> bool:
        return self.loop_depth > 0 or self.hot

    # -- scope bookkeeping -------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_func(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node) -> None:
        saved = (
            self.hot,
            self.loop_depth,
            self.device_names,
            self.pulled_names,
            self.fresh_names,
            self.mask_names,
            self.zerod_names,
            self.buffer_names,
            self.atomic_scope,
            self.capture_scope,
            self.loop_targets,
            self.bounded_targets,
            self.frontier_param,
        )
        self.scope.append(node.name)
        self.def_lines.append(node.lineno)
        self.hot = is_hot_def(node, self.hot_paths, self.directives)
        # R8 scope: a def handed to make_graphed_callables, or any def
        # nested inside a capture region
        self.capture_scope = self.capture_scope or node.name in self.captured_callees
        self.loop_depth = 0
        self.device_names = _device_params(node.args)
        self.pulled_names = set()
        self.fresh_names = set()
        self.mask_names = set()
        self.zerod_names = set()
        self.buffer_names = set()
        self.loop_targets = set()
        self.bounded_targets = set()
        self.frontier_param = _frontier_param(node.args)
        self.atomic_scope = self._scope_is_atomic(node)
        self._check_r5(node)
        for child in node.body:
            self.visit(child)
        self.def_lines.pop()
        self.scope.pop()
        (
            self.hot,
            self.loop_depth,
            self.device_names,
            self.pulled_names,
            self.fresh_names,
            self.mask_names,
            self.zerod_names,
            self.buffer_names,
            self.atomic_scope,
            self.capture_scope,
            self.loop_targets,
            self.bounded_targets,
            self.frontier_param,
        ) = saved

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda runs later: its body is not in the enclosing loop
        saved = self.loop_depth
        self.loop_depth = 0
        self.generic_visit(node)
        self.loop_depth = saved

    # -- loops -------------------------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        self._check_r4(node)
        self.visit(node.iter)
        self.loop_depth += 1
        # R13: names this loop binds are loop-variable labels in its body;
        # a ``for x in range(...)`` target is BOUNDED (the label set can
        # never outgrow the range — rank ids from range(num_ranks) are
        # the canonical case), any other iterable is not, and an inner
        # non-range loop re-binding a bounded name strips the exemption
        saved_targets = set(self.loop_targets)
        saved_bounded = set(self.bounded_targets)
        targets = self._target_names([node.target])
        for group in (self.device_names, self.pulled_names, self.fresh_names):
            group.difference_update(targets)
        if self._is_device_expr(node.iter):
            self.device_names.update(targets)  # rows of a device tensor
        self.loop_targets.update(targets)
        if self._iter_is_bounded(node.iter):
            self.bounded_targets.update(targets)
        else:
            self.bounded_targets.difference_update(targets)
        self.visit(node.target)
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_targets = saved_targets
        # On exit, adjust only THIS loop's own targets: a range loop's
        # revert to their pre-loop status (conservative — the var holds
        # the last range value, but the pre-loop binding is what the
        # rest of the scope was written against), a non-range loop's
        # stay STRIPPED (the name still holds an element of the
        # unbounded iterable; Python loop vars outlive the loop). Strips
        # of OTHER names made inside the body persist — a wholesale
        # snapshot restore would resurrect a name an inner
        # `for r in requests:` rebind had stripped.
        bounded_iter = self._iter_is_bounded(node.iter)
        for t in targets:
            if bounded_iter and t in saved_bounded:
                self.bounded_targets.add(t)
            else:
                self.bounded_targets.discard(t)
        self.loop_depth -= 1

    @staticmethod
    def _iter_is_bounded(it: ast.AST) -> bool:
        """Is this for-loop iterable a bounded label source? ``range(...)``
        (and ``enumerate(range(...))``) over configuration-shaped
        arguments — names, constants, attributes, arithmetic thereof
        (``range(num_ranks)``, ``range(2 * R)``). A range whose argument
        embeds a CALL — ``range(len(requests))``,
        ``range(queue.qsize())`` — is sized by DATA, so its label set
        grows with the process's traffic: exactly the unbounded
        cardinality R13 exists to catch, not exempt."""
        if (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "enumerate"
            and it.args
        ):
            it = it.args[0]
        if not (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "range"
        ):
            return False
        return not any(
            isinstance(sub, ast.Call)
            for arg in it.args
            for sub in ast.walk(arg)
        )

    def visit_While(self, node: ast.While) -> None:
        self._check_r4(node)
        # the test runs every iteration: it is inside the loop
        self.loop_depth += 1
        self._check_r3_test(node, node.test)
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_If(self, node: ast.If) -> None:
        self._check_r3_test(node, node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_r3_test(node, node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_r3_test(node, node.test)
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        # every operand but the last is tested for truth
        for value in node.values[:-1]:
            self._check_r3_test(node, value)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        captures = any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func) in _GRAPH_CONTEXTS
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        saved = self.capture_scope
        self.capture_scope = self.capture_scope or captures
        for stmt in node.body:
            self.visit(stmt)
        self.capture_scope = saved

    # -- assignments: device / pulled / fresh tracking -----------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        # ``buf[rows] = torch.from_numpy(block).to(dev)``: a sliced
        # write-back, like ``buf[:k].copy_(..)`` (R2 exempt)
        if any(isinstance(t, ast.Subscript) for t in node.targets):
            self.sliced_writebacks.add(id(node.value))
        # the value is evaluated before the targets are bound
        self.visit(node.value)
        self._check_r7_assign(node.targets, node.value)
        self._track_assignment(node.targets, node.value)
        for tgt in node.targets:
            self.visit(tgt)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._check_r7_assign([node.target], node.value)
            self._track_assignment([node.target], node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)

    def _target_names(self, targets) -> List[str]:
        names: List[str] = []
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                names.extend(self._target_names(tgt.elts))
            elif isinstance(tgt, ast.Starred):
                names.extend(self._target_names([tgt.value]))
        return names

    def _track_assignment(self, targets, value) -> None:
        names = self._target_names(targets)
        if not names:
            return
        # classify the value against the bindings BEFORE this one
        device = self._is_device_expr(value) or self._is_device_tuple(value)
        pulled = self._is_host_pull(value)
        fresh = self._is_fresh_tensor(value)
        mask = self._is_device_mask(value)
        zerod = self._is_zerod(value)
        buffer = isinstance(value, ast.Call) and _dotted(value.func) in _BUFFER_FACTORIES
        # state threading: ``fr, inc_cost = step(fr, inc_cost, ..)`` hands
        # the device values back under the same names
        threaded = set()
        if isinstance(value, ast.Call):
            threaded = {
                a.id for a in list(value.args) + [kw.value for kw in value.keywords]
                if isinstance(a, ast.Name) and a.id in self.device_names
            } & set(names)
        for group in (
            self.device_names,
            self.pulled_names,
            self.fresh_names,
            self.mask_names,
            self.zerod_names,
            self.buffer_names,
        ):
            group.difference_update(names)  # rebinding clears prior status
        if device:
            self.device_names.update(names)
        self.device_names.update(threaded)
        if pulled:
            self.pulled_names.update(names)
        if fresh:
            self.fresh_names.update(names)
        if mask:
            self.mask_names.update(names)
        if zerod and len(names) == 1:
            self.zerod_names.update(names)
        # ``a, b = x // n, x % n``: element by element
        if (len(targets) == 1 and isinstance(targets[0], ast.Tuple) and isinstance(value, ast.Tuple)
                and len(targets[0].elts) == len(value.elts)):
            for tgt, elt in zip(targets[0].elts, value.elts):
                if isinstance(tgt, ast.Name) and self._is_zerod(elt):
                    self.zerod_names.add(tgt.id)
        if buffer:
            self.buffer_names.update(names)

    def _is_device_tuple(self, value: ast.AST) -> bool:
        """``a, b = t1, t2`` / ``x, y = wrapper(...)``: the unpacked names
        are device values when every element (or the call) is one."""
        if isinstance(value, ast.Tuple):
            return bool(value.elts) and all(self._is_device_expr(e) for e in value.elts)
        return False

    # -- the device-tensor heuristic -----------------------------------------

    def _is_device_call(self, node: ast.Call, strict: bool = False) -> bool:
        name = _dotted(node.func) or ""
        root = name.split(".", 1)[0]
        if root in _DEVICE_MODULES:
            if name in _TORCH_HOST_CALLS or name.startswith(_TORCH_NON_TENSOR):
                return False
            # an explicit host placement makes a host tensor
            for kw in node.keywords:
                if kw.arg == "device" and _is_cpu_literal(kw.value):
                    return False
            return True
        if name.rsplit(".", 1)[-1] in _KERNEL_WRAPPERS:
            return True
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in _HOST_METHODS:
                return False
            if meth == "to" and _moves_to_cpu(node):
                return False
            return self._is_device_expr(node.func.value, strict)
        return False

    def _is_device_expr(self, node: ast.AST, strict: bool = False) -> bool:
        """Heuristic: does this expression name a device tensor? A
        ``DEVICE_ATTRS`` field counts on any object, or under ``strict``
        only on a device value or a frontier-named parameter (``fr.count``,
        not ``res.cost`` of a host result)."""
        if isinstance(node, ast.Name):
            return node.id in self.device_names
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            if node.attr in DEVICE_ATTRS and (
                not strict
                or isinstance(node.value, ast.Name) and node.value.id in _FRONTIER_PARAMS
            ):
                return True
            return self._is_device_expr(node.value, strict)
        if isinstance(node, ast.Subscript):
            return self._is_device_expr(node.value, strict)
        if isinstance(node, ast.Call):
            return self._is_device_call(node, strict)
        if isinstance(node, ast.BinOp):
            return self._is_device_expr(node.left, strict) or self._is_device_expr(node.right, strict)
        if isinstance(node, ast.UnaryOp) and not isinstance(node.op, ast.Not):
            return self._is_device_expr(node.operand, strict)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return any(self._is_device_expr(x, strict) for x in [node.left] + node.comparators)
        return False

    def _is_device_mask(self, node: ast.AST) -> bool:
        """A device bool tensor: a comparison of device values, ``&`` /
        ``|`` / ``^`` / ``~`` of masks, ``torch.isfinite`` and kin, or a
        name bound from one."""
        if isinstance(node, ast.Name):
            return node.id in self.mask_names
        if isinstance(node, ast.Compare):
            return self._is_device_expr(node)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_device_mask(node.left) or self._is_device_mask(node.right)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_device_mask(node.operand)
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            if name in _MASK_CALLS:
                return True
            return (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "bool"
                and self._is_device_expr(node.func.value)
            )
        return False

    def _is_zerod(self, node: ast.AST) -> bool:
        """A 0-d device tensor (R14): a full reduction of a device tensor
        (no ``dim``), a name bound from one, or arithmetic, a cast or a
        clamp of one with host scalars or other 0-d values."""
        if isinstance(node, ast.Name):
            return node.id in self.zerod_names
        if isinstance(node, ast.BinOp):
            sides = (node.left, node.right)
            return any(self._is_zerod(x) for x in sides) and all(
                self._is_zerod(x) or not self._is_device_expr(x) for x in sides)
        if isinstance(node, ast.UnaryOp) and not isinstance(node.op, ast.Not):
            return self._is_zerod(node.operand)
        if isinstance(node, ast.Subscript):  # a [k] tensor read at a 0-d index
            return self._is_device_expr(node.value) and self._is_zerod(node.slice)
        if not isinstance(node, ast.Call):
            return False
        name = _dotted(node.func) or ""
        has_dim = any(kw.arg in ("dim", "axis") for kw in node.keywords)
        if name.startswith("torch.") and name.split(".", 1)[1] in _FULL_REDUCTIONS:
            return len(node.args) == 1 and not has_dim and self._is_device_expr(node.args[0])
        if name in ("torch.clamp", "torch.minimum", "torch.maximum"):
            return bool(node.args) and self._is_zerod(node.args[0])
        if isinstance(node.func, ast.Attribute):
            meth, recv = node.func.attr, node.func.value
            if meth in _FULL_REDUCTIONS:
                return not node.args and not has_dim and self._is_device_expr(recv)
            if meth in _ZEROD_KEEPING:
                return self._is_zerod(recv)
        return False

    def _is_host_pull(self, node: ast.AST) -> bool:
        """A call that copies a device tensor to host data."""
        if isinstance(node, ast.Subscript):
            return self._is_host_pull(node.value)
        if not isinstance(node, ast.Call):
            return False
        name = _dotted(node.func)
        if name in _HOST_PULL_CALLS or name in _SCALAR_CONVERSIONS:
            return bool(node.args) and (
                self._is_device_expr(node.args[0]) or self._is_host_pull(node.args[0])
            )
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if node.func.attr in _HOST_PULL_METHODS or (
                node.func.attr == "to" and _moves_to_cpu(node)
            ):
                return self._is_device_expr(recv) or self._is_host_pull(recv)
            if node.func.attr == "copy":  # np .copy() of a pulled array
                return self._is_host_pull(recv)
        return False

    def _is_fresh_tensor(self, node: ast.AST) -> bool:
        """A freshly allocated tensor (R7): a torch factory/cat/where, or
        ``.clone()`` / ``.contiguous()`` / ``.to(<dtype>)`` of a tensor."""
        if isinstance(node, ast.Name):
            return node.id in self.fresh_names
        if not isinstance(node, ast.Call):
            return False
        name = _dotted(node.func) or ""
        if name.startswith("torch.") and name.split(".", 1)[1] in _FRESH_TORCH_CALLS:
            return True
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in _COPY_METHODS:
                return True
            if meth == "to" and _casts_dtype(node):
                return True
        return False

    # -- calls: R1 / R2 / R6 / R8 / R13 ----------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        self._check_r8(node, name)
        self._check_r13(node, name)
        self._check_r1(node, name)
        self._check_r2(node, name)
        self._check_r6(node, name)
        self._check_r7_call(node, name)
        # ``buf[:k].copy_(torch.from_numpy(rows))``: the sanctioned sliced
        # write-back (R2 exempt)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "copy_"
            and isinstance(node.func.value, ast.Subscript)
        ):
            for arg in node.args:
                self.sliced_writebacks.add(id(arg))
        self.generic_visit(node)

    def _check_r1(self, node: ast.Call, name: Optional[str]) -> None:
        if "R1" not in self.rules or not self.in_hot:
            return
        what = None
        if name in _HOST_PULL_CALLS or name in _SCALAR_CONVERSIONS:
            if node.args and self._is_device_expr(node.args[0]):
                what = f"{name}()"
        elif isinstance(node.func, ast.Attribute) and (
            node.func.attr in _HOST_PULL_METHODS
            or (node.func.attr == "to" and _moves_to_cpu(node))
        ):
            if self._is_device_expr(node.func.value):
                what = f".{node.func.attr}()"
        elif _data_shaped(node, name) and (
            name in _DATA_SHAPED_CALLS or name == "torch.where"
            or self._is_device_expr(node.func.value)
        ):
            what = f"{name or '.' + node.func.attr}() sizes its output by the data and"
        if what is not None:
            self._emit(
                node,
                "R1",
                f"{what} copies a device tensor to the host inside a hot "
                "loop — the host waits for the stream every iteration; "
                "hoist it out or keep the value on the device",
            )

    def visit_Subscript(self, node: ast.Subscript) -> None:
        index = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
        # any base: a list or a tensor indexed by a 0-d tensor calls __index__
        if "R14" in self.rules and any(self._is_zerod(i) for i in index):
            what = "write" if isinstance(node.ctx, ast.Store) else "read"
            self._emit(
                node,
                "R14",
                f"subscript {what} `{_short(node)}` indexes by a 0-d device tensor: "
                "Tensor.__index__ reads it back to the host (a hidden sync, and a break "
                "in a CUDA-graph capture); use gather / index_select / scatter_ with a "
                "1-element index tensor",
            )
        if (
            "R1" in self.rules
            and self.in_hot
            and isinstance(node.ctx, ast.Load)
            and self._is_device_expr(node.value)
            and self._is_device_mask(node.slice)
        ):
            self._emit(
                node,
                "R1",
                f"boolean-mask subscript `{_short(node)}` sizes its output by "
                "the data and copies the count to the host inside a hot loop — "
                "the host waits for the stream every iteration; keep the shape "
                "fixed (torch.where / a masked fill) or hoist it",
            )
        self.generic_visit(node)

    def _check_r2(self, node: ast.Call, name: Optional[str]) -> None:
        # R2 only fires in hot contexts: a one-time down-compute-up round
        # trip in setup code is legitimate; per-spill/per-iteration
        # uploads are the hazard
        if "R2" not in self.rules or not self.in_hot:
            return
        if id(node) in self.sliced_writebacks:
            return
        arg = node.args[0] if node.args else None
        upload = None
        if name in _UPLOAD_CALLS and arg is not None:
            if _has_device_kw(node):
                upload = name
        elif isinstance(node.func, ast.Attribute) and (
            node.func.attr == "cuda"
            or (node.func.attr == "to" and _moves_to_device(node))
        ):
            recv = node.func.value
            if (
                isinstance(recv, ast.Call)
                and _dotted(recv.func) == "torch.from_numpy"
                and recv.args
            ):
                upload, arg = f"torch.from_numpy(..).{node.func.attr}()", recv.args[0]
            elif isinstance(recv, ast.Name) and recv.id in self.pulled_names:
                upload, arg = f".{node.func.attr}()", recv
        if upload is None:
            return
        if isinstance(arg, ast.Name) and arg.id in self.pulled_names:
            self._emit(
                node,
                "R2",
                f"{upload} re-uploads `{arg.id}`, pulled from the device in "
                "this function — write the mutated slice back in place with "
                "buf[:k].copy_(...) instead",
            )
        elif not self._is_device_expr(arg):
            self._emit(
                node,
                "R2",
                f"{upload} builds a device tensor from host data in a hot "
                "context — a synchronous host-to-device copy every "
                "iteration; hoist the constant out of the loop or use a "
                "device fill (torch.full / a Python scalar operand)",
            )

    # -- R8: metric/trace recording inside a CUDA-graph capture ----------------

    def _check_r8(self, node: ast.Call, name: Optional[str]) -> None:
        """A registry/tracer recording inside a capture region runs once,
        while the graph is recorded; every replay launches the captured
        kernels and never runs the Python again, so the series counts one
        event for any number of replays. Record around the replay."""
        if "R8" not in self.rules or not self.capture_scope or name is None:
            return
        root, _, _rest = name.partition(".")
        verb = name.rsplit(".", 1)[-1]
        hit = (
            root in _OBS_RECORDER_ROOTS and verb in _OBS_RECORDER_VERBS
            if "." in name
            else name in _OBS_BARE_CALLS
        )
        if hit:
            self._emit(
                node,
                "R8",
                f"{name}() records host-side telemetry inside a CUDA-graph "
                "capture — it runs once at capture and never at replay "
                "(the series counts one event for every replay); move the "
                "recording to the host code around graph.replay()",
            )

    # -- R13: unbounded metric-label cardinality -----------------------------

    @staticmethod
    def _unwrap_str_call(node: ast.AST) -> ast.AST:
        """``str(x)`` around a label value changes nothing about its
        cardinality — look through one conversion layer."""
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "str"
            and node.args
        ):
            return node.args[0]
        return node

    def _r13_label_hazard(self, value: ast.AST) -> Optional[str]:
        """Why this label value has unbounded cardinality, or None."""
        value = self._unwrap_str_call(value)
        if isinstance(value, ast.JoinedStr):
            return "an f-string label mints a new series per formatted value"
        if (
            isinstance(value, ast.Name)
            and value.id in self.loop_targets
            # range()-bound loop vars are a bounded set (per-rank gauges
            # labeled from range(num_ranks) must never trip the rule)
            and value.id not in self.bounded_targets
        ):
            return (
                f"loop variable {value.id!r} as a label mints one series "
                "per iteration"
            )
        root = _root_name(value)
        if root in _R13_REQUEST_NAMES and isinstance(
            value, (ast.Subscript, ast.Attribute)
        ):
            return (
                "a per-request field as a label mints one series per "
                "distinct request"
            )
        if (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "get"
            and _root_name(value.func.value) in _R13_REQUEST_NAMES
        ):
            return (
                "a per-request field as a label mints one series per "
                "distinct request"
            )
        return None

    def _check_r13(self, node: ast.Call, name: Optional[str]) -> None:
        """The registry keeps one series per distinct label tuple FOREVER
        (that is what makes delta/scrape semantics work), so a label
        value drawn from an unbounded set — an f-string, a loop
        variable, a per-request field — is a memory leak and a scrape
        explosion. Bounded label sets (tier names, entry names, seam
        names, literal strings, module constants) are the contract."""
        if "R13" not in self.rules or name is None or "." not in name:
            return
        root, _, _rest = name.partition(".")
        verb = name.rsplit(".", 1)[-1]
        if root not in _R13_REGISTRY_ROOTS or verb not in _R13_RECORD_VERBS:
            return
        for kw in node.keywords:
            if kw.arg is None or kw.arg in _R13_NON_LABEL_KWARGS:
                continue
            why = self._r13_label_hazard(kw.value)
            if why:
                self._emit(
                    node,
                    "R13",
                    f"label {kw.arg!r} at {name}() has unbounded "
                    f"cardinality: {why} — label with a value from a "
                    "fixed set (tier/entry/seam name) and put the "
                    "variable part in the metric VALUE or a span attr",
                )

    # -- R6: non-atomic write of a durable artifact --------------------------

    def _scope_is_atomic(self, root: ast.AST) -> bool:
        """Does this scope's own code os.replace/os.rename — i.e. follow
        the write-temp-then-publish pattern that makes its writes safe?"""
        for sub in _walk_own(root):
            if (
                isinstance(sub, ast.Call)
                and _dotted(sub.func) in _ATOMIC_PUBLISH_CALLS
            ):
                return True
        return False

    @staticmethod
    def _tempish_token(text: str) -> bool:
        """TOKEN-boundary temp matching: split on non-alphanumerics and
        require a segment that IS tmp/temp (or a tmp*/tempfile/tempdir
        compound). Substring matching would silently exempt durable
        writes through names like ``attempt``/``template``/``temperature``
        — exactly the false negatives an exemption rule must not have."""
        for seg in re.split(r"[^a-z0-9]+", text.lower()):
            if seg in ("tmp", "temp", "tempfile", "tempdir", "mkdtemp", "mkstemp"):
                return True
            if seg.startswith("tmp"):  # tmpfile, tmpdir, tmp2, ...
                return True
        return False

    def _is_tempish(self, node: ast.AST) -> bool:
        """Heuristic: does this path expression name a TEMP location?
        tempfile-derived values, names/attributes/strings with a tmp/temp
        token — a crash leaves garbage nobody will ever read back."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                if self._tempish_token(sub.id):
                    return True
            elif isinstance(sub, ast.Attribute):
                if self._tempish_token(sub.attr):
                    return True
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if self._tempish_token(sub.value):
                    return True
        return False

    def _check_r6(self, node: ast.Call, name: Optional[str]) -> None:
        if "R6" not in self.rules or self.atomic_scope:
            return
        if name in _DURABLE_NP_WRITES and node.args:
            # np.save(path, arr) / torch.save(obj, path): the path is the
            # first argument of numpy's writers and the second of torch's
            pos = 1 if name == "torch.save" else 0
            target = node.args[pos] if len(node.args) > pos else None
            for kw in node.keywords:
                if kw.arg in ("f", "file"):
                    target = kw.value
            if target is None:
                return
            if self._is_buffer_target(target) or self._is_tempish(target):
                return
            self._emit(
                node,
                "R6",
                f"{name}() writes a durable artifact straight to its final "
                "path — a crash mid-write leaves a truncated file; write to "
                "a temp file and os.replace() it into place "
                "(resilience.checkpoint.write_atomic)",
            )
        elif name == "open" and node.args:
            mode = node.args[1] if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if not (
                isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and any(c in mode.value for c in "wx")
            ):
                return
            if self._is_tempish(node.args[0]):
                return
            self._emit(
                node,
                "R6",
                f"open(..., {mode.value!r}) publishes a durable artifact "
                "non-atomically — a crash mid-write leaves a truncated "
                "file; write to a temp file and os.replace() it into place "
                "(resilience.checkpoint.write_json_atomic)",
            )

    def _is_buffer_target(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.buffer_names
        return (
            isinstance(node, ast.Call)
            and _dotted(node.func) in _BUFFER_FACTORIES
        )

    # -- R3: control flow on a device tensor ---------------------------------

    def _check_r3_test(self, node: ast.AST, test: ast.AST) -> None:
        if "R3" not in self.rules:
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if isinstance(test, ast.BoolOp):
            # the operands but the last are judged by visit_BoolOp
            self._check_r3_test(node, test.values[-1])
            return
        if self._is_device_expr(test, strict=True):
            kind = {ast.While: "while", ast.If: "if", ast.Assert: "assert",
                    ast.IfExp: "ternary", ast.BoolOp: "and/or"}.get(type(node), "test")
            self._emit(
                node,
                "R3",
                f"Python {kind} on `{_short(test)}`, a device tensor — the "
                "implicit Tensor.__bool__ waits for the stream (a hidden "
                "sync, and a break in a CUDA-graph capture); read it "
                "explicitly with bool()/int()/.item() where a read is meant",
            )

    # -- R4: torch launches in a python loop ----------------------------------

    def _check_r4(self, node) -> None:
        if "R4" not in self.rules or not self.hot:
            return
        for sub in _walk_own(node):
            hit = None
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func) or ""
                if self._is_device_call(sub) and not (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _HOST_METHODS
                ):
                    hit = f"{name or _short(sub.func)}()"
                elif name not in _NON_LAUNCH_CALLS and any(
                    self._is_device_expr(a)
                    for a in list(sub.args) + [kw.value for kw in sub.keywords]
                ):
                    # a project function handed device tensors launches
                    # its own torch work
                    hit = f"{name or _short(sub.func)}()"
            elif isinstance(sub, ast.BinOp) and self._is_device_expr(sub):
                hit = f"`{_short(sub)}`"
            if hit is not None:
                # anchor on the loop statement so a loop-line disable
                # covers every launch in the body
                self._emit(
                    node,
                    "R4",
                    f"{hit} (line {sub.lineno}) launches device work inside "
                    "a Python loop of a hot function — the kernels relaunch "
                    "every iteration, each paying the host's launch cost; "
                    "batch the iterations into one op or capture them in a "
                    "CUDA graph",
                )
                return  # one violation per loop

    # -- R5: early return None drops mutated self state ----------------------

    def _check_r5(self, func) -> None:
        if "R5" not in self.rules:
            return
        body = func.body
        # lexical positions of self.<attr> OVERWRITES and write-backs
        overwrites: List[int] = []
        writebacks: List[int] = []
        assigns: List[int] = []  # local name bindings
        returns_none: List[ast.Return] = []
        last_stmt_line = body[-1].lineno if body else func.lineno

        for node in _walk_own(func):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        overwrites.append(node.lineno)
                        writebacks.append(node.lineno)
                    elif isinstance(tgt, ast.Name):
                        assigns.append(node.lineno)
            elif isinstance(node, ast.Call):
                # self.X.append(...) / extend / insert / update write-backs
                name = _dotted(node.func) or ""
                if name.startswith("self.") and name.rsplit(".", 1)[-1] in (
                    "append",
                    "extend",
                    "insert",
                    "update",
                    "add",
                ):
                    writebacks.append(node.lineno)
            elif isinstance(node, ast.Return):
                is_none = node.value is None or (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is None
                )
                if is_none and node.lineno < last_stmt_line:
                    returns_none.append(node)

        if not overwrites:
            return
        first_ow = min(overwrites)
        for ret in returns_none:
            if ret.lineno <= first_ow:
                continue
            # state computed after the overwrite but before the return?
            computed = [ln for ln in assigns if first_ow < ln < ret.lineno]
            if not computed:
                continue
            # any write-back strictly between overwrite and return clears it
            saved = [ln for ln in writebacks if first_ow < ln < ret.lineno]
            if saved:
                continue
            self._emit(
                ret,
                "R5",
                "early `return None` after overwriting self state with "
                "locals computed but never written back — mutated state is "
                "dropped (the _partition take==0 bug class)",
            )

    # -- R7: a frontier function builds a new frontier buffer ------------------

    def _r7_emit(self, node: ast.AST, what: str) -> None:
        self._emit(
            node,
            "R7",
            f"{what} in a function that takes the frontier "
            f"(`{self.frontier_param}`) — the reservoir-scale buffer is "
            "written in place (contracts.check_donated); a fresh buffer "
            "doubles the device footprint and breaks the callers' aliasing; "
            "write through fr.nodes[...] instead, or disable R7 on a "
            "harness that copies on purpose",
        )

    def _check_r7_call(self, node: ast.Call, name: Optional[str]) -> None:
        if "R7" not in self.rules or self.frontier_param is None:
            return
        if (name or "").rsplit(".", 1)[-1] != "Frontier":
            return
        first = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "nodes":
                first = kw.value
        if first is not None and self._is_fresh_tensor(first):
            self._r7_emit(node, f"Frontier({_short(first)}, ..) builds a new frontier buffer")

    def _check_r7_assign(self, targets, value) -> None:
        if "R7" not in self.rules or self.frontier_param is None:
            return
        for tgt in targets:
            rebinds = (
                isinstance(tgt, ast.Attribute) and tgt.attr == "nodes"
                and _root_name(tgt) == self.frontier_param
            ) or (
                isinstance(tgt, ast.Name) and tgt.id == self.frontier_param == "nodes"
            )
            if rebinds and self._is_fresh_tensor(value):
                self._r7_emit(
                    tgt, f"`{_short(tgt)} = {_short(value)}` rebinds the frontier buffer"
                )

    # -- entry point ---------------------------------------------------------

    def run(self) -> List[Violation]:
        for node in self.tree.body:
            self.visit(node)
        return self.violations


def _short(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse covers every node type
        return "<expr>"
    return text if len(text) <= limit else text[: limit - 3] + "..."


def _data_shaped(call: ast.Call, name: Optional[str]) -> bool:
    """An op whose output size depends on the data: ``torch.nonzero`` and
    kin, one-argument ``torch.where``, ``repeat_interleave`` without
    ``output_size``."""
    if any(kw.arg == "output_size" for kw in call.keywords):
        return False
    if name == "torch.where":
        return len(call.args) == 1 and not call.keywords
    if name in _DATA_SHAPED_CALLS:
        return True
    return (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _DATA_SHAPED_METHODS
        and not (name or "").startswith(("np.", "numpy."))
    )


def _is_cpu_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and _dotted(node.func) == "torch.device"
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def _moves_to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")``."""
    if call.args and _is_cpu_literal(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu_literal(kw.value) for kw in call.keywords)


def _is_dtype_expr(node: ast.AST) -> bool:
    name = _dotted(node) or ""
    return name.startswith("torch.") and name.split(".", 1)[1] in (
        "float32", "float64", "float16", "bfloat16", "int32", "int64", "int16", "int8",
        "uint8", "bool", "float", "double", "long", "int", "half", "complex64",
    )


def _casts_dtype(call: ast.Call) -> bool:
    """``.to(torch.int32)`` / ``.to(x.dtype)`` / ``.to(dtype)`` /
    ``.to(dtype=..)``: a copy when the dtype differs."""
    if call.args:
        a = call.args[0]
        if _is_dtype_expr(a) or (isinstance(a, ast.Attribute) and a.attr == "dtype") or (
            isinstance(a, ast.Name) and a.id in ("dtype", "dt", "cost_dtype")
        ):
            return True
    return any(kw.arg == "dtype" for kw in call.keywords)


def _moves_to_device(call: ast.Call) -> bool:
    """``.to(dev)`` / ``.to(device=dev)`` with a non-CPU, non-dtype
    target."""
    if _moves_to_cpu(call) or _casts_dtype(call) and not any(
        kw.arg == "device" for kw in call.keywords
    ):
        return False
    if call.args:
        return True
    return any(kw.arg == "device" for kw in call.keywords)


def _has_device_kw(call: ast.Call) -> bool:
    """``torch.tensor(x, device=dev)`` with a device that is not the
    CPU."""
    return any(
        kw.arg == "device" and not _is_cpu_literal(kw.value)
        and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in call.keywords
    )


def is_hot_def(node, hot_paths: Iterable[str], directives: _Directives) -> bool:
    """Is this def a hot path: named in ``hot_paths`` or marked
    ``# graftlint: hot`` on its ``def`` line(s)?"""
    return node.name in hot_paths or any(
        ln in directives.hot_lines for ln in range(node.lineno, node.body[0].lineno)
    )


def hot_lines(source: str, hot_paths: Optional[Iterable[str]] = None) -> Set[int]:
    """The lines of ``source`` in a lexically hot context by the lint's own
    rules: inside a loop body (a ``while`` test included) or anywhere in a
    hot function's body. Nested defs and lambdas start cold (they run
    later) unless hot themselves."""
    tree = ast.parse(source)
    directives = _Directives(source)
    hot = set(hot_paths) if hot_paths is not None else set(DEFAULT_HOT_PATHS)
    out: Set[int] = set()

    def span(node) -> range:
        return range(node.lineno, getattr(node, "end_lineno", node.lineno) + 1)

    def walk(node: ast.AST, hot_here: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                h = is_hot_def(child, hot, directives)
                if h:
                    for stmt in child.body:
                        out.update(span(stmt))
                walk(child, h)
            elif isinstance(child, ast.Lambda):
                walk(child, False)
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                for stmt in child.body:
                    out.update(span(stmt))
                walk(child, hot_here)
            elif isinstance(child, ast.While):
                out.update(span(child.test))
                for stmt in child.body:
                    out.update(span(stmt))
                walk(child, hot_here)
            else:
                walk(child, hot_here)

    walk(tree, False)
    return out


# -- public API ---------------------------------------------------------------


def lint_text(
    source: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
    hot_paths: Optional[Iterable[str]] = None,
    waived: Optional[List[Violation]] = None,
) -> List[Violation]:
    """Lint one source string; returns violations (disable comments already
    honored, baseline NOT applied). The violations an inline disable waived
    are appended to ``waived`` when a list is given."""
    tree = ast.parse(source, filename=path)
    linter = _FileLinter(
        path,
        source,
        tree,
        set(rules) if rules is not None else set(RULES),
        set(hot_paths) if hot_paths is not None else set(DEFAULT_HOT_PATHS),
    )
    out = linter.run()
    if waived is not None:
        waived.extend(linter.waived)
    return out


def _iter_py_files(paths: Sequence[pathlib.Path]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(
    paths: Sequence[pathlib.Path],
    root: pathlib.Path,
    rules: Optional[Iterable[str]] = None,
) -> List[Violation]:
    """Lint every .py under ``paths``; violation paths are ``root``-relative."""
    out: List[Violation] = []
    for f in _iter_py_files(paths):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            out.extend(lint_text(source, rel, rules=rules))
        except SyntaxError:
            continue
    return out


# -- baseline -----------------------------------------------------------------


@dataclass
class BaselineResult:
    new: List[Violation] = field(default_factory=list)
    accepted: List[Violation] = field(default_factory=list)
    stale: List[str] = field(default_factory=list)


def load_baseline(path: pathlib.Path) -> Dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("entries", {}).items()}


def write_baseline(path: pathlib.Path, violations: Sequence[Violation]) -> None:
    counts: Dict[str, int] = {}
    for v in violations:
        counts[v.fingerprint] = counts.get(v.fingerprint, 0) + 1
    path.write_text(
        json.dumps(
            {
                "comment": (
                    "graftlint accepted-site baseline: pre-existing "
                    "violations keyed path::rule::scope::code (line-free). "
                    "Regenerate with: python -m "
                    "tsp_mpi_reduction_tpu_torch.analysis --write-baseline"
                ),
                "version": 1,
                "entries": dict(sorted(counts.items())),
            },
            indent=2,
        )
        + "\n"
    )


def apply_baseline(
    violations: Sequence[Violation], baseline: Dict[str, int]
) -> BaselineResult:
    """Split violations into new vs baseline-accepted; surplus occurrences of
    a baselined fingerprint count as new."""
    budget = dict(baseline)
    res = BaselineResult()
    for v in violations:
        if budget.get(v.fingerprint, 0) > 0:
            budget[v.fingerprint] -= 1
            res.accepted.append(v)
        else:
            res.new.append(v)
    res.stale = sorted(k for k, n in budget.items() if n > 0)
    return res


def collect_scopes(tree: ast.Module) -> Set[str]:
    """Every qualified def/class scope a module defines, dotted exactly as
    ``_FileLinter`` qualifies violation scopes ("Cls.meth",
    "solve_sharded.spill_refill", ...), plus "<module>"."""
    out: Set[str] = {"<module>"}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                q = f"{prefix}.{child.name}" if prefix else child.name
                out.add(q)
                walk(child, q)
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def find_dead_scopes(baseline: Dict[str, int], root: pathlib.Path) -> List[str]:
    """Baseline fingerprints whose file or enclosing scope no longer exists
    in the source — stale DEBT, not just stale line numbers: the code the
    entry was accepted for is gone, so the entry can never be repaid and
    only masks a future violation that happens to reuse the fingerprint.
    The CLI fails on these (delete the entry or regenerate the baseline).
    Fingerprints are ``path::rule::scope::code``; each referenced file is
    parsed once."""
    scopes_by_path: Dict[str, Optional[Set[str]]] = {}
    dead: List[str] = []
    for fp in baseline:
        parts = fp.split("::", 3)
        if len(parts) != 4:
            dead.append(fp)  # unparseable fingerprint: treat as dead debt
            continue
        path, _rule, scope, _code = parts
        if path not in scopes_by_path:
            try:
                source = (root / path).read_text()
                scopes_by_path[path] = collect_scopes(ast.parse(source))
            except (OSError, SyntaxError, UnicodeDecodeError):
                scopes_by_path[path] = None
        known = scopes_by_path[path]
        if known is None or scope not in known:
            dead.append(fp)
    return sorted(dead)

"""graftflow: flow-aware, interprocedural dataflow lint (rules R9-R12).

Counterpart of ``tsp_mpi_reduction_tpu/analysis/graftflow.py``: the same
IR, R9 carried unchanged, and R10-R12 re-targeted at their torch/CUDA
form under the same ids. graftlint (the sibling pass) judges one AST node
at a time; the hazard classes below are relationships between program
points — an attribute access and the lock that guards it three methods
away, a pointer and the binding of the tensor it points into, a
collective and the rank test one branch out. graftflow builds a small
per-project dataflow IR instead:

- a **module index** (imports resolved across the lint surface, classes
  with their lock attributes and field types, every function/method with
  its qualified scope);
- a **call graph** with cheap type resolution (``self.m()``,
  ``self.field.m()`` via constructor/annotation field types, bare and
  module-aliased calls, locals assigned ``ClassName(...)``);
- a **thread-reachability closure** seeded at thread entry points
  (``threading.Thread(target=...)`` and ``executor.submit(f, ...)``
  with a function reference);
- per-function **flow state**: lexically-held locks (propagated into
  ``*_locked`` helpers via the intersection of held-locks at their call
  sites) and a pointer-binding lattice walked over the statement graph.

The four rules:

  R9  lock-discipline race: each class's ``attribute -> guarding lock``
      map is inferred from writes performed while holding a lock
      (``with self._lock:`` blocks, plus methods only ever called with
      the lock held). In a class whose methods run on more than one
      thread (it spawns threads, or is reachable from a thread entry
      point), any access to a guarded attribute without that lock is a
      data race — including cross-object reads like
      ``self.ladder.tier_counts`` from another class. ``__init__`` is
      exempt (pre-publication), and the double-checked-locking idiom (an
      unlocked read re-checked under the same lock in the same method)
      is recognized, not flagged.
  R10 a pointer that outlives its tensor (the JAX rule's use after
      donate): ``.data_ptr()`` taken on a temporary — a call result that
      is not a view (``.contiguous()``, ``.to()``, ``.float()``,
      ``.clone()``, a factory) — points into a block the caching
      allocator may hand to the next allocation of the same argument list
      before the kernel reads it; and a pointer bound to a name whose
      tensor binding is rebound or deleted before the pointer's use.
      Names and views (``highs[hoff[p]:].data_ptr()``) keep their base
      alive.
  R11 hand-kernel launch off the current stream (the JAX rule's static
      arg recompile risk: a launch that breaks graph capture): a launch
      through the kernels' C interface (a call passing ``.data_ptr()``
      arguments, or a ``*_launch`` entry) whose stream argument is not
      read from ``torch.cuda.current_stream(..)`` at the call (or from a
      local bound to it in the same function) — a literal ``0`` /
      ``None`` (the legacy default stream) or a stream cached at import.
      Under CUDA-graph capture such a launch falls off the capture
      stream.
  R12 collective reached by only some ranks (the JAX rule's collective
      axis-name drift): a rank-group collective (``parallel/mesh.KINDS``
      on a rank group, ``agree``, ``gather_objects``,
      ``scatter_objects``, ``torch.distributed.*``) under an ``if`` (or
      a ternary, or after an early ``return``) whose test reads the rank,
      with no call of the same kind on the other branch: the ranks that
      skip it never meet the others, and the group hangs. Every decision
      is taken alike on R processes; a rank-0 computation followed by a
      broadcast every rank reaches is the sanctioned form.

Escape hatches and baseline are SHARED with graftlint: the same
``# graftlint: disable=R9`` comment grammar (same line, line above, or
the ``def`` line), and the same ``graftlint_baseline.json`` fingerprint
machinery — one gate, one ratchet.

Like graftlint, this pass is stdlib-only (``ast`` + ``tokenize``) and
must never import torch: it runs first in the sweep's gate, before any
device exists.

Known over-approximations (deliberate, lint-grade): method resolution is
name+type-based with no inheritance walk; objects handed around as bare
parameters are untyped (their classes are only checked when reached some
other way); module-global locks guarding module-global state are out of
the class-attribute model; a collective reached through a call on one
rank only is out of R12's lexical view. Each limitation loses findings,
not precision.
"""

from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .graftlint import (
    Violation,
    _Directives,
    _dotted,
    _iter_py_files,
    _short,
    _walk_own,
)

FLOW_RULES = {
    "R9": "thread-shared attribute accessed outside its guarding lock",
    "R10": "a device pointer that outlives its tensor",
    "R11": "hand-kernel launch on a stream not read at the call",
    "R12": "collective reached by only some ranks",
}

#: lock/condition factories whose targets become guard attributes
_LOCK_FACTORIES = frozenset(
    {"Lock", "RLock", "Condition"}
)
#: the rank-group collectives: ``parallel/mesh.KINDS`` (read from the
#: project's own ``KINDS`` tuple when the surface holds it) plus the
#: host-decision helpers, and the ``torch.distributed`` spellings
_DEFAULT_KINDS = ("all_gather", "ppermute", "all_reduce", "broadcast", "gather", "scatter")
_GROUP_HELPERS = frozenset({"agree", "gather_objects", "scatter_objects", "barrier"})
_DIST_COLLECTIVES = frozenset(
    {"all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
     "gather", "scatter", "all_to_all", "reduce_scatter", "reduce_scatter_tensor",
     "barrier", "gather_object", "scatter_object_list", "all_gather_object",
     "broadcast_object_list", "send", "recv", "isend", "irecv", "monitored_barrier"}
)
_DIST_ROOTS = frozenset({"torch.distributed", "dist", "_dist", "self._dist"})
#: names whose reading makes a test rank-dependent (R12)
_RANK_NAMES = frozenset({"rank", "is_root", "local_rank", "get_rank", "RANK", "LOCAL_RANK"})
#: tensor methods that return a VIEW of their receiver (R10: a pointer
#: into a view is a pointer into a live base)
_VIEW_METHODS = frozenset(
    {"view", "view_as", "narrow", "select", "t", "transpose", "permute", "expand",
     "expand_as", "unsqueeze", "squeeze", "as_strided", "detach", "diagonal",
     "unflatten", "unfold", "movedim", "swapaxes", "real", "imag", "__getitem__"}
)
#: method names that MUTATE their receiver (R9: ``self.q.append(x)`` is a
#: write to ``q`` for guard inference, like ``self.d[k] = v``)
_MUTATORS = frozenset(
    {
        "append", "extend", "insert", "add", "update", "pop", "popitem",
        "popleft", "appendleft", "extendleft", "remove", "discard",
        "clear", "setdefault", "sort", "reverse", "move_to_end",
    }
)


# -- IR dataclasses -----------------------------------------------------------


@dataclass
class Access:
    """One ``self.attr`` (or ``self.field.attr``) touch inside a method."""

    attr: str
    write: bool
    line: int
    method: str  # method name within the class
    held: frozenset  # lock attrs lexically held
    node: ast.AST
    #: for cross-object accesses: the ``self.<field>`` the attr hangs off
    via_field: Optional[str] = None


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    lock_attrs: Set[str] = field(default_factory=set)
    #: self.<field> -> (module_path, class_name) when statically known
    field_types: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    properties: Set[str] = field(default_factory=set)
    accesses: List[Access] = field(default_factory=list)
    #: method -> [(callee method, held locks at the call)] intra-class
    intra_calls: Dict[str, List[Tuple[str, frozenset]]] = field(
        default_factory=dict
    )
    #: method -> locks certainly held at EVERY call site (fixpoint)
    entry_locks: Dict[str, frozenset] = field(default_factory=dict)
    spawns_threads: bool = False

    @property
    def qual(self) -> Tuple[str, str]:
        return (self.module.path, self.name)


@dataclass
class FuncInfo:
    qualname: str  # "Cls.meth" / "func" / "outer.inner"
    node: ast.AST
    module: "ModuleInfo"
    cls: Optional[ClassInfo] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module.path, self.qualname)


@dataclass
class ModuleInfo:
    path: str  # repo-relative posix path
    dotted: str  # dotted module name relative to the lint root
    source: str
    tree: ast.Module
    directives: _Directives
    #: alias -> dotted module name ("canon" -> "pkg.serve.canonical")
    module_aliases: Dict[str, str] = field(default_factory=dict)
    #: local name -> (dotted module, symbol) for from-imports
    symbol_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    #: module-level NAME = ClassName(...) instance types
    global_types: Dict[str, Tuple[str, str]] = field(default_factory=dict)


# -- project construction -----------------------------------------------------


def _module_dotted(path: str) -> str:
    parts = path[:-3].split("/") if path.endswith(".py") else path.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_relative(mod: ModuleInfo, level: int, name: str) -> str:
    """``from ..x import y`` inside ``mod`` -> dotted target module."""
    base = mod.dotted.split(".")
    if not mod.path.endswith("__init__.py"):
        base = base[:-1]  # the module's package
    if level > 1:
        base = base[: len(base) - (level - 1)]
    return ".".join([p for p in base if p] + ([name] if name else []))


class Project:
    """The whole lint surface parsed once; modules keyed by repo-relative
    path AND by dotted name (for import resolution)."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        #: (module_path, qualname) -> FuncInfo
        self.functions: Dict[Tuple[str, str], FuncInfo] = {}
        #: function key -> set of callee function keys
        self.call_edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        #: thread entry points (function keys)
        self.thread_roots: Set[Tuple[str, str]] = set()
        self.reachable: Set[Tuple[str, str]] = set()

    # -- loading -------------------------------------------------------------

    def add_module(self, path: str, source: str) -> Optional[ModuleInfo]:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return None
        mod = ModuleInfo(
            path=path,
            dotted=_module_dotted(path),
            source=source,
            tree=tree,
            directives=_Directives(source),
        )
        self.modules[path] = mod
        self.by_dotted[mod.dotted] = mod
        return mod

    def finalize(self) -> None:
        for mod in self.modules.values():
            self._scan_imports(mod)
            self._scan_toplevel(mod)
        for mod in self.modules.values():
            self._index_functions(mod)
        for mod in self.modules.values():
            for cls in mod.classes.values():
                _ClassScanner(self, cls).scan()
        for mod in self.modules.values():
            self._scan_calls(mod)
        self._compute_entry_locks()
        self._compute_reachability()

    # -- imports / module-level bindings -------------------------------------

    def _scan_imports(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        mod.module_aliases[a.asname] = a.name
                    else:
                        # `import a.b.c` binds the ROOT package `a`
                        root = a.name.split(".")[0]
                        mod.module_aliases[root] = root
            elif isinstance(node, ast.ImportFrom):
                target = _resolve_relative(
                    mod, node.level, node.module or ""
                ) if node.level else (node.module or "")
                for a in node.names:
                    local = a.asname or a.name
                    # `from pkg import sub` can bind a MODULE
                    sub = f"{target}.{a.name}" if target else a.name
                    mod.symbol_imports[local] = (target, a.name)
                    mod.module_aliases.setdefault(local, sub)

    def _scan_toplevel(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                mod.classes[node.name] = ClassInfo(node.name, mod, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if not isinstance(tgt, ast.Name):
                    continue
                if isinstance(node.value, ast.Call):
                    cls = self._resolve_class_name(
                        mod, _dotted(node.value.func)
                    )
                    if cls is not None:
                        mod.global_types[tgt.id] = cls

    def _index_functions(self, mod: ModuleInfo) -> None:
        def walk(node: ast.AST, prefix: str, cls: Optional[ClassInfo]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    owner = cls if prefix and cls and prefix == cls.name else (
                        cls if cls and not prefix else None
                    )
                    fi = FuncInfo(q, child, mod, owner)
                    mod.functions[q] = fi
                    self.functions[fi.key] = fi
                    if cls is not None and prefix == cls.name:
                        cls.methods[child.name] = child
                        for dec in child.decorator_list:
                            if _dotted(dec) == "property":
                                cls.properties.add(child.name)
                    walk(child, q, cls)
                elif isinstance(child, ast.ClassDef):
                    c = mod.classes.get(child.name)
                    walk(child, child.name if c else prefix, c or cls)
                else:
                    walk(child, prefix, cls)

        walk(mod.tree, "", None)

    # -- name resolution ------------------------------------------------------

    def _resolve_class_name(
        self, mod: ModuleInfo, dotted: Optional[str]
    ) -> Optional[Tuple[str, str]]:
        """Resolve a constructor-call name to a (module_path, class) in
        this project, through from-imports and module aliases."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if not rest:
            if head in mod.classes:
                return (mod.path, head)
            imp = mod.symbol_imports.get(head)
            if imp is not None:
                target = self.by_dotted.get(imp[0])
                if target is not None and imp[1] in target.classes:
                    return (target.path, imp[1])
            return None
        # mod_alias.ClassName
        target_name = mod.module_aliases.get(head)
        if target_name is not None and "." not in rest:
            target = self.by_dotted.get(target_name)
            if target is not None and rest in target.classes:
                return (target.path, rest)
        return None

    def _resolve_function(
        self, mod: ModuleInfo, dotted: Optional[str]
    ) -> Optional[Tuple[str, str]]:
        """Resolve a call name to a project function key (module functions
        and imported symbols; not methods)."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if not rest:
            if head in mod.functions:
                return (mod.path, head)
            imp = mod.symbol_imports.get(head)
            if imp is not None:
                target = self.by_dotted.get(imp[0])
                if target is not None and imp[1] in target.functions:
                    return (target.path, imp[1])
            return None
        target_name = mod.module_aliases.get(head)
        if target_name is not None and "." not in rest:
            target = self.by_dotted.get(target_name)
            if target is not None and rest in target.functions:
                return (target.path, rest)
        return None

    # -- module constants (R12) ------------------------------------------------

    def _const_str_tuple(
        self, mod: ModuleInfo, node: ast.AST
    ) -> Optional[List[str]]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for el in node.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    out.append(el.value)
                else:
                    return None
            return out
        if isinstance(node, ast.Name):
            # module-level NAME = ("a", "b", ...) constant tuples
            for stmt in mod.tree.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == node.id
                ):
                    return self._const_str_tuple(mod, stmt.value)
        return None

    # -- call graph / threads -------------------------------------------------

    def _scan_calls(self, mod: ModuleInfo) -> None:
        for fi in mod.functions.values():
            edges: Set[Tuple[str, str]] = set()
            # closures see enclosing scopes' typed locals: merge outer
            # functions' types (inner bindings shadow outer ones)
            local_types: Dict[str, Tuple[str, str]] = {}
            parts = fi.qualname.split(".")
            for i in range(1, len(parts) + 1):
                outer = mod.functions.get(".".join(parts[:i]))
                if outer is not None:
                    local_types.update(
                        _local_var_types(self, mod, outer.node)
                    )
            for sub in ast.walk(fi.node):
                if not isinstance(sub, ast.Call):
                    continue
                self._edge_for_call(mod, fi, sub, local_types, edges)
                self._maybe_thread_root(mod, fi, sub, local_types)
            self.call_edges[fi.key] = edges

    def global_instance_type(
        self, mod: ModuleInfo, base: ast.AST
    ) -> Optional[Tuple[str, str]]:
        """Type of a module-global instance expression: ``NAME`` (local or
        from-imported) or ``mod_alias.NAME``."""
        if isinstance(base, ast.Name):
            t = mod.global_types.get(base.id)
            if t is not None:
                return t
            imp = mod.symbol_imports.get(base.id)
            if imp is not None:
                target = self.by_dotted.get(imp[0])
                if target is not None:
                    return target.global_types.get(imp[1])
            return None
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
        ):
            target_name = mod.module_aliases.get(base.value.id)
            if target_name is not None:
                target = self.by_dotted.get(target_name)
                if target is not None:
                    return target.global_types.get(base.attr)
        return None

    def _method_key(
        self, cls_key: Tuple[str, str], meth: str
    ) -> Optional[Tuple[str, str]]:
        mod = self.modules.get(cls_key[0])
        if mod is None:
            return None
        cls = mod.classes.get(cls_key[1])
        if cls is None or meth not in cls.methods:
            return None
        return (mod.path, f"{cls.name}.{meth}")

    def _edge_for_call(self, mod, fi, call, local_types, edges) -> None:
        func = call.func
        if isinstance(func, ast.Attribute):
            base = func.value
            meth = func.attr
            # self.m(...)
            if isinstance(base, ast.Name) and base.id == "self" and fi.cls:
                key = self._method_key(fi.cls.qual, meth)
                if key:
                    edges.add(key)
                return
            # self.field.m(...)
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and fi.cls is not None
            ):
                ftype = fi.cls.field_types.get(base.attr)
                if ftype:
                    key = self._method_key(ftype, meth)
                    if key:
                        edges.add(key)
                return
            # var.m(...) with a known local type
            if isinstance(base, ast.Name):
                vtype = local_types.get(base.id)
                if vtype:
                    key = self._method_key(vtype, meth)
                    if key:
                        edges.add(key)
                    return
            # GLOBAL.m(...) / mod_alias.GLOBAL.m(...) on a typed
            # module-level instance (the TRACER/REGISTRY singletons)
            gtype = self.global_instance_type(mod, base)
            if gtype:
                key = self._method_key(gtype, meth)
                if key:
                    edges.add(key)
                return
            # mod_alias.f(...)
            key = self._resolve_function(mod, _dotted(func))
            if key:
                edges.add(key)
            return
        if isinstance(func, ast.Name):
            # nested defs resolve innermost-scope-first (closure calls)
            key = self._nested_or_module_function(mod, fi, func.id)
            if key:
                edges.add(key)
                return
        name = _dotted(func)
        # constructor call -> __init__ edge
        cls_key = self._resolve_class_name(mod, name)
        if cls_key:
            key = self._method_key(cls_key, "__init__")
            if key:
                edges.add(key)

    def _nested_or_module_function(
        self, mod: ModuleInfo, fi: FuncInfo, name: str
    ) -> Optional[Tuple[str, str]]:
        prefix = fi.qualname
        while True:
            q = f"{prefix}.{name}" if prefix else name
            if q in mod.functions:
                return (mod.path, q)
            if not prefix:
                break
            prefix = prefix.rsplit(".", 1)[0] if "." in prefix else ""
        return self._resolve_function(mod, name)

    def _fn_ref_key(
        self, mod, fi, node, local_types
    ) -> Optional[Tuple[str, str]]:
        """Resolve a function REFERENCE expression (not a call) to a
        project function key — thread targets and executor submissions."""
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self" and fi.cls:
                return self._method_key(fi.cls.qual, node.attr)
            if isinstance(base, ast.Name):
                vtype = local_types.get(base.id) or mod.global_types.get(
                    base.id
                )
                if vtype:
                    return self._method_key(vtype, node.attr)
            return self._resolve_function(mod, _dotted(node))
        if isinstance(node, ast.Name):
            # nested def in the same enclosing scope first
            prefix = fi.qualname
            while True:
                q = f"{prefix}.{node.id}" if prefix else node.id
                if q in mod.functions:
                    return (mod.path, q)
                if not prefix:
                    break
                prefix = prefix.rsplit(".", 1)[0] if "." in prefix else ""
            return self._resolve_function(mod, node.id)
        return None

    def _maybe_thread_root(self, mod, fi, call, local_types) -> None:
        name = _dotted(call.func) or ""
        is_thread = name.rsplit(".", 1)[-1] == "Thread"
        is_submit = (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "submit"
            and self._executor_receiver(mod, call.func.value, local_types)
        )
        target_expr = None
        if is_thread:
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif is_submit and call.args:
            target_expr = call.args[0]
        else:
            return
        if target_expr is None:
            return
        key = self._fn_ref_key(mod, fi, target_expr, local_types)
        if key is not None:
            self.thread_roots.add(key)
            if is_thread and fi.cls is not None:
                fi.cls.spawns_threads = True

    def _executor_receiver(self, mod, recv, local_types) -> bool:
        """Is ``.submit``'s receiver plausibly a thread-pool executor?
        A project class's own ``submit`` (the micro-batch scheduler's
        takes DATA) must not turn its first argument into a phantom
        thread root, so: never a project-typed receiver, and the
        receiver's name must say executor/pool (stdlib executors are
        invisible to the index, names are the only signal left)."""
        if isinstance(recv, ast.Name):
            rtype = local_types.get(recv.id) or mod.global_types.get(recv.id)
            if rtype is not None:
                return False  # a project class: its submit takes work items
        path = (_attr_path(recv) or "").rsplit(".", 1)[-1].lower()
        return "pool" in path or "executor" in path or path == "ex"

    # -- fixpoints ------------------------------------------------------------

    def _compute_entry_locks(self) -> None:
        """A method only ever called with lock L held effectively holds L
        for its whole body (``*_locked`` helpers). Intersection over call
        sites, iterated to fixpoint."""
        for mod in self.modules.values():
            for cls in mod.classes.values():
                entry = {m: None for m in cls.methods}  # None = no info yet
                for _ in range(len(cls.methods) + 1):
                    changed = False
                    incoming: Dict[str, Optional[frozenset]] = {
                        m: None for m in cls.methods
                    }
                    for caller, calls in cls.intra_calls.items():
                        caller_entry = entry.get(caller) or frozenset()
                        for callee, held in calls:
                            eff = frozenset(held) | caller_entry
                            cur = incoming.get(callee)
                            incoming[callee] = (
                                eff if cur is None else (cur & eff)
                            )
                    for m in cls.methods:
                        new = incoming[m] or frozenset()
                        if entry[m] != new:
                            entry[m] = new
                            changed = True
                    if not changed:
                        break
                cls.entry_locks = {
                    m: (v or frozenset()) for m, v in entry.items()
                }

    def _compute_reachability(self) -> None:
        seen = set(self.thread_roots)
        frontier = list(seen)
        while frontier:
            key = frontier.pop()
            for nxt in self.call_edges.get(key, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        self.reachable = seen

    def concurrent_classes(self) -> Set[Tuple[str, str]]:
        out: Set[Tuple[str, str]] = set()
        for mod in self.modules.values():
            for cls in mod.classes.values():
                if cls.spawns_threads:
                    out.add(cls.qual)
                    continue
                for m in cls.methods:
                    if (mod.path, f"{cls.name}.{m}") in self.reachable:
                        out.add(cls.qual)
                        break
        return out


def _local_var_types(
    project: Project, mod: ModuleInfo, fn_node: ast.AST
) -> Dict[str, Tuple[str, str]]:
    """name -> class for locals assigned ``ClassName(...)`` (also through
    ``a or ClassName(...)``) and parameters annotated with a project class
    (``Optional[X]`` unwrapped)."""
    out: Dict[str, Tuple[str, str]] = {}

    def class_of_expr(expr) -> Optional[Tuple[str, str]]:
        if isinstance(expr, ast.Call):
            return project._resolve_class_name(mod, _dotted(expr.func))
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                c = class_of_expr(v)
                if c is not None:
                    return c
        return None

    if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in list(fn_node.args.posonlyargs) + list(fn_node.args.args):
            ann = a.annotation
            if isinstance(ann, ast.Subscript):  # Optional[X] / Dict[...]
                ann = ann.slice
            c = project._resolve_class_name(mod, _dotted(ann)) if ann else None
            if c is not None:
                out[a.arg] = c
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
            tgt = sub.targets[0]
            if isinstance(tgt, ast.Name):
                c = class_of_expr(sub.value)
                if c is not None:
                    out[tgt.id] = c
    return out


# -- class scanning (R9 IR) ----------------------------------------------------


class _ClassScanner:
    """Collects a class's lock attrs, field types, and every ``self.*``
    access with the lexically-held lock set."""

    def __init__(self, project: Project, cls: ClassInfo):
        self.project = project
        self.cls = cls
        self.mod = cls.module

    def scan(self) -> None:
        # pass 1: lock attrs + field types (any method may declare them)
        for name, meth in self.cls.methods.items():
            for sub in ast.walk(meth):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    if not (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        continue
                    val = sub.value
                    if isinstance(val, ast.Call):
                        callee = _dotted(val.func) or ""
                        if callee.rsplit(".", 1)[-1] in _LOCK_FACTORIES:
                            self.cls.lock_attrs.add(tgt.attr)
                            continue
                        ftype = self.project._resolve_class_name(
                            self.mod, _dotted(val.func)
                        )
                        if ftype is not None:
                            self.cls.field_types[tgt.attr] = ftype
                    elif isinstance(val, ast.Name):
                        # self.x = param — use the param's annotation
                        types = _local_var_types(self.project, self.mod, meth)
                        ftype = types.get(val.id)
                        if ftype is not None:
                            self.cls.field_types[tgt.attr] = ftype
        # pass 2: accesses + intra-class calls, per method
        for name, meth in self.cls.methods.items():
            self.cls.intra_calls.setdefault(name, [])
            self._walk_stmt_list(meth.body, name, frozenset())

    # recursive statement walker tracking `with self.<lock>:` scopes
    def _walk_stmt_list(self, stmts, method: str, held: frozenset) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt, method, held)

    def _walk_stmt(self, stmt, method: str, held: frozenset) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, the lexical lock is NOT guaranteed
            self._walk_stmt_list(stmt.body, method, frozenset())
            return
        if isinstance(stmt, ast.With):
            acquired = set()
            for item in stmt.items:
                self._visit_expr(item.context_expr, method, held)
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Attribute)
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                    and ce.attr in self.cls.lock_attrs
                ):
                    acquired.add(ce.attr)
            self._walk_stmt_list(stmt.body, method, held | acquired)
            return
        # visit this statement's own expressions, then child statements
        for fname, value in ast.iter_fields(stmt):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self._walk_stmt_list(value, method, held)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._visit_expr(v, method, held)
                        elif isinstance(v, ast.excepthandler):
                            self._walk_stmt_list(v.body, method, held)
            elif isinstance(value, ast.expr):
                self._visit_expr(value, method, held)

    def _visit_expr(self, expr, method: str, held: frozenset) -> None:
        writeish = _writeish_attr_ids(expr)
        for sub in ast.walk(expr):
            if isinstance(sub, (ast.Lambda,)):
                continue
            if isinstance(sub, ast.Call):
                self._record_call(sub, method, held)
            elif isinstance(sub, ast.Attribute):
                self._record_attr(sub, method, held, writeish)

    def _record_call(self, call: ast.Call, method: str, held) -> None:
        func = call.func
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and func.attr in self.cls.methods
        ):
            self.cls.intra_calls.setdefault(method, []).append(
                (func.attr, held)
            )

    def _record_attr(
        self, node: ast.Attribute, method: str, held, writeish
    ) -> None:
        base = node.value
        write = isinstance(node.ctx, (ast.Store, ast.Del)) or (
            id(node) in writeish
        )
        # self.attr
        if isinstance(base, ast.Name) and base.id == "self":
            if node.attr in self.cls.lock_attrs:
                return
            self.cls.accesses.append(
                Access(
                    attr=node.attr,
                    write=write,
                    line=node.lineno,
                    method=method,
                    held=held,
                    node=node,
                )
            )
            return
        # self.field.attr (cross-object)
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "self"
        ):
            self.cls.accesses.append(
                Access(
                    attr=node.attr,
                    write=write,
                    line=node.lineno,
                    method=method,
                    held=held,
                    node=node,
                    via_field=base.attr,
                )
            )


def _writeish_attr_ids(expr: ast.AST) -> Set[int]:
    """ids of Attribute nodes mutated THROUGH: ``self.d[k] = v`` stores
    into the object ``self.d`` names, and ``self.q.append(x)`` mutates
    ``self.q`` — both count as writes for lock-guard inference."""
    out: Set[int] = set()
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Subscript) and isinstance(
            sub.ctx, (ast.Store, ast.Del)
        ):
            if isinstance(sub.value, ast.Attribute):
                out.add(id(sub.value))
        elif (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _MUTATORS
            and isinstance(sub.func.value, ast.Attribute)
        ):
            out.add(id(sub.func.value))
    return out


# -- the linter ----------------------------------------------------------------


class FlowLinter:
    def __init__(self, project: Project, rules: Set[str]):
        self.project = project
        self.rules = rules
        self.violations: List[Violation] = []
        self._seen: Set[Tuple[str, int, str, str]] = set()

    # -- emission -------------------------------------------------------------

    def _emit(
        self,
        mod: ModuleInfo,
        node: ast.AST,
        rule: str,
        scope: str,
        message: str,
        def_line: Optional[int] = None,
    ) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 1)
        key = (mod.path, line, rule, message)
        if key in self._seen:
            return
        if mod.directives.suppressed(line, rule, def_line):
            return
        lines = mod.source.splitlines()
        code = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        self._seen.add(key)
        self.violations.append(
            Violation(mod.path, line, rule, scope, code, message)
        )

    def _def_line_of(self, mod: ModuleInfo, scope: str) -> Optional[int]:
        fi = mod.functions.get(scope)
        return fi.node.lineno if fi is not None else None

    # -- R9 -------------------------------------------------------------------

    def check_r9(self) -> None:
        concurrent = self.project.concurrent_classes()
        guarded: Dict[Tuple[str, str], Dict[str, Set[str]]] = {}
        # inference pass: locked WRITES outside __init__ define guards
        for mod in self.project.modules.values():
            for cls in mod.classes.values():
                gmap: Dict[str, Set[str]] = {}
                for acc in cls.accesses:
                    if acc.via_field is not None or acc.method == "__init__":
                        continue
                    eff = acc.held | cls.entry_locks.get(
                        acc.method, frozenset()
                    )
                    if acc.write and eff:
                        gmap.setdefault(acc.attr, set()).update(eff)
                guarded[cls.qual] = gmap
        # double-checked-locking suppression: an unlocked read whose
        # method (or a direct intra-class callee — the faults registry's
        # ``fire`` -> ``_cross`` fast path) re-reads the attribute under
        # the guarding lock is the sanctioned lock-free pre-check
        for mod in self.project.modules.values():
            for cls in mod.classes.values():
                if cls.qual not in concurrent:
                    continue
                gmap = guarded[cls.qual]
                if not gmap:
                    continue
                locked_by_method: Dict[str, Set[str]] = {}
                for acc in cls.accesses:
                    if acc.via_field is None and not acc.write:
                        eff = acc.held | cls.entry_locks.get(
                            acc.method, frozenset()
                        )
                        if acc.attr in gmap and eff & gmap[acc.attr]:
                            locked_by_method.setdefault(
                                acc.method, set()
                            ).add(acc.attr)
                locked_reads: Set[Tuple[str, str]] = set()
                for m in cls.methods:
                    attrs = set(locked_by_method.get(m, ()))
                    for callee, _held in cls.intra_calls.get(m, ()):
                        attrs |= locked_by_method.get(callee, set())
                    for a in attrs:
                        locked_reads.add((m, a))
                for acc in cls.accesses:
                    if acc.via_field is not None or acc.method == "__init__":
                        continue
                    locks = gmap.get(acc.attr)
                    if not locks:
                        continue
                    eff = acc.held | cls.entry_locks.get(
                        acc.method, frozenset()
                    )
                    if eff & locks:
                        continue
                    if (
                        not acc.write
                        and (acc.method, acc.attr) in locked_reads
                    ):
                        continue  # double-checked locking idiom
                    scope = f"{cls.name}.{acc.method}"
                    lock_names = ", ".join(sorted(f"self.{n}" for n in locks))
                    verb = "write to" if acc.write else "read of"
                    self._emit(
                        mod,
                        acc.node,
                        "R9",
                        scope,
                        f"{verb} `self.{acc.attr}` without {lock_names} — "
                        f"every other mutation of this attribute holds the "
                        f"lock, and {cls.name} runs on multiple threads "
                        "(data race: lost updates / torn reads)",
                        def_line=self._def_line_of(mod, scope),
                    )
        # cross-object pass: self.field.attr where field's class guards attr
        for mod in self.project.modules.values():
            for cls in mod.classes.values():
                for acc in cls.accesses:
                    if acc.via_field is None:
                        continue
                    ftype = cls.field_types.get(acc.via_field)
                    if ftype is None or ftype not in concurrent:
                        continue
                    fmod = self.project.modules.get(ftype[0])
                    fcls = fmod.classes.get(ftype[1]) if fmod else None
                    if fcls is None:
                        continue
                    if acc.attr in fcls.methods or acc.attr in fcls.properties:
                        continue
                    locks = guarded.get(ftype, {}).get(acc.attr)
                    if not locks:
                        continue
                    # only contexts that can run concurrently with the
                    # target object's threads are flagged
                    accessor_key = (mod.path, f"{cls.name}.{acc.method}")
                    if (
                        cls.qual not in concurrent
                        and accessor_key not in self.project.reachable
                    ):
                        continue
                    scope = f"{cls.name}.{acc.method}"
                    lock_names = ", ".join(sorted(locks))
                    self._emit(
                        mod,
                        acc.node,
                        "R9",
                        scope,
                        f"unlocked {'write to' if acc.write else 'read of'} "
                        f"`self.{acc.via_field}.{acc.attr}`, an attribute "
                        f"{ftype[1]} guards with `self.{lock_names}` — "
                        f"take a snapshot through a locked accessor on "
                        f"{ftype[1]} instead of reaching into its state",
                        def_line=self._def_line_of(mod, scope),
                    )
        self._check_global_instances(concurrent, guarded)

    def _check_global_instances(self, concurrent, guarded) -> None:
        """Accesses to guarded attributes of module-global instances
        (``TRACER.path`` through any import alias) from thread-shared
        contexts."""
        for mod in self.project.modules.values():
            for fi in mod.functions.values():
                in_concurrent_cls = (
                    fi.cls is not None and fi.cls.qual in concurrent
                )
                if fi.key not in self.project.reachable and not in_concurrent_cls:
                    continue
                writeish = _writeish_attr_ids(fi.node)
                for sub in ast.walk(fi.node):
                    if not isinstance(sub, ast.Attribute):
                        continue
                    gtype = self._global_instance_type(mod, sub.value)
                    if gtype is None or gtype not in concurrent:
                        continue
                    gmod = self.project.modules.get(gtype[0])
                    gcls = gmod.classes.get(gtype[1]) if gmod else None
                    if gcls is None:
                        continue
                    if (
                        sub.attr in gcls.methods
                        or sub.attr in gcls.properties
                    ):
                        continue
                    locks = guarded.get(gtype, {}).get(sub.attr)
                    if not locks:
                        continue
                    # accesses inside the owning class itself were already
                    # judged (with lock context) by the within-class pass
                    if fi.cls is not None and fi.cls.qual == gtype:
                        continue
                    write = isinstance(sub.ctx, (ast.Store, ast.Del)) or (
                        id(sub) in writeish
                    )
                    base = _attr_path(sub.value) or "<global>"
                    self._emit(
                        mod,
                        sub,
                        "R9",
                        fi.qualname,
                        f"unlocked {'write to' if write else 'read of'} "
                        f"`{base}.{sub.attr}`, an attribute {gtype[1]} "
                        f"guards with `self.{', '.join(sorted(locks))}` — "
                        f"go through a locked accessor on {gtype[1]}",
                        def_line=fi.node.lineno,
                    )

    def _global_instance_type(
        self, mod: ModuleInfo, base: ast.AST
    ) -> Optional[Tuple[str, str]]:
        return self.project.global_instance_type(mod, base)

    # -- R10 ------------------------------------------------------------------

    def check_r10(self) -> None:
        for mod in self.project.modules.values():
            for fi in mod.functions.values():
                self._r10_temporaries(mod, fi)
                _PointerScan(self, mod, fi).run()

    def _r10_temporaries(self, mod, fi) -> None:
        for sub in _walk_own(fi.node):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "data_ptr"
            ):
                continue
            base = _strip_views(sub.func.value)
            if isinstance(base, ast.Call):
                self._emit(
                    mod,
                    sub,
                    "R10",
                    fi.qualname,
                    f"`{_short(sub.func.value)}.data_ptr()` points into a "
                    "temporary — nothing holds the tensor once the "
                    "expression ends, so the caching allocator may hand its "
                    "block to the next allocation (of the same argument list) "
                    "before the kernel reads it; bind the tensor to a name "
                    "first",
                    def_line=fi.node.lineno,
                )

    # -- R11 ------------------------------------------------------------------

    def check_r11(self) -> None:
        for mod in self.project.modules.values():
            module_names = _module_bound_names(mod.tree)
            for fi in mod.functions.values():
                self._r11_function(mod, fi, module_names)

    def _r11_function(self, mod, fi, module_names: Set[str]) -> None:
        stream_locals: Set[str] = set()
        for sub in _walk_own(fi.node):
            if isinstance(sub, ast.Assign) and _reads_current_stream(sub.value):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        stream_locals.add(tgt.id)
        params = {a.arg for a in fi.node.args.args + fi.node.args.kwonlyargs}
        for sub in _walk_own(fi.node):
            if not (isinstance(sub, ast.Call) and _is_kernel_launch(sub)):
                continue
            stream = sub.args[-1] if sub.args else None
            for kw in sub.keywords:
                if kw.arg == "stream":
                    stream = kw.value
            if stream is None or _reads_current_stream(stream):
                continue
            if isinstance(stream, ast.Name) and stream.id in stream_locals:
                continue
            if isinstance(stream, ast.Constant):
                why = (
                    f"the literal {stream.value!r} (the legacy default "
                    "stream)"
                )
            elif isinstance(stream, ast.Name) and stream.id in module_names - params:
                why = f"`{stream.id}`, a stream cached at import"
            else:
                why = f"`{_short(stream)}`, not read from current_stream at the call"
            self._emit(
                mod,
                stream,
                "R11",
                fi.qualname,
                f"kernel launch `{_short(sub.func)}(..)` runs on {why} — "
                "under CUDA-graph capture (and any non-default stream "
                "context) the launch falls off the caller's stream; pass "
                "torch.cuda.current_stream(<tensor>.device).cuda_stream",
                def_line=fi.node.lineno,
            )

    # -- R12 ------------------------------------------------------------------

    def _kinds(self) -> Set[str]:
        """The rank-group collective method names: the project's own
        ``parallel/mesh.KINDS`` when the surface holds it, else the
        default copy, plus the host-decision helpers."""
        kinds: Set[str] = set(_DEFAULT_KINDS)
        for mod in self.project.modules.values():
            if mod.dotted.endswith("parallel.mesh"):
                for stmt in mod.tree.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and stmt.targets[0].id == "KINDS"
                    ):
                        vals = self.project._const_str_tuple(mod, stmt.value)
                        if vals:
                            kinds = set(vals)
        return kinds | _GROUP_HELPERS

    def check_r12(self) -> None:
        kinds = self._kinds()
        for mod in self.project.modules.values():
            for fi in mod.functions.values():
                _RankScan(self, mod, fi, kinds).block(fi.node.body)

    # -- entry point ----------------------------------------------------------

    def run(self) -> List[Violation]:
        if "R9" in self.rules:
            self.check_r9()
        if "R10" in self.rules:
            self.check_r10()
        if "R11" in self.rules:
            self.check_r11()
        if "R12" in self.rules:
            self.check_r12()
        self.violations.sort(key=lambda v: (v.path, v.line, v.rule))
        return self.violations


def _strip_views(node: ast.AST) -> ast.AST:
    """``x[a].view(..).t()`` -> ``x``: subscripts and view methods share
    their base's storage."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _VIEW_METHODS
        ):
            node = node.func.value
        else:
            return node


def _reads_current_stream(expr: ast.AST) -> bool:
    """Does ``expr`` read ``*.current_stream(..)`` (e.g.
    ``torch.cuda.current_stream(t.device).cuda_stream``)?"""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and (_dotted(sub.func) or "").rsplit(".", 1)[
            -1
        ] == "current_stream":
            return True
    return False


def _is_kernel_launch(call: ast.Call) -> bool:
    """A launch through a kernel library's C interface: ``lib.<entry>(..)``
    passing ``.data_ptr()`` arguments, or a library entry named
    ``*_launch``."""
    if not isinstance(call.func, ast.Attribute) or call.func.attr == "data_ptr":
        return False
    recv = (_dotted(call.func.value) or "").rsplit(".", 1)[-1].lower()
    if call.func.attr.endswith("_launch") and "lib" in recv:
        return True
    for arg in call.args:
        for sub in ast.walk(arg):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "data_ptr"
            ):
                return True
    return False


def _module_bound_names(tree: ast.Module) -> Set[str]:
    """Names bound at module level (assignments): a stream read there is
    read once, at import."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for tgt in targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name):
                        out.add(sub.id)
    return out


def _attr_path(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for pure Name/Attribute LOAD chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- R10 pointer scan ----------------------------------------------------------


class _PointerScan:
    """Forward walk of one function's statement graph tracking pointer
    bindings ``p = <path>.data_ptr()``: state maps the pointer name to its
    owner path and, once the owner binding is rebound or deleted, the line
    that killed it. A use of a pointer whose owner was killed on some path
    is a violation; rebinding the pointer clears it."""

    def __init__(self, linter: FlowLinter, mod, fi):
        self.linter = linter
        self.mod = mod
        self.fi = fi
        self.emitted: Set[Tuple[int, str]] = set()

    def run(self) -> None:
        # loops re-run their own bodies against the joined back-edge
        # state (see _stmt), so one top-level pass suffices
        self._block(list(self.fi.node.body), {}, emit=True)

    # state: dict ptr -> (owner path, kill line or 0); None = every path
    # through the block terminated
    def _block(self, stmts, state, emit: bool):
        cur = dict(state)
        for stmt in stmts:
            cur = self._stmt(stmt, cur, emit)
            if cur is None:
                return None
        return cur

    def _join(self, *states):
        live = [s for s in states if s is not None]
        if not live:
            return None
        out: Dict[str, Tuple[str, int]] = {}
        for s in live:
            for ptr, (owner, killed) in s.items():
                prev = out.get(ptr)
                if prev is None or killed > prev[1]:
                    out[ptr] = (owner, killed)
        return out

    def _stmt(self, stmt, state, emit):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return state
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            if value is not None:
                self._use_check(value, state, emit)
            for tgt in targets:
                self._kill_target(tgt, state, stmt.lineno)
            owner = _pointer_owner(value) if value is not None else None
            if owner is not None and len(targets) == 1 and isinstance(targets[0], ast.Name):
                state[targets[0].id] = (owner, 0)
            return state
        if isinstance(stmt, ast.AugAssign):
            self._use_check(stmt.value, state, emit)
            self._use_check(stmt.target, state, emit)
            self._kill_target(stmt.target, state, stmt.lineno)
            return state
        if isinstance(stmt, ast.Expr):
            self._use_check(stmt.value, state, emit)
            return state
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._use_check(stmt.value, state, emit)
            return None
        if isinstance(stmt, (ast.Raise, ast.Break, ast.Continue)):
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                self._use_check(stmt.exc, state, emit)
            return None
        if isinstance(stmt, ast.If):
            self._use_check(stmt.test, state, emit)
            a = self._block(stmt.body, state, emit)
            b = self._block(stmt.orelse, state, emit)
            return self._join(a, b)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            if isinstance(stmt, ast.While):
                self._use_check(stmt.test, state, emit)
            else:
                self._use_check(stmt.iter, state, emit)
                self._kill_target(stmt.target, state, stmt.lineno)
            once = self._block(stmt.body, state, emit=False)
            looped = self._join(state, once)
            body_out = self._block(stmt.body, looped or state, emit)
            els = self._block(
                stmt.orelse, self._join(state, body_out) or {}, emit
            )
            return self._join(state, body_out, els)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._use_check(item.context_expr, state, emit)
                if item.optional_vars is not None:
                    self._kill_target(item.optional_vars, state, stmt.lineno)
            return self._block(stmt.body, state, emit)
        if isinstance(stmt, ast.Try):
            body_out = self._block(stmt.body, state, emit)
            handler_in = self._join(state, body_out) or dict(state)
            h_outs = [
                self._block(h.body, handler_in, emit) for h in stmt.handlers
            ]
            else_out = (
                self._block(stmt.orelse, body_out, emit)
                if body_out is not None
                else None
            )
            merged = self._join(body_out if not stmt.orelse else else_out,
                                *h_outs)
            if stmt.finalbody:
                merged = self._block(
                    stmt.finalbody, merged or dict(state), emit
                )
            return merged
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self._kill_target(tgt, state, stmt.lineno)
            return state
        # fallback: visit any expressions hanging off the statement
        for _f, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self._use_check(value, state, emit)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._use_check(v, state, emit)
        return state

    def _use_check(self, expr, state, emit) -> None:
        if not state or not emit:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                hit = state.get(node.id)
                if hit is not None and hit[1]:
                    self._flag(node, hit)

    def _flag(self, node, hit) -> None:
        owner, killed = hit
        key = (getattr(node, "lineno", 0), node.id)
        if key in self.emitted:
            return
        self.emitted.add(key)
        self.linter._emit(
            self.mod,
            node,
            "R10",
            self.fi.qualname,
            f"pointer `{node.id}` into `{owner}` is used after `{owner}` "
            f"was rebound or deleted (line {killed}) — the tensor it "
            "pointed into may be freed and its block reused; take the "
            "pointer after the last rebind, next to the launch",
            def_line=self.fi.node.lineno,
        )

    def _kill_target(self, tgt, state, line: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._kill_target(el, state, line)
            return
        if isinstance(tgt, ast.Starred):
            self._kill_target(tgt.value, state, line)
            return
        path = _attr_path(tgt)
        if path is None:
            return
        state.pop(path, None)  # the pointer name itself is rebound
        for ptr, (owner, killed) in list(state.items()):
            if not killed and (owner == path or owner.startswith(path + ".")):
                state[ptr] = (owner, line)


def _pointer_owner(value: ast.AST) -> Optional[str]:
    """``<path>[..].view(..).data_ptr()`` -> the owner path, else None."""
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and value.func.attr == "data_ptr"
    ):
        return _attr_path(_strip_views(value.func.value))
    return None


# -- R12 rank scan -------------------------------------------------------------


def _reads_rank(test: ast.AST) -> bool:
    """Does a test read the rank (``ranks.is_root``, ``rank == 0``,
    ``dist.get_rank() != 0``)?"""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name) and sub.id in _RANK_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _RANK_NAMES:
            return True
    return False


def _terminates(stmts) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


class _RankScan:
    """Walks one function's statements for rank-conditioned branches and
    compares the collectives each side reaches (R12)."""

    def __init__(self, linter: FlowLinter, mod, fi, kinds: Set[str]):
        self.linter = linter
        self.mod = mod
        self.fi = fi
        self.kinds = kinds

    def collective(self, call: ast.Call) -> Optional[str]:
        """The collective kind a call performs, or None."""
        name = _dotted(call.func) or ""
        head, _, meth = name.rpartition(".")
        if not head:
            return None
        if head in _DIST_ROOTS or head.endswith("._dist"):
            return meth if meth in _DIST_COLLECTIVES else None
        if meth in self.kinds:
            recv = head.rsplit(".", 1)[-1].lower()
            if "rank" in recv or recv in ("mesh", "group", "grp"):
                return meth
        return None

    def calls_in(self, nodes) -> List[Tuple[str, ast.Call]]:
        out: List[Tuple[str, ast.Call]] = []
        for root in nodes:
            for sub in _walk_own(root):
                if isinstance(sub, ast.Call):
                    kind = self.collective(sub)
                    if kind is not None:
                        out.append((kind, sub))
        return out

    def judge(self, test: ast.AST, one, other) -> None:
        a, b = self.calls_in(one), self.calls_in(other)
        kinds_a, kinds_b = {k for k, _ in a}, {k for k, _ in b}
        cond = _short(test)
        for side, peer_kinds, where in ((a, kinds_b, "holds"), (b, kinds_a, "fails")):
            for kind, call in side:
                if kind in peer_kinds:
                    continue
                self.linter._emit(
                    self.mod,
                    call,
                    "R12",
                    self.fi.qualname,
                    f"collective `{_short(call.func)}()` runs only where "
                    f"`{cond}` {where} — the other ranks never reach a "
                    f"matching `{kind}` and the group hangs; take the "
                    "decision alike on every rank (compute on rank 0, then "
                    "a collective every rank reaches)",
                    def_line=self.fi.node.lineno,
                )

    def block(self, stmts) -> None:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If) and _reads_rank(stmt.test):
                if not stmt.orelse and _terminates(stmt.body):
                    # ``if <rank test>: return``: the rest of the block is
                    # the other branch
                    self.judge(stmt.test, stmt.body, stmts[i + 1:])
                else:
                    self.judge(stmt.test, stmt.body, stmt.orelse)
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.IfExp) and _reads_rank(sub.test):
                    self.judge(sub.test, [sub.body], [sub.orelse])
            for field_name in ("body", "orelse", "finalbody", "handlers"):
                child = getattr(stmt, field_name, None)
                if isinstance(child, list) and child:
                    if field_name == "handlers":
                        for h in child:
                            self.block(h.body)
                    elif isinstance(child[0], ast.stmt):
                        self.block(child)


# -- public API ----------------------------------------------------------------


def flow_project(
    sources: Dict[str, str], rules: Optional[Iterable[str]] = None
) -> List[Violation]:
    """Analyze a {path: source} project (disable comments honored,
    baseline NOT applied)."""
    project = Project()
    for path, src in sources.items():
        project.add_module(path, src)
    project.finalize()
    linter = FlowLinter(
        project, set(rules) if rules is not None else set(FLOW_RULES)
    )
    return linter.run()


def flow_text(
    source: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
) -> List[Violation]:
    """Analyze one source string as a single-module project."""
    return flow_project({path: source}, rules=rules)


def flow_paths(
    paths: Sequence[pathlib.Path],
    root: pathlib.Path,
    rules: Optional[Iterable[str]] = None,
) -> List[Violation]:
    """Analyze every .py under ``paths`` as ONE project (imports resolve
    across files); violation paths are ``root``-relative."""
    project = Project()
    for f in _iter_py_files(paths):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        project.add_module(rel, source)
    project.finalize()
    linter = FlowLinter(
        project, set(rules) if rules is not None else set(FLOW_RULES)
    )
    return linter.run()

"""AST extraction for the concurrency analyzer: locks, guards, accesses.

One :class:`ModuleModel` per scanned file, built in two passes:

1. **Lock discovery** — every lock *declaration site*:
   ``self.X = threading.Lock()`` (any method), dataclass fields with a
   lock ``default_factory``, class-level and module-level lock
   assignments.  ``Lock``/``RLock``/``Condition`` all count — a
   ``Condition`` guards exactly like the lock it wraps.  The
   declaration line is the allocation site the lock-witness runtime
   matches against at runtime.
2. **Access attribution** — for every method/function: each
   ``self.<attr>`` access (read / write / augmented RMW, plus whether
   a read sits inside a branch test — the check-then-act shape), each
   module-global access (symtable-aware: local shadowing is not a
   global access; global *writes* require a ``global`` declaration),
   and each call site, all annotated with the **guard set**: the lock
   ids held at that point via enclosing ``with`` scopes.  Nested
   ``with`` scopes also yield static lock-order edges.

Lock identity: ``"Class.attr"`` for instance locks, ``"file::NAME"``
for module-level locks, and ``"~attr"`` for locks reached through a
non-self receiver (``with shard.lock:``) — wildcard guards count for
guard-presence but stay out of the order graph, where an unresolved
identity could fabricate cycles.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: Callables whose result is a guard-capable lock.
_LOCK_FACTORIES = frozenset(
    {
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "Lock",
        "RLock",
        "Condition",
    }
)

#: Attribute leaves accepted as wildcard guards on non-self receivers.
_LOCKISH_LEAVES = ("lock", "cv", "mutex", "cond")


def dotted(node: ast.expr) -> str | None:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass(frozen=True)
class LockDecl:
    lock_id: str
    file: str
    line: int  # the allocation site (the Lock() call / field() line)
    kind: str  # "Lock" | "RLock" | "Condition"


@dataclass(frozen=True)
class Access:
    name: str  # attribute or global name
    line: int
    kind: str  # "read" | "write" | "aug"
    guards: frozenset[str]
    in_test: bool = False  # read inside an if/while/ternary test


@dataclass(frozen=True)
class CallSite:
    name: str  # dotted receiver chain, e.g. "self._queue.put"
    line: int
    guards: frozenset[str]
    #: True when the call carries ``timeout=``/``block=False`` (or a
    #: positional block arg) — bounded, so not a blocking hazard.
    bounded: bool


@dataclass
class FuncInfo:
    qual: str  # "Class.method" or "function"
    cls: str | None
    file: str
    line: int
    accesses: list[Access] = field(default_factory=list)
    global_accesses: list[Access] = field(default_factory=list)
    calls: list[CallSite] = field(default_factory=list)
    #: Lock ids this function acquires via ``with`` (top level or not).
    acquired: set[str] = field(default_factory=set)
    #: Static order edges (outer held when inner acquired) with lines.
    order_edges: list[tuple[str, str, int]] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    file: str
    line: int
    methods: dict[str, FuncInfo] = field(default_factory=dict)
    locks: dict[str, LockDecl] = field(default_factory=dict)  # attr -> decl


@dataclass
class ModuleModel:
    path: str  # repo-relative
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    functions: dict[str, FuncInfo] = field(default_factory=dict)
    global_locks: dict[str, LockDecl] = field(default_factory=dict)
    #: Names assigned at module scope (global-state candidates).
    module_globals: set[str] = field(default_factory=set)
    tree: ast.Module | None = None


def _lock_kind(call: ast.expr) -> str | None:
    if not isinstance(call, ast.Call):
        return None
    name = dotted(call.func)
    if name in _LOCK_FACTORIES:
        return name.rsplit(".", 1)[-1]
    # dataclass field(default_factory=threading.Lock)
    if name is not None and name.rsplit(".", 1)[-1] in ("field", "dc_field"):
        for kw in call.keywords:
            if kw.arg == "default_factory":
                factory = dotted(kw.value)
                if factory in _LOCK_FACTORIES:
                    return factory.rsplit(".", 1)[-1]
    return None


class _LockCollector(ast.NodeVisitor):
    """Pass 1: lock declaration sites."""

    def __init__(self, model: ModuleModel):
        self.model = model
        self._class: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        info = self.model.classes.setdefault(
            node.name, ClassInfo(node.name, self.model.path, node.lineno)
        )
        # class-level / dataclass-field lock declarations
        for stmt in node.body:
            target: str | None = None
            value: ast.expr | None = None
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                target, value = stmt.target.id, stmt.value
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(
                stmt.targets[0], ast.Name
            ):
                target, value = stmt.targets[0].id, stmt.value
            if target is None or value is None:
                continue
            kind = _lock_kind(value)
            if kind is not None:
                info.locks[target] = LockDecl(
                    f"{node.name}.{target}", self.model.path, value.lineno, kind
                )
        self.generic_visit(node)
        self._class.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        kind = _lock_kind(node.value)
        for tgt in node.targets:
            # self.X = threading.Lock() inside a method
            if (
                kind is not None
                and self._class
                and isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                cls = self.model.classes[self._class[-1]]
                cls.locks[tgt.attr] = LockDecl(
                    f"{cls.name}.{tgt.attr}", self.model.path, node.value.lineno, kind
                )
            # NAME = threading.Lock() at module scope
            if (
                kind is not None
                and not self._class
                and isinstance(tgt, ast.Name)
            ):
                self.model.global_locks[tgt.id] = LockDecl(
                    f"{self.model.path}::{tgt.id}",
                    self.model.path,
                    node.value.lineno,
                    kind,
                )
        self.generic_visit(node)


def _local_names(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> tuple[set[str], set[str]]:
    """(names assigned locally, names declared global) within ``fn``
    (nested functions included — close enough for shadowing)."""
    assigned: set[str] = set()
    declared_global: set[str] = set()
    for a in fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs:
        assigned.add(a.arg)
    if fn.args.vararg:
        assigned.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        assigned.add(fn.args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            assigned.add(node.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    assigned.add(t.id)
    return assigned - declared_global, declared_global


class _AccessCollector(ast.NodeVisitor):
    """Pass 2: guarded/bare accesses, calls, with-lock order edges."""

    def __init__(self, model: ModuleModel, all_lock_attrs: frozenset[str]):
        self.model = model
        self.all_lock_attrs = all_lock_attrs
        self._class: list[str] = []
        self._func: list[FuncInfo] = []
        self._guards: list[str] = []
        self._in_test = 0
        self._locals: list[tuple[set[str], set[str]]] = []
        #: Per-function map of local names bound from ``v = self.attr``
        #: — calling ``v(...)`` is a call through ``self.attr`` (the
        #: tracer's hook-dispatch pattern).
        self._aliases: list[dict[str, str]] = []

    # -- scope tracking -------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def _visit_func(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        nested = bool(self._func)
        if not nested:
            cls = self._class[-1] if self._class else None
            qual = f"{cls}.{node.name}" if cls else node.name
            info = FuncInfo(qual, cls, self.model.path, node.lineno)
            if cls:
                self.model.classes.setdefault(
                    cls, ClassInfo(cls, self.model.path, node.lineno)
                ).methods[node.name] = info
            else:
                self.model.functions[node.name] = info
            self._func.append(info)
            self._locals.append(_local_names(node))
            self._aliases.append({})
        # Nested defs/lambdas fold into the enclosing top-level
        # function: their bodies execute (at the latest) on the same
        # threads that can reach the enclosing function.
        self.generic_visit(node)
        if not nested:
            self._func.pop()
            self._locals.pop()
            self._aliases.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- guards ---------------------------------------------------------

    def _guard_id(self, expr: ast.expr) -> str | None:
        """Lock id acquired by ``with <expr>:``, or None (not a lock)."""
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id == "self" and self._class:
                cls = self.model.classes.get(self._class[-1])
                if cls is not None and expr.attr in cls.locks:
                    return cls.locks[expr.attr].lock_id
                if expr.attr in self.all_lock_attrs or any(
                    t in expr.attr.lower() for t in _LOCKISH_LEAVES
                ):
                    # Unknown self lock (declared in a base class or
                    # dynamically): wildcard — a guard, but no identity.
                    return f"~{expr.attr}"
                return None
            leaf = expr.attr
            if leaf in self.all_lock_attrs or any(
                t in leaf.lower() for t in _LOCKISH_LEAVES
            ):
                return f"~{leaf}"
            return None
        if isinstance(expr, ast.Name):
            decl = self.model.global_locks.get(expr.id)
            if decl is not None:
                return decl.lock_id
        return None

    def _visit_with(self, node: ast.With | ast.AsyncWith) -> None:
        pushed = 0
        for item in node.items:
            gid = self._guard_id(item.context_expr)
            if gid is None:
                continue
            if self._func:
                info = self._func[-1]
                info.acquired.add(gid)
                for outer in self._guards:
                    if outer != gid:
                        info.order_edges.append((outer, gid, node.lineno))
            self._guards.append(gid)
            pushed += 1
        self.generic_visit(node)
        for _ in range(pushed):
            self._guards.pop()

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # -- test-position tracking (check-then-act reads) ------------------

    def _visit_branch(self, node: ast.If | ast.While | ast.IfExp) -> None:
        self._in_test += 1
        self.visit(node.test)
        self._in_test -= 1
        for child in ast.iter_child_nodes(node):
            if child is not node.test:
                self.visit(child)

    visit_If = _visit_branch
    visit_While = _visit_branch
    visit_IfExp = _visit_branch

    # -- accesses -------------------------------------------------------

    def _record_attr(self, attr: str, line: int, kind: str) -> None:
        if not self._func:
            return
        self._func[-1].accesses.append(
            Access(
                attr,
                line,
                kind,
                frozenset(self._guards),
                in_test=kind == "read" and self._in_test > 0,
            )
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
            self._record_attr(node.attr, node.lineno, kind)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
        ):
            self._record_attr(tgt.attr, node.lineno, "aug")
            self.visit(node.value)
            return
        if isinstance(tgt, ast.Name) and self._func:
            locals_, globals_ = self._locals[-1]
            if tgt.id in globals_ and tgt.id in self.model.module_globals:
                self._func[-1].global_accesses.append(
                    Access(tgt.id, node.lineno, "aug", frozenset(self._guards))
                )
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self._func or node.id not in self.model.module_globals:
            return
        locals_, globals_ = self._locals[-1]
        if isinstance(node.ctx, ast.Load):
            if node.id in locals_:
                return
            self._func[-1].global_accesses.append(
                Access(
                    node.id,
                    node.lineno,
                    "read",
                    frozenset(self._guards),
                    in_test=self._in_test > 0,
                )
            )
        elif isinstance(node.ctx, (ast.Store, ast.Del)) and node.id in globals_:
            self._func[-1].global_accesses.append(
                Access(node.id, node.lineno, "write", frozenset(self._guards))
            )

    # -- calls ----------------------------------------------------------

    @staticmethod
    def _bounded(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg in ("timeout", "block"):
                return True
        leaf = None
        if isinstance(node.func, ast.Attribute):
            leaf = node.func.attr
        if leaf in ("put", "get") and len(node.args) >= 2:
            return True  # explicit positional block arg
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        # ``v = self.attr`` -> calls through v are calls through the
        # attr (hook dispatch: ``hook = self.on_span_close; hook(sp)``).
        if (
            self._func
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Attribute)
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id == "self"
        ):
            self._aliases[-1][node.targets[0].id] = f"self.{node.value.attr}"
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if (
            name is not None
            and self._func
            and isinstance(node.func, ast.Name)
            and name in self._aliases[-1]
        ):
            name = self._aliases[-1][name]
        if name is not None and self._func:
            self._func[-1].calls.append(
                CallSite(
                    name,
                    node.lineno,
                    frozenset(self._guards),
                    bounded=self._bounded(node),
                )
            )
        self.generic_visit(node)


def _collect_module_globals(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            names.add(stmt.target.id)
        elif isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
            names.add(stmt.target.id)
    return names


def build_module_model(source: str, rel_path: str) -> ModuleModel:
    """Parse one file into a :class:`ModuleModel` (both passes).  The
    access pass needs the *program-wide* lock-attr vocabulary for
    wildcard guards, so :func:`build_program_model` re-runs it after
    pass 1 has seen every file; this single-file entry point is for
    fixtures and tests."""
    tree = ast.parse(source, filename=rel_path)
    model = ModuleModel(path=rel_path, tree=tree)
    model.module_globals = _collect_module_globals(tree)
    _LockCollector(model).visit(tree)
    attrs = frozenset(
        a for c in model.classes.values() for a in c.locks
    ) | frozenset(model.global_locks)
    _AccessCollector(model, attrs).visit(tree)
    return model


def build_program_model(sources: dict[str, str]) -> dict[str, ModuleModel]:
    """{rel_path: source} -> {rel_path: ModuleModel} with a shared
    lock-attr vocabulary across all files."""
    models: dict[str, ModuleModel] = {}
    for rel, src in sources.items():
        tree = ast.parse(src, filename=rel)
        model = ModuleModel(path=rel, tree=tree)
        model.module_globals = _collect_module_globals(tree)
        _LockCollector(model).visit(tree)
        models[rel] = model
    attrs = frozenset(
        a for m in models.values() for c in m.classes.values() for a in c.locks
    ) | frozenset(n for m in models.values() for n in m.global_locks)
    for model in models.values():
        assert model.tree is not None
        _AccessCollector(model, attrs).visit(model.tree)
    return models


__all__ = [
    "Access",
    "CallSite",
    "ClassInfo",
    "FuncInfo",
    "LockDecl",
    "ModuleModel",
    "build_module_model",
    "build_program_model",
    "dotted",
]

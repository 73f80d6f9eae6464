"""Execution-root discovery: where concurrent control flow enters.

A *root* is a call site that hands a callable to another thread of
control: ``threading.Thread(target=...)``, a thread-pool submit
(``executor.submit`` / ``loop.run_in_executor``), an asyncio task or
server handler (``create_task`` / ``ensure_future`` /
``start_server``), a signal handler, an ``atexit`` hook — plus the
synthetic ``main`` root for every module-level ``main`` function (the
interpreter's own thread is a root too).

``ProcessPoolExecutor`` submits are deliberately **not** roots: the
submitted function runs in another *process*, sharing no Python state
with this one; counting it would tag the verify workers' pure-crypto
code as multithreaded.  Modules that import ``ProcessPoolExecutor``
without ``ThreadPoolExecutor`` get their ``.submit`` sites skipped.

Each root carries *entry specs* naming the callables it starts:
``("qual", "Class.method")`` when resolvable from the call site
(``target=self._device_loop`` inside the class), ``("leaf", name)``
when only the method name is known (``target=t.bump``), or
``("func", name)`` for a module-level function.  Lambdas contribute
the calls inside their body as entries.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .model import dotted

EntrySpec = tuple[str, str]  # ("qual" | "leaf" | "func", name)


@dataclass(frozen=True)
class Root:
    name: str  # human label, e.g. "thread:epoch-pipeline-device"
    file: str
    line: int
    entries: tuple[EntrySpec, ...]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "file": self.file,
            "line": self.line,
            "entries": ["::".join(e) for e in self.entries],
        }


_THREAD_NAMES = ("threading.Thread", "Thread")
_TASK_NAMES = (
    "asyncio.create_task",
    "create_task",
    "asyncio.ensure_future",
    "ensure_future",
)


def _entry_specs(expr: ast.expr, cls: str | None) -> list[EntrySpec]:
    """Entry specs for a callable-valued argument expression."""
    if isinstance(expr, ast.Lambda):
        out: list[EntrySpec] = []
        for node in ast.walk(expr.body):
            if isinstance(node, ast.Call):
                out.extend(_entry_specs(node.func, cls))
        return out
    if isinstance(expr, ast.Call):
        # create_task(self._loop(...)) — the coroutine factory is the entry
        return _entry_specs(expr.func, cls)
    name = dotted(expr)
    if name is None:
        return []
    if name.startswith("self.") and cls is not None and name.count(".") == 1:
        return [("qual", f"{cls}.{name.split('.', 1)[1]}")]
    if "." in name:
        return [("leaf", name.rsplit(".", 1)[-1])]
    return [("func", name)]


class _RootVisitor(ast.NodeVisitor):
    def __init__(self, rel_path: str, tree: ast.Module):
        self.rel_path = rel_path
        self.roots: list[Root] = []
        self._class: list[str] = []
        imports = ast.dump(tree)
        self._process_pool_only = (
            "ProcessPoolExecutor" in imports and "ThreadPoolExecutor" not in imports
        )

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def _add(self, label: str, node: ast.AST, entries: list[EntrySpec]) -> None:
        if entries:
            self.roots.append(
                Root(label, self.rel_path, node.lineno, tuple(entries))
            )

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name == "main" and not self._class:
            self.roots.append(
                Root("main", self.rel_path, node.lineno, (("func", "main"),))
            )
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        cls = self._class[-1] if self._class else None
        leaf = name.rsplit(".", 1)[-1] if name else None
        if name in _THREAD_NAMES:
            label = "thread"
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    label = f"thread:{kw.value.value}"
            for kw in node.keywords:
                if kw.arg == "target":
                    self._add(label, node, _entry_specs(kw.value, cls))
        elif leaf == "submit" and name != "self.submit":
            if not self._process_pool_only and node.args:
                self._add("executor-submit", node, _entry_specs(node.args[0], cls))
        elif leaf == "run_in_executor" and len(node.args) >= 2:
            self._add("executor-submit", node, _entry_specs(node.args[1], cls))
        elif name in _TASK_NAMES and node.args:
            self._add("asyncio-task", node, _entry_specs(node.args[0], cls))
        elif leaf == "start_server" and node.args:
            self._add("http-handler", node, _entry_specs(node.args[0], cls))
        elif leaf == "add_signal_handler" and len(node.args) >= 2:
            self._add("signal-handler", node, _entry_specs(node.args[1], cls))
        elif name is not None and name.split(".", 1)[0] == "atexit" and node.args:
            self._add("atexit-hook", node, _entry_specs(node.args[0], cls))
        elif leaf == "add_done_callback" and node.args:
            self._add("future-callback", node, _entry_specs(node.args[0], cls))
        self.generic_visit(node)


def discover_roots(trees: dict[str, ast.Module]) -> list[Root]:
    """{rel_path: parsed module} -> deduplicated root list."""
    roots: list[Root] = []
    seen: set[tuple] = set()
    for rel, tree in trees.items():
        visitor = _RootVisitor(rel, tree)
        visitor.visit(tree)
        for root in visitor.roots:
            key = (root.file, root.line, root.entries)
            if key not in seen:
                seen.add(key)
                roots.append(root)
    return roots


__all__ = ["EntrySpec", "Root", "discover_roots"]

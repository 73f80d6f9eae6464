"""Pass-7 rules: guard inference, lock-order graph, blocking-under-lock.

Six rules over the :mod:`model` + :mod:`roots` whole-program view.
All of them fire only where concurrency is *provable* from the tree:
a class participates when its methods are reachable from >= 2
execution roots (the call graph resolves ``self.m()`` exactly,
module-level calls exactly, and cross-class ``obj.m()`` by method name
with a fan-out cap so generic names don't connect everything to
everything).

- ``unguarded-shared-attr``: an attribute accessed under a class lock
  in one method but bare in another (outside ``__init__``) — the
  guard discipline exists but has a hole; the bare site is the bug.
- ``unguarded-rmw``: a bare augmented assignment (``self.x += 1``) on
  a multiroot path — a read-modify-write torn across threads loses
  updates even under the GIL.
- ``check-then-act``: a bare branch-test read of an attribute followed
  by a bare write of the same attribute in the same multiroot method —
  the classic racy flag flip (two threads both pass the check).
- ``lock-order-cycle``: a cycle in the static lock-order graph (lock B
  acquired while A held, directly via nested ``with`` or transitively
  through calls) — deadlock potential.
- ``blocking-call-under-lock``: unbounded ``queue.put``/``get``,
  ``time.sleep``, ``subprocess``, socket/HTTP I/O, thread joins, or
  bare ``future.result()`` while holding a lock — every other acquirer
  stalls behind I/O.
- ``native-call-under-lock``: a native ``zk_runtime``/batch-verify/
  Poseidon call or a device sync (``block_until_ready``/
  ``device_get``) under a lock — these release the GIL and run for
  milliseconds-to-seconds, turning the lock into a global stall (the
  GIL-release hazard class).

Helper methods *only ever called with a class lock held* (every
in-class call site guarded by the same lock) inherit that guard, so
``_rotate_locked``-style helpers don't false-positive.

Findings matching the explicit :mod:`waivers` table are downgraded to
the report's waiver list — visible in ANALYSIS.json, never silent.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from ..report import Finding
from .model import (
    Access,
    ClassInfo,
    FuncInfo,
    ModuleModel,
    build_program_model,
)
from .roots import Root, discover_roots
from .waivers import WAIVERS, Waiver

#: Max candidate methods a cross-class ``obj.m()`` call may resolve to;
#: beyond this the name is too generic to carry reachability.
_FANOUT_CAP = 6

#: Trees whose class instances are *thread-confined by design* — each
#: object is constructed and used within a single thread of control
#: (the EVM devchain and client are test and tooling harnesses, crypto
#: objects are per-call).  The shared-state rules (mixed-guard / RMW /
#: check-then-act) skip classes defined here; the lock-order and
#: blocking-under-lock rules still apply.  This is a declared policy,
#: recorded in the ANALYSIS.json concurrency section.
#:
#: zk/ is not on this list: the proving plane's dispatcher threads, the
#: ingest dispatchers (batch crypto), and the /aggregate executor all
#: reach the zk bridge — prover *instances* stay confined to one
#: dispatcher (or one worker process), but module state like
#: ``zk/native.py``'s loader globals is genuinely shared and analyzed
#: (the loader holds a one-time-init lock).
_CONFINED_TREES = (
    "protocol_tpu_torch/evm/",
    "protocol_tpu_torch/client/",
    "protocol_tpu_torch/crypto/",
    "protocol_tpu_torch/models/",
)

#: Leaves of calls that block while holding the GIL-visible lock.
_SLEEP_CALLS = frozenset({"time.sleep", "sleep"})
_SUBPROCESS_ROOTS = frozenset({"subprocess", "os.system", "os.popen"})
_SOCKET_ROOTS = frozenset({"socket", "requests", "urllib", "http"})
_JOINISH_RECEIVERS = ("thread", "worker", "_writer", "proc")

#: Native / GIL-releasing entry points (the zk runtime's OpenMP
#: regions, batch crypto, and device syncs).
_NATIVE_LEAVES = frozenset(
    {
        "eddsa_verify_batch",
        "verify_batch",
        "poseidon_permute_batch",
        "msm",
        "ntt",
        "block_until_ready",
        "device_get",
        "zk_phase_stats",
        "zk_phase_reset",
    }
)
_NATIVE_RECEIVER_TOKENS = ("cnative", "zk_runtime", "native")


@dataclass
class StaticConcurrencyModel:
    """What the lock-witness runtime cross-checks against."""

    #: (class, attr) -> guard lock ids (attrs whose every non-init
    #: access is guarded — the *inferred guarded* set).
    guard_map: dict[tuple[str, str], frozenset[str]] = field(default_factory=dict)
    #: lock id -> (file, line) allocation site.
    lock_sites: dict[str, tuple[str, int]] = field(default_factory=dict)
    #: Static lock-order edges (outer, inner).
    order_edges: set[tuple[str, str]] = field(default_factory=set)
    roots: list[Root] = field(default_factory=list)
    multiroot_classes: set[str] = field(default_factory=set)

    def site_to_lock(self) -> dict[tuple[str, int], str]:
        return {site: lid for lid, site in self.lock_sites.items()}


# ---------------------------------------------------------------------------
# call graph + reachability
# ---------------------------------------------------------------------------


def _method_index(models: dict[str, ModuleModel]) -> dict[str, list[str]]:
    """method leaf name -> [Class.method quals] program-wide."""
    index: dict[str, list[str]] = {}
    for m in models.values():
        for cls in m.classes.values():
            for name, fn in cls.methods.items():
                index.setdefault(name, []).append(fn.qual)
    return index


def _func_index(models: dict[str, ModuleModel]) -> dict[str, list[str]]:
    index: dict[str, list[str]] = {}
    for m in models.values():
        for name in m.functions:
            index.setdefault(name, []).append(name)
    return index


def _all_funcs(models: dict[str, ModuleModel]) -> dict[str, FuncInfo]:
    out: dict[str, FuncInfo] = {}
    for m in models.values():
        out.update(m.functions)
        for cls in m.classes.values():
            for fn in cls.methods.values():
                out[fn.qual] = fn
    return out


def _resolve_call(
    name: str,
    fn: FuncInfo,
    model: ModuleModel,
    methods: dict[str, list[str]],
) -> list[str]:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("self.") and name.count(".") == 1 and fn.cls is not None:
        cls = model.classes.get(fn.cls)
        if cls is not None and leaf in cls.methods:
            return [f"{fn.cls}.{leaf}"]
        # inherited / dynamic: fall through to the name index
    if "." not in name:
        if name in model.functions:
            return [name]
        return []
    candidates = methods.get(leaf, [])
    if 0 < len(candidates) <= _FANOUT_CAP:
        return list(candidates)
    return []


def _hook_registry(
    models: dict[str, ModuleModel],
    methods: dict[str, list[str]],
    funcs: dict[str, list[str]],
) -> dict[str, list[str]]:
    """``X.on_foo = <callable>`` registrations anywhere in the tree:
    hook attr name -> registered quals.  Calling through ``self.on_foo``
    (directly or via a local alias) then dispatches to these."""
    import ast as _ast

    from .roots import _entry_specs

    registry: dict[str, list[str]] = {}
    for m in models.values():
        if m.tree is None:
            continue
        for node in _ast.walk(m.tree):
            if not isinstance(node, _ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (
                isinstance(tgt, _ast.Attribute) and tgt.attr.startswith("on_")
            ):
                continue
            for kind, name in _entry_specs(node.value, None):
                if kind == "qual":
                    registry.setdefault(tgt.attr, []).append(name)
                elif kind == "func":
                    registry.setdefault(tgt.attr, []).extend(funcs.get(name, []))
                elif kind == "leaf":
                    candidates = methods.get(name, []) + funcs.get(name, [])
                    if 0 < len(candidates) <= _FANOUT_CAP:
                        registry.setdefault(tgt.attr, []).extend(candidates)
    return registry


def _build_call_graph(
    models: dict[str, ModuleModel],
) -> dict[str, set[str]]:
    methods = _method_index(models)
    funcs = _func_index(models)
    hooks = _hook_registry(models, methods, funcs)
    graph: dict[str, set[str]] = {}
    for model in models.values():
        fns = list(model.functions.values()) + [
            fn for c in model.classes.values() for fn in c.methods.values()
        ]
        for fn in fns:
            edges = graph.setdefault(fn.qual, set())
            for call in fn.calls:
                leaf = call.name.rsplit(".", 1)[-1]
                if leaf in hooks:
                    edges.update(hooks[leaf])
                for target in _resolve_call(call.name, fn, model, methods):
                    edges.add(target)
    return graph


def _reachable(entries: list[str], graph: dict[str, set[str]]) -> set[str]:
    seen: set[str] = set()
    stack = list(entries)
    while stack:
        qual = stack.pop()
        if qual in seen:
            continue
        seen.add(qual)
        stack.extend(graph.get(qual, ()))
    return seen


def _root_entries(
    root: Root,
    models: dict[str, ModuleModel],
    methods: dict[str, list[str]],
    funcs: dict[str, list[str]],
) -> list[str]:
    out: list[str] = []
    for kind, name in root.entries:
        if kind == "qual":
            out.append(name)
        elif kind == "func":
            out.extend(funcs.get(name, []))
            # a Class name used as a callable -> its __init__ et al: skip
        elif kind == "leaf":
            candidates = methods.get(name, []) + funcs.get(name, [])
            if 0 < len(candidates) <= _FANOUT_CAP:
                out.extend(candidates)
    return out


# ---------------------------------------------------------------------------
# guard inference
# ---------------------------------------------------------------------------


def _inherited_guards(cls: ClassInfo) -> dict[str, frozenset[str]]:
    """method -> guards it always runs under, because every in-class
    call site of it is inside a ``with`` holding those locks."""
    call_guards: dict[str, list[frozenset[str]]] = {}
    for fn in cls.methods.values():
        for call in fn.calls:
            if call.name.startswith("self.") and call.name.count(".") == 1:
                leaf = call.name.split(".", 1)[1]
                if leaf in cls.methods:
                    call_guards.setdefault(leaf, []).append(call.guards)
    out: dict[str, frozenset[str]] = {}
    for method, guard_sets in call_guards.items():
        common = frozenset.intersection(*guard_sets) if guard_sets else frozenset()
        if common:
            out[method] = common
    return out


def _effective_accesses(cls: ClassInfo) -> list[tuple[str, Access]]:
    """(method, access) pairs with helper-inherited guards applied."""
    inherited = _inherited_guards(cls)
    out: list[tuple[str, Access]] = []
    for name, fn in cls.methods.items():
        extra = inherited.get(name, frozenset())
        for acc in fn.accesses:
            if extra:
                acc = Access(
                    acc.name,
                    acc.line,
                    acc.kind,
                    acc.guards | extra,
                    acc.in_test,
                )
            out.append((name, acc))
    return out


_INIT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


def _finding(rule: str, message: str, file: str, line: int | None) -> Finding:
    return Finding(
        pass_name="concurrency",
        rule=rule,
        severity="error",
        message=message,
        file=file,
        line=line,
    )


def _is_blocking_call(call) -> str | None:
    """Why this call blocks (short label), or None."""
    name, leaf = call.name, call.name.rsplit(".", 1)[-1]
    root = name.split(".", 1)[0]
    if name in _SLEEP_CALLS:
        return "time.sleep"
    if root in _SUBPROCESS_ROOTS or name in _SUBPROCESS_ROOTS:
        return "subprocess"
    if root in _SOCKET_ROOTS:
        return "socket/HTTP I/O"
    if leaf in ("put", "get") and not call.bounded:
        receiver = name.rsplit(".", 1)[0].lower() if "." in name else ""
        if "queue" in receiver or receiver.endswith("_q"):
            return f"unbounded queue.{leaf}"
    if leaf == "join" and "." in name:
        receiver = name.rsplit(".", 1)[0].lower()
        if any(t in receiver for t in _JOINISH_RECEIVERS):
            return "thread join"
    if leaf == "result" and not call.bounded:
        receiver = name.rsplit(".", 1)[0].lower() if "." in name else ""
        if "future" in receiver or "submit" in receiver:
            return "future.result()"
    return None


def _is_native_call(call) -> bool:
    leaf = call.name.rsplit(".", 1)[-1]
    if leaf in _NATIVE_LEAVES:
        return True
    receiver = call.name.rsplit(".", 1)[0] if "." in call.name else ""
    return any(t in receiver for t in _NATIVE_RECEIVER_TOKENS)


def _find_cycle(edges: set[tuple[str, str]]) -> list[str] | None:
    """A lock-id cycle in the order graph, or None.  Self-edges on
    reentrant locks were already filtered by the caller."""
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    stack_path: list[str] = []

    def dfs(node: str) -> list[str] | None:
        color[node] = GRAY
        stack_path.append(node)
        for nxt in sorted(graph.get(node, ())):
            c = color.get(nxt, WHITE)
            if c == GRAY:
                i = stack_path.index(nxt)
                return stack_path[i:] + [nxt]
            if c == WHITE:
                cycle = dfs(nxt)
                if cycle is not None:
                    return cycle
        stack_path.pop()
        color[node] = BLACK
        return None

    for node in sorted(graph):
        if color.get(node, WHITE) == WHITE:
            cycle = dfs(node)
            if cycle is not None:
                return cycle
    return None


def analyze_models(
    models: dict[str, ModuleModel],
    waivers: tuple[Waiver, ...] = WAIVERS,
) -> tuple[list[Finding], dict, StaticConcurrencyModel]:
    """Run all six rules.  Returns (unwaived findings, the ANALYSIS.json
    ``concurrency`` section, the static model for the witness)."""
    trees = {rel: m.tree for rel, m in models.items() if m.tree is not None}
    roots = discover_roots(trees)
    graph = _build_call_graph(models)
    methods = _method_index(models)
    funcs = _func_index(models)

    # per-root reachability -> per-method root sets
    method_roots: dict[str, set[str]] = {}
    for i, root in enumerate(roots):
        label = f"{root.name}@{root.file}:{root.line}"
        for qual in _reachable(_root_entries(root, models, methods, funcs), graph):
            method_roots.setdefault(qual, set()).add(label)

    static = StaticConcurrencyModel(roots=roots)
    for m in models.values():
        for cls in m.classes.values():
            for decl in cls.locks.values():
                static.lock_sites[decl.lock_id] = (decl.file, decl.line)
        for decl in m.global_locks.values():
            static.lock_sites[decl.lock_id] = (decl.file, decl.line)

    reentrant = {
        decl.lock_id
        for m in models.values()
        for scope in (
            [d for c in m.classes.values() for d in c.locks.values()],
            list(m.global_locks.values()),
        )
        for decl in scope
        if decl.kind in ("RLock", "Condition")
    }

    findings: list[Finding] = []

    for m in models.values():
        for cls in m.classes.values():
            cls_roots: set[str] = set()
            for name in cls.methods:
                cls_roots |= method_roots.get(f"{cls.name}.{name}", set())
            multiroot = len(cls_roots) >= 2
            if multiroot:
                static.multiroot_classes.add(cls.name)

            confined = any(m.path.startswith(t) for t in _CONFINED_TREES)
            accesses = _effective_accesses(cls)
            lock_ids = {d.lock_id for d in cls.locks.values()}
            by_attr: dict[str, list[tuple[str, Access]]] = {}
            for method, acc in accesses:
                if acc.name in cls.locks or acc.name in cls.methods:
                    continue  # the lock attribute / bound-method reads
                by_attr.setdefault(acc.name, []).append((method, acc))

            for attr, uses in sorted(by_attr.items()):
                live = [
                    (meth, acc) for meth, acc in uses if meth not in _INIT_METHODS
                ]
                if not live:
                    continue
                guarded = [
                    (meth, acc)
                    for meth, acc in live
                    if acc.guards
                    & (lock_ids | {g for g in acc.guards if g.startswith("~")})
                ]
                bare = [(meth, acc) for meth, acc in live if not acc.guards]
                # inferred-guarded attrs feed the witness cross-check
                if guarded and not bare:
                    common = frozenset.intersection(
                        *(acc.guards for _, acc in guarded)
                    )
                    concrete = frozenset(g for g in common if not g.startswith("~"))
                    if concrete:
                        static.guard_map[(cls.name, attr)] = concrete
                if not multiroot or confined:
                    continue
                # rule 1: mixed discipline — only attrs whose binding
                # actually mutates after construction (a never-reassigned
                # reference to a thread-safe object needs no guard)
                mutated = any(
                    acc.kind in ("write", "aug") for _, acc in live
                )
                fired_r1 = False
                if guarded and bare and mutated:
                    guarded_methods = {meth for meth, _ in guarded}
                    all_guards = sorted(
                        frozenset.union(*(a.guards for _, a in guarded))
                    )
                    for meth, acc in bare:
                        if meth in guarded_methods and all(
                            gm == meth for gm, _ in guarded
                        ):
                            continue  # single-method mix: local reasoning
                        findings.append(
                            _finding(
                                "unguarded-shared-attr",
                                f"{cls.name}.{attr} is guarded by "
                                f"{all_guards} in {sorted(guarded_methods)} "
                                f"but accessed bare in {meth}() — a "
                                "cross-thread torn read/write (class "
                                f"reachable from {len(cls_roots)} roots)",
                                m.path,
                                acc.line,
                            )
                        )
                        fired_r1 = True
                        break  # one finding per attr: the first bare site
                # rule 2: bare RMW on a multiroot path
                if not fired_r1:
                    for meth, acc in live:
                        if acc.kind == "aug" and not acc.guards and (
                            len(method_roots.get(f"{cls.name}.{meth}", set())) >= 2
                            or multiroot
                        ):
                            findings.append(
                                _finding(
                                    "unguarded-rmw",
                                    f"{cls.name}.{attr} read-modify-write "
                                    f"({cls.name}.{meth}) without a lock on a "
                                    "multiroot path — concurrent updates are "
                                    "lost even under the GIL",
                                    m.path,
                                    acc.line,
                                )
                            )
                            break
                # rule 3: check-then-act
                if not fired_r1:
                    per_method: dict[str, list[Access]] = {}
                    for meth, acc in live:
                        per_method.setdefault(meth, []).append(acc)
                    for meth, accs in sorted(per_method.items()):
                        if len(method_roots.get(f"{cls.name}.{meth}", set())) < 2:
                            continue
                        test_reads = [
                            a for a in accs if a.in_test and not a.guards
                        ]
                        writes = [
                            a
                            for a in accs
                            if a.kind in ("write", "aug") and not a.guards
                        ]
                        hit = next(
                            (
                                w
                                for r in test_reads
                                for w in writes
                                if w.line > r.line
                            ),
                            None,
                        )
                        if hit is not None:
                            findings.append(
                                _finding(
                                    "check-then-act",
                                    f"{cls.name}.{meth}() tests "
                                    f"{cls.name}.{attr} and later writes it, "
                                    "both bare, on a multi-root path — two "
                                    "threads can both pass the check (racy "
                                    "flag flip)",
                                    m.path,
                                    hit.line,
                                )
                            )
                            break

            # module-level globals: same mixed/RMW logic, function scope
        module_confined = any(m.path.startswith(t) for t in _CONFINED_TREES)
        for fname, fn in m.functions.items():
            if module_confined:
                break
            n_roots = len(method_roots.get(fname, set()))
            for acc in fn.global_accesses:
                if acc.kind == "aug" and not acc.guards and n_roots >= 2:
                    findings.append(
                        _finding(
                            "unguarded-rmw",
                            f"module global {acc.name} read-modify-write in "
                            f"{fname}() without a lock on a multi-root path",
                            m.path,
                            acc.line,
                        )
                    )

    # rules 5+6: blocking / native calls under a lock
    for m in models.values():
        all_fns = list(m.functions.values()) + [
            fn for c in m.classes.values() for fn in c.methods.values()
        ]
        for fn in all_fns:
            for call in fn.calls:
                if not call.guards:
                    continue
                why = _is_blocking_call(call)
                if why is not None:
                    findings.append(
                        _finding(
                            "blocking-call-under-lock",
                            f"{call.name}() ({why}) inside "
                            f"`with {sorted(call.guards)}` in {fn.qual} — "
                            "every other acquirer stalls behind the block; "
                            "move the call outside the critical section or "
                            "bound it",
                            fn.file,
                            call.line,
                        )
                    )
                elif _is_native_call(call):
                    findings.append(
                        _finding(
                            "native-call-under-lock",
                            f"{call.name}() under `with {sorted(call.guards)}` "
                            f"in {fn.qual} — native/batch calls release the "
                            "GIL and run for ms-to-s, turning the lock into "
                            "a global stall (GIL-release hazard)",
                            fn.file,
                            call.line,
                        )
                    )

    # rule 4: lock-order cycles (concrete ids only, reentrant self-edges
    # dropped; one finding per cycle)
    edge_lines: dict[tuple[str, str], tuple[str, int]] = {}
    for m in models.values():
        for fn in list(m.functions.values()) + [
            f for c in m.classes.values() for f in c.methods.values()
        ]:
            for a, b, line in fn.order_edges:
                if a.startswith("~") or b.startswith("~"):
                    continue
                if a == b and a in reentrant:
                    continue
                static.order_edges.add((a, b))
                edge_lines.setdefault((a, b), (fn.file, line))
    # transitive edges through calls made under a held lock — resolved
    # STRICTLY (self-methods and same-module functions only): a
    # leaf-name fan-out here would fabricate edges, and a fabricated
    # edge can fabricate a deadlock cycle.
    def _resolve_strict(name: str, fn: FuncInfo, model: ModuleModel) -> list[str]:
        if name.startswith("self.") and name.count(".") == 1 and fn.cls is not None:
            cls = model.classes.get(fn.cls)
            leaf = name.split(".", 1)[1]
            if cls is not None and leaf in cls.methods:
                return [f"{fn.cls}.{leaf}"]
        if "." not in name and name in model.functions:
            return [name]
        return []

    all_fn_map = _all_funcs(models)
    for m in models.values():
        funcs_here = list(m.functions.values()) + [
            f for c in m.classes.values() for f in c.methods.values()
        ]
        for fn in funcs_here:
            for call in fn.calls:
                if not call.guards:
                    continue
                for target in _resolve_strict(call.name, fn, m):
                    callee = all_fn_map.get(target)
                    if callee is None:
                        continue
                    for inner in callee.acquired:
                        if inner.startswith("~"):
                            continue
                        for outer in call.guards:
                            if outer.startswith("~") or outer == inner:
                                continue
                            if (outer, inner) not in static.order_edges:
                                static.order_edges.add((outer, inner))
                                edge_lines[(outer, inner)] = (fn.file, call.line)
    cycle = _find_cycle(static.order_edges)
    if cycle is not None:
        first_edge = (cycle[0], cycle[1])
        file, line = edge_lines.get(first_edge, (None, None))
        findings.append(
            _finding(
                "lock-order-cycle",
                "lock-order cycle (deadlock potential): "
                + " -> ".join(cycle)
                + " — acquire these locks in one global order",
                file or "<program>",
                line,
            )
        )

    # waivers: explicit, enumerated, never silent
    live_findings: list[Finding] = []
    waived: list[dict] = []
    matched: set[int] = set()
    for f in findings:
        waiver = next(
            (
                (i, w)
                for i, w in enumerate(waivers)
                if w.matches(f.rule, f.file or "", f.message)
            ),
            None,
        )
        if waiver is None:
            live_findings.append(f)
        else:
            matched.add(waiver[0])
            waived.append(
                {
                    "rule": f.rule,
                    "file": f.file,
                    "line": f.line,
                    "symbol": waiver[1].symbol,
                    "reason": waiver[1].reason,
                }
            )

    stale_waivers = [
        {"symbol": w.symbol, "rule": w.rule, "reason": w.reason}
        for i, w in enumerate(waivers)
        if i not in matched
    ]
    # A dead waiver is itself a gate failure, in every run that
    # evaluates the table (the default full run included) — a fixed bug
    # must take its waiver with it, or the entry silently pre-suppresses
    # the NEXT bug in the same file.
    for entry in stale_waivers:
        live_findings.append(
            _finding(
                "stale-waiver",
                f"waiver {entry['symbol']!r} ({entry['rule']}) matches no "
                "live finding; remove it with the fix it documented",
                "protocol_tpu_torch/analysis/concurrency/waivers.py",
                None,
            )
        )

    section = {
        "roots": [r.to_dict() for r in roots],
        "confined_trees": list(_CONFINED_TREES),
        "classes_analyzed": sum(len(m.classes) for m in models.values()),
        "multiroot_classes": sorted(static.multiroot_classes),
        "guarded_attrs": {
            f"{c}.{a}": sorted(locks)
            for (c, a), locks in sorted(static.guard_map.items())
        },
        "lock_graph": {
            "nodes": sorted(static.lock_sites),
            "edges": sorted([a, b] for a, b in static.order_edges),
        },
        "findings": len(live_findings),
        "waived": waived,
        "stale_waivers": stale_waivers,
    }
    return live_findings, section, static


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def analyze_sources(
    sources: dict[str, str], waivers: tuple[Waiver, ...] = ()
) -> list[Finding]:
    """In-memory whole-program run (fixtures/tests) — no waivers by
    default, so seeded violations always surface."""
    findings, _, _ = analyze_models(build_program_model(sources), waivers)
    return findings


def _tree_sources(root: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    for path in sorted((root / "protocol_tpu_torch").rglob("*.py")):
        out[str(path.relative_to(root))] = path.read_text()
    return out


def analyze_tree(
    root: str | Path | None = None,
) -> tuple[list[Finding], dict, StaticConcurrencyModel]:
    """Full run over ``protocol_tpu_torch/`` with the real waiver table."""
    if root is None:
        root = Path(__file__).resolve().parents[3]
    return analyze_models(build_program_model(_tree_sources(Path(root))), WAIVERS)


def build_static_model(root: str | Path | None = None) -> StaticConcurrencyModel:
    """The witness cross-check input: guard map + lock sites + order
    graph for the real tree."""
    return analyze_tree(root)[2]


def run_concurrency_pass(
    root: str | Path | None = None,
) -> tuple[list[Finding], dict]:
    findings, section, _ = analyze_tree(root)
    return findings, section


__all__ = [
    "StaticConcurrencyModel",
    "analyze_models",
    "analyze_sources",
    "analyze_tree",
    "build_static_model",
    "run_concurrency_pass",
]

"""Lock-witness runtime: observe what the static analyzer inferred.

Opt-in debug mode (off by default — the production node never pays for
it): while installed, ``threading.Lock``/``RLock`` allocations return
witness-wrapped locks that record, per allocation site:

- the set of **holder threads** and a per-site **wait-time histogram**
  (contention), exported through ``obs/metrics.py``
  (``eigentrust_lock_wait_seconds{site}``);
- **acquisition-order edges**: when a thread acquires lock B while
  holding lock A, the witness records A→B keyed by allocation site.

:meth:`LockWitness.watch` additionally instruments attribute *writes*
on chosen objects (a per-class ``__setattr__`` shim), recording the
writing thread and the witnessed locks it held — the runtime side of
the static guard map.

:meth:`LockWitness.cross_check` closes the loop against
:class:`~.checker.StaticConcurrencyModel`:

1. observed order edges must be **acyclic**;
2. every observed edge between locks whose allocation sites map to
   statically known locks must appear in the **static order graph**
   (a runtime-only edge means the analyzer's graph is incomplete —
   or a code path acquires locks in an order the tree never declares);
3. for every watched attribute the analyzer inferred as **guarded**,
   no cross-thread write may be observed **bare** (static says
   guarded ⇒ runtime must never see an unguarded write from a second
   thread).

Wrapped locks proxy the private ``Condition`` integration surface
(``_is_owned``/``_release_save``/``_acquire_restore``), so
``threading.Condition`` built on a witnessed lock keeps working.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterable

_REPO_ROOT = str(Path(__file__).resolve().parents[3])


def _allocation_site() -> tuple[str, int]:
    """(repo-relative file, line) of the nearest repo frame allocating
    this lock; ("<external>", 0) when allocation came from outside."""
    import sys

    frame = sys._getframe(2)
    while frame is not None:
        fname = frame.f_code.co_filename
        if fname.startswith(_REPO_ROOT) and "concurrency/witness" not in fname:
            rel = fname[len(_REPO_ROOT) :].lstrip("/")
            return rel, frame.f_lineno
        frame = frame.f_back
    return "<external>", 0


class _WitnessedLock:
    """Wraps one real lock; records holders, waits, and order edges."""

    def __init__(self, witness: "LockWitness", real: Any, site: tuple[str, int]):
        self._witness = witness
        self._real = real
        self._site = site
        self._depth = 0  # RLock reentrancy (single owner at a time)

    # -- core protocol --------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        if timeout == -1:
            ok = self._real.acquire(blocking)
        else:
            ok = self._real.acquire(blocking, timeout)
        if ok:
            self._witness._on_acquire(
                self._site, time.perf_counter() - t0, first=self._depth == 0
            )
            self._depth += 1
        return ok

    def release(self) -> None:
        self._depth -= 1
        if self._depth <= 0:
            self._depth = 0
            self._witness._on_release(self._site)
        self._real.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._real.locked() if hasattr(self._real, "locked") else False

    # -- Condition integration (private threading API passthrough) ------

    def _is_owned(self):  # pragma: no cover - Condition internals
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def _release_save(self):  # pragma: no cover - Condition internals
        self._witness._on_release(self._site)
        depth, self._depth = self._depth, 0
        if hasattr(self._real, "_release_save"):
            return depth, self._real._release_save()
        self._real.release()
        return depth, None

    def _acquire_restore(self, state):  # pragma: no cover - Condition internals
        depth, inner = state
        if hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(inner)
        else:
            self._real.acquire()
        self._depth = depth
        self._witness._on_acquire(self._site, 0.0, first=True)

    def __repr__(self) -> str:
        return f"<witnessed {self._real!r} @ {self._site[0]}:{self._site[1]}>"


class LockWitness:
    """Process-global witness; install()/uninstall() bracket a run."""

    def __init__(self) -> None:
        self._installed = False
        self._orig_lock: Any = None
        self._orig_rlock: Any = None
        self._tls = threading.local()
        self._state_lock = threading.Lock()  # guards the tallies below
        #: site -> set of thread idents that held it
        self.holders: dict[tuple[str, int], set[int]] = defaultdict(set)
        #: (outer site, inner site) -> count
        self.order_edges: dict[tuple, int] = defaultdict(int)
        #: site -> [wait seconds] (also mirrored to the obs histogram)
        self.waits: dict[tuple[str, int], list[float]] = defaultdict(list)
        #: (class name, attr) -> list of (thread ident, held sites)
        self.writes: dict[tuple[str, str], list[tuple[int, tuple]]] = defaultdict(
            list
        )
        self._patched_classes: list[type] = []
        self._watched: dict[int, frozenset[str]] = {}

    # -- install/uninstall ----------------------------------------------

    def install(self) -> "LockWitness":
        if self._installed:
            return self
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        witness = self

        def make_lock() -> _WitnessedLock:
            return _WitnessedLock(witness, witness._orig_lock(), _allocation_site())

        def make_rlock() -> _WitnessedLock:
            return _WitnessedLock(witness, witness._orig_rlock(), _allocation_site())

        threading.Lock = make_lock  # type: ignore[misc]
        threading.RLock = make_rlock  # type: ignore[misc]
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._orig_lock  # type: ignore[misc]
        threading.RLock = self._orig_rlock  # type: ignore[misc]
        for cls in self._patched_classes:
            orig = cls.__dict__["__witness_orig_setattr__"]
            cls.__setattr__ = orig  # type: ignore[method-assign]
            del cls.__witness_orig_setattr__  # type: ignore[attr-defined]
        self._patched_classes.clear()
        self._watched.clear()
        self._installed = False

    def __enter__(self) -> "LockWitness":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- runtime recording ----------------------------------------------

    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _on_acquire(self, site: tuple[str, int], wait_s: float, first: bool) -> None:
        if getattr(self._tls, "in_mirror", False):
            return  # instrument-internal acquisition (metrics mirror)
        stack = self._held()
        ident = threading.get_ident()
        with self._state_lock:
            self.holders[site].add(ident)
            self.waits[site].append(wait_s)
            if first:
                for outer in stack:
                    if outer != site:
                        self.order_edges[(outer, site)] += 1
        if first:
            stack.append(site)
        # Contention surface: scrape-able even mid-test.  The mirror is
        # re-entrancy-guarded: when the metrics registry's own lock was
        # allocated under the witness, observing through it would
        # recurse back here and deadlock on the non-reentrant registry
        # lock.
        if getattr(self._tls, "in_mirror", False):
            return
        self._tls.in_mirror = True
        try:
            from ...obs import metrics as obs_metrics

            obs_metrics.LOCK_WAIT_SECONDS.observe(
                wait_s, site=f"{site[0]}:{site[1]}"
            )
        except Exception:  # noqa: BLE001 - observability never throws
            pass
        finally:
            self._tls.in_mirror = False

    def _on_release(self, site: tuple[str, int]) -> None:
        if getattr(self._tls, "in_mirror", False):
            return
        stack = self._held()
        if site in stack:
            stack.reverse()
            stack.remove(site)
            stack.reverse()

    # -- guarded-write observation --------------------------------------

    def watch(self, obj: Any, attrs: Iterable[str]) -> None:
        """Record every write to ``attrs`` on ``obj``: writing thread +
        witnessed locks held.  Class ``__setattr__`` is shimmed once."""
        cls = type(obj)
        self._watched[id(obj)] = frozenset(attrs) | self._watched.get(
            id(obj), frozenset()
        )
        if "__witness_orig_setattr__" in cls.__dict__:
            return
        witness = self
        orig = cls.__setattr__

        def traced_setattr(inst, name, value):
            watched = witness._watched.get(id(inst))
            if watched is not None and name in watched:
                with witness._state_lock:
                    witness.writes[(cls.__name__, name)].append(
                        (threading.get_ident(), tuple(witness._held()))
                    )
            orig(inst, name, value)

        cls.__witness_orig_setattr__ = orig  # type: ignore[attr-defined]
        cls.__setattr__ = traced_setattr  # type: ignore[method-assign]
        self._patched_classes.append(cls)

    # -- reporting + cross-check ----------------------------------------

    def report(self) -> dict:
        with self._state_lock:
            return {
                "locks": {
                    f"{f}:{ln}": {
                        "threads": len(holders),
                        "acquisitions": len(self.waits.get((f, ln), [])),
                        "max_wait_s": max(self.waits.get((f, ln), [0.0]) or [0.0]),
                    }
                    for (f, ln), holders in sorted(self.holders.items())
                },
                "order_edges": {
                    f"{a[0]}:{a[1]} -> {b[0]}:{b[1]}": n
                    for (a, b), n in sorted(self.order_edges.items())
                },
                "watched_writes": {
                    f"{c}.{a}": len(ws) for (c, a), ws in sorted(self.writes.items())
                },
            }

    def cross_check(self, static) -> list[str]:
        """Violations of the static model observed at runtime (empty =
        consistent).  ``static`` is a StaticConcurrencyModel."""
        violations: list[str] = []
        with self._state_lock:
            edges = list(self.order_edges)
            writes = {k: list(v) for k, v in self.writes.items()}

        # 1. acyclicity of the observed graph.  "<external>" sites are
        # excluded: every lock allocated outside the repo shares that
        # one label, so edges through it alias distinct locks and can
        # fabricate cycles the program cannot actually deadlock on.
        graph: dict[tuple, set] = defaultdict(set)
        for a, b in edges:
            if a[0] == "<external>" or b[0] == "<external>":
                continue
            graph[a].add(b)
        visiting: set = set()
        done: set = set()

        def cyclic(node) -> bool:
            if node in done:
                return False
            if node in visiting:
                return True
            visiting.add(node)
            if any(cyclic(nxt) for nxt in graph.get(node, ())):
                return True
            visiting.discard(node)
            done.add(node)
            return False

        if any(cyclic(n) for n in list(graph)):
            violations.append(
                "observed lock-order graph is cyclic: "
                + "; ".join(f"{a}->{b}" for a, b in edges)
            )

        # 2. observed edges between statically known locks must be a
        # subset of the static order graph
        site_to_lock = static.site_to_lock()
        static_edges = set(static.order_edges)
        for a, b in edges:
            la, lb = site_to_lock.get(a), site_to_lock.get(b)
            if la is None or lb is None or la == lb:
                continue
            if (la, lb) not in static_edges:
                violations.append(
                    f"runtime order edge {la} -> {lb} "
                    f"({a[0]}:{a[1]} -> {b[0]}:{b[1]}) absent from the "
                    "static lock-order graph"
                )

        # 3. statically-guarded attrs must never see a bare cross-thread
        # write
        for (cls_name, attr), guard_locks in static.guard_map.items():
            ws = writes.get((cls_name, attr))
            if not ws:
                continue
            threads = {t for t, _ in ws}
            if len(threads) < 2:
                continue
            guard_sites = {
                site
                for lock_id in guard_locks
                for lock_id2, site in static.lock_sites.items()
                if lock_id2 == lock_id
            }
            for ident, held in ws:
                if not guard_sites & set(held):
                    violations.append(
                        f"{cls_name}.{attr}: statically guarded by "
                        f"{sorted(guard_locks)} but thread {ident} wrote it "
                        f"holding {list(held) or 'no witnessed locks'}"
                    )
                    break
        return violations


#: Process-global witness (tests install/uninstall around their run).
WITNESS = LockWitness()


__all__ = ["LockWitness", "WITNESS"]

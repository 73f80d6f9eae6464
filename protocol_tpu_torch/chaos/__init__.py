"""Fault injection: named fault points driven by a seeded schedule.

The durability plane (node/wal.py, node/checkpoint.py, the recovery
path) is only as trustworthy as the failures it has actually survived,
so the code that implements it carries *fault points* — named host-side
hooks (``chaos.fire("checkpoint.pre_rename")``) where a configured
schedule can crash the process (the ``kill -9`` analog), delay, tear a
write at byte k, or raise an intermittent ``OSError``/RPC error.
``tools/crash_matrix.py`` enumerates the registry and kills the node at
every point; ``tests/`` drive individual faults deterministically.

Doctrine:

- **Zero cost disabled.**  Every call site guards with
  ``if chaos.ACTIVE:`` — one module-attribute read on the hot path
  (same stance as the unsampled lineage path).  The
  engine below is never touched on a production node.
- **Deterministic.**  A schedule is a seed plus a list of fault specs;
  triggers are exact hit counts (``after``/``times``) or seeded
  per-point RNG draws (``p``) — the same spec replays the same
  failure, which is what makes a crash matrix a regression test
  instead of a dice roll.
- **Host boundaries only.**  A fault point inside a captured CUDA
  graph would fire once at capture time and never again — the same doctrine as spans and
  journal writes.

Spec shape (``ProtocolConfig.chaos``, or the ``PROTOCOL_TPU_CHAOS``
env var holding inline JSON or ``@/path/to/spec.json``)::

    {"seed": 42, "faults": [
        {"point": "wal.post_append", "kind": "crash", "after": 3},
        {"point": "rpc.get_logs", "kind": "rpc-error", "times": 2},
        {"point": "wal.append", "kind": "torn", "at": 12, "after": 2},
        {"point": "ingest.pre_apply", "kind": "io-error", "p": 0.25},
        {"point": "wal.replay", "kind": "delay", "delay_s": 0.1}
    ]}

Kinds: ``crash`` (``os._exit(137)`` — no atexit, no flush: the
``kill -9`` analog), ``delay`` (``delay_s`` sleep), ``io-error``
(raises ``OSError`` with ``errno`` — default ENOSPC), ``rpc-error``
(raises :class:`ChaosRpcError`, a ``ConnectionError`` the RPC retry
wall handles like a real transport failure), and ``torn`` (a write is
truncated at byte ``at``; with ``then_crash`` — the default — the next
fired point crashes, so the torn prefix reaches disk and the process
dies, exactly the power-loss shape).  Triggers: ``after`` (the exact
Nth hit), ``times`` (hits 1..N), ``p`` (per-hit probability from the
seeded per-point stream), else every hit.

An *empty* fault list still activates the engine in counting mode —
``hits()`` then reports how often the workload reached each point,
which is how the crash matrix discovers which points a run exercises.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import threading
import time
from random import Random
from typing import Any, BinaryIO

#: Hot-path guard: sites read this one module attribute and skip the
#: engine entirely when False (the default).  Flipped by configure().
ACTIVE: bool = False


class ChaosRpcError(ConnectionError):
    """Injected RPC transport failure (kind="rpc-error") — a
    ConnectionError subclass so retry walls treat it like the real
    thing."""


#: Exit code of an injected crash — distinct from SIGKILL's 137-by-
#: shell so the matrix can tell "chaos fired" from "OOM killer".
CRASH_EXIT_CODE = 117


class _Fault:
    """One parsed fault spec bound to its seeded trigger stream."""

    def __init__(self, spec: dict[str, Any], seed: int):
        self.point: str = str(spec["point"])
        self.kind: str = str(spec.get("kind", "crash"))
        self.after: int | None = (
            int(spec["after"]) if "after" in spec else None
        )
        self.times: int | None = (
            int(spec["times"]) if "times" in spec else None
        )
        self.p: float | None = float(spec["p"]) if "p" in spec else None
        self.delay_s: float = float(spec.get("delay_s", 0.05))
        self.at: int | None = int(spec["at"]) if "at" in spec else None
        self.then_crash: bool = bool(spec.get("then_crash", True))
        self.errno: int = getattr(
            _errno, str(spec.get("errno", "ENOSPC")), _errno.ENOSPC
        )
        # Per-fault deterministic stream: independent of every other
        # fault's draws, stable under spec reordering.
        self._rng = Random(f"{seed}:{self.point}:{self.kind}")

    def triggers(self, hit: int) -> bool:
        if self.after is not None:
            return hit == self.after
        if self.times is not None:
            return hit <= self.times
        if self.p is not None:
            return self._rng.random() < self.p
        return True


class _TornFile:
    """File proxy that silently drops everything past byte ``at`` —
    the torn-write shape for whole-file writers (np.savez through the
    checkpoint's atomic tmp).  With ``arm_crash`` the engine's next
    fired point crashes, so the torn prefix is all that survives."""

    def __init__(self, inner: BinaryIO, at: int, engine: "_Engine", arm: bool):
        self._inner = inner
        self._remaining = at
        self._engine = engine
        self._arm = arm
        # One wrapped file is written by one writer in practice, but
        # the budget bookkeeping is lock-guarded anyway.
        self._lock = threading.Lock()

    def write(self, data: bytes) -> int:
        n = len(data)
        with self._lock:
            take = min(n, self._remaining)
            self._remaining -= take
            exhausted = self._remaining == 0
        if take > 0:
            self._inner.write(data[:take])
        if exhausted and take < n and self._arm:
            self._engine.arm_crash("torn-file")
        return n  # callers see a "successful" write

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class _Engine:
    """The fault engine: registry, hit counters, trigger evaluation.
    All state under one lock — fire() is called from ingest dispatcher
    threads, the epoch executor, and the event loop alike."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._registry: dict[str, str] = {}
        self._faults: dict[str, list[_Fault]] = {}
        self._hits: dict[str, int] = {}
        self._crash_armed: str | None = None
        self.seed: int = 0

    # -- configuration --------------------------------------------------

    def configure(self, spec: dict[str, Any] | None) -> None:
        global ACTIVE
        with self._lock:
            self._faults.clear()
            self._hits.clear()
            self._crash_armed = None
            if spec is None:
                ACTIVE = False
                return
            self.seed = int(spec.get("seed", 0))
            for raw in spec.get("faults", ()):
                fault = _Fault(raw, self.seed)
                self._faults.setdefault(fault.point, []).append(fault)
            ACTIVE = True

    def declare(self, point: str, description: str) -> str:
        with self._lock:
            self._registry.setdefault(point, description)
        return point

    def registry(self) -> dict[str, str]:
        with self._lock:
            return dict(self._registry)

    def hits(self) -> dict[str, int]:
        with self._lock:
            return dict(self._hits)

    def arm_crash(self, why: str) -> None:
        with self._lock:
            self._crash_armed = why

    # -- firing ---------------------------------------------------------

    def _crash(self, point: str) -> None:
        # The kill -9 analog: no atexit hooks, no buffered-IO flush —
        # whatever the OS has is whatever recovery gets.
        os._exit(CRASH_EXIT_CODE)

    def _evaluate(self, point: str) -> list[_Fault]:
        """Count one hit at ``point`` and apply every triggered
        non-torn fault (crash / delay / io-error / rpc-error); returns
        the triggered torn faults for the caller to act on."""
        with self._lock:
            if self._crash_armed is not None:
                self._crash(point)
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            fired = [f for f in self._faults.get(point, ()) if f.triggers(hit)]
        torn: list[_Fault] = []
        for fault in fired:
            self._journal(point, fault, hit)
            if fault.kind == "crash":
                self._crash(point)
            elif fault.kind == "delay":
                time.sleep(fault.delay_s)
            elif fault.kind == "io-error":
                raise OSError(
                    fault.errno, f"chaos: injected io-error at {point}"
                )
            elif fault.kind == "rpc-error":
                raise ChaosRpcError(f"chaos: injected rpc error at {point}")
            elif fault.kind == "torn":
                torn.append(fault)
        return torn

    def fire(self, point: str) -> None:
        """Evaluate the schedule at one fault point.  May crash the
        process, sleep, or raise; returns normally otherwise."""
        self._evaluate(point)

    def corrupt(self, point: str, data: bytes) -> bytes:
        """Apply the schedule to a record about to be written; a torn
        fault truncates the payload at byte ``at`` and (by default)
        arms the next fired point to crash — so the site's write →
        fsync → fire sequence puts exactly the torn prefix on disk."""
        for fault in self._evaluate(point):
            at = fault.at if fault.at is not None else len(data) // 2
            if fault.then_crash:
                self.arm_crash(point)
            return data[:at]
        return data

    def wrap_file(self, point: str, f: BinaryIO) -> BinaryIO:
        """Apply the schedule to a whole-file write; a torn fault wraps
        the handle so everything past byte ``at`` is dropped while the
        writer believes it succeeded (``then_crash: false`` lands a
        silently-torn file — the shape checkpoint digest verification
        exists to catch)."""
        for fault in self._evaluate(point):
            at = fault.at if fault.at is not None else 64
            return _TornFile(f, at, self, fault.then_crash)  # type: ignore[return-value]
        return f

    @staticmethod
    def _journal(point: str, fault: _Fault, hit: int) -> None:
        # Observability for every *triggered* fault (hits are free):
        # the flight recorder is exactly where a post-mortem looks.
        from ..obs.journal import JOURNAL

        JOURNAL.record(
            "chaos-fault", point=point, fault=fault.kind, hit=hit
        )


_ENGINE = _Engine()

# -- module-level API (what call sites use) -----------------------------


def configure(spec: dict[str, Any] | str | None) -> None:
    """Install a fault schedule (dict, inline JSON, or ``@path``);
    None deactivates.  An empty ``faults`` list = counting mode."""
    if isinstance(spec, str):
        text = spec
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                text = f.read()
        spec = json.loads(text)
    _ENGINE.configure(spec)


def reset() -> None:
    """Deactivate and clear hit counters (tests)."""
    _ENGINE.configure(None)


def declare(point: str, description: str) -> str:
    """Register a fault point (module import time at the call site) so
    the crash matrix can enumerate every point that exists."""
    return _ENGINE.declare(point, description)


def registry() -> dict[str, str]:
    return _ENGINE.registry()


def hits() -> dict[str, int]:
    return _ENGINE.hits()


def fire(point: str) -> None:
    _ENGINE.fire(point)


def corrupt(point: str, data: bytes) -> bytes:
    return _ENGINE.corrupt(point, data)


def wrap_file(point: str, f: BinaryIO) -> BinaryIO:
    return _ENGINE.wrap_file(point, f)


def _configure_from_env() -> None:
    spec = os.environ.get("PROTOCOL_TPU_CHAOS")
    if spec:
        configure(spec)


_configure_from_env()

__all__ = [
    "ACTIVE",
    "CRASH_EXIT_CODE",
    "ChaosRpcError",
    "configure",
    "corrupt",
    "declare",
    "fire",
    "hits",
    "registry",
    "reset",
    "wrap_file",
]

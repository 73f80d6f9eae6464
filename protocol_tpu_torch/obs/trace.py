"""Hierarchical trace spans with per-epoch span trees.

A span is a context manager timing one host-side phase; nesting is
tracked through a :mod:`contextvars` variable, so spans opened anywhere
down the call stack (manager → backend → checkpoint store) attach to
the right parent without plumbing, and concurrent epoch ticks in
executor threads keep independent stacks.

``Tracer.epoch(n)`` opens the per-epoch root span (``epoch_tick``) and,
on exit, freezes the tree into a JSON-ready dict the node serves as
``GET /trace/<epoch>``.  Spans opened with no enclosing root are still
timed (and fed to ``on_span_close``, which the package wires into the
phase-seconds histogram) but belong to no stored trace — ingest spans
on the event loop work this way.

Spans must only wrap host-boundary work: a span inside the power
iteration's loop would sneak a host clock read (and, with the memory
watcher, a host sync) into every step.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

#: The innermost open span of the current thread/task, or None.
_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "protocol_tpu_obs_span", default=None
)
#: The epoch whose root span is open on this thread/task, or None.
_current_epoch: contextvars.ContextVar["int | None"] = contextvars.ContextVar(
    "protocol_tpu_obs_epoch", default=None
)

#: Process-wide span id source (CPython-atomic C iterator).
_span_ids = itertools.count(1)


@dataclass
class Span:
    """One timed phase.  ``duration_s`` is None while the span is open."""

    name: str
    span_id: int
    attrs: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    #: Monotonic start (for durations) and offset from the root span's
    #: start (for ordering inside a serialized tree).
    start_monotonic: float = 0.0
    start_offset_s: float = 0.0
    duration_s: float | None = None

    def child_names(self) -> list[str]:
        return [c.name for c in self.children]

    def find(self, name: str) -> "Span | None":
        """First descendant (depth-first) with the given name."""
        for c in self.children:
            if c.name == name:
                return c
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "start_offset_s": round(self.start_offset_s, 6),
            "duration_s": round(self.duration_s, 6)
            if self.duration_s is not None
            else None,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        out["children"] = [c.to_dict() for c in self.children]
        return out


class Tracer:
    """Span factory + per-epoch trace store.

    Thread-safe: spans nest per-thread via contextvars; the finished
    trace dicts live behind a lock so HTTP scrapes and epoch ticks can
    race freely.
    """

    def __init__(self, keep_epochs: int = 16):
        self.keep_epochs = keep_epochs
        self._traces: dict[int, dict[str, Any]] = {}
        #: Graft payloads that arrived before their epoch's trace was
        #: stored (an async proof can land while its epoch's root span
        #: is still open — e.g. a fast prove against a cold-compile
        #: converge); applied when the trace stores, bounded like the
        #: trace ring.
        self._pending_grafts: dict[int, list[tuple[dict[str, Any], str | None]]] = {}
        self._lock = threading.Lock()
        #: Called with every closed span (package wiring feeds the
        #: phase-seconds histogram).  Must be cheap and never raise.
        self.on_span_close: Callable[[Span], None] | None = None
        #: Called with every opened span (the device-memory watermark
        #: watcher snapshots allocator state here).  Same contract.
        self.on_span_open: Callable[[Span], None] | None = None

    # -- spans ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        parent = _current_span.get()
        now = time.monotonic()
        root_start = parent.start_monotonic - parent.start_offset_s if parent else now
        sp = Span(
            name=name,
            span_id=next(_span_ids),
            attrs=attrs,
            start_monotonic=now,
            start_offset_s=now - root_start,
        )
        if parent is not None:
            parent.children.append(sp)
        token = _current_span.set(sp)
        open_hook = self.on_span_open
        if open_hook is not None:
            try:
                open_hook(sp)
            except Exception:  # noqa: BLE001 - observability never throws
                pass
        try:
            yield sp
        finally:
            sp.duration_s = time.monotonic() - sp.start_monotonic
            _current_span.reset(token)
            hook = self.on_span_close
            if hook is not None:
                try:
                    hook(sp)
                except Exception:  # noqa: BLE001 - observability never throws
                    pass

    def attach_closed(self, name: str, duration_s: float, **attrs: Any) -> Span | None:
        """Attach an already-measured phase as a closed child of the
        current span — the bridge for sub-phase attributions gathered
        out-of-band (the native prover's phase-timer table, accumulated
        per-call timings) that have a total duration but no single
        contiguous interval.  The synthetic span starts at attach time
        minus its duration so ``start + duration`` never exceeds "now"
        and ``end >= start`` always holds; it feeds ``on_span_close``
        like a real span.  Returns None (and records nothing) when no
        span is open — sub-phases without a parent have nowhere to
        hang."""
        parent = _current_span.get()
        if parent is None:
            return None
        duration_s = max(float(duration_s), 0.0)
        now = time.monotonic()
        root_start = parent.start_monotonic - parent.start_offset_s
        sp = Span(
            name=name,
            span_id=next(_span_ids),
            attrs=attrs,
            start_monotonic=now - duration_s,
            start_offset_s=max(now - duration_s - root_start, 0.0),
            duration_s=duration_s,
        )
        parent.children.append(sp)
        hook = self.on_span_close
        if hook is not None:
            try:
                hook(sp)
            except Exception:  # noqa: BLE001 - observability never throws
                pass
        return sp

    @contextlib.contextmanager
    def epoch(self, epoch_number: int) -> Iterator[Span]:
        """Open the per-epoch root span (``epoch_tick``) and store the
        serialized tree on exit — including on exception, so a failed
        tick still leaves its partial trace behind."""
        epoch_number = int(epoch_number)
        token = _current_epoch.set(epoch_number)
        root: Span | None = None
        try:
            with self.span("epoch_tick", epoch=epoch_number) as root:
                try:
                    yield root
                except BaseException:
                    root.attrs["error"] = True
                    raise
        finally:
            _current_epoch.reset(token)
            if root is not None:
                with self._lock:
                    trace = root.to_dict()
                    # The serialized tree is relative (start_offset_s);
                    # the root's monotonic start anchors it on this
                    # host's clock so the pod stitcher (obs/podtrace)
                    # can place N trees on one aligned timeline.
                    trace["start_monotonic"] = round(root.start_monotonic, 6)
                    self._traces[epoch_number] = trace
                    # Early-arrived grafts (a proof that landed while
                    # this root span was still open) attach now.
                    for span_dict, parent_name in self._pending_grafts.pop(
                        epoch_number, ()
                    ):
                        self._graft_locked(trace, span_dict, parent_name)
                    while len(self._traces) > self.keep_epochs:
                        del self._traces[min(self._traces)]

    def graft(
        self,
        epoch_number: int,
        span_dict: dict[str, Any],
        parent_name: str | None = None,
    ) -> bool:
        """Attach an already-serialized span tree to a *stored* epoch
        trace — the bridge for work that finishes after its epoch's
        root span closed (the async proving plane: a worker process
        proves epoch k seconds after epoch k's tick stored its trace,
        and its ``prove{power_iterate, circuit_check, snark{...}}``
        tree lands here so ``GET /trace/<epoch>`` keeps the deep
        attribution).  ``parent_name`` picks a descendant to graft
        under (first match, depth-first); default is the root.
        A graft for an epoch whose trace is not stored *yet* (the root
        span may still be open — a fast prove can beat a cold-compile
        tick) is parked and applied when the trace stores; grafts for
        ring-evicted epochs are dropped.  Returns whether the graft
        landed immediately — parked/dropped grafts return False; the
        graft is best-effort, like all telemetry."""
        with self._lock:
            epoch_number = int(epoch_number)
            trace = self._traces.get(epoch_number)
            if trace is None:
                if not self._traces or epoch_number >= min(self._traces):
                    self._pending_grafts.setdefault(epoch_number, []).append(
                        (dict(span_dict), parent_name)
                    )
                    while len(self._pending_grafts) > self.keep_epochs:
                        del self._pending_grafts[min(self._pending_grafts)]
                return False
            return self._graft_locked(trace, span_dict, parent_name)

    @staticmethod
    def _graft_locked(
        trace: dict[str, Any],
        span_dict: dict[str, Any],
        parent_name: str | None,
    ) -> bool:
        def find(node: dict[str, Any], name: str) -> dict[str, Any] | None:
            for child in node.get("children", ()):
                if child.get("name") == name:
                    return child
                hit = find(child, name)
                if hit is not None:
                    return hit
            return None

        target = trace if parent_name is None else find(trace, parent_name)
        if target is None:
            return False
        target.setdefault("children", []).append(dict(span_dict))
        return True

    # -- queries --------------------------------------------------------

    def get_trace(self, epoch_number: int) -> dict[str, Any] | None:
        with self._lock:
            trace = self._traces.get(int(epoch_number))
            return dict(trace) if trace is not None else None

    def latest_epoch(self) -> int | None:
        with self._lock:
            return max(self._traces) if self._traces else None

    def epochs(self) -> list[int]:
        with self._lock:
            return sorted(self._traces)

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()


#: Process-global tracer (the node's /trace source).
TRACER = Tracer()


# ---------------------------------------------------------------------------
# Logging integration
# ---------------------------------------------------------------------------

#: Log format with the span/epoch context columns the filter injects.
LOG_FORMAT = (
    "%(asctime)s %(name)s %(levelname)s "
    "[epoch=%(epoch)s span=%(span)s] %(message)s"
)


class SpanContextFilter(logging.Filter):
    """Stamps every record with ``epoch``/``span``/``span_id`` from the
    current trace context, so any formatter may reference them."""

    def filter(self, record: logging.LogRecord) -> bool:
        span = _current_span.get()
        epoch = _current_epoch.get()
        record.epoch = "-" if epoch is None else epoch
        record.span = span.name if span is not None else "-"
        record.span_id = span.span_id if span is not None else 0
        return True


def configure_logging(level: int = logging.INFO) -> None:
    """Single logging entry point for the node (and anything embedding
    it).  Unlike a bare ``logging.basicConfig``, this respects an
    existing root handler: it only *attaches* the span-context filter
    (so the host application's own format can use ``%(epoch)s`` /
    ``%(span)s``) and never installs a second handler or clobbers the
    existing formatter.  On a pristine root it installs one stream
    handler with :data:`LOG_FORMAT`."""
    root = logging.getLogger()
    if root.handlers:
        for handler in root.handlers:
            if not any(isinstance(f, SpanContextFilter) for f in handler.filters):
                handler.addFilter(SpanContextFilter())
        return
    handler = logging.StreamHandler()
    handler.addFilter(SpanContextFilter())
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    root.addHandler(handler)
    root.setLevel(level)


__all__ = [
    "LOG_FORMAT",
    "Span",
    "SpanContextFilter",
    "TRACER",
    "Tracer",
    "configure_logging",
]

"""Flight recorder: a bounded JSONL event journal for post-mortems.

Every interesting host-side event — closed spans, ingest rejections,
plan outcomes, coalesced ticks, recompiles, drift anomalies — writes
one small dict through :meth:`FlightRecorder.record`.  The record path
is designed for writer threads that must never block or throw: one
``deque.append`` into a bounded in-memory ring (GIL-atomic, so the
epoch executor, the asyncio ingest loop, and the pipeline worker need
no lock) plus one append into a pending queue a background writer
thread drains in batches.

The ring always runs (``GET /debug/flight`` serves its tail even on a
node with no journal path configured); the on-disk JSONL file is
opt-in via :meth:`configure` (``ProtocolConfig.journal_path``).  The
file is size-bounded: past ``max_bytes`` it is rewritten from the ring
(the journal is a flight recorder, not an archive — the recent window
is the valuable part).  On crash or SIGTERM the node calls
:meth:`dump` so the final ring survives the process.

Doctrine: journal writes are host-boundary work: never inside a
kernel launch loop or a captured CUDA graph, where one would run once
at capture time and lie forever.
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from pathlib import Path
from typing import Any

from . import metrics as _metrics


class FlightRecorder:
    """Bounded in-memory event ring + optional batched JSONL writer."""

    def __init__(
        self,
        max_events: int = 4096,
        max_bytes: int = 8 * 1024 * 1024,
        flush_interval_s: float = 0.25,
    ):
        self.max_events = int(max_events)
        self.max_bytes = int(max_bytes)
        self.flush_interval_s = float(flush_interval_s)
        #: The ring: newest events, bounded — deque.append/popleft are
        #: GIL-atomic, so record() takes no lock on the hot path.
        self._ring: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=self.max_events
        )
        #: Events awaiting disk, bounded like the ring so a wedged
        #: writer thread can't grow memory; overflow increments the
        #: dropped counter instead of blocking the recorder.
        self._pending: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=self.max_events
        )
        self._seq = 0
        self._path: Path | None = None
        self._file: io.TextIOBase | None = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._writer: threading.Thread | None = None
        #: Serializes file open/rotate/close against the writer thread;
        #: record() never takes it.
        self._io_lock = threading.Lock()

    # -- configuration --------------------------------------------------

    def configure(self, path: str | os.PathLike | None) -> "FlightRecorder":
        """Attach (or detach, with None) the on-disk JSONL journal and
        start the batched writer thread.  Reconfiguring closes the
        previous file."""
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._path = None
            if path:
                p = Path(path)
                p.parent.mkdir(parents=True, exist_ok=True)
                self._file = open(p, "a", encoding="utf-8")
                self._path = p
            # Writer-thread lifecycle stays under the same lock as the
            # file handle: configure() and close() race from different
            # roots (node boot, SIGTERM handler, tests).
            if self._file is not None and (
                self._writer is None or not self._writer.is_alive()
            ):
                self._stop.clear()
                self._writer = threading.Thread(
                    target=self._writer_loop, name="flight-recorder", daemon=True
                )
                self._writer.start()
        return self

    @property
    def path(self) -> Path | None:
        with self._io_lock:
            return self._path

    # -- hot path -------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event.  Never blocks, never raises — the epoch
        executor and the ingest loop call this inline."""
        try:
            self._seq += 1  # benign race: seq is advisory ordering
            event = {"ts": round(time.time(), 6), "seq": self._seq, "kind": kind}
            event.update(fields)
            if len(self._pending) == self._pending.maxlen and self._file is not None:
                _metrics.JOURNAL_DROPPED.inc()
            self._ring.append(event)
            if self._file is not None:
                self._pending.append(event)
                self._wake.set()
            _metrics.JOURNAL_EVENTS.inc(kind=kind)
        except Exception:  # noqa: BLE001 - observability never throws
            pass

    # -- queries --------------------------------------------------------

    def tail(self, n: int | None = None) -> list[dict[str, Any]]:
        """The newest ``n`` events (all ring contents by default),
        oldest first.  A plain list() of the deque is safe against
        concurrent appends."""
        events = list(self._ring)
        if n is not None and n >= 0:
            events = events[-n:]
        return events

    def __len__(self) -> int:
        return len(self._ring)

    # -- disk -----------------------------------------------------------

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            self.flush()

    def flush(self) -> None:
        """Drain the pending queue to disk in one batched write, then
        rotate if the file outgrew ``max_bytes``."""
        if self._file is None:
            self._pending.clear()
            return
        batch: list[dict[str, Any]] = []
        while True:
            try:
                batch.append(self._pending.popleft())
            except IndexError:
                break
        if not batch:
            return
        lines = "".join(json.dumps(e, default=str) + "\n" for e in batch)
        with self._io_lock:
            f = self._file
            if f is None:
                return
            try:
                f.write(lines)
                f.flush()
                if f.tell() > self.max_bytes:
                    self._rotate_locked()
            except (OSError, ValueError):
                pass

    def _rotate_locked(self) -> None:
        """Rewrite the file from the ring (callers hold ``_io_lock``):
        the journal keeps the recent window, not the full history."""
        assert self._path is not None and self._file is not None
        self._file.close()
        with open(self._path, "w", encoding="utf-8") as f:
            for event in list(self._ring):
                f.write(json.dumps(event, default=str) + "\n")
        self._file = open(self._path, "a", encoding="utf-8")

    def dump(self, path: str | os.PathLike, reason: str = "dump") -> Path:
        """Write the whole ring to ``path`` as JSONL (newline-appended
        with a final marker event) — the crash/SIGTERM post-mortem
        artifact.  Safe to call from a signal handler's deferred
        callback or an excepthook."""
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        events = list(self._ring)
        marker = {
            "ts": round(time.time(), 6),
            "seq": self._seq + 1,
            "kind": "journal-dump",
            "reason": reason,
            "events": len(events),
        }
        with open(out, "w", encoding="utf-8") as f:
            for event in events:
                f.write(json.dumps(event, default=str) + "\n")
            f.write(json.dumps(marker) + "\n")
        return out

    def close(self) -> None:
        """Flush pending events and stop the writer thread."""
        self._stop.set()
        self._wake.set()
        # Swap under the lock, join outside it: holding _io_lock across
        # the join would stall flush() (and trip the concurrency lint's
        # blocking-call-under-lock rule) for the whole drain.
        with self._io_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.join(timeout=5.0)
        self.flush()
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def reset(self) -> None:
        """Drop all buffered events (tests)."""
        self._ring.clear()
        self._pending.clear()


#: Process-global flight recorder (the node's /debug/flight source).
JOURNAL = FlightRecorder()


# ---------------------------------------------------------------------------
# Spawn-boundary post-mortems
# ---------------------------------------------------------------------------

#: Events kept per recovered worker dump when journaling its tail.
_WORKER_TAIL_EVENTS = 20


def install_worker_dump_handler(
    dump_dir: str | os.PathLike | None, pool: str
) -> None:
    """Worker-bootstrap half: install a SIGTERM handler that dumps the
    worker process's flight-recorder ring into ``dump_dir`` before the
    process dies, so a terminated worker's last events survive the
    spawn boundary (a hard ``os._exit`` kill leaves nothing — same as
    a real SIGKILL).  No-op without a dump dir or where signals are
    unavailable; never raises (this runs in every worker's init)."""
    if not dump_dir:
        return
    try:
        import signal

        directory = Path(dump_dir)

        def _dump(signum, frame):  # pragma: no cover - runs in workers
            try:
                JOURNAL.dump(
                    directory / f"flight-{pool}-{os.getpid()}.jsonl",
                    reason=f"{pool}-SIGTERM",
                )
            finally:
                os._exit(143)

        signal.signal(signal.SIGTERM, _dump)
    except (ImportError, ValueError, OSError):
        pass


def collect_worker_dumps(
    dump_dir: str | os.PathLike | None,
    pool: str,
    *,
    tail_events: int = _WORKER_TAIL_EVENTS,
) -> list[dict[str, Any]]:
    """Parent half: read (then delete) every per-worker flight dump in
    ``dump_dir``, journal each tail as a ``worker-flight-tail`` event,
    and return the recovered events — the pools attach them to their
    ``*-crashed`` results so a post-mortem sees what the worker was
    doing when it died."""
    if not dump_dir:
        return []
    recovered: list[dict[str, Any]] = []
    directory = Path(dump_dir)
    if not directory.is_dir():
        return recovered
    for path in sorted(directory.glob("flight-*.jsonl")):
        try:
            lines = path.read_text().splitlines()
        except OSError:
            continue
        events: list[dict[str, Any]] = []
        for line in lines[-(tail_events + 1) :]:
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        JOURNAL.record(
            "worker-flight-tail",
            pool=pool,
            dump=path.name,
            events=len(events),
            last=events[-1] if events else None,
        )
        recovered.extend(events)
        try:
            path.unlink()
        except OSError:
            pass
    return recovered


__all__ = [
    "JOURNAL",
    "FlightRecorder",
    "collect_worker_dumps",
    "install_worker_dump_handler",
]

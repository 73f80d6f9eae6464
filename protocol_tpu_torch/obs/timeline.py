"""Epoch timeline registry: one joined record per epoch.

The observability surfaces grown through PRs 4-10 each answer one
question well — ``/trace`` the span tree, ``/metrics`` the aggregate
counters, ``/proof`` the lifecycle — but reconstructing *one epoch's
story* ("what did epoch 41 ingest, how long did each phase take, when
did its proof land?") meant joining three endpoints by hand.  This
registry does the join at write time: every subsystem records its
fragment against the epoch number as it happens —

- the manager's host stage: ingest watermarks (accepted/rejected
  totals at graph assembly), graph size, warm/delta disposition;
- the epoch root span on close: per-phase durations and the tick
  wall-clock (wired through ``obs.__init__``'s span-close hook);
- the converge: iterations, residual, backend;
- the proving plane: the proof lifecycle with submit/land timestamps,
  prove seconds, and lag;
- the lineage tracker: the epoch cohort's end-to-end freshness
  summary when its proof lands;

and ``GET /timeline/<epoch>`` (or ``latest``) serves the merged record.
Records live in a bounded ring like the trace store.  All writes are
merge-into-dict under one lock — observability-cheap, and safe from
every root that touches an epoch (executor, pipeline worker, proving
dispatchers, HTTP scrapes).
"""

from __future__ import annotations

import threading
import time
from typing import Any


class TimelineRegistry:
    """Bounded per-epoch record store with merge-on-record semantics."""

    def __init__(self, keep_epochs: int = 32):
        self.keep_epochs = int(keep_epochs)
        self._lock = threading.Lock()
        self._epochs: dict[int, dict[str, Any]] = {}

    def record(self, epoch: int, **fields: Any) -> None:
        """Merge ``fields`` into the epoch's record (dict-valued fields
        merge one level deep, so ``proof={"state": ...}`` updates join
        instead of clobbering earlier proof fragments)."""
        epoch = int(epoch)
        with self._lock:
            rec = self._epochs.get(epoch)
            if rec is None:
                rec = self._epochs[epoch] = {
                    "epoch": epoch,
                    "first_seen_unix": round(time.time(), 3),
                }
                while len(self._epochs) > self.keep_epochs:
                    del self._epochs[min(self._epochs)]
            for key, value in fields.items():
                if (
                    isinstance(value, dict)
                    and isinstance(rec.get(key), dict)
                ):
                    rec[key].update(value)
                else:
                    rec[key] = value

    # -- queries -----------------------------------------------------------

    def get(self, epoch: int) -> dict[str, Any] | None:
        with self._lock:
            rec = self._epochs.get(int(epoch))
            return dict(rec) if rec is not None else None

    def latest_epoch(self) -> int | None:
        with self._lock:
            return max(self._epochs) if self._epochs else None

    def latest(self) -> dict[str, Any] | None:
        with self._lock:
            if not self._epochs:
                return None
            return dict(self._epochs[max(self._epochs)])

    def epochs(self) -> list[int]:
        with self._lock:
            return sorted(self._epochs)

    def seconds_since_last_tick(self) -> float | None:
        """Wall seconds since the newest epoch's tick closed (None
        before any tick, or if the newest record has no tick yet) —
        the /healthz cadence probe and the SLO engine's epoch-cadence
        source."""
        with self._lock:
            if not self._epochs:
                return None
            rec = self._epochs[max(self._epochs)]
            ended = rec.get("tick_ended_unix")
        if ended is None:
            return None
        return max(time.time() - float(ended), 0.0)

    def reset(self) -> None:
        with self._lock:
            self._epochs.clear()


#: Process-global timeline (the node's /timeline source).
TIMELINE = TimelineRegistry()


__all__ = ["TIMELINE", "TimelineRegistry"]

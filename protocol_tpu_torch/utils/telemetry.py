"""Structured telemetry: named timers/counters and a device profiler hook.

Every hot path records into a process-global registry the node exposes
over ``GET /status``, and ``device_trace`` wraps ``torch.profiler`` for
device timeline captures.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class TimerStats:
    count: int = 0
    total: float = 0.0
    last: float = 0.0
    max: float = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.last = seconds
        self.max = max(self.max, seconds)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "last_s": round(self.last, 6),
            "max_s": round(self.max, 6),
            "mean_s": round(self.total / self.count, 6) if self.count else 0.0,
        }


@dataclass
class Telemetry:
    """Thread-safe: the node records from executor threads while the
    event loop snapshots for /status."""

    timers: dict[str, TimerStats] = field(default_factory=lambda: defaultdict(TimerStats))
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            with self._lock:
                self.timers[name].record(elapsed)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "timers": {k: v.to_dict() for k, v in self.timers.items()},
                "counters": dict(self.counters),
            }

    def reset(self) -> None:
        with self._lock:
            self.timers.clear()
            self.counters.clear()


#: Process-global registry (the node's /status source).
TELEMETRY = Telemetry()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a host and CUDA timeline with ``torch.profiler`` into
    ``log_dir`` as a Chrome trace (view with Perfetto or TensorBoard).
    The CUDA activity is traced only where a card is visible."""
    import pathlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace-{int(time.time() * 1e3)}.json"))

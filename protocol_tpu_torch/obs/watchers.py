"""Runtime invariant watchers: kernel builds, memory watermarks, drift.

Three monitors that turn the epoch path's guarantees into watched ones
on a running node:

- :class:`RecompileTracker` — the port's counterpart of the reference's
  jit recompile watch: it counts the CUDA kernel libraries that
  ``ops/_build.py`` builds or loads (a first use in the process),
  observed at the host boundary around each epoch's converge.  Every
  build lands on ``eigentrust_jit_recompiles_total{fn}``; a build during
  a *steady-state delta epoch* (warm seed + delta plan, which runs the
  kernels the epochs before it loaded) is an anomaly: logged, journaled.
- :class:`MemoryWatermarkWatcher` — per-span device-memory watermarks:
  ``torch.cuda.memory_stats`` snapshotted on span open, delta recorded
  on span close (span attrs + a per-phase gauge).  Without a card it
  degrades to a no-op.
- :class:`ScoreDriftMonitor` — score-integrity: per-epoch L1/L∞ drift
  between consecutive fixed points (peers aligned by hash), the top-k
  mover peers, and a residual-stall detector flagging non-monotone
  convergence trajectories.  Served as ``GET /scores/drift`` and the
  drift/stall gauges.

This module imports only the standard library at import time; torch is
reached lazily inside methods, and only at host boundaries.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Any, Iterable

from . import metrics as _metrics
from .journal import JOURNAL

log = logging.getLogger(__name__)

#: The module that builds and loads the CUDA kernel libraries.
_BUILD_MODULE = __name__.rpartition(".obs.")[0] + ".ops._build"


# ---------------------------------------------------------------------------
# Recompile tracker
# ---------------------------------------------------------------------------


class RecompileTracker:
    """Kernel-library build watcher over ``ops/_build.py``.

    The epoch path brackets each converge with :meth:`snapshot` /
    :meth:`observe`, which diffs the per-library load counts that
    ``_build.load`` keeps — every increase is a library compiled with
    ``nvcc`` or loaded from the build directory for the first time in
    this process.  ``observe(steady_state=True)`` marks the bracket as a
    steady-state delta epoch, whose kernels the earlier epochs loaded,
    so the delta must be zero; a build there is warned and journaled as
    an anomaly.
    """

    def snapshot(self) -> dict[str, int]:
        """Current per-library load counts (empty while no kernel
        library was ever loaded: the build module is not imported)."""
        build = sys.modules.get(_BUILD_MODULE)
        if build is None:
            return {}
        try:
            return dict(build.load_counts())
        except Exception:  # noqa: BLE001 - observability never throws
            return {}

    def observe(
        self,
        before: dict[str, int],
        *,
        steady_state: bool = False,
        epoch: int | None = None,
    ) -> dict[str, int]:
        """Diff the load counts against ``before``: count builds on the
        recompile metric, journal them, and (for a steady-state delta
        epoch) warn — that epoch was guaranteed build-free.  Returns the
        per-library build counts (empty = no builds)."""
        after = self.snapshot()
        misses = {
            name: after[name] - before.get(name, 0)
            for name in after
            if after[name] > before.get(name, 0)
        }
        for name, count in misses.items():
            _metrics.JIT_RECOMPILES.inc(count, fn=name)
            JOURNAL.record(
                "recompile",
                fn=name,
                count=count,
                epoch=epoch,
                steady_state=steady_state,
            )
        if misses and steady_state:
            log.warning(
                "steady-state delta epoch %s BUILT kernel libraries (%s): the "
                "epochs before it should have loaded every kernel it runs",
                "?" if epoch is None else epoch,
                ", ".join(f"{k}+{v}" for k, v in sorted(misses.items())),
            )
            JOURNAL.record(
                "anomaly", what="steady-state-recompile", epoch=epoch,
                fns=sorted(misses),
            )
        return misses


#: Process-global tracker.
RECOMPILES = RecompileTracker()


# ---------------------------------------------------------------------------
# Device-memory watermarks
# ---------------------------------------------------------------------------


class MemoryWatermarkWatcher:
    """Per-span device-memory watermarks via ``torch.cuda.memory_stats``.

    Installed as the tracer's ``on_span_open``/``on_span_close`` hook
    pair: open snapshots the caching allocator's allocated bytes summed
    over the visible cards, close records the delta (and the peak) into
    the span's attrs and the per-phase gauge.  The first call probes
    whether a card is visible and disables itself when none is, so the
    steady state on a CPU-only host is two no-op attribute reads."""

    def __init__(self) -> None:
        #: Guards the probe verdict: span hooks fire from every root
        #: that opens spans (epoch executor, pipeline device worker,
        #: ingest threads), so the first-probe flip must not race.
        self._probe_lock = threading.Lock()
        self._enabled: bool | None = None  # None = not probed yet
        #: Per-backend converge peaks: the highest device bytes observed
        #: across a converge span per backend.  Guarded by the probe
        #: lock — writes come from span hooks on several roots.
        self._converge_peaks: dict[str, int] = {}

    def _bytes_in_use(self) -> tuple[int, int] | None:
        """(allocated bytes, peak allocated bytes) summed over the
        visible cards, or None where no card is visible."""
        try:
            import torch

            if not torch.cuda.is_available():
                return None
            stats = [torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())]
        except Exception:  # noqa: BLE001 - observability never throws
            return None
        if not stats:
            return None
        return (
            sum(int(s.get("allocated_bytes.all.current", 0)) for s in stats),
            sum(int(s.get("allocated_bytes.all.peak", 0)) for s in stats),
        )

    def on_open(self, span) -> None:
        with self._probe_lock:
            if self._enabled is False:
                return
        snap = self._bytes_in_use()
        with self._probe_lock:
            self._enabled = snap is not None
        if snap is None:
            return
        span.attrs["_mem_open_bytes"] = snap[0]

    def on_close(self, span) -> None:
        with self._probe_lock:
            if self._enabled is not True:
                return
        opened = span.attrs.pop("_mem_open_bytes", None)
        if opened is None:
            return
        snap = self._bytes_in_use()
        if snap is None:
            return
        delta = snap[0] - int(opened)
        span.attrs["dev_mem_delta_bytes"] = delta
        span.attrs["dev_mem_peak_bytes"] = snap[1]
        _metrics.DEVICE_MEMORY_DELTA.set(delta, phase=span.name)
        if span.name == "converge" and "backend" in span.attrs:
            self.record_converge_peak(str(span.attrs["backend"]), snap[1])

    def record_converge_peak(self, backend: str, peak_bytes: int) -> None:
        """Record one backend's converge peak (max over observations)
        onto the ``eigentrust_converge_peak_bytes`` gauge."""
        peak = int(peak_bytes)
        with self._probe_lock:
            if peak <= self._converge_peaks.get(backend, -1):
                return
            self._converge_peaks[backend] = peak
        _metrics.CONVERGE_PEAK_BYTES.set(peak, backend=backend)

    def converge_peaks(self) -> dict[str, int]:
        """Per-backend converge peaks recorded so far (bytes)."""
        with self._probe_lock:
            return dict(self._converge_peaks)


#: Process-global watermark watcher (wired by obs/__init__).
MEMORY_WATERMARKS = MemoryWatermarkWatcher()


# ---------------------------------------------------------------------------
# Score-integrity monitor
# ---------------------------------------------------------------------------


class ScoreDriftMonitor:
    """Per-epoch fixed-point drift + convergence-health anomalies.

    The manager feeds every landed epoch's ``(epoch, peer hashes,
    scores, residual trajectory)``; the monitor aligns consecutive
    fixed points by peer hash (joins/leaves drop out of the pairwise
    drift), computes L1/L∞ drift and the top-k movers, and flags a
    *residual stall* when the trajectory is non-monotone beyond
    ``stall_tolerance`` (a residual that *rises* mid-convergence means
    the operator or the seed changed under the iteration — exactly the
    class of bug arXiv:2606.11956-style partial matvecs can introduce,
    watched here before that work lands).  State is a scrape-ready
    dict behind a lock (``GET /scores/drift``)."""

    def __init__(self, top_k: int = 10, stall_tolerance: float = 1e-9):
        self.top_k = int(top_k)
        self.stall_tolerance = float(stall_tolerance)
        self._lock = threading.Lock()
        self._prev: tuple[list[int], Any] | None = None  # (hashes, scores)
        self._last: dict[str, Any] = {}

    def observe(
        self,
        epoch: int,
        peer_hashes: Iterable[int],
        scores,
        residuals=None,
    ) -> dict[str, Any]:
        """Record one landed epoch; returns the drift summary dict."""
        hashes = [int(h) for h in peer_hashes]
        vals = [float(s) for s in scores]
        summary: dict[str, Any] = {
            "epoch": int(epoch),
            "peers": len(hashes),
            "l1": None,
            "linf": None,
            "joined": 0,
            "departed": 0,
            "top_movers": [],
        }
        with self._lock:
            prev = self._prev
            self._prev = (hashes, vals)
        if prev is not None:
            prev_by_hash = dict(zip(prev[0], prev[1]))
            cur_set = set(hashes)
            deltas: list[tuple[float, int, float]] = []
            l1 = 0.0
            linf = 0.0
            for h, v in zip(hashes, vals):
                old = prev_by_hash.get(h)
                if old is None:
                    summary["joined"] += 1
                    continue
                d = v - old
                l1 += abs(d)
                if abs(d) > linf:
                    linf = abs(d)
                deltas.append((abs(d), h, d))
            summary["departed"] = sum(1 for h in prev[0] if h not in cur_set)
            summary["l1"] = l1
            summary["linf"] = linf
            deltas.sort(reverse=True)
            summary["top_movers"] = [
                {"peer_hash": hex(h), "delta": d}
                for absd, h, d in deltas[: self.top_k]
                if absd > 0.0
            ]
            _metrics.SCORE_DRIFT_L1.set(l1)
            _metrics.SCORE_DRIFT_LINF.set(linf)
        stall = self._check_stall(residuals)
        summary["residual_increases"] = stall[0]
        summary["stalled"] = stall[1]
        if stall[1]:
            _metrics.RESIDUAL_STALLS.inc()
            log.warning(
                "epoch %d: non-monotone convergence — residual rose %d time(s) "
                "beyond tolerance (trajectory stall)",
                epoch,
                stall[0],
            )
            JOURNAL.record(
                "anomaly", what="residual-stall", epoch=int(epoch),
                increases=stall[0],
            )
        JOURNAL.record(
            "drift",
            epoch=int(epoch),
            l1=summary["l1"],
            linf=summary["linf"],
            joined=summary["joined"],
            departed=summary["departed"],
            stalled=summary["stalled"],
        )
        with self._lock:
            self._last = summary
        return summary

    def _check_stall(self, residuals) -> tuple[int, bool]:
        """(count of beyond-tolerance residual increases, stalled?).
        One rise is tolerated (warm starts can overshoot on the first
        step); two or more is a stall."""
        if residuals is None:
            return 0, False
        vals = [float(r) for r in residuals]
        increases = sum(
            1 for a, b in zip(vals, vals[1:]) if b > a + self.stall_tolerance
        )
        return increases, increases >= 2

    def last(self) -> dict[str, Any]:
        """The newest drift summary (empty before the first epoch)."""
        with self._lock:
            return dict(self._last)

    def reset(self) -> None:
        with self._lock:
            self._prev = None
            self._last = {}


#: Process-global drift monitor (the node's /scores/drift source).
DRIFT = ScoreDriftMonitor()


__all__ = [
    "DRIFT",
    "MEMORY_WATERMARKS",
    "RECOMPILES",
    "MemoryWatermarkWatcher",
    "RecompileTracker",
    "ScoreDriftMonitor",
]

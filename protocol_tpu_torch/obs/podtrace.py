"""Pod-wide trace stitching: N per-host span trees -> one pod epoch.

The port of ``protocol_tpu/obs/podtrace.py``.  The rest of the obs
plane is per-process: a pod epoch leaves N
independent ``epoch_tick`` trees in N tracers, with no shared clock and
no notion of which host dragged the collective.  This module closes the
gap over the same ``fleet_dir`` atomic-rename exchange the metric
snapshots ride (obs/fleet.py):

- every host serializes its stored epoch trace plus a burst of
  monotonic<->wall *clock-sync samples* into
  ``podtrace-h<host>-e<epoch>.json`` (:func:`publish_epoch_trace`);
- host 0 estimates each host's monotonic->wall offset as the median of
  its sync sample diffs (:func:`estimate_offset` — the median absorbs
  scheduler preemption between the paired clock reads, the same
  robustness argument as NTP's sample filter), rebases every tree onto
  one pod timeline, and merges them into a single ``pod_epoch`` trace
  (:func:`stitch_epoch`) served as ``GET /trace/pod/<epoch>|latest``;
- the stitch computes the pod's *skew* signals: per-phase max-median
  host duration (``eigentrust_pod_phase_skew_seconds{phase}``) for the
  four epoch phases, and the pre-collective barrier-arrival spread
  (``eigentrust_pod_barrier_wait_seconds``) from the clock-aligned
  arrival stamps a pod's plan build records ahead of its
  dimension-agreement collective (``parallel.pod.PodWindowPlan.build``).
  Both feed the pod SLOs
  (obs/slo.py) and the :class:`~.watchers.StragglerWatcher`.

Clock model: within one host, ``unix ~= monotonic + offset`` with the
offset constant over an epoch (wall-clock steps would break this —
which is why the offset is re-sampled and re-estimated every epoch).
Absolute span time is then ``root_start_monotonic + start_offset_s +
offset``; the stitched tree is normalized so the earliest host's root
sits at pod offset 0.

Doctrine: stdlib-only at import (the obs stance), and stitching is
best-effort host-boundary work — a torn or missing file degrades the
stitch to partial (tracked by the stitch-completeness SLO), never
raises into the epoch path.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from pathlib import Path
from typing import Any, Callable

from . import metrics as _metrics
from .journal import JOURNAL
from .trace import TRACER, Tracer
from .watchers import STRAGGLERS, StragglerWatcher

#: Per-host trace file schema version (mismatches are skipped, like
#: fleet snapshots).
PODTRACE_VERSION = 1

#: The phases whose cross-host skew the stitcher attributes — the four
#: top-level spans of a pod dryrun/node epoch.
SKEW_PHASES = ("plan", "converge", "checkpoint", "wal_flush")

#: Clock-sync sample pairs per publish: enough for a meaningful median,
#: cheap enough to take every epoch (6 clock reads).
SYNC_SAMPLES = 3


def clock_sync_samples(
    n: int = SYNC_SAMPLES,
    *,
    monotonic: Callable[[], float] = time.monotonic,
    wall: Callable[[], float] = time.time,
) -> list[dict[str, float]]:
    """Back-to-back (monotonic, unix) clock read pairs.  Each pair is
    read as tightly as Python allows; the stitcher's median over the
    diffs drops the pairs a preemption split apart."""
    return [
        {"monotonic": monotonic(), "unix": wall()} for _ in range(max(int(n), 1))
    ]


def estimate_offset(samples: list[dict[str, float]]) -> float | None:
    """The host's monotonic->wall offset: median of ``unix - monotonic``
    over its sync samples (None when there are none)."""
    diffs = [
        float(s["unix"]) - float(s["monotonic"])
        for s in samples
        if isinstance(s, dict) and "unix" in s and "monotonic" in s
    ]
    if not diffs:
        return None
    return statistics.median(diffs)


def _trace_path(directory: Path, host: int, epoch: int) -> Path:
    return directory / f"podtrace-h{int(host):03d}-e{int(epoch):06d}.json"


def publish_epoch_trace(
    directory: str | os.PathLike,
    host_id: int,
    epoch: int,
    *,
    tracer: Tracer | None = None,
    trace: dict[str, Any] | None = None,
    sync: list[dict[str, float]] | None = None,
    barrier: dict[str, float] | None = None,
    extra: dict[str, Any] | None = None,
) -> Path | None:
    """Write this host's epoch trace + clock-sync samples into the
    fleet directory (atomic tmp+rename, same contract as
    :func:`~.fleet.publish_snapshot`).  ``trace`` defaults to the
    tracer's stored trace for the epoch; publishing with none stored
    returns None (nothing to stitch).  ``barrier`` carries the
    pre-collective arrival stamp from ``PodWindowPlan.build``
    (``enter_monotonic`` / ``wait_seconds``)."""
    tracer = tracer if tracer is not None else TRACER
    if trace is None:
        trace = tracer.get_trace(epoch)
    if trace is None:
        return None
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    record: dict[str, Any] = {
        "version": PODTRACE_VERSION,
        "host": int(host_id),
        "epoch": int(epoch),
        "taken_unix": round(time.time(), 3),
        "clock_sync": sync if sync is not None else clock_sync_samples(),
        "trace": trace,
    }
    if barrier:
        record["barrier"] = dict(barrier)
    if extra:
        record.update(extra)
    path = _trace_path(directory, host_id, epoch)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(record) + "\n")
    tmp.replace(path)
    return path


def directory_hosts(directory: str | os.PathLike, epoch: int) -> list[int]:
    """Host ids with a published trace file for ``epoch`` (sorted)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    suffix = f"-e{int(epoch):06d}.json"
    hosts: list[int] = []
    for path in sorted(directory.glob(f"podtrace-h*{suffix}")):
        try:
            hosts.append(int(path.name[len("podtrace-h") : -len(suffix)]))
        except ValueError:
            continue
    return hosts


def directory_epochs(directory: str | os.PathLike) -> list[int]:
    """Epochs with at least one published per-host trace (sorted)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    epochs: set[int] = set()
    for path in sorted(directory.glob("podtrace-h*-e*.json")):
        try:
            epochs.add(int(path.stem.rsplit("-e", 1)[1]))
        except (IndexError, ValueError):
            continue
    return sorted(epochs)


def phase_durations(trace: dict[str, Any]) -> dict[str, float]:
    """Shallowest-first closed-span duration per skew phase in one
    host's serialized tree — a top-level ``converge`` wins over a
    nested helper span that reused the name."""

    def find(node: dict[str, Any], name: str) -> dict[str, Any] | None:
        children = node.get("children", ())
        for child in children:
            if child.get("name") == name:
                return child
        for child in children:
            hit = find(child, name)
            if hit is not None:
                return hit
        return None

    out: dict[str, float] = {}
    for phase in SKEW_PHASES:
        span = find(trace, phase)
        if span is not None and span.get("duration_s") is not None:
            out[phase] = float(span["duration_s"])
    return out


def compute_phase_skew(
    per_host: dict[str, dict[int, float]]
) -> dict[str, float]:
    """max - median host duration per phase (``{phase: {host: s}}`` ->
    ``{phase: skew_s}``).  Phases observed on fewer than two hosts are
    skipped — skew is a cross-host quantity."""
    skew: dict[str, float] = {}
    for phase, by_host in per_host.items():
        durations = sorted(by_host.values())
        if len(durations) < 2:
            continue
        skew[phase] = max(durations) - statistics.median(durations)
    return skew


class PodTraceStore:
    """Bounded ring of stitched pod epoch traces (host 0's /trace/pod
    source), mirroring the tracer's per-epoch ring, plus the latest
    stitch-completeness verdict the pod SLO reads."""

    def __init__(self, keep_epochs: int = 16):
        self.keep_epochs = int(keep_epochs)
        self._lock = threading.Lock()
        self._traces: dict[int, dict[str, Any]] = {}
        self._last_missing: int | None = None  # None = never stitched

    def put(self, epoch: int, stitched: dict[str, Any]) -> None:
        with self._lock:
            self._traces[int(epoch)] = stitched
            self._last_missing = len(stitched.get("missing_hosts", ()))
            while len(self._traces) > self.keep_epochs:
                del self._traces[min(self._traces)]

    def get(self, epoch: int) -> dict[str, Any] | None:
        with self._lock:
            trace = self._traces.get(int(epoch))
            return dict(trace) if trace is not None else None

    def latest_epoch(self) -> int | None:
        with self._lock:
            return max(self._traces) if self._traces else None

    def epochs(self) -> list[int]:
        with self._lock:
            return sorted(self._traces)

    def last_missing_hosts(self) -> int | None:
        """Hosts missing from the newest stitch (None before any) —
        the pod-stitch-completeness SLO value."""
        with self._lock:
            return self._last_missing

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._last_missing = None


#: Process-global stitched-trace store (the node's /trace/pod source).
POD_TRACES = PodTraceStore()


def _load_host_records(
    directory: Path, epoch: int
) -> list[dict[str, Any]]:
    records: list[dict[str, Any]] = []
    suffix = f"-e{int(epoch):06d}.json"
    for path in sorted(directory.glob(f"podtrace-h*{suffix}")):
        try:
            rec = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(rec, dict) or rec.get("version") != PODTRACE_VERSION:
            continue
        if not isinstance(rec.get("trace"), dict):
            continue
        records.append(rec)
    # Files sort lexically by host already; keep a numeric sort so a
    # future >999-host pod can't interleave, and drop duplicate hosts
    # (last write wins, matching the exchange's latest-snapshot stance).
    by_host: dict[int, dict[str, Any]] = {}
    for rec in records:
        try:
            by_host[int(rec["host"])] = rec
        except (KeyError, TypeError, ValueError):
            continue
    return [by_host[h] for h in sorted(by_host)]


def stitch_epoch(
    directory: str | os.PathLike,
    epoch: int,
    *,
    expected_hosts: int | list[int] | None = None,
    store: PodTraceStore | None = None,
    straggler_watcher: StragglerWatcher | None = None,
    graft_into: Tracer | None = None,
    monotonic: Callable[[], float] = time.monotonic,
) -> dict[str, Any] | None:
    """Align clocks and merge every published host tree for ``epoch``
    into one pod trace (see module doc).  Returns None when no host has
    published yet.  Side effects (all best-effort): the stitched trace
    lands in ``store`` (default :data:`POD_TRACES`), the skew metrics
    are fed, the straggler watcher observes the per-phase host
    durations, and — when ``graft_into`` is given — a ``pod_stitch``
    summary span grafts onto the stitching host's own epoch trace
    (parking if that root is still open, the ``Tracer.graft``
    contract)."""
    t_stitch = monotonic()
    directory = Path(directory)
    records = _load_host_records(directory, epoch)
    if not records:
        return None

    if expected_hosts is None:
        expected = [int(r["host"]) for r in records]
    elif isinstance(expected_hosts, int):
        expected = list(range(expected_hosts))
    else:
        expected = sorted(int(h) for h in expected_hosts)
    present = [int(r["host"]) for r in records]
    missing = sorted(set(expected) - set(present))

    # Per-host clock alignment: absolute wall time of each root =
    # start_monotonic + offset.  A record without sync samples (or a
    # pre-PR-19 trace without start_monotonic) anchors at its
    # publication stamp minus the root duration — degraded, but the
    # tree still lands in the stitch.
    aligned: list[dict[str, Any]] = []
    for rec in records:
        trace = rec["trace"]
        offset = estimate_offset(rec.get("clock_sync") or [])
        start_monotonic = trace.get("start_monotonic")
        if offset is not None and isinstance(start_monotonic, (int, float)):
            root_unix = float(start_monotonic) + offset
            degraded = False
        else:
            offset = None
            root_unix = float(rec.get("taken_unix", 0.0)) - float(
                trace.get("duration_s") or 0.0
            )
            degraded = True
        aligned.append(
            {
                "host": int(rec["host"]),
                "trace": trace,
                "offset": offset,
                "root_unix": root_unix,
                "degraded": degraded,
                "barrier": rec.get("barrier") or None,
            }
        )

    pod_start_unix = min(a["root_unix"] for a in aligned)
    pod_end_unix = pod_start_unix
    children: list[dict[str, Any]] = []
    per_phase: dict[str, dict[int, float]] = {}
    attribution: dict[str, float] = {}
    barrier_arrivals: dict[str, float] = {}
    barrier_waits: dict[str, float] = {}
    for a in aligned:
        shift = a["root_unix"] - pod_start_unix
        tree = _shift_tree(a["trace"], shift)
        tree.setdefault("attrs", {})["host"] = a["host"]
        if a["degraded"]:
            tree["attrs"]["clock_degraded"] = True
        children.append(tree)
        root_dur = float(a["trace"].get("duration_s") or 0.0)
        pod_end_unix = max(pod_end_unix, a["root_unix"] + root_dur)
        durations = phase_durations(a["trace"])
        for phase, dur in durations.items():
            per_phase.setdefault(phase, {})[a["host"]] = dur
        # Phase attribution: how much of the host's root the four
        # top-level phases explain (1.0 = every second accounted for).
        if root_dur > 0.0:
            attribution[str(a["host"])] = round(
                min(sum(durations.values()) / root_dur, 1.0), 4
            )
        barrier = a["barrier"]
        if barrier and a["offset"] is not None:
            enter = barrier.get("enter_monotonic")
            if isinstance(enter, (int, float)) and float(enter) > 0.0:
                barrier_arrivals[str(a["host"])] = round(
                    float(enter) + a["offset"] - pod_start_unix, 6
                )
            wait = barrier.get("wait_seconds")
            if isinstance(wait, (int, float)):
                barrier_waits[str(a["host"])] = round(float(wait), 6)

    skew = compute_phase_skew(per_phase)
    barrier_spread = (
        round(max(barrier_arrivals.values()) - min(barrier_arrivals.values()), 6)
        if len(barrier_arrivals) >= 2
        else None
    )

    stitched: dict[str, Any] = {
        "name": "pod_epoch",
        "epoch": int(epoch),
        "n_hosts": len(present),
        "hosts": present,
        "missing_hosts": missing,
        "complete": not missing,
        "start_unix": round(pod_start_unix, 6),
        "duration_s": round(pod_end_unix - pod_start_unix, 6),
        "clock_offsets_s": {
            str(a["host"]): round(a["offset"], 6)
            for a in aligned
            if a["offset"] is not None
        },
        "phase_seconds": {
            phase: {str(h): round(d, 6) for h, d in sorted(by_host.items())}
            for phase, by_host in sorted(per_phase.items())
        },
        "phase_skew_s": {p: round(s, 6) for p, s in sorted(skew.items())},
        "phase_attribution": attribution,
        "barrier": {
            "arrivals_offset_s": barrier_arrivals,
            "waits_s": barrier_waits,
            "spread_s": barrier_spread,
        },
        "children": children,
    }

    for phase, value in skew.items():
        _metrics.POD_PHASE_SKEW_SECONDS.observe(value, phase=phase)
    if barrier_spread is not None:
        _metrics.POD_BARRIER_WAIT_SECONDS.set(barrier_spread)

    watcher = straggler_watcher if straggler_watcher is not None else STRAGGLERS
    straggler = watcher.observe(int(epoch), per_phase)
    if straggler.get("flagged"):
        stitched["stragglers"] = straggler["flagged"]

    stitch_seconds = monotonic() - t_stitch
    stitched["stitch_seconds"] = round(stitch_seconds, 6)
    _metrics.POD_STITCH_SECONDS.set(stitch_seconds)

    store = store if store is not None else POD_TRACES
    store.put(int(epoch), stitched)
    JOURNAL.record(
        "pod-stitch",
        epoch=int(epoch),
        hosts=len(present),
        missing=len(missing),
        max_skew_s=round(max(skew.values()), 6) if skew else None,
        barrier_spread_s=barrier_spread,
        stitch_seconds=round(stitch_seconds, 6),
    )

    if graft_into is not None:
        graft_into.graft(
            int(epoch),
            {
                "name": "pod_stitch",
                "span_id": 0,
                "start_offset_s": 0.0,
                "duration_s": round(stitch_seconds, 6),
                "attrs": {
                    "hosts": len(present),
                    "missing": len(missing),
                    "complete": not missing,
                },
                "children": [],
            },
        )
    return stitched


def _shift_tree(trace: dict[str, Any], shift: float) -> dict[str, Any]:
    """Copy of one host's tree with every ``start_offset_s`` rebased
    from host-root-relative to pod-start-relative."""

    def walk(node: dict[str, Any]) -> dict[str, Any]:
        out = dict(node)
        out.pop("start_monotonic", None)
        out["start_offset_s"] = round(
            float(node.get("start_offset_s") or 0.0) + shift, 6
        )
        out["children"] = [walk(c) for c in node.get("children", ())]
        return out

    return walk(trace)


__all__ = [
    "POD_TRACES",
    "PODTRACE_VERSION",
    "PodTraceStore",
    "SKEW_PHASES",
    "clock_sync_samples",
    "compute_phase_skew",
    "directory_epochs",
    "directory_hosts",
    "estimate_offset",
    "phase_durations",
    "publish_epoch_trace",
    "stitch_epoch",
]

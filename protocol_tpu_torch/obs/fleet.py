"""Cross-process metric aggregation: one coherent scrape for a fleet.

The port of ``protocol_tpu/obs/fleet.py``; the merged exposition is
byte-identical to the reference's for the same snapshots.  A node is
more than one process — spawned verify workers, the prover pool,
multi-process runs — but a plain scrape serves only the parent
registry, so a worker's signature throughput, prove-phase histograms,
and flight events would be invisible.  Two mechanisms close the gap,
both built on :func:`registry_snapshot` (a JSON-able dump of a
process's registry):

- **worker shipping**: verify/prover workers snapshot their own
  process-global registry after each batch/job and return it *with the
  result* — flat dicts across the spawn boundary, the span-graft
  stance — and the parent folds it into the process-global
  :data:`FLEET` aggregator keyed by ``<pool>-<pid>``;
- **directory exchange**: multi-process runs (the ranks of a
  ``torch.distributed`` group, a pod's hosts) publish snapshots into
  a shared directory (:func:`publish_snapshot`, atomic rename) and
  any process merges the directory on scrape (:func:`load_directory`).

:func:`fleet_prometheus_text` renders the union — the local registry
plus every aggregated source — as ONE exposition document in which
every series gains a ``process`` label (``process="node"`` locally,
``process="<source>"`` for the rest).  Sources keep their *latest*
snapshot (push-gateway semantics), so re-shipping a worker's cumulative
counters never double-counts.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Any

from .export import _escape_help, _fmt, _labels
from .metrics import METRICS, Histogram, MetricsRegistry
from . import metrics as _metrics

#: Snapshot schema version (bump on shape changes; mismatched files in
#: a fleet directory are skipped, not mis-parsed).
SNAPSHOT_VERSION = 1


def registry_snapshot(
    registry: MetricsRegistry | None = None,
    *,
    skip_empty: bool = True,
    source: str | None = None,
) -> dict[str, Any]:
    """One process's registry as a flat JSON-able dict.

    ``skip_empty`` drops metrics with no recorded samples — a worker
    process registers the full catalog at import but has touched only
    a handful, and shipping zeros per batch is wasted wire."""
    registry = registry if registry is not None else METRICS
    metrics: dict[str, Any] = {}
    for metric in registry.collect():
        if isinstance(metric, Histogram):
            snap = metric.snapshot()
            if skip_empty and not snap:
                continue
            metrics[metric.name] = {
                "kind": metric.kind,
                "help": metric.help,
                "labelnames": list(metric.labelnames),
                "buckets": [
                    "+Inf" if b == math.inf else b for b in metric.bucket_bounds
                ],
                "hist": {
                    ",".join(k): v for k, v in snap.items()
                },
            }
            continue
        samples = metric.samples()
        if skip_empty and not samples:
            continue
        metrics[metric.name] = {
            "kind": metric.kind,
            "help": metric.help,
            "labelnames": list(metric.labelnames),
            "samples": [[list(k), v] for k, v in samples],
        }
    return {
        "version": SNAPSHOT_VERSION,
        "pid": os.getpid(),
        "source": source or f"pid-{os.getpid()}",
        "taken_unix": round(time.time(), 3),
        "metrics": metrics,
    }


class FleetAggregator:
    """Latest-snapshot-per-source store behind the fleet scrape.

    Sources also carry a *staleness* side-table: a source whose newest
    snapshot aged past the directory TTL (:func:`load_directory`'s
    ``max_age_s``) is evicted from the merged exposition but remembered
    here with its age, so ``/healthz`` can degrade on a silently dead
    pod host instead of trusting its last numbers forever.  A fresh
    ingest clears the mark."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: dict[str, dict[str, Any]] = {}
        self._stale: dict[str, float] = {}

    def ingest(self, source: str, snapshot: dict[str, Any]) -> None:
        """Install (or replace) one source's snapshot.  Cumulative
        counters re-shipped by a long-lived worker overwrite the prior
        snapshot, so the rendered series never double-counts."""
        if snapshot.get("version") != SNAPSHOT_VERSION:
            return
        with self._lock:
            self._sources[str(source)] = snapshot
            self._stale.pop(str(source), None)
            n, n_stale = len(self._sources), len(self._stale)
        _metrics.FLEET_SOURCES.set(n)
        _metrics.FLEET_STALE_SOURCES.set(n_stale)

    def forget(self, source: str) -> None:
        with self._lock:
            self._sources.pop(str(source), None)
            self._stale.pop(str(source), None)
            n, n_stale = len(self._sources), len(self._stale)
        _metrics.FLEET_SOURCES.set(n)
        _metrics.FLEET_STALE_SOURCES.set(n_stale)

    def mark_stale(self, source: str, age_s: float) -> None:
        """Evict one source for staleness but keep the tombstone (and
        the observed age) for the health surface."""
        with self._lock:
            self._sources.pop(str(source), None)
            self._stale[str(source)] = float(age_s)
            n, n_stale = len(self._sources), len(self._stale)
        _metrics.FLEET_SOURCES.set(n)
        _metrics.FLEET_STALE_SOURCES.set(n_stale)

    def stale(self) -> dict[str, float]:
        """Stale-evicted sources -> last observed snapshot age (s)."""
        with self._lock:
            return dict(self._stale)

    def sources(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    def snapshots(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return dict(self._sources)

    def reset(self) -> None:
        with self._lock:
            self._sources.clear()
            self._stale.clear()
        _metrics.FLEET_SOURCES.set(0)
        _metrics.FLEET_STALE_SOURCES.set(0)


#: Process-global aggregator (the node's /metrics/fleet source).
FLEET = FleetAggregator()


# ---------------------------------------------------------------------------
# Directory exchange (multi-process runs)
# ---------------------------------------------------------------------------


def publish_snapshot(
    directory: str | os.PathLike,
    process_id: str | int,
    registry: MetricsRegistry | None = None,
) -> Path:
    """Write this process's snapshot into a shared fleet directory
    (atomic tmp+rename, so a concurrent merge never reads a torn
    file).  Multi-process runs call this per scrape interval; the
    merging process picks every file up via :func:`load_directory`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    source = f"proc-{process_id}"
    snap = registry_snapshot(registry, source=source)
    path = directory / f"fleet-{process_id}.json"
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(snap) + "\n")
    tmp.replace(path)
    return path


def load_directory(
    directory: str | os.PathLike,
    aggregator: FleetAggregator | None = None,
    *,
    skip_pid: int | None = None,
    max_age_s: float | None = None,
    clock=time.time,
) -> list[str]:
    """Ingest every snapshot file in a fleet directory (skipping this
    process's own, by pid, so the local registry isn't merged twice).
    Returns the ingested source names; unreadable or version-mismatched
    files are skipped — a scrape must never fail on a half-written
    sibling.

    ``max_age_s`` is the staleness TTL: a snapshot whose ``taken_unix``
    is older than that (against ``clock()``, injectable for tests) is
    *not* ingested — it is evicted via :meth:`FleetAggregator.mark_stale`
    so the dead host drops out of the merged series but stays visible
    to ``/healthz`` and ``eigentrust_fleet_stale_sources``.  Without a
    TTL the old keep-forever behavior holds (worker pools that publish
    once and exit)."""
    aggregator = aggregator if aggregator is not None else FLEET
    directory = Path(directory)
    ingested: list[str] = []
    if not directory.is_dir():
        return ingested
    now = clock() if max_age_s is not None else 0.0
    for path in sorted(directory.glob("fleet-*.json")):
        try:
            snap = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(snap, dict):
            continue
        if skip_pid is not None and snap.get("pid") == skip_pid:
            continue
        source = str(snap.get("source") or path.stem)
        taken = snap.get("taken_unix")
        if (
            max_age_s is not None
            and isinstance(taken, (int, float))
            and now - float(taken) > float(max_age_s)
        ):
            aggregator.mark_stale(source, now - float(taken))
            continue
        aggregator.ingest(source, snap)
        ingested.append(source)
    return ingested


# ---------------------------------------------------------------------------
# Merged exposition
# ---------------------------------------------------------------------------


def _local_as_snapshot(registry: MetricsRegistry | None) -> dict[str, Any]:
    return registry_snapshot(registry, skip_empty=False, source="node")


def fleet_prometheus_text(
    registry: MetricsRegistry | None = None,
    aggregator: FleetAggregator | None = None,
    *,
    local_process: str = "node",
) -> str:
    """The merged fleet exposition: every series from the local
    registry plus every aggregated source, each stamped with a
    ``process`` label.  HELP/TYPE render once per metric name."""
    aggregator = aggregator if aggregator is not None else FLEET
    docs: list[tuple[str, dict[str, Any]]] = [
        (local_process, _local_as_snapshot(registry))
    ]
    docs.extend(sorted(aggregator.snapshots().items()))

    # metric name -> (kind, help, [(process, entry), ...]) in
    # first-seen order, local first.
    merged: dict[str, dict[str, Any]] = {}
    for process, snap in docs:
        for name, entry in snap.get("metrics", {}).items():
            slot = merged.setdefault(
                name,
                {"kind": entry["kind"], "help": entry.get("help", ""), "rows": []},
            )
            slot["rows"].append((process, entry))

    lines: list[str] = []
    for name, slot in merged.items():
        if slot["help"]:
            lines.append(f"# HELP {name} {_escape_help(slot['help'])}")
        lines.append(f"# TYPE {name} {slot['kind']}")
        for process, entry in slot["rows"]:
            labelnames = tuple(entry.get("labelnames", ())) + ("process",)
            if "hist" in entry:
                bounds = [
                    math.inf if b == "+Inf" else float(b)
                    for b in entry["buckets"]
                ]
                hist = entry["hist"] or {
                    ",".join("" for _ in entry.get("labelnames", ())): {
                        "buckets": [0] * len(bounds),
                        "sum": 0.0,
                        "count": 0,
                    }
                }
                for labelkey, state in hist.items():
                    values = tuple(labelkey.split(",")) if entry.get(
                        "labelnames"
                    ) else ()
                    values += (process,)
                    for bound, count in zip(bounds, state["buckets"]):
                        le = f'le="{_fmt(bound)}"'
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels(labelnames, values, le)} {count}"
                        )
                    lines.append(
                        f"{name}_sum{_labels(labelnames, values)} "
                        f"{_fmt(state['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_labels(labelnames, values)} "
                        f"{state['count']}"
                    )
                continue
            samples = entry.get("samples") or (
                [[[], 0.0]] if not entry.get("labelnames") else []
            )
            for labelvalues, value in samples:
                values = tuple(labelvalues) + (process,)
                lines.append(
                    f"{name}{_labels(labelnames, values)} {_fmt(value)}"
                )
    return "\n".join(lines) + "\n"


__all__ = [
    "FLEET",
    "FleetAggregator",
    "SNAPSHOT_VERSION",
    "fleet_prometheus_text",
    "load_directory",
    "publish_snapshot",
    "registry_snapshot",
]

"""Node-wide observability: trace spans, metrics, the flight recorder,
lineage, the epoch timeline and runtime invariant watchers.

The port's copy of the reference's instrumentation layer, exporting
what the reference's ``obs`` package exports:

- :mod:`~protocol_tpu_torch.obs.trace` — hierarchical spans collected
  into a per-epoch span tree (``TRACER``);
- :mod:`~protocol_tpu_torch.obs.metrics` — the thread-safe registry of
  counters, gauges and histograms (``METRICS``), with the reference's
  metric names;
- :mod:`~protocol_tpu_torch.obs.journal` — the flight recorder
  (``JOURNAL``);
- :mod:`~protocol_tpu_torch.obs.lineage` — attestation lineage sampling
  (``LINEAGE``);
- :mod:`~protocol_tpu_torch.obs.timeline` — one joined record per epoch
  (``TIMELINE``);
- :mod:`~protocol_tpu_torch.obs.watchers` — the kernel-build watch
  around each converge (``RECOMPILES``), per-span device-memory
  watermarks from ``torch.cuda.memory_stats``, the score-drift
  monitor (``DRIFT``) and the pod straggler watcher (``STRAGGLERS``);
- :mod:`~protocol_tpu_torch.obs.export` — the Prometheus and JSON
  exporters and the ``torch.profiler`` session;
- :mod:`~protocol_tpu_torch.obs.fleet` — cross-process aggregation:
  the registry snapshots that the verify and prover workers ship back
  (``FLEET``), the fleet directory exchange and the merged exposition;
- :mod:`~protocol_tpu_torch.obs.slo` — the declarative SLO engine
  behind ``GET /slo`` (``SLO_ENGINE``): objectives over the registry
  with burn-rate state and journaled transitions;
- :mod:`~protocol_tpu_torch.obs.podtrace` — the pod trace stitcher:
  per-host span trees clock-aligned into one pod epoch
  (``POD_TRACES``), served as ``GET /trace/pod/<epoch>``.

Doctrine: spans, metrics and journal writes live at host boundaries
only; the per-iteration residual trajectory is written on the device
and fetched once after convergence.  This package imports only the
standard library at import time.
"""

from __future__ import annotations

import time as _time

from . import metrics as _metrics
from .export import metrics_json, profile_session, prometheus_text
from .fleet import FLEET, FleetAggregator, fleet_prometheus_text, registry_snapshot
from .journal import JOURNAL, FlightRecorder
from .lineage import LINEAGE, LineageTracker
from .metrics import METRICS, MetricsRegistry
from .podtrace import (
    POD_TRACES,
    PodTraceStore,
    publish_epoch_trace,
    stitch_epoch,
)
from .slo import (
    SLO_ENGINE,
    SLOEngine,
    SLObjective,
    install_pod_defaults,
    pod_objectives,
)
from .timeline import TIMELINE, TimelineRegistry
from .trace import (
    TRACER,
    Span,
    SpanContextFilter,
    Tracer,
    configure_logging,
)
from .watchers import (
    DRIFT,
    MEMORY_WATERMARKS,
    RECOMPILES,
    STRAGGLERS,
    MemoryWatermarkWatcher,
    RecompileTracker,
    ScoreDriftMonitor,
    StragglerWatcher,
)


def _span_closed(span: Span) -> None:
    # Memory watermark first so the delta lands in the span's attrs
    # before the event is journaled.
    MEMORY_WATERMARKS.on_close(span)
    # Every closed span feeds the phase-seconds histogram, so span
    # timings (plan, converge, prove, checkpoint, sig_verify, ...) are
    # scrapeable without separate timer plumbing at each site.
    _metrics.PHASE_SECONDS.observe(span.duration_s or 0.0, phase=span.name)
    # An epoch root closing is the timeline's phase-join moment: the
    # tick wall-clock and the per-phase durations land on the epoch's
    # record in one write (children with repeated names last-win —
    # the phases here mirror /trace exactly).
    if span.name == "epoch_tick" and "epoch" in span.attrs:
        TIMELINE.record(
            span.attrs["epoch"],
            tick_seconds=round(span.duration_s or 0.0, 6),
            tick_ended_unix=round(_time.time(), 3),
            phases={
                c.name: round(c.duration_s or 0.0, 6)
                for c in span.children
                if c.duration_s is not None
            },
            error=bool(span.attrs.get("error", False)),
        )
    # ... and the flight recorder, so a post-mortem replays the span
    # sequence without the trace ring having kept the epoch.
    fields = {"name": span.name, "duration_s": round(span.duration_s or 0.0, 6)}
    for k, v in span.attrs.items():
        if k not in fields and k not in ("ts", "seq", "kind") and isinstance(
            v, (str, int, float, bool)
        ):
            fields[k] = v
    JOURNAL.record("span", **fields)


TRACER.on_span_close = _span_closed
TRACER.on_span_open = MEMORY_WATERMARKS.on_open

__all__ = [
    "DRIFT",
    "FLEET",
    "JOURNAL",
    "LINEAGE",
    "METRICS",
    "MEMORY_WATERMARKS",
    "POD_TRACES",
    "RECOMPILES",
    "SLO_ENGINE",
    "STRAGGLERS",
    "TIMELINE",
    "FleetAggregator",
    "FlightRecorder",
    "LineageTracker",
    "MemoryWatermarkWatcher",
    "MetricsRegistry",
    "PodTraceStore",
    "RecompileTracker",
    "SLOEngine",
    "SLObjective",
    "ScoreDriftMonitor",
    "Span",
    "SpanContextFilter",
    "StragglerWatcher",
    "TRACER",
    "TimelineRegistry",
    "Tracer",
    "configure_logging",
    "fleet_prometheus_text",
    "install_pod_defaults",
    "metrics_json",
    "pod_objectives",
    "profile_session",
    "prometheus_text",
    "publish_epoch_trace",
    "registry_snapshot",
    "stitch_epoch",
]

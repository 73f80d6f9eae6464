"""Exporters: Prometheus text format, JSON, and the profiler hook.

The port of ``protocol_tpu/obs/export.py``.  ``prometheus_text``
renders the registry in the Prometheus exposition format (text/plain;
version=0.0.4) a node serves at ``GET /metrics``; ``metrics_json`` is
the same state for tooling that prefers JSON.  ``profile_session`` is
the opt-in device-timeline capture around a converge: where the
reference wraps ``jax.profiler.trace``, the port wraps
``torch.profiler`` and writes its trace into the directory given.
Importing this module touches no device runtime: torch loads only when
a session starts.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator

from .metrics import METRICS, Histogram, Metric, MetricsRegistry


def _escape_label_value(value: str) -> str:
    """Exposition-format label-value escaping: backslash FIRST (or the
    other escapes' backslashes double), then quote and newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _labels(names: tuple[str, ...], values: tuple[str, ...], extra: str = "") -> str:
    pairs = [
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _render_metric(metric: Metric) -> list[str]:
    lines = []
    if metric.help:
        lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
    lines.append(f"# TYPE {metric.name} {metric.kind}")
    if isinstance(metric, Histogram):
        snap = metric.snapshot()
        if not snap:
            # An unobserved histogram still advertises its series.
            snap = {
                tuple("" for _ in metric.labelnames): {
                    "buckets": [0] * len(metric.bucket_bounds),
                    "sum": 0.0,
                    "count": 0,
                }
            }
        for labelvalues, state in snap.items():
            for bound, count in zip(metric.bucket_bounds, state["buckets"]):
                le = f'le="{_fmt(bound)}"'
                lines.append(
                    f"{metric.name}_bucket"
                    f"{_labels(metric.labelnames, labelvalues, le)} {count}"
                )
            lines.append(
                f"{metric.name}_sum"
                f"{_labels(metric.labelnames, labelvalues)} {_fmt(state['sum'])}"
            )
            lines.append(
                f"{metric.name}_count"
                f"{_labels(metric.labelnames, labelvalues)} {state['count']}"
            )
        return lines
    samples = metric.samples()
    if not samples and not metric.labelnames:
        samples = [((), 0.0)]
    for labelvalues, value in samples:
        lines.append(
            f"{metric.name}{_labels(metric.labelnames, labelvalues)} {_fmt(value)}"
        )
    return lines


#: Content type of the exposition format, for HTTP servers.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """The full registry in Prometheus exposition format."""
    registry = registry if registry is not None else METRICS
    lines: list[str] = []
    for metric in registry.collect():
        lines.extend(_render_metric(metric))
    return "\n".join(lines) + "\n"


def metrics_json(registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """JSON-ready snapshot: metric name -> {kind, help, state}."""
    registry = registry if registry is not None else METRICS
    return {
        metric.name: {"kind": metric.kind, "help": metric.help, **metric.to_dict()}
        for metric in registry.collect()
    }


@contextlib.contextmanager
def profile_session(log_dir: str | None, device=None) -> Iterator[None]:
    """Opt-in ``torch.profiler`` capture: a device-timeline trace of
    the wrapped region (host activity, and the card's where one is
    visible), written into ``log_dir`` in the TensorBoard plugin's
    format when the session closes; a no-op context when ``log_dir``
    is None or empty.

    Where the wrapped region runs on a card (``device``, a CUDA device,
    or the current card where None), the session is settled on it
    before the region starts (``bench/_timing.py::settle_trace``): the
    profiler can lose a fresh session's first launches, which for a
    converge of one iteration are all of them."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    card = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        if card:
            from ..bench._timing import settle_trace

            settle_trace(device)
        yield


__all__ = [
    "PROMETHEUS_CONTENT_TYPE",
    "metrics_json",
    "profile_session",
    "prometheus_text",
]

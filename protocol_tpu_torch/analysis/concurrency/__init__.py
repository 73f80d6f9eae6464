"""graftlint pass 7 — the whole-program concurrency analyzer.

The node is genuinely concurrent: the epoch pipeline's device worker,
the four-stage ingest plane, the journal writer thread, the asyncio
HTTP/event tasks and their executor offloads, signal handlers, and a
metrics registry scraped mid-epoch.  Passes 1–6 pin kernels and
hot-path hygiene; this pass pins the *threading contract*:

- :mod:`model` builds a per-module AST index — classes, methods, lock
  declarations (``self._lock = threading.Lock()`` and friends),
  per-attribute accesses with the set of locks held at each site, and
  call sites with their guard context.
- :mod:`roots` enumerates every execution root: ``threading.Thread``
  targets, thread-pool/executor submits (process pools are excluded —
  no shared memory), ``asyncio`` task/server/signal entry points, and
  ``main`` functions.
- :mod:`checker` runs the six pass-7 rules over the model (guard
  inference, mixed-discipline and RMW hazards, check-then-act flips,
  the lock-order graph with cycle detection, and the two
  blocking-under-lock classes), applies the explicit waiver table in
  :mod:`waivers`, and emits the ``concurrency`` section of
  ANALYSIS.json.
- :mod:`witness` is the runtime counterpart: an opt-in debug mode that
  wraps lock allocation to observe actual holder threads, acquisition
  order, and guarded writes, and cross-checks them against the static
  guard map and lock-order graph.
"""

from __future__ import annotations

from .checker import (
    StaticConcurrencyModel,
    analyze_sources,
    analyze_tree,
    build_static_model,
    run_concurrency_pass,
)
from .roots import Root, discover_roots
from .waivers import WAIVERS, Waiver

__all__ = [
    "Root",
    "StaticConcurrencyModel",
    "WAIVERS",
    "Waiver",
    "analyze_sources",
    "analyze_tree",
    "build_static_model",
    "discover_roots",
    "run_concurrency_pass",
]

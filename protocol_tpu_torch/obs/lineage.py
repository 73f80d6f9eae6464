"""Attestation lineage sampling: end-to-end freshness measurement.

The one question a production operator keeps asking — "how long from an
attestation hitting ``POST /attestation`` until its effect is in a
*proven, servable* score?" — is unanswerable from per-stage metrics
alone: admission latency, epoch cadence, and proof lag compose through
queues, coalescing, and proof supersession.  This module answers it by
*sampling*: a configurable fraction of submissions draw a lineage ID at
intake and carry it through every hop of their life

    intake -> admitted -> verified -> applied -> included(-in-epoch-E)
           -> converged -> proof_landed

with a landmark timestamp recorded at each hop.  Every hop observes
``eigentrust_freshness_seconds{stage=...}`` (elapsed since intake), so
the per-stage histograms decompose exactly where freshness goes, and
``stage="proof_landed"`` is the end-to-end headline the SLO engine
gates.

Cost doctrine: the *unsampled* path allocates **nothing** — with
sampling disabled ``maybe_begin`` is one attribute read and a return;
with sampling enabled it is one counter tick and a modulo, and only the
1-in-N sampled submissions build tracker state.  A lineage ID is a bare
``int`` (0 = unsampled), so it crosses the spawn boundaries flat —
:class:`~protocol_tpu_torch.prover.jobs.ProofJob` carries the including
epoch's IDs as a plain tuple and the worker echoes them back with the
proof, the same flat-data stance as the span graft.

Epoch semantics mirror the proving plane's supersede rules: entries
bind to the epoch whose graph absorbed them (``bind_epoch`` at
``Manager.prepare_epoch``); a proof landing for epoch E completes every
entry bound to E *or earlier* (a superseded epoch's effect is proven by
the newer epoch's SNARK — scores are cumulative state).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any

from . import metrics as _metrics

#: Lineage hop names, in lifecycle order.
STAGES = (
    "intake",
    "admitted",
    "verified",
    "applied",
    "included",
    "converged",
    "proof_landed",
)

#: The "not sampled" lineage ID — falsy, flat, allocation-free.
UNSAMPLED = 0


class _Entry:
    __slots__ = ("t0", "stage", "epoch", "hops")

    def __init__(self, t0: float):
        self.t0 = t0
        self.stage = "intake"
        self.epoch: int | None = None
        #: stage -> seconds since intake.
        self.hops: dict[str, float] = {"intake": 0.0}


class LineageTracker:
    """Sampled per-attestation lifecycle tracking (see module doc).

    Thread-safe: intake/admission/verify threads, the epoch executor,
    and proving-plane dispatchers all mark hops; one lock covers the
    entry table.  The sampling decision itself takes no lock (a
    CPython-atomic ``itertools.count`` tick), so the unsampled hot
    path never contends.
    """

    def __init__(self, sample_every: int = 0, max_entries: int = 4096):
        self._every = int(sample_every)
        self.max_entries = int(max_entries)
        self._tick = itertools.count(1)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._entries: dict[int, _Entry] = {}
        #: epoch -> lineage IDs bound to it (insertion-ordered).
        self._by_epoch: dict[int, list[int]] = {}

    # -- configuration ---------------------------------------------------

    def configure(self, sample_every: int) -> "LineageTracker":
        """Set the sampling period (1 = every accepted submission,
        N = one in N, 0 = off).  Existing entries keep running."""
        self._every = int(sample_every)
        return self

    @property
    def sample_every(self) -> int:
        return self._every

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- intake (hot path) -----------------------------------------------

    def maybe_begin(self) -> int:
        """Draw a lineage ID for this submission, or :data:`UNSAMPLED`.

        The unsampled path is allocation-free: disabled sampling is one
        attribute read; enabled sampling adds one counter tick and a
        modulo.  Only the sampled 1-in-N builds an entry."""
        every = self._every
        if every <= 0:
            return UNSAMPLED
        if next(self._tick) % every:
            return UNSAMPLED
        lid = next(self._ids)
        entry = _Entry(time.monotonic())
        with self._lock:
            if len(self._entries) >= self.max_entries:
                evicted = min(self._entries)
                self._discard_locked(evicted)
                _metrics.LINEAGE_DROPPED.inc(reason="evicted")
            self._entries[lid] = entry
        _metrics.LINEAGE_SAMPLED.inc()
        return lid

    # -- hops --------------------------------------------------------------

    def mark(self, lid: int, stage: str) -> None:
        """Record one hop for a sampled entry; a falsy/unknown ID is a
        no-op (the unsampled path costs one comparison here)."""
        if not lid:
            return
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(lid)
            if entry is None:
                return
            elapsed = now - entry.t0
            entry.stage = stage
            entry.hops[stage] = elapsed
        _metrics.FRESHNESS_SECONDS.observe(elapsed, stage=stage)

    def drop(self, lid: int, reason: str = "rejected") -> None:
        """Abandon a sampled entry (its attestation was rejected, or
        the node is shutting down)."""
        if not lid:
            return
        with self._lock:
            if lid not in self._entries:
                return
            self._discard_locked(lid)
        _metrics.LINEAGE_DROPPED.inc(reason=reason)

    def _discard_locked(self, lid: int) -> None:
        entry = self._entries.pop(lid, None)
        if entry is not None and entry.epoch is not None:
            ids = self._by_epoch.get(entry.epoch)
            if ids is not None and lid in ids:
                ids.remove(lid)

    # -- epoch lifecycle ---------------------------------------------------

    def bind_epoch(self, epoch: int) -> tuple[int, ...]:
        """Bind every entry that has reached ``applied`` (and no epoch
        yet) to this epoch — called from ``Manager.prepare_epoch``, the
        moment the epoch's graph absorbs the attestation cache.
        Returns the bound IDs (the epoch's lineage cohort)."""
        epoch = int(epoch)
        now = time.monotonic()
        bound: list[int] = []
        elapsed: list[float] = []
        with self._lock:
            for lid, entry in self._entries.items():
                if entry.epoch is None and entry.stage == "applied":
                    entry.epoch = epoch
                    entry.stage = "included"
                    dt = now - entry.t0
                    entry.hops["included"] = dt
                    bound.append(lid)
                    elapsed.append(dt)
            if bound:
                self._by_epoch.setdefault(epoch, []).extend(bound)
        for dt in elapsed:
            _metrics.FRESHNESS_SECONDS.observe(dt, stage="included")
        return tuple(bound)

    def ids_for_epoch(self, epoch: int) -> tuple[int, ...]:
        """Live lineage IDs whose effect epoch ``epoch``'s proof will
        attest to: everything bound to it or an earlier epoch.  Flat
        ints — this is what :class:`ProofJob.lineage` carries across
        the spawn boundary (``()`` when nothing is sampled)."""
        epoch = int(epoch)
        with self._lock:
            return tuple(
                lid
                for e in sorted(self._by_epoch)
                if e <= epoch
                for lid in self._by_epoch[e]
            )

    def epoch_converged(self, epoch: int) -> None:
        """Mark every entry bound to ``epoch`` (or earlier — a
        coalesced epoch's cohort converges with its superseder) as
        converged."""
        epoch = int(epoch)
        now = time.monotonic()
        elapsed: list[float] = []
        with self._lock:
            for e, ids in self._by_epoch.items():
                if e > epoch:
                    continue
                for lid in ids:
                    entry = self._entries.get(lid)
                    if entry is None or entry.stage != "included":
                        continue
                    entry.stage = "converged"
                    dt = now - entry.t0
                    entry.hops["converged"] = dt
                    elapsed.append(dt)
        for dt in elapsed:
            _metrics.FRESHNESS_SECONDS.observe(dt, stage="converged")

    def epoch_proved(self, epoch: int) -> list[float]:
        """Complete every entry bound to ``epoch`` or earlier (the
        proof supersede semantics: a newer epoch's SNARK covers older
        cohorts) and return their end-to-end freshness seconds —
        ``stage="proof_landed"`` observations, the headline series."""
        epoch = int(epoch)
        now = time.monotonic()
        e2e: list[float] = []
        with self._lock:
            done_epochs = [e for e in self._by_epoch if e <= epoch]
            for e in done_epochs:
                for lid in self._by_epoch.pop(e):
                    entry = self._entries.pop(lid, None)
                    if entry is None:
                        continue
                    e2e.append(now - entry.t0)
        for dt in e2e:
            _metrics.FRESHNESS_SECONDS.observe(dt, stage="proof_landed")
        if e2e:
            _metrics.LINEAGE_COMPLETED.inc(len(e2e))
        return e2e

    # -- queries -----------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Scrape-ready state: live entries by stage, epoch cohorts."""
        with self._lock:
            by_stage: dict[str, int] = {}
            for entry in self._entries.values():
                by_stage[entry.stage] = by_stage.get(entry.stage, 0) + 1
            return {
                "sample_every": self._every,
                "live": len(self._entries),
                "by_stage": by_stage,
                "epoch_cohorts": {
                    str(e): len(ids) for e, ids in sorted(self._by_epoch.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_epoch.clear()


#: Process-global lineage tracker (configured by the node from
#: ``ProtocolConfig.lineage_sample_every``; off by default in bare
#: library use).
LINEAGE = LineageTracker()


__all__ = ["LINEAGE", "LineageTracker", "STAGES", "UNSAMPLED"]

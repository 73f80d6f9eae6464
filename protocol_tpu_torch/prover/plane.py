"""The asynchronous proving plane: epoch ticks enqueue, workers prove.

The port of ``protocol_tpu/prover/plane.py``: the same lifecycle,
latest-wins queue, metrics and span graft.

The epoch pipeline's device stage ends at ``converge → checkpoint`` and
hands the SNARK to this plane as a bounded-queue job — a slow prover
then shows up as *proof lag* (``eigentrust_proof_lag_epochs``), never
as epoch latency.  Topology mirrors the ingest plane: a non-blocking
submit in front of a bounded queue, dispatcher threads (one per
worker) feeding the spawn-based
:class:`~protocol_tpu_torch.prover.workers.ProverPool`, and every job
resolving to an explicit terminal state.

Lifecycle (the ``GET /proof/<epoch>`` surface)::

    queued → proving → proved
                     ↘ failed      (crashed/timed out past retries)
    queued → superseded            (displaced under backpressure)

Backpressure is *latest-wins coalescing*, the EpochPipeline's
supersede semantics applied to proofs: a full queue displaces the
oldest **queued** job (marked ``superseded`` — counted and journaled,
never silent) in favor of the newest epoch, and :meth:`submit` never
blocks the epoch tick.  A job already ``proving`` is never superseded:
its proof still lands (proofs are per-epoch facts, not cumulative
state), so under sustained overload the plane degrades to proving a
sampled subsequence of epochs — newest-first — with the gap visible as
lag and supersede counts.

When a proof lands, the worker's span tree (``prove{power_iterate,
circuit_check, snark{msm, ntt, gate_eval, ...}}``) is grafted back
into the epoch's stored trace (``Tracer.graft``), so ``GET
/trace/<epoch>`` keeps the prover's deep attribution even though the
prove ran epochs later in another process.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

from ..obs import TRACER
from ..obs import metrics as obs_metrics
from ..obs.fleet import FLEET
from ..obs.journal import JOURNAL
from ..obs.lineage import LINEAGE
from ..obs.timeline import TIMELINE
from .jobs import (
    FAILED,
    PROVED,
    PROVING,
    QUEUED,
    SUPERSEDED,
    ProofJob,
    ProofResult,
)
from .workers import ProverCrashed, ProverPool

log = logging.getLogger(__name__)

#: Terminal lifecycle entries kept for inspection (the /proof surface).
_STATUS_RING = 64


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    idx = min(int(round(q * (len(vals) - 1))), len(vals) - 1)
    return vals[idx]


@dataclass(frozen=True)
class ProvingPlaneConfig:
    #: Prover worker processes; 0 = prove inline on the dispatcher
    #: thread (no pool — the unit-test and tiny-node default).  The
    #: plane runs one dispatcher per worker either way.
    workers: int = 1
    #: Jobs that may wait between submit and a dispatcher.  Beyond it,
    #: the oldest queued job is superseded (latest-wins) — an epoch
    #: tick never blocks on a full proof queue.
    queue_depth: int = 1
    #: Worker-crash/timeout retries per job before ``failed``.
    max_retries: int = 1
    #: Per-attempt wall-clock bound; a worker past it is treated as
    #: crashed (killed + retried).  None = unbounded.
    prove_timeout_s: float | None = 900.0
    #: OMP_NUM_THREADS for each worker's native MSM/NTT loops
    #: (0 = leave the runtime default).  Kept for parity: the port's zk
    #: runtime is built without OpenMP, so it changes no bits and no speed.
    omp_threads: int = 0
    #: Verify each proof in the worker before returning it.
    verify: bool = True


@dataclass
class ProofStatus:
    """One epoch's position in the proof lifecycle."""

    epoch: int
    state: str
    reason: str | None = None
    prove_seconds: float | None = None
    #: Submit → terminal-state wall-clock (the proof-lag headline's
    #: per-job component).
    lag_seconds: float | None = None
    submitted: float = dc_field(default_factory=time.perf_counter)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"epoch": self.epoch, "state": self.state}
        if self.reason is not None:
            out["reason"] = self.reason
        if self.prove_seconds is not None:
            out["prove_seconds"] = round(self.prove_seconds, 4)
        if self.lag_seconds is not None:
            out["lag_seconds"] = round(self.lag_seconds, 4)
        return out


class ProvingPlane:
    """The async proving tier behind one node (or bench driver).

    ``on_proved`` receives every landed :class:`ProofResult` on a
    dispatcher thread — the node installs the proof into the Manager's
    cache there.  All lifecycle state lives under one condition
    variable; submit paths, dispatchers, and HTTP status reads share
    it.
    """

    def __init__(
        self,
        config: ProvingPlaneConfig | None = None,
        *,
        on_proved: Callable[[ProofResult], None] | None = None,
    ):
        self.config = config or ProvingPlaneConfig()
        self.pool = ProverPool(
            self.config.workers,
            max_retries=self.config.max_retries,
            timeout_s=self.config.prove_timeout_s,
            omp_threads=self.config.omp_threads,
            verify=self.config.verify,
        )
        self._on_proved = on_proved
        self._cv = threading.Condition()
        self._queue: deque[ProofJob] = deque()
        self._status: dict[int, ProofStatus] = {}
        self._pending = 0  # jobs queued or proving
        #: Highest epoch ever submitted / proved (the lag gauge pair).
        self._latest_submitted: int | None = None
        self._latest_proved: int | None = None
        self.completed = 0
        self.failed = 0
        self.superseded = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop, name=f"prover-dispatch-{i}", daemon=True
            )
            for i in range(max(1, self.config.workers))
        ]
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ProvingPlane":
        # Flip under the condition lock: the node boot path and a bench
        # driver can race start(), and a bare check-then-act would
        # double-start the dispatcher threads.
        with self._cv:
            if self._started:
                return self
            self._started = True
        obs_metrics.PROOF_QUEUE_DEPTH.set(0)
        obs_metrics.PROOF_LAG_EPOCHS.set(0)
        obs_metrics.PROOFS_COMPLETED.inc(0)
        obs_metrics.PROOFS_FAILED.inc(0)
        obs_metrics.PROOFS_SUPERSEDED.inc(0)
        for t in self._threads:
            t.start()
        return self

    def prewarm(
        self,
        params,
        prover: str = "plonk",
        srs_path: str | None = None,
        *,
        zk_backend: str = "native",
        zk_device: str | None = None,
    ):
        """Build every worker's SRS/proving-key cache now (pool start),
        so the first epoch's job pays no setup; under ``graft`` also
        the SRS's point cache on ``zk_device`` (``None``: the card)."""
        self.pool.prewarm(
            params, prover, srs_path, zk_backend=zk_backend, zk_device=zk_device
        )

    def close(self, *, drain: bool = True, timeout: float = 120.0) -> None:
        with self._cv:
            started = self._started
        if drain and started:
            self.drain(timeout=timeout)
        self._stop.set()
        if started:
            for t in self._threads:
                t.join(timeout=10.0)
        self.pool.close()
        # Anything still queued after an undrained close gets a
        # terminal state — the lifecycle never leaks a silent drop.
        with self._cv:
            stragglers = list(self._queue)
            self._queue.clear()
            for job in stragglers:
                self._set_status(job.epoch, FAILED, reason="shutdown")
                self.failed += 1
                self._pending -= 1
            self._cv.notify_all()

    def __enter__(self) -> "ProvingPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until every submitted job reached a terminal state."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)

    # -- submit (epoch tick thread) -------------------------------------

    def submit(self, job: ProofJob) -> ProofStatus:
        """Enqueue one epoch's proof job; never blocks.  Under
        backpressure the oldest *queued* job is superseded in favor of
        this one (latest-wins); the displaced epoch's terminal state is
        explicit and counted."""
        self.start()  # idempotent under the condition lock
        displaced: ProofJob | None = None
        with self._cv:
            if len(self._queue) >= max(1, self.config.queue_depth):
                displaced = self._queue.popleft()
                self._set_status(displaced.epoch, SUPERSEDED, by=job.epoch)
                self.superseded += 1
                self._pending -= 1
            self._queue.append(job)
            self._pending += 1
            status = self._set_status(job.epoch, QUEUED)
            if (
                self._latest_submitted is None
                or job.epoch > self._latest_submitted
            ):
                self._latest_submitted = job.epoch
            self._update_lag_locked()
            obs_metrics.PROOF_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify()
        TIMELINE.record(
            job.epoch,
            proof={
                "state": QUEUED,
                "submitted_unix": round(time.time(), 3),
                "lineage_ids": len(job.lineage),
            },
        )
        if displaced is not None:
            obs_metrics.PROOFS_SUPERSEDED.inc()
            TIMELINE.record(
                displaced.epoch,
                proof={"state": SUPERSEDED, "superseded_by": job.epoch},
            )
            JOURNAL.record(
                "proof-superseded", epoch=displaced.epoch, by=job.epoch
            )
            log.warning(
                "epoch %d proof superseded by epoch %d before reaching a "
                "prover (proving-plane backpressure)",
                displaced.epoch,
                job.epoch,
            )
        return status

    # -- dispatchers (one thread per worker) ----------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                if not self._queue:
                    self._cv.wait(timeout=0.05)
                    continue
                job = self._queue.popleft()
                self._set_status(job.epoch, PROVING)
                obs_metrics.PROOF_QUEUE_DEPTH.set(len(self._queue))
            try:
                result = self.pool.prove(job)
            except ProverCrashed as exc:
                self._finish(job.epoch, FAILED, reason="prover-crashed")
                obs_metrics.PROOFS_FAILED.inc()
                TIMELINE.record(
                    job.epoch,
                    proof={"state": FAILED, "reason": "prover-crashed"},
                )
                # The recovered worker flight tail rides with the
                # crashed result: post-mortems survive the spawn
                # boundary.
                JOURNAL.record(
                    "anomaly",
                    what="proof-failed",
                    epoch=job.epoch,
                    error=repr(exc),
                    worker_flight_events=len(exc.flight_tail),
                    worker_flight_last=(
                        exc.flight_tail[-1] if exc.flight_tail else None
                    ),
                )
                log.error("epoch %d proof failed: %r", job.epoch, exc)
                continue
            except BaseException as exc:  # noqa: BLE001 - a job must not kill the loop
                self._finish(job.epoch, FAILED, reason="prove-error")
                obs_metrics.PROOFS_FAILED.inc()
                TIMELINE.record(
                    job.epoch, proof={"state": FAILED, "reason": "prove-error"}
                )
                JOURNAL.record(
                    "anomaly",
                    what="proof-failed",
                    epoch=job.epoch,
                    error=repr(exc),
                )
                log.error("epoch %d proof failed: %r", job.epoch, exc)
                continue
            self._land(job, result)

    def _land(self, job: ProofJob, result: ProofResult) -> None:
        if self._on_proved is not None:
            try:
                self._on_proved(result)
            except Exception:  # noqa: BLE001
                log.exception("epoch %d on_proved hook failed", job.epoch)
        # Deep attribution across the process boundary: the worker's
        # prove span tree lands under the epoch's stored trace root.
        TRACER.graft(job.epoch, result.spans)
        # Cross-process metric aggregation: a pooled worker's registry
        # snapshot rides back with the proof; the parent's own snapshot
        # (inline pools) is already the local scrape, so skip it.
        if result.metrics is not None and result.metrics.get("pid") != os.getpid():
            FLEET.ingest(
                result.metrics.get("source", f"prover-{result.metrics.get('pid')}"),
                result.metrics,
            )
            obs_metrics.WORKER_SNAPSHOT_MERGES.inc(pool="prover")
        obs_metrics.PROVE_SECONDS.observe(result.prove_seconds)
        obs_metrics.PROOFS_COMPLETED.inc()
        status = self._finish(
            job.epoch, PROVED, prove_seconds=result.prove_seconds
        )
        if status.lag_seconds is not None:
            obs_metrics.PROOF_LAG_SECONDS.observe(status.lag_seconds)
        # End-to-end lineage completion: this proof covers every
        # attestation bound to this epoch or an earlier (superseded)
        # one — their freshness clocks stop here.
        e2e = LINEAGE.epoch_proved(job.epoch)
        TIMELINE.record(
            job.epoch,
            proof={
                "state": PROVED,
                "landed_unix": round(time.time(), 3),
                "prove_seconds": round(result.prove_seconds, 4),
                "lag_seconds": round(status.lag_seconds or 0.0, 4),
            },
            freshness={
                "completed": len(e2e),
                "p99_seconds": round(_percentile(e2e, 0.99), 4) if e2e else None,
                "max_seconds": round(max(e2e), 4) if e2e else None,
            },
        )
        JOURNAL.record(
            "proof-landed",
            epoch=job.epoch,
            seconds=round(result.prove_seconds, 3),
            lag_seconds=round(status.lag_seconds or 0.0, 3),
            lineage_completed=len(e2e),
        )
        log.info(
            "epoch %d proved in %.2fs (%.2fs after submit)",
            job.epoch,
            result.prove_seconds,
            status.lag_seconds or 0.0,
        )

    # -- lifecycle store (all under _cv) --------------------------------

    def _set_status(self, epoch: int, state: str, **attrs) -> ProofStatus:
        """Caller holds ``_cv`` (or is pre-start single-threaded)."""
        status = self._status.get(epoch)
        if status is None:
            status = self._status[epoch] = ProofStatus(epoch=epoch, state=state)
            while len(self._status) > _STATUS_RING:
                del self._status[min(self._status)]
        status.state = state
        if "reason" in attrs:
            status.reason = attrs["reason"]
        if state == SUPERSEDED:
            status.reason = f"superseded-by-{attrs.get('by')}"
            status.lag_seconds = time.perf_counter() - status.submitted
        return status

    def _finish(
        self,
        epoch: int,
        state: str,
        *,
        reason: str | None = None,
        prove_seconds: float | None = None,
    ) -> ProofStatus:
        with self._cv:
            status = self._set_status(epoch, state)
            status.reason = reason
            status.prove_seconds = prove_seconds
            status.lag_seconds = time.perf_counter() - status.submitted
            if state == PROVED and (
                self._latest_proved is None or epoch > self._latest_proved
            ):
                self._latest_proved = epoch
            if state == PROVED:
                self.completed += 1
            elif state == FAILED:
                self.failed += 1
            self._pending -= 1
            self._update_lag_locked()
            self._cv.notify_all()
            return status

    def _update_lag_locked(self) -> None:
        """Proof lag in epochs: newest submitted minus newest proved —
        0 when proving keeps up, growing when the prover falls behind."""
        if self._latest_submitted is None:
            lag = 0
        elif self._latest_proved is None:
            lag = self._pending
        else:
            lag = max(self._latest_submitted - self._latest_proved, 0)
        obs_metrics.PROOF_LAG_EPOCHS.set(lag)

    # -- queries --------------------------------------------------------

    def status(self, epoch: int) -> ProofStatus | None:
        with self._cv:
            return self._status.get(epoch)

    def latest_epoch(self) -> int | None:
        """Newest epoch with any lifecycle entry."""
        with self._cv:
            return max(self._status) if self._status else None

    def stats(self) -> dict[str, Any]:
        """Per-instance snapshot (the bench's report source)."""
        with self._cv:
            return {
                "completed": self.completed,
                "failed": self.failed,
                "superseded": self.superseded,
                "pending": self._pending,
                "queue_depth": len(self._queue),
                "latest_submitted": self._latest_submitted,
                "latest_proved": self._latest_proved,
                "states": {
                    e: s.to_dict() for e, s in sorted(self._status.items())
                },
            }


__all__ = ["ProofStatus", "ProvingPlane", "ProvingPlaneConfig"]

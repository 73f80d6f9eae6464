"""Double-buffered epoch pipeline.

A sequential epoch tick serializes two very different resources: the
*host* (ingest drain, graph assembly, warm-start remap, plan delta) and
the *device* (convergence) plus the prover.  Steady-state traffic keeps
both busy less than half the time.  This module overlaps them: while
epoch k holds the device (converge → prove → checkpoint), the host
prepares epoch k+1 (``Manager.prepare_epoch`` — everything up to, but
excluding, the first device dispatch), handing the prepared state over
a bounded queue.

Backpressure is *coalescing*, not dropping: when the device stage falls
behind (a slow prover, a cold-compile epoch) and the queue is full, the
newest prepared epoch replaces the stale one still waiting — safe
because an epoch's prepared state is cumulative (the attestation cache
only advances, the dirty-sender set is cleared only after a successful
converge, and the warm-start seed always remaps from the last *landed*
epoch), so processing the newer epoch subsumes the superseded one.
Superseded ticks are counted on
``eigentrust_epoch_ticks_coalesced_total`` — degradation is graceful
and observable instead of silent.

Plan mutation (``WindowPlan.apply_delta``) stays on the host, before
the first kernel launch of the converge that uses the plan.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable

from ..obs import metrics as obs_metrics
from ..obs.journal import JOURNAL
from ..obs.timeline import TIMELINE
from ..trust.backend import ConvergenceResult
from .epoch import Epoch
from .manager import Manager, PreparedEpoch

log = logging.getLogger(__name__)

#: Epoch outcomes the pipeline retains for inspection (matches the
#: tracer's epoch-ring depth).
_RESULT_RING = 16


@dataclass
class EpochOutcome:
    """What the device stage produced for one epoch — the result, or
    the exception that ended it (the pipeline never dies with a tick)."""

    epoch: Epoch
    result: ConvergenceResult | Any | None
    error: BaseException | None = None


class EpochPipeline:
    """Bounded host/device epoch pipeline around a :class:`Manager`.

    One producer thread (the caller of :meth:`submit` — the node's
    epoch loop, or a benchmark) runs host stages; one internal
    worker thread runs device stages.  ``queue_depth`` bounds how many
    prepared epochs may wait between them (1 = classic double
    buffering: one epoch on the device, one staged behind it).

    ``device_stage`` defaults to ``Manager.converge_prepared`` with the
    pipeline's convergence parameters; the node passes a richer stage
    (prove → converge → checkpoint) without changing the queueing
    semantics.
    """

    def __init__(
        self,
        manager: Manager,
        *,
        alpha: float = 0.1,
        tol: float = 1e-6,
        max_iter: int = 50,
        queue_depth: int = 1,
        device_stage: Callable[[PreparedEpoch], Any] | None = None,
        on_complete: Callable[[EpochOutcome], None] | None = None,
    ):
        self.manager = manager
        self.alpha = alpha
        self.tol = tol
        self.max_iter = max_iter
        self._queue: queue.Queue[PreparedEpoch] = queue.Queue(
            maxsize=max(int(queue_depth), 1)
        )
        self._device_stage = device_stage or self._default_device_stage
        self._on_complete = on_complete
        self._cv = threading.Condition()
        self._pending = 0  # prepared epochs queued or on the device
        self._stop = threading.Event()
        self.outcomes: dict[int, EpochOutcome] = {}
        #: Ticks superseded under backpressure (mirrors the counter
        #: metric, but per-instance — benchmarks read this).
        self.coalesced = 0
        self.completed = 0
        #: Whether the worker thread has made the manager's card current.
        self._device_bound = False
        self._worker = threading.Thread(
            target=self._device_loop, name="epoch-pipeline-device", daemon=True
        )
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "EpochPipeline":
        # The started flip happens under the condition lock: submit
        # paths and close() race this from different roots, and a bare
        # check-then-act here double-starts the worker thread.
        with self._cv:
            if self._started:
                return self
            self._started = True
        self._worker.start()
        return self

    def close(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the device worker; with ``drain`` (default) only after
        every queued epoch has run."""
        with self._cv:
            started = self._started
        if drain and started:
            self.drain(timeout=timeout)
        self._stop.set()
        if started:
            self._worker.join(timeout=timeout)

    def __enter__(self) -> "EpochPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- host stage (producer thread) -----------------------------------

    def submit(self, epoch: Epoch) -> PreparedEpoch:
        """Run epoch's host stage on the calling thread and enqueue the
        prepared state for the device worker.  Never blocks on a busy
        device: a full queue coalesces (the stale waiting epoch is
        superseded by this one), so a slow prover stretches epoch
        latency instead of backing work up or dropping ticks."""
        self.start()  # idempotent under the condition lock
        prepared = self.manager.prepare_epoch(epoch)
        superseded: PreparedEpoch | None = None
        with self._cv:
            try:
                self._queue.put_nowait(prepared)
            except queue.Full:
                # Single producer: between this get and put nobody else
                # fills the slot (the worker only drains).
                try:
                    superseded = self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._queue.put_nowait(prepared)
            self._pending += 1 if superseded is None else 0
            if superseded is not None:
                self.coalesced += 1
            obs_metrics.PIPELINE_QUEUE_DEPTH.set(self._queue.qsize())
        if superseded is not None:
            obs_metrics.EPOCH_TICKS_COALESCED.inc()
            TIMELINE.record(
                superseded.epoch.number, coalesced_by=prepared.epoch.number
            )
            JOURNAL.record(
                "coalesced-tick",
                superseded=superseded.epoch.number,
                by=prepared.epoch.number,
            )
            log.warning(
                "epoch %s superseded by %s before reaching the device "
                "(pipeline backpressure)",
                superseded.epoch,
                prepared.epoch,
            )
        return prepared

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted epoch has completed (or the
        timeout passes); returns whether the pipeline is empty."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)

    # -- device stage (worker thread) -----------------------------------

    def _default_device_stage(self, prepared: PreparedEpoch):
        return self.manager.converge_prepared(
            prepared, alpha=self.alpha, tol=self.tol, max_iter=self.max_iter
        )

    def _bind_device(self) -> None:
        """Make the manager's card current on the worker thread before
        its first CUDA call (once).  Kernels launch on the thread's
        current stream, which is the card's default stream here as on
        the submitting thread, and the host stage uploads nothing: a
        converge's uploads, launches and read-back run in order on that
        one stream."""
        if self._device_bound:
            return
        device = getattr(self.manager, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.set_device(device)
        self._device_bound = True

    def _device_loop(self) -> None:
        while not self._stop.is_set():
            try:
                prepared = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            obs_metrics.PIPELINE_QUEUE_DEPTH.set(self._queue.qsize())
            try:
                self._bind_device()
                outcome = EpochOutcome(prepared.epoch, self._device_stage(prepared))
            except BaseException as exc:  # noqa: BLE001 - tick must not kill the loop
                log.error("epoch %s device stage failed: %r", prepared.epoch, exc)
                JOURNAL.record(
                    "anomaly",
                    what="epoch-device-stage-failed",
                    epoch=prepared.epoch.number,
                    error=repr(exc),
                )
                outcome = EpochOutcome(prepared.epoch, None, exc)
            with self._cv:
                self.outcomes[prepared.epoch.number] = outcome
                while len(self.outcomes) > _RESULT_RING:
                    del self.outcomes[min(self.outcomes)]
                self.completed += 1
                self._pending -= 1
                self._cv.notify_all()
            if self._on_complete is not None:
                try:
                    self._on_complete(outcome)
                except Exception:  # noqa: BLE001
                    log.exception("epoch %s on_complete hook failed", prepared.epoch)


__all__ = ["EpochOutcome", "EpochPipeline"]

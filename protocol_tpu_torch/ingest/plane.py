"""The admission pipeline: intake → admission → verify → apply.

The port of ``protocol_tpu/ingest/plane.py``: the same stages, queues,
verdicts and reason codes.

Four stages behind two bounded queues:

1. **intake** (:meth:`IngestPlane.submit`, any thread): O(1) —
   envelope the attestation, digest it, and ``put_nowait`` it on the
   submit queue.  A full queue **sheds**: the future resolves
   immediately with ``reason="queue-full"`` (a server maps it to HTTP
   429), the shed counter and journal record it, and the caller backs
   off.  Nothing upstream of this queue ever blocks.
2. **admission** (one thread): the cheap gates in cost order —
   structural checks, per-sender token bucket + spam score, sharded
   dedup/nonce cache — so replays and floods die for dict-lookup
   money, never reaching a signature check.  Survivors batch up
   (``batch_size`` or ``linger_s``, whichever first) onto the bounded
   batch queue; when the verify tier falls behind, the blocking put
   here backs pressure up into the submit queue, which sheds.
3. **verify** (one dispatcher thread per worker): blocking batch
   verdicts from the :class:`~protocol_tpu_torch.ingest.workers.VerifyPool`
   — crash-retried, and rejected with ``reason="verify-crashed"``
   when a batch outlives its retries.
4. **apply**: accepted attestations land in the Manager's cache via
   :meth:`~protocol_tpu_torch.node.manager.Manager.apply_verified` (a dict
   insert — the pk hash is already memoized for group members), and
   every verdict feeds the sender's spam history.

Every envelope resolves exactly once; ``drain`` makes that a testable
barrier.  Queue depths, shed counts, per-item admission latency, and
batch outcomes are all first-class metrics (``obs/metrics.py``), so
"the ingest tier is saturated" is a scrape, not a guess.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field as dc_field
from typing import TYPE_CHECKING

from ..crypto import group_pks_hash
from ..obs import TRACER
from ..obs import metrics as obs_metrics
from ..obs.journal import JOURNAL
from ..obs.lineage import LINEAGE
from .dedup import ShardedDedupCache
from .ratelimit import AdmissionPolicy, RateLimitConfig
from .workers import VerifyCrashed, VerifyPool

if TYPE_CHECKING:  # heavy import (torch via trust backends); runtime-lazy
    from ..node.attestation import Attestation
    from ..node.manager import Manager

#: The shed reason code — the reference's ``node/server.py`` answers 429
#: for it (the port's server is ROADMAP A5c (ii-b)).
SHED_REASON = "queue-full"


@dataclass(frozen=True)
class IngestPlaneConfig:
    #: Verify worker processes; 0 = verify inline on the dispatcher
    #: thread (no pool — the small-node default).
    workers: int = 0
    #: Signatures per verify batch (the native verifier's sweet spot
    #: is large batches; latency is bounded by ``linger_s``).
    batch_size: int = 64
    #: Max seconds a partial batch waits for more traffic.
    linger_s: float = 0.005
    #: Intake bound — beyond this, submissions shed with 429.
    submit_queue_max: int = 1024
    #: Admitted batches waiting for a dispatcher (the verify-stage
    #: bound; overflow backs up into the submit queue).
    batch_queue_max: int = 8
    dedup_shards: int = 16
    dedup_hashes_per_shard: int = 65536
    rate: RateLimitConfig = dc_field(default_factory=RateLimitConfig)
    #: Worker-crash retries per batch before ``verify-crashed``.
    max_batch_retries: int = 1


@dataclass
class _Envelope:
    att: "Attestation"
    sender: tuple[int, int]
    digest: bytes
    nonce: int | None
    enqueued: float
    future: Future
    #: Wire payload — the WAL record body (node/wal.py), kept so the
    #: apply stage never re-serializes what intake already had.
    raw: bytes = b""
    #: Lineage ID (obs/lineage.py) — 0 for the unsampled majority.
    lineage: int = 0


class IngestPlane:
    """The admission tier in front of one :class:`Manager`."""

    def __init__(self, manager: "Manager", config: IngestPlaneConfig | None = None):
        self.manager = manager
        self.config = config or IngestPlaneConfig()
        self.dedup = ShardedDedupCache(
            self.config.dedup_shards, self.config.dedup_hashes_per_shard
        )
        self.policy = AdmissionPolicy(self.config.rate)
        self.pool = VerifyPool(
            self.config.workers, max_retries=self.config.max_batch_retries
        )
        self._pks_hash = group_pks_hash(manager._group_pks)
        self._submit_queue: queue.Queue[_Envelope] = queue.Queue(
            maxsize=max(1, self.config.submit_queue_max)
        )
        self._batch_queue: queue.Queue[list[_Envelope]] = queue.Queue(
            maxsize=max(1, self.config.batch_queue_max)
        )
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._pending = 0  # enqueued envelopes not yet resolved
        #: Per-instance verdict tallies (the bench reads these; the
        #: process-global metrics aggregate across planes).
        self.accepted = 0
        self.shed = 0
        self.rejections: dict[str, int] = {}
        self._threads = [
            threading.Thread(
                target=self._admission_loop, name="ingest-admission", daemon=True
            )
        ] + [
            threading.Thread(
                target=self._dispatch_loop, name=f"ingest-verify-{i}", daemon=True
            )
            for i in range(max(1, self.config.workers))
        ]
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "IngestPlane":
        # Flip under the condition lock: the node's boot path and a
        # bench driver can race start(), and a bare check-then-act
        # would double-start the stage threads.
        with self._cv:
            if self._started:
                return self
            self._started = True
        # Materialize the backpressure surface in /metrics from
        # boot: gauges at zero, labeled counters at zero rows.
        obs_metrics.INGEST_QUEUE_DEPTH.set(0, stage="submit")
        obs_metrics.INGEST_QUEUE_DEPTH.set(0, stage="verify")
        obs_metrics.INGEST_SHED.inc(0, stage="submit")
        obs_metrics.INGEST_VERIFY_BATCHES.inc(0, outcome="ok")
        for t in self._threads:
            t.start()
        return self

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        with self._cv:
            started = self._started
        if drain and started:
            self.drain(timeout=timeout)
        self._stop.set()
        if started:
            for t in self._threads:
                t.join(timeout=5.0)
        self.pool.close()
        # Anything still unresolved (undrained close) must not leave a
        # caller waiting on a future forever.
        for q in (self._submit_queue, self._batch_queue):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                for env in item if isinstance(item, list) else [item]:
                    self._resolve(env, False, "shutdown")

    def __enter__(self) -> "IngestPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted envelope has a verdict."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)

    def advance_epoch(self) -> None:
        """Epoch-aligned dedup eviction — the node calls this once per
        epoch tick; digests age out after two epochs."""
        self.dedup.rotate_all()

    # -- stage 1: intake (any thread) -----------------------------------

    def submit(
        self,
        att: "Attestation",
        *,
        nonce: int | None = None,
        raw: bytes | None = None,
    ) -> Future:
        """Envelope + enqueue; never blocks.  Returns a future that
        resolves to the item's :class:`IngestResult`.  ``raw`` (the
        wire payload, when the caller already has it) feeds the dedup
        digest without re-serializing."""
        if raw is None:
            from ..node.attestation import AttestationData

            raw = AttestationData.from_attestation(att).to_bytes()
        env = _Envelope(
            att=att,
            sender=(att.pk.point.x, att.pk.point.y),
            digest=hashlib.sha256(raw).digest(),
            nonce=nonce,
            enqueued=time.perf_counter(),
            future=Future(),
            raw=raw,
            # Lineage sampling (obs/lineage.py): the unsampled path is
            # one counter tick; a sampled envelope carries its flat int
            # ID through every admission hop.
            lineage=LINEAGE.maybe_begin(),
        )
        with self._cv:
            self._pending += 1
        try:
            self._submit_queue.put_nowait(env)
            obs_metrics.INGEST_QUEUE_DEPTH.set(self._submit_queue.qsize(), stage="submit")
        except queue.Full:
            with self._cv:
                self.shed += 1
            obs_metrics.INGEST_SHED.inc(stage="submit")
            JOURNAL.record("ingest-shed", stage="submit")
            self._resolve(env, False, SHED_REASON)
        return env.future

    # -- stage 2: admission (one thread) --------------------------------

    def _admit(self, env: _Envelope) -> str | None:
        error = self.manager._structural_error(env.att)
        if error is not None:
            return error[0]
        reason = self.policy.check(env.sender)
        if reason is not None:
            return reason
        return self.dedup.admit(env.sender, env.digest, env.nonce)

    def _admission_loop(self) -> None:
        batch: list[_Envelope] = []
        while not self._stop.is_set():
            try:
                env = self._submit_queue.get(
                    timeout=self.config.linger_s if batch else 0.05
                )
            except queue.Empty:
                env = None
            if env is not None:
                obs_metrics.INGEST_QUEUE_DEPTH.set(
                    self._submit_queue.qsize(), stage="submit"
                )
                reason = self._admit(env)
                if reason is not None:
                    self._resolve(env, False, reason)
                else:
                    LINEAGE.mark(env.lineage, "admitted")
                    batch.append(env)
            if batch and (len(batch) >= self.config.batch_size or env is None):
                self._enqueue_batch(batch)
                batch = []
        if batch:
            self._enqueue_batch(batch)

    def _enqueue_batch(self, batch: list[_Envelope]) -> None:
        """Blocking put (in 50 ms slices so close() can interrupt) —
        THE backpressure coupling: a saturated verify tier parks the
        admission thread here, the submit queue fills, and intake
        starts shedding 429s instead of queueing without bound."""
        while not self._stop.is_set():
            try:
                self._batch_queue.put(batch, timeout=0.05)
                obs_metrics.INGEST_QUEUE_DEPTH.set(
                    self._batch_queue.qsize(), stage="verify"
                )
                return
            except queue.Full:
                continue
        for env in batch:
            self._resolve(env, False, "shutdown")

    # -- stages 3+4: verify + apply (one thread per worker) -------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._batch_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            obs_metrics.INGEST_QUEUE_DEPTH.set(
                self._batch_queue.qsize(), stage="verify"
            )
            items = [
                (
                    env.att.sig.big_r.x,
                    env.att.sig.big_r.y,
                    env.att.sig.s,
                    env.att.pk.point.x,
                    env.att.pk.point.y,
                    tuple(env.att.scores),
                )
                for env in batch
            ]
            t0 = time.perf_counter()
            try:
                with TRACER.span("ingest", batch=len(batch)):
                    verdicts = self.pool.verify(self._pks_hash, items)
            except VerifyCrashed as exc:
                # The recovered worker flight tail ships with the
                # crashed verdict: the post-mortem survives the
                # process boundary.
                JOURNAL.record(
                    "anomaly",
                    what="verify-batch-crashed",
                    batch=len(batch),
                    worker_flight_events=len(exc.flight_tail),
                    worker_flight_last=(
                        exc.flight_tail[-1] if exc.flight_tail else None
                    ),
                )
                for env in batch:
                    self._resolve(env, False, "verify-crashed")
                continue
            if len(verdicts) != len(batch):
                # A verifier that lost count is a crashed verifier:
                # zip-truncation would leave futures unresolved forever.
                for env in batch:
                    self._resolve(env, False, "verify-crashed")
                continue
            obs_metrics.SIG_VERIFY_SECONDS.observe(time.perf_counter() - t0)
            obs_metrics.SIGS_VERIFIED.inc(len(batch))
            obs_metrics.INGEST_VERIFY_BATCHES.inc(outcome="ok")
            # Apply with buffered WAL appends, then ONE fsync for the
            # whole batch (flush_wal) BEFORE any accept verdict
            # resolves: an acknowledged attestation is on disk, and the
            # fsync cost amortizes across the batch exactly like the
            # signature checks (node/wal.py durability contract).
            applied: list[_Envelope] = []
            for env, ok in zip(batch, verdicts):
                if ok:
                    LINEAGE.mark(env.lineage, "verified")
                    try:
                        self.manager.apply_verified(
                            env.att, raw=env.raw, flush=False
                        )
                    except OSError as exc:
                        JOURNAL.record(
                            "anomaly", what="wal-append-failed", error=repr(exc)
                        )
                        self._resolve(env, False, "wal-error")
                        continue
                    applied.append(env)
                else:
                    self._resolve(env, False, "bad-signature")
            if applied:
                try:
                    self.manager.flush_wal()
                except OSError as exc:
                    # The records may not have reached disk: the cache
                    # kept them (a retry overwrites harmlessly) but the
                    # verdict must not promise durability.
                    JOURNAL.record(
                        "anomaly", what="wal-flush-failed", error=repr(exc)
                    )
                    for env in applied:
                        self._resolve(env, False, "wal-error")
                else:
                    for env in applied:
                        LINEAGE.mark(env.lineage, "applied")
                        self._resolve(env, True, None)

    # -- verdicts -------------------------------------------------------

    def _resolve(self, env: _Envelope, accepted: bool, reason: str | None) -> None:
        from ..node.manager import IngestResult

        obs_metrics.INGEST_ADMISSION_SECONDS.observe(time.perf_counter() - env.enqueued)
        why = None if accepted else (reason or "unknown")
        if accepted:
            self.policy.record_outcome(env.sender, True)
        else:
            # A rejected attestation's lineage ends here: it will never
            # be in an epoch, so its entry must not wait for one.
            LINEAGE.drop(env.lineage, reason="rejected")
        if not accepted:
            obs_metrics.ATTESTATIONS_REJECTED.inc(reason=why)
            JOURNAL.record("ingest-reject", reason=why)
            # The policy already tallied its own verdicts; sheds are
            # the node's fault, not the sender's.
            if why not in ("rate-limited", "spam-score", SHED_REASON, "shutdown"):
                self.policy.record_outcome(env.sender, False)
        env.future.set_result(IngestResult(accepted, reason))
        # Verdict tallies are resolved from three roots (intake shed,
        # the admission thread, every dispatcher) — the condition lock
        # that already serializes _pending covers them too.
        with self._cv:
            if accepted:
                self.accepted += 1
            else:
                self.rejections[why] = self.rejections.get(why, 0) + 1
            self._pending -= 1
            self._cv.notify_all()

    def stats(self) -> dict:
        """Per-instance verdict snapshot (the bench's report source)."""
        with self._cv:
            return {
                "accepted": self.accepted,
                "shed": self.shed,
                "rejections": dict(self.rejections),
                "pending": self._pending,
            }


__all__ = ["IngestPlane", "IngestPlaneConfig", "SHED_REASON"]

"""Multi-process signature-verification workers.

The port of ``protocol_tpu/ingest/workers.py``.  In the node's process
signature checks share the GIL and the core budget with the epoch loop.
The pool here moves the expensive half of admission (Poseidon message
hashing + batch EdDSA) into spawned worker processes, each owning its
own native runtime (``crypto.native`` loads per process; the
initializer pins ``OMP_NUM_THREADS=1`` as the reference does, though
the port's runtime is built without OpenMP, so W workers are W cores
either way).

Work items are flat integer tuples — no protocol objects cross the
process boundary, so a worker's import footprint is just the port's
crypto tree: no torch, no jax, nothing of ``protocol_tpu`` — and every
batch result is per-item booleans in submit order.  Worker death is a
first-class outcome: the pool rebuilds the executor and the caller's
in-flight batch is retried up to ``max_retries`` times, after which
:class:`VerifyCrashed` carries the batch out to be *rejected with a
reason code*, never silently dropped.  The workers are spawned, never
forked, so a parent that holds a CUDA context passes none on.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor
from multiprocessing import get_context

from ..obs import metrics as obs_metrics
from ..obs.journal import (
    JOURNAL,
    collect_worker_dumps,
    install_worker_dump_handler,
)

#: Chaos hook for crash-recovery tests and the ingest-storm bench's
#: worker-crash mix: a work item equal to this string hard-kills the
#: worker mid-batch (``os._exit``), exactly like an OOM kill would.
CRASH_MARKER = "__crash-worker__"

#: (sig.R.x, sig.R.y, sig.s, pk.x, pk.y, scores tuple) — everything the
#: worker needs to bind and verify one attestation signature.
WorkItem = tuple[int, int, int, int, int, tuple[int, ...]]


def _worker_init(dump_dir: str | None = None) -> None:
    """Runs in each spawned worker before any batch: pin the native
    runtime to one OpenMP thread so the pool scales by process,
    pre-load the crypto tree off the critical path, and install the
    flight-recorder dump handler so a SIGTERM'd worker leaves its
    event ring behind for the parent's post-mortem."""
    os.environ["OMP_NUM_THREADS"] = "1"
    install_worker_dump_handler(dump_dir, pool="ingest-verify")
    from ..crypto import native as cnative

    cnative.available()


def verify_batch(pks_hash: int, items: list) -> list[bool]:
    """Hash + verify one batch (runs inside a worker, or inline for
    ``workers=0``): batched Poseidon message hashes for the shared
    ``pks_hash``, then one native batch-EdDSA call (pure-Python
    fallback when the runtime is unavailable)."""
    from ..crypto import message_hash_batch
    from ..crypto import native as cnative
    from ..crypto.babyjubjub import Point
    from ..crypto.eddsa import PublicKey, Signature, verify as verify_sig

    for item in items:
        if item == CRASH_MARKER:
            os._exit(1)
    msgs = message_hash_batch(pks_hash, [list(it[5]) for it in items])
    if cnative.available():
        ok = cnative.eddsa_verify_batch(
            [it[0] for it in items],
            [it[1] for it in items],
            [it[2] for it in items],
            [it[3] for it in items],
            [it[4] for it in items],
            msgs,
        )
        return [bool(x) for x in ok]
    return [
        verify_sig(
            Signature.new(it[0], it[1], it[2]), PublicKey(Point(it[3], it[4])), m
        )
        for it, m in zip(items, msgs)
    ]


def verify_batch_shipping(pks_hash: int, items: list) -> tuple[list, dict]:
    """Worker-process entry: verify the batch AND ship this process's
    registry snapshot back with the verdicts — the cross-process
    metric-aggregation hop.  The worker records its own sig-verify
    metrics (its registry is process-private), journals the batch into
    its flight ring, and the parent folds the snapshot into the fleet
    aggregator under a ``process`` label."""
    from ..obs.fleet import registry_snapshot

    t0 = time.perf_counter()
    verdicts = verify_batch(pks_hash, items)
    obs_metrics.SIG_VERIFY_SECONDS.observe(time.perf_counter() - t0)
    obs_metrics.SIGS_VERIFIED.inc(len(verdicts))
    JOURNAL.record("verify-batch", n=len(verdicts), ok=sum(map(bool, verdicts)))
    return verdicts, registry_snapshot(source=f"ingest-verify-{os.getpid()}")


class VerifyCrashed(RuntimeError):
    """A batch's worker died ``max_retries + 1`` times; the caller must
    reject the batch's items with a distinct reason code.
    ``flight_tail`` carries whatever per-worker flight-recorder dumps
    the pool recovered from the crash (SIGTERM'd workers dump their
    ring; hard-killed ones leave nothing)."""

    def __init__(self, *args: object) -> None:
        super().__init__(*args)
        self.flight_tail: list = []


class VerifyPool:
    """Process pool façade with crash recovery.

    ``workers=0`` verifies inline on the calling thread (no processes —
    the single-node default); ``workers>0``
    spawns that many verifier processes.  :meth:`verify` blocks until
    the batch's verdicts are in, so the plane runs one dispatcher
    thread per worker to keep all processes fed.
    """

    def __init__(self, workers: int = 0, *, max_retries: int = 1):
        self.workers = int(workers)
        self.max_retries = int(max_retries)
        self._lock = threading.Lock()
        self._generation = 0
        self._executor: ProcessPoolExecutor | None = None
        #: Flight-recorder tails recovered from crashed workers' dump
        #: files, attached to the next VerifyCrashed (under _lock).
        self._flight_tail: list = []
        self._dump_dir: str | None = (
            tempfile.mkdtemp(prefix="ingest_verify_flight_")
            if self.workers > 0
            else None
        )
        if self.workers > 0:
            self._executor = self._make()

    def _make(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.workers,
            mp_context=get_context("spawn"),
            initializer=_worker_init,
            initargs=(self._dump_dir,),
        )

    def _snapshot(self) -> tuple[int, ProcessPoolExecutor | None]:
        with self._lock:
            return self._generation, self._executor

    def _restart(self, generation: int) -> None:
        """Rebuild the executor once per crash: concurrent batches that
        all observed the same broken generation race here, and only the
        first replaces it.  Any flight-recorder dumps the dead workers
        left behind are journaled and kept for the next
        :class:`VerifyCrashed` so the post-mortem survives the process
        boundary."""
        with self._lock:
            if self._generation != generation or self._executor is None:
                return
            old = self._executor
            self._executor = self._make()
            self._generation += 1
        old.shutdown(wait=False, cancel_futures=True)
        tails = collect_worker_dumps(self._dump_dir, pool="ingest-verify")
        if tails:
            with self._lock:
                self._flight_tail.extend(tails)
        obs_metrics.INGEST_WORKER_RESTARTS.inc()
        JOURNAL.record("anomaly", what="ingest-worker-crashed", generation=generation)

    def take_flight_tail(self) -> list:
        """Pop the recovered worker flight-recorder events (attached to
        crashed results by :meth:`verify`)."""
        with self._lock:
            tail, self._flight_tail = self._flight_tail, []
        return tail

    def verify(self, pks_hash: int, items: list) -> list[bool]:
        """Blocking batch verdict with crash retry; raises
        :class:`VerifyCrashed` when the batch outlives its retries."""
        from ..obs.fleet import FLEET

        attempts = 0
        while True:
            generation, executor = self._snapshot()
            try:
                if executor is None:
                    return verify_batch(pks_hash, items)
                verdicts, snap = executor.submit(
                    verify_batch_shipping, pks_hash, items
                ).result()
                # The worker's registry rides back with the verdicts;
                # latest-snapshot-per-source, so cumulative counters
                # never double-count.
                FLEET.ingest(snap.get("source", "ingest-verify"), snap)
                obs_metrics.WORKER_SNAPSHOT_MERGES.inc(pool="ingest-verify")
                return verdicts
            except (BrokenExecutor, RuntimeError) as exc:
                # RuntimeError covers submit() on a shutdown executor
                # racing close(); treat it like a crash for retry
                # accounting so items are never silently dropped.
                self._restart(generation)
                attempts += 1
                if attempts > self.max_retries:
                    obs_metrics.INGEST_VERIFY_BATCHES.inc(outcome="failed")
                    crashed = VerifyCrashed(
                        f"verify batch of {len(items)} died {attempts} time(s)"
                    )
                    crashed.flight_tail = self.take_flight_tail()
                    raise crashed from exc
                obs_metrics.INGEST_VERIFY_BATCHES.inc(outcome="retried")

    def close(self) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)


__all__ = [
    "CRASH_MARKER",
    "VerifyCrashed",
    "VerifyPool",
    "WorkItem",
    "verify_batch",
    "verify_batch_shipping",
]

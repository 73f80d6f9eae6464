"""The spawn-based prover worker pool.

The port of ``protocol_tpu/prover/workers.py``.  Proving burns a whole
core for seconds at a time, and in-process it competes with the epoch
loop and the ingest dispatchers for the GIL and the core budget.  The
pool here is the ingest verify-pool topology applied to proving:
spawned worker processes (flat
:class:`~protocol_tpu_torch.prover.jobs.ProofJob` payloads, so a child
imports only the port's zk/crypto tree), and crash recovery as a
first-class outcome — a dead or hung worker rebuilds the executor once
per generation and the in-flight job is retried up to ``max_retries``
times before :class:`ProverCrashed` carries it out to be *failed with a
reason code*, never silently dropped.  Workers are spawned, never
forked, so each one opens its own CUDA context when a graft job first
touches the card; a kernel error that kills a worker comes back as a
crash.

Each worker process caches its prover (SRS + proving key) across jobs —
:func:`~protocol_tpu_torch.prover.jobs.prover_for` — and
:meth:`ProverPool.prewarm` builds that cache at pool start, so
steady-state jobs pay zero setup.  Under ``zk_backend="graft"`` the
prewarm also builds the SRS's point cache on the worker's device (its
CUDA context, the kernel libraries' loads and K10's two launches), so
the first job pays for neither.

``omp_threads`` is kept for parity with the reference: the port's zk
runtime is built without OpenMP, so the knob changes neither the bits
nor the speed.
"""

from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor, TimeoutError
from multiprocessing import get_context

from ..obs import metrics as obs_metrics
from ..obs.journal import (
    JOURNAL,
    collect_worker_dumps,
    install_worker_dump_handler,
)
from .jobs import ProofJob, ProofResult, prove_job, prover_for


def _worker_init(omp_threads: int, dump_dir: str | None = None) -> None:
    """Runs in each spawned worker before any job: pin (or free) the
    native runtime's OpenMP width, install the flight-recorder dump
    handler (a SIGTERM'd — e.g. hung-and-terminated — worker leaves
    its event ring behind for the parent's post-mortem), and pre-load
    the zk runtime off the first job's critical path."""
    if omp_threads > 0:
        os.environ["OMP_NUM_THREADS"] = str(omp_threads)
    install_worker_dump_handler(dump_dir, pool="prover")
    from ..zk import native as zk_native

    zk_native.available()


def _worker_prewarm(
    params: tuple[int, int, int, int],
    prover: str,
    srs_path: str | None,
    zk_backend: str = "native",
    zk_device: str | None = None,
) -> bool:
    """Build this worker's prover cache (SRS load + keygen/cached-pk
    load) ahead of the first real job; under ``graft`` also the SRS's
    point cache on ``zk_device`` (``None``: the card)."""
    inst = prover_for(params, prover, srs_path)
    if zk_backend == "graft" and prover == "plonk":
        from ..zk.graft import use_zk_backend

        with use_zk_backend(zk_backend, zk_device):
            inst.vk.srs._graft_cache()
    return True


def _worker_prove(job: ProofJob, verify: bool) -> ProofResult:
    return prove_job(job, verify=verify)


class ProverCrashed(RuntimeError):
    """A job's worker died (or timed out) ``max_retries + 1`` times;
    the plane must fail the job with ``reason="prover-crashed"``.
    ``flight_tail`` carries whatever per-worker flight-recorder dumps
    the pool recovered (a terminated hung worker dumps its ring on
    SIGTERM; a hard-killed one leaves nothing)."""

    def __init__(self, *args: object) -> None:
        super().__init__(*args)
        self.flight_tail: list = []


class ProverPool:
    """Process-pool façade with crash recovery and per-job timeout.

    ``workers=0`` proves inline on the calling thread (no processes —
    the small-node and unit-test default); ``workers>0`` spawns that
    many prover processes.  :meth:`prove` blocks until the job's proof
    is in, so the plane runs one dispatcher thread per worker.

    ``timeout_s`` bounds one attempt: a worker that exceeds it is
    treated exactly like a crashed worker (generation-guarded executor
    rebuild, best-effort terminate of the old processes, retry) — a
    wedged prover must never wedge the plane.
    """

    def __init__(
        self,
        workers: int = 0,
        *,
        max_retries: int = 1,
        timeout_s: float | None = None,
        omp_threads: int = 0,
        verify: bool = True,
    ):
        self.workers = int(workers)
        self.max_retries = int(max_retries)
        self.timeout_s = timeout_s
        self.omp_threads = int(omp_threads)
        self.verify = bool(verify)
        self._lock = threading.Lock()
        self._generation = 0
        self._executor: ProcessPoolExecutor | None = None
        #: Flight-recorder tails recovered from crashed workers' dump
        #: files, attached to the next ProverCrashed (under _lock).
        self._flight_tail: list = []
        self._dump_dir: str | None = (
            tempfile.mkdtemp(prefix="prover_flight_") if self.workers > 0 else None
        )
        if self.workers > 0:
            self._executor = self._make()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def _make(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.workers,
            mp_context=get_context("spawn"),
            initializer=_worker_init,
            initargs=(self.omp_threads, self._dump_dir),
        )

    def _snapshot(self) -> tuple[int, ProcessPoolExecutor | None]:
        with self._lock:
            return self._generation, self._executor

    def _restart(self, generation: int) -> None:
        """Rebuild the executor once per crash generation: concurrent
        jobs that observed the same broken generation race here, and
        only the first replaces it."""
        with self._lock:
            if self._generation != generation or self._executor is None:
                return
            old = self._executor
            self._executor = self._make()
            self._generation += 1
        # A hung worker survives shutdown(cancel_futures=True); kill it
        # so a timeout doesn't leak a core-burning orphan.  SIGTERM
        # also triggers the worker's flight-dump handler, so "what was
        # the hung prover doing" survives into the dump dir.
        procs = list(getattr(old, "_processes", {}).values())
        for proc in procs:
            try:
                proc.terminate()
            except (OSError, ValueError):
                pass
        for proc in procs:
            try:
                proc.join(timeout=2.0)
            except (OSError, ValueError, AssertionError):
                pass
        old.shutdown(wait=False, cancel_futures=True)
        tails = collect_worker_dumps(self._dump_dir, pool="prover")
        if tails:
            with self._lock:
                self._flight_tail.extend(tails)
        obs_metrics.PROVER_WORKER_RESTARTS.inc()
        JOURNAL.record("anomaly", what="prover-worker-crashed", generation=generation)

    def take_flight_tail(self) -> list:
        """Pop the recovered worker flight-recorder events (attached to
        crashed jobs by :meth:`prove`)."""
        with self._lock:
            tail, self._flight_tail = self._flight_tail, []
        return tail

    def prewarm(
        self,
        params,
        prover: str = "plonk",
        srs_path: str | None = None,
        *,
        zk_backend: str = "native",
        zk_device: str | None = None,
    ):
        """Build every worker's prover cache now (SRS + proving key),
        so the first real job pays no setup; under ``graft`` also the
        point cache on ``zk_device``.  Inline pools warm the calling
        process's cache instead.  Best-effort: a crash during prewarm
        surfaces on the first real job's retry path."""
        params = tuple(int(p) for p in params)
        _, executor = self._snapshot()
        if executor is None:
            _worker_prewarm(params, prover, srs_path, zk_backend, zk_device)
            return
        futures = [
            executor.submit(
                _worker_prewarm, params, prover, srs_path, zk_backend, zk_device
            )
            for _ in range(self.workers)
        ]
        for f in futures:
            try:
                f.result(timeout=self.timeout_s)
            except (BrokenExecutor, TimeoutError, RuntimeError, OSError):
                break

    def prove(self, job: ProofJob) -> ProofResult:
        """Blocking prove with crash/timeout retry; raises
        :class:`ProverCrashed` when the job outlives its retries."""
        attempts = 0
        while True:
            generation, executor = self._snapshot()
            try:
                if executor is None:
                    return prove_job(job, verify=self.verify)
                future = executor.submit(_worker_prove, job, self.verify)
                return future.result(timeout=self.timeout_s)
            except (BrokenExecutor, TimeoutError, RuntimeError) as exc:
                # RuntimeError covers submit() on a shutdown executor
                # racing close(); TimeoutError is a wedged worker.
                # Both rebuild and retry so jobs are never silently
                # dropped.
                self._restart(generation)
                attempts += 1
                if attempts > self.max_retries:
                    crashed = ProverCrashed(
                        f"epoch {job.epoch} proof attempt died "
                        f"{attempts} time(s): {exc!r}"
                    )
                    crashed.flight_tail = self.take_flight_tail()
                    raise crashed from exc
                JOURNAL.record(
                    "anomaly",
                    what="prove-retried",
                    epoch=job.epoch,
                    attempt=attempts,
                )

    def close(self) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)


__all__ = ["ProverCrashed", "ProverPool"]

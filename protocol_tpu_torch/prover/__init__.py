"""The asynchronous proving plane: the epoch tick enqueues, workers prove.

The port of ``protocol_tpu/prover/``.  A prove takes seconds; a card
converge takes milliseconds, so a tick that proves inline holds the
converge behind the SNARK.  This package takes the SNARK off the epoch
critical path: the tick ends at ``converge → checkpoint`` and
*enqueues* a proving job; a spawn-based worker pool proves it
concurrently, and a slow prover shows up as bounded, observable *proof
lag* instead of epoch latency.

- :mod:`~protocol_tpu_torch.prover.jobs` — the flat, picklable
  :class:`ProofJob` payload (ints and tuples only, so workers import
  just the port's zk/crypto tree), deterministic blinding seeds (pooled
  and in-process proofs are bit-identical, and equal the reference's),
  and :func:`prove_job`, the shared prove entry that returns the proof
  together with its serialized span tree;
- :mod:`~protocol_tpu_torch.prover.workers` — the ingest-style spawn
  pool: per-worker SRS/proving-key cache with pool-start prewarm (under
  ``graft`` also the SRS's point cache on the worker's device), per-job
  timeout, generation-guarded executor rebuild on crash, bounded
  retries — a dead prover fails a job with a reason code, never
  silently;
- :mod:`~protocol_tpu_torch.prover.plane` — the lifecycle
  (``queued → proving → proved | failed | superseded``) behind a
  bounded queue with latest-wins coalescing (the EpochPipeline's
  supersede semantics), dispatcher threads, proof-lag/queue-depth/
  prove-seconds metrics, and the span graft back into the epoch's
  stored trace.

Under ``zk_backend="graft"`` the worker launches the card kernels
K10–K13 in its own CUDA context; the job names the device
(``ProofJob.zk_device``).
"""

from .jobs import (
    CRASH_MARKER,
    FAILED,
    PROVED,
    PROVING,
    QUEUED,
    SUPERSEDED,
    ProofJob,
    ProofResult,
    crash_once_marker,
    job_seed,
    prove_job,
)
from .plane import ProofStatus, ProvingPlane, ProvingPlaneConfig
from .workers import ProverCrashed, ProverPool

__all__ = [
    "CRASH_MARKER",
    "FAILED",
    "PROVED",
    "PROVING",
    "QUEUED",
    "SUPERSEDED",
    "ProofJob",
    "ProofResult",
    "ProofStatus",
    "ProverCrashed",
    "ProverPool",
    "ProvingPlane",
    "ProvingPlaneConfig",
    "crash_once_marker",
    "job_seed",
    "prove_job",
]

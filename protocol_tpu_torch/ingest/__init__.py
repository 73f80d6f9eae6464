"""The admission plane: an ingest tier in front of the Manager.

The port of ``protocol_tpu/ingest/``.  Batch-EdDSA verification shares
cores and the GIL with the epoch loop when it runs in the node's
process, so admission moves off the epoch loop and in front of
``Manager.add_attestations_bulk``:

- :mod:`~protocol_tpu_torch.ingest.dedup` — a sharded dedup/nonce cache
  (per-sender monotonic nonces + recent-message-hash generations,
  bounded memory, epoch-aligned eviction) that rejects replays
  *before* paying for a signature check;
- :mod:`~protocol_tpu_torch.ingest.ratelimit` — per-sender token
  buckets plus a burst/rejection-history spam score, with a
  pre-trust-set whitelist bypass;
- :mod:`~protocol_tpu_torch.ingest.workers` — the multi-process
  signature-verification pool: spawned workers each owning the native
  batch-EdDSA verifier (``crypto/native.py``) and the batched Poseidon
  message hash, fed fixed-size batches, respawned on crash with
  in-flight batches retried or rejected — never silently dropped;
- :mod:`~protocol_tpu_torch.ingest.plane` — the pipeline tying them
  together behind bounded queues (intake → admission → verify →
  manager apply) with backpressure as first-class state: queue-depth
  gauges, shed counters, journal events, and a 429-style shed verdict.

Every rejection flows through the
:class:`~protocol_tpu_torch.node.manager.IngestResult` reason plumbing
and the ``eigentrust_attestations_rejected_total`` reason labels, so the
admission tier widens the front door without forking the ingest
accounting.  Verdicts and reasons are the reference's.  The epoch loop
itself must never verify signatures or block on an unbounded queue.
Nothing here touches the card.
"""

from .dedup import ShardedDedupCache
from .plane import SHED_REASON, IngestPlane, IngestPlaneConfig
from .ratelimit import AdmissionPolicy, RateLimitConfig
from .workers import VerifyPool

__all__ = [
    "AdmissionPolicy",
    "IngestPlane",
    "IngestPlaneConfig",
    "RateLimitConfig",
    "SHED_REASON",
    "ShardedDedupCache",
    "VerifyPool",
]

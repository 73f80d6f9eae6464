"""Node configuration (server/src/main.rs:39-45, data/protocol-config.json).

The port of ``protocol_tpu/node/config.py``: the same JSON shape, fields
and defaults, so existing config files load unchanged.  ``trust_backend``
names a rung of the port's ladder, and one field is the port's own:
``device``, the card the node's converges run on."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class ProtocolConfig:
    epoch_interval: int = 10
    endpoint: tuple[tuple[int, int, int, int], int] = ((0, 0, 0, 0), 3000)
    ethereum_node_url: str = "http://localhost:8545"
    as_contract_address: str = "0x" + "0" * 40
    # Rebuild-specific (absent from reference configs; defaulted).
    # Any rung of the port's trust/backend.py ladder: native-cpu |
    # cuda-dense | cuda-sparse | cuda-csr | cuda-windowed |
    # cuda-sharded[:cuda-csr|:cuda-windowed].  A name of the reference's
    # ladder (tpu-*) is not mapped: building the node raises
    # get_backend's ValueError.  The windowed backends additionally
    # persist their bucketing plan with each checkpoint.  The default
    # is the port's own: a card rung, so a config that names no
    # backend converges on the card (the reference's is native-cpu);
    # native-cpu runs on the host only where a config names it.
    trust_backend: str = "cuda-windowed"
    #: The port's own field: the device the card backends (and a graft
    #: prove) run on, passed to ``ManagerConfig.device``.  None means
    #: the card, and building the node raises where there is none;
    #: "cpu" runs the kernels' plain versions (how tests drive a node).
    device: str | None = None
    event_fixture: str | None = None
    checkpoint_dir: str | None = None
    #: Write-ahead attestation log (node/wal.py): every accepted
    #: attestation is fsync'd to a size-rotated segment log before its
    #: ingest verdict returns, and boot recovery replays the tail past
    #: the newest valid checkpoint — ``kill -9`` at any instruction
    #: loses nothing acknowledged.  Requires ``checkpoint_dir`` (the
    #: log lives beside the snapshots); ``false`` restores the
    #: checkpoint-only (lossy between snapshots) behavior.
    wal: bool = True
    #: WAL directory override; default ``<checkpoint_dir>/wal``.
    wal_dir: str | None = None
    #: Segment rotation threshold — with per-checkpoint truncation this
    #: bounds WAL disk to roughly one epoch of traffic per retained
    #: snapshot.
    wal_segment_bytes: int = 4 << 20
    #: fsync on every durability boundary (per verdict / per verify
    #: batch).  Disable only for tests and benchmarks.
    wal_fsync: bool = True
    #: Fault-injection schedule (protocol_tpu_torch/chaos/): a spec
    #: dict, an ``@path`` reference, or None (disabled — the hot-path
    #: cost of disabled chaos is one module-attribute read).  The
    #: chaos environment variable takes precedence; only chaos tooling
    #: and tests should ever set either.
    chaos: dict | str | None = None
    #: Double-buffered epoch pipeline (node/pipeline.py): overlap the
    #: next epoch's host stages (ingest drain, graph build, plan delta)
    #: with the current epoch's device converge + proving, behind a
    #: bounded queue with coalescing backpressure.  Off by default —
    #: the sequential tick is easier to reason about on small nodes.
    epoch_pipeline: bool = False
    #: Seed each epoch's convergence from the previous fixed point
    #: (ManagerConfig.warm_start).
    warm_start: bool = True
    #: Dirty-row fraction above which the windowed plan cache rebuilds
    #: instead of delta-updating (ManagerConfig.plan_delta_max_churn).
    plan_delta_max_churn: float = 0.05
    #: Admission plane (protocol_tpu_torch/ingest/): bounded-queue intake +
    #: sharded dedup/nonce cache + per-sender rate limits in front of
    #: the Manager, serving POST /attestation with 429 shed semantics.
    #: On by default; ``false`` restores direct Manager ingest.
    ingest_plane: bool = True
    #: Verify worker processes (0 = verify inline, no pool): each
    #: spawned worker owns a native batch-EdDSA verifier pinned to one
    #: OMP thread, so admission scales across cores and off the epoch
    #: loop's GIL.
    ingest_workers: int = 0
    #: Signatures per verify batch.
    ingest_batch_size: int = 64
    #: Submit-queue bound; beyond it, POST /attestation sheds with 429.
    ingest_queue_max: int = 1024
    #: Per-sender token-bucket refill (attestations/second) and burst
    #: capacity for non-whitelisted senders.
    ingest_rate_rps: float = 50.0
    ingest_rate_burst: float = 200.0
    #: Exempt the pre-trust set from rate/spam gates (dedup still
    #: applies to everyone).
    ingest_whitelist_pretrusted: bool = True
    #: "plonk" (real KZG SNARK per epoch, the reference's behavior) or
    #: "commitment" (fast Poseidon binding).
    prover: str = "plonk"
    #: Async proving plane (protocol_tpu_torch/prover/): the epoch tick ends
    #: at converge → checkpoint and *enqueues* the SNARK onto a bounded
    #: queue drained by a prover worker pool — a slow prover becomes
    #: proof lag (eigentrust_proof_lag_epochs, GET /proof/<epoch>),
    #: never epoch latency.  Off by default: the sequential tick keeps
    #: the reference's proof-per-tick semantics on small nodes.
    async_prover: bool = False
    #: Prover worker processes (0 = prove inline on the plane's
    #: dispatcher thread — still off the epoch tick, but sharing the
    #: node process's GIL).  Each worker caches its SRS + proving key
    #: across jobs and is prewarmed at boot.
    prover_workers: int = 1
    #: Proof jobs that may wait for a dispatcher; beyond it the oldest
    #: queued job is superseded (latest-wins — an epoch tick never
    #: blocks on the proof queue).
    prover_queue_max: int = 1
    #: Per-attempt prove timeout (seconds); a worker past it is killed
    #: and the job retried, then failed with reason=prover-crashed.
    prove_timeout_s: float = 900.0
    #: OMP_NUM_THREADS for each prover worker's native MSM/NTT loops
    #: (0 = runtime default).
    prover_omp_threads: int = 0
    #: Ceremony SRS file for the PLONK prover (kzg.Setup format).
    srs_path: str | None = None
    #: Opt-in torch.profiler capture: device-timeline traces of each
    #: epoch's convergence land under ``<profile_dir>/epoch_<N>``
    #: (view with TensorBoard).  None disables profiling — the
    #: default; span/metric telemetry is always on and costs no device
    #: sync either way.
    profile_dir: str | None = None
    #: On-disk flight-recorder journal (obs/journal.py): a bounded
    #: JSONL file every span close, ingest rejection, plan outcome,
    #: coalesced tick, and anomaly is appended to by a batched writer
    #: thread.  None keeps the recorder in-memory-only (the ring and
    #: ``GET /debug/flight`` work either way); on crash/SIGTERM the
    #: node dumps the ring next to this path (or to
    #: ``FLIGHT_dump.jsonl`` in the working directory).
    journal_path: str | None = None
    #: Attestation lineage sampling period (obs/lineage.py): one in N
    #: accepted submissions carries a lineage ID through
    #: intake → ... → proof-landed, feeding the per-stage
    #: eigentrust_freshness_seconds histograms.  0 disables sampling;
    #: the unsampled path costs one counter tick either way.
    lineage_sample_every: int = 32
    #: Shared directory for multi-process (torch.distributed) metric
    #: exchange: each process publishes its registry snapshot here and
    #: GET /metrics/fleet merges every sibling into one
    #: process-labeled exposition.  None = single-process fleet (spawn
    #: workers still merge through their result payloads).
    fleet_dir: str | None = None
    #: SLO targets (obs/slo.py): end-to-end freshness p99 and
    #: submit-to-proved p99, in seconds.  The epoch-cadence objective
    #: derives from epoch_interval; a violating objective flips
    #: GET /slo to ok=false and fails the CI dryrun.
    slo_freshness_p99_s: float = 120.0
    slo_proof_lag_p99_s: float = 60.0
    #: Fleet snapshot staleness TTL (obs/fleet.py): a sibling whose
    #: newest fleet_dir snapshot is older than this is evicted from
    #: the merged scrape, counted on eigentrust_fleet_stale_sources,
    #: and degrades /healthz — a silently dead pod host surfaces here
    #: before a collective hangs on it.  0 disables the TTL.
    fleet_stale_after_s: float = 30.0
    #: Pod straggler watcher (obs/watchers.py StragglerWatcher): flag a
    #: host whose phase time exceeds the pod median by this ratio for
    #: this many consecutive stitched epochs.
    straggler_ratio: float = 1.5
    straggler_epochs: int = 3
    #: Pod phase-skew SLO target (obs/slo.py pod_objectives): p99 of
    #: max-median host duration per epoch phase, seconds.
    slo_pod_skew_p99_s: float = 1.0

    @property
    def host(self) -> str:
        return ".".join(str(x) for x in self.endpoint[0])

    @property
    def port(self) -> int:
        return self.endpoint[1]

    @classmethod
    def from_json(cls, text: str) -> "ProtocolConfig":
        obj = json.loads(text)
        cfg = cls()
        cfg.epoch_interval = int(obj.get("epoch_interval", cfg.epoch_interval))
        if "endpoint" in obj:
            octets, port = obj["endpoint"]
            cfg.endpoint = (tuple(int(x) for x in octets), int(port))
        cfg.ethereum_node_url = obj.get("ethereum_node_url", cfg.ethereum_node_url)
        cfg.as_contract_address = obj.get("as_contract_address", cfg.as_contract_address)
        cfg.trust_backend = obj.get("trust_backend", cfg.trust_backend)
        cfg.device = obj.get("device", cfg.device)
        cfg.event_fixture = obj.get("event_fixture", cfg.event_fixture)
        cfg.checkpoint_dir = obj.get("checkpoint_dir", cfg.checkpoint_dir)
        cfg.wal = bool(obj.get("wal", cfg.wal))
        cfg.wal_dir = obj.get("wal_dir", cfg.wal_dir)
        cfg.wal_segment_bytes = int(
            obj.get("wal_segment_bytes", cfg.wal_segment_bytes)
        )
        cfg.wal_fsync = bool(obj.get("wal_fsync", cfg.wal_fsync))
        cfg.chaos = obj.get("chaos", cfg.chaos)
        cfg.epoch_pipeline = bool(obj.get("epoch_pipeline", cfg.epoch_pipeline))
        cfg.warm_start = bool(obj.get("warm_start", cfg.warm_start))
        cfg.plan_delta_max_churn = float(
            obj.get("plan_delta_max_churn", cfg.plan_delta_max_churn)
        )
        cfg.ingest_plane = bool(obj.get("ingest_plane", cfg.ingest_plane))
        cfg.ingest_workers = int(obj.get("ingest_workers", cfg.ingest_workers))
        cfg.ingest_batch_size = int(
            obj.get("ingest_batch_size", cfg.ingest_batch_size)
        )
        cfg.ingest_queue_max = int(obj.get("ingest_queue_max", cfg.ingest_queue_max))
        cfg.ingest_rate_rps = float(obj.get("ingest_rate_rps", cfg.ingest_rate_rps))
        cfg.ingest_rate_burst = float(
            obj.get("ingest_rate_burst", cfg.ingest_rate_burst)
        )
        cfg.ingest_whitelist_pretrusted = bool(
            obj.get("ingest_whitelist_pretrusted", cfg.ingest_whitelist_pretrusted)
        )
        cfg.prover = obj.get("prover", cfg.prover)
        cfg.async_prover = bool(obj.get("async_prover", cfg.async_prover))
        cfg.prover_workers = int(obj.get("prover_workers", cfg.prover_workers))
        cfg.prover_queue_max = int(
            obj.get("prover_queue_max", cfg.prover_queue_max)
        )
        cfg.prove_timeout_s = float(obj.get("prove_timeout_s", cfg.prove_timeout_s))
        cfg.prover_omp_threads = int(
            obj.get("prover_omp_threads", cfg.prover_omp_threads)
        )
        cfg.srs_path = obj.get("srs_path", cfg.srs_path)
        cfg.profile_dir = obj.get("profile_dir", cfg.profile_dir)
        cfg.journal_path = obj.get("journal_path", cfg.journal_path)
        cfg.lineage_sample_every = int(
            obj.get("lineage_sample_every", cfg.lineage_sample_every)
        )
        cfg.fleet_dir = obj.get("fleet_dir", cfg.fleet_dir)
        cfg.slo_freshness_p99_s = float(
            obj.get("slo_freshness_p99_s", cfg.slo_freshness_p99_s)
        )
        cfg.slo_proof_lag_p99_s = float(
            obj.get("slo_proof_lag_p99_s", cfg.slo_proof_lag_p99_s)
        )
        cfg.fleet_stale_after_s = float(
            obj.get("fleet_stale_after_s", cfg.fleet_stale_after_s)
        )
        cfg.straggler_ratio = float(
            obj.get("straggler_ratio", cfg.straggler_ratio)
        )
        cfg.straggler_epochs = int(
            obj.get("straggler_epochs", cfg.straggler_epochs)
        )
        cfg.slo_pod_skew_p99_s = float(
            obj.get("slo_pod_skew_p99_s", cfg.slo_pod_skew_p99_s)
        )
        return cfg

    @classmethod
    def load(cls, path: str | Path) -> "ProtocolConfig":
        return cls.from_json(Path(path).read_text())

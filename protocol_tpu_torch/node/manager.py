"""The Manager: attestation cache and per-epoch score/proof computation.

The port of the reference package's ``node/manager.py`` (itself a
rebuild of server/src/manager/mod.rs:72-237), on the port's backends:

- protocol constants are a runtime ``ManagerConfig``;
- trust convergence runs on a pluggable TrustBackend from the port's
  ladder (``native-cpu``, ``cuda-dense``, ``cuda-sparse``, ``cuda-csr``,
  ``cuda-windowed``) on ``ManagerConfig.device``: ``None`` means the
  card, and raises where there is none; the fixed-set path keeps the
  reference's exact field semantics via ``power_iterate`` so public
  inputs match bit-for-bit;
- beyond the fixed set, every valid attestation also feeds an *open
  graph* (peer-id-indexed edge list) that the card backends converge at
  scale.

- each epoch proof is the reference's: with the defaults
  (``prover="plonk"``, ``check_circuit=True``) the epoch statement is
  checked at the constraint level, then proved with a KZG PLONK proof
  on the host (``zk.proof.PlonkEpochProver``), byte-identical to the
  reference package's at the same statement and SRS;
- ``aggregate_proofs`` folds cached epoch proofs into one KZG
  accumulator and its one pairing check (``zk.aggregator``).
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field as dc_field

import numpy as np

from .. import chaos, resolve_device
from ..analysis.budget import COMM_INVARIANTS, HOST_BACKENDS, KERNEL_INVARIANTS
from ..crypto import calculate_message_hash, group_pks_hash, message_hash_batch
from ..crypto.eddsa import PublicKey, sign, verify as verify_sig
from ..obs import TRACER
from ..obs import metrics as obs_metrics
from ..obs.journal import JOURNAL
from ..obs.lineage import LINEAGE
from ..obs.timeline import TIMELINE
from ..obs.watchers import DRIFT, RECOMPILES
from ..ops.gather_window import WindowPlan
from ..trust.backend import ConvergenceResult, get_backend
from ..trust.graph import TrustGraph
from ..trust.native import power_iterate
from ..zk.proof import PoseidonCommitmentProver, Proof, Prover
from .attestation import Attestation, AttestationData
from .bootstrap import FIXED_SET, INITIAL_SCORE, NUM_ITER, NUM_NEIGHBOURS, SCALE, keyset_from_raw
from .epoch import Epoch
from .errors import EigenError

logger = logging.getLogger(__name__)

chaos.declare("ingest.pre_apply", "an accepted attestation about to enter the cache/WAL")
chaos.declare("epoch.post_converge", "the fixed point landed, before state publish")
chaos.declare("prover.pre_enqueue", "the epoch proof about to be computed or enqueued")

#: Epochs the in-memory proof cache retains for ``GET /proof/<epoch>``
#: ~10 min of history
#: at a 10 s cadence.  Older proofs stay durable in checkpoints; the
#: serving cache must not grow with uptime.
PROOF_CACHE_EPOCHS = 64

#: Epochs of ConvergenceResult (full f32[N] fixed point each) kept for
#: inspection — same ring discipline as ``EpochPipeline.outcomes``.
RESULT_CACHE_EPOCHS = 16


@dataclass
class ManagerConfig:
    num_neighbours: int = NUM_NEIGHBOURS
    num_iter: int = NUM_ITER
    initial_score: int = INITIAL_SCORE
    scale: int = SCALE
    fixed_set: list[tuple[str, str]] = dc_field(default_factory=lambda: list(FIXED_SET))
    #: TrustBackend for the open-graph convergence (trust/backend.py
    #: ladder: native-cpu | cuda-dense | cuda-sparse | cuda-csr |
    #: cuda-windowed | cuda-sharded[:cuda-csr|:cuda-windowed]).
    #: cuda-windowed and cuda-sharded:cuda-windowed reuse the manager's
    #: cached WindowPlan across epochs.  cuda-sharded runs where this
    #: process is a rank of an initialized torch.distributed group:
    #: each rank runs its own Manager on the same inputs.
    backend: str = "native-cpu"
    #: Device of the card backends and of the graft prover kernels:
    #: None means the card (and raises where there is none); "cpu" runs
    #: their plain versions.  The host backend native-cpu converges on
    #: none.
    device: str | None = None
    #: Run the constraint-system statement check before each proof —
    #: the reference's always-on MockProver sanity pass.
    check_circuit: bool = True
    #: Proof backend: "plonk" (KZG PLONK, the reference's default) or
    #: "commitment" (Poseidon binding, bit-identical to the reference's).
    prover: str = "plonk"
    #: The PLONK prover's ceremony SRS file (None: a dev-only random
    #: setup) and proving-kernel backend: "native" (the host runtime) or
    #: "graft" (the card kernels K10-K13, on the node's device: ``device``
    #: as the converge resolves it, so "cpu" runs their plain versions).
    srs_path: str | None = None
    zk_backend: str = "native"
    #: Seed each epoch's convergence from the previous epoch's fixed
    #: point (renormalized over joined/departed peers) — the fixed
    #: point is start-independent, so this only shortens the path
    #: (sparse power methods converge dramatically faster from a
    #: near-fixed-point start).
    warm_start: bool = True
    #: Dirty-row fraction above which the windowed plan cache skips the
    #: delta update and rebuilds from scratch: past this crossover the
    #: per-window repack costs more than the full counting sorts.
    plan_delta_max_churn: float = 0.05
    #: Pod membership (ROADMAP item 1): with ``pod_hosts > 1`` this
    #: node owns only the peers the rendezvous partition assigns to
    #: ``pod_host_id``, and ``prepare_epoch`` clips the plan-delta
    #: churn hint to owned rows — churn on other hosts' peers never
    #: touches this host's plan (``parallel.partition``).
    pod_hosts: int = 1
    pod_host_id: int = 0
    #: Salt namespace for the pod's peer→host partition; every host in
    #: one pod must configure the same value.
    pod_seed: int = 0


@dataclass(frozen=True)
class IngestResult:
    """Per-item bulk-ingest outcome: acceptance plus the structural or
    signature failure reason (the rejection-reason metric's label).
    Truthiness mirrors acceptance so boolean-style callers keep
    working."""

    accepted: bool
    #: Rejection reason code (``eigentrust_attestations_rejected_total``
    #: label) — None when accepted.
    reason: str | None = None

    def __bool__(self) -> bool:
        return self.accepted


@dataclass
class PreparedEpoch:
    """Output of the host stage of one epoch (``Manager.prepare_epoch``):
    everything ``converge_prepared`` needs to dispatch device work, and
    nothing that touches the attestation cache again — so the pipeline
    can prepare epoch k+1 while epoch k still owns the device."""

    epoch: Epoch
    graph: TrustGraph
    #: Peer hash per graph row id, assembly order (the score index map).
    id_order: list[int]
    #: Warm-start seed remapped onto this graph's id space, or None for
    #: a cold start.
    t0: np.ndarray | None
    #: Churn hint for the windowed plan cache (row ids whose out-edges
    #: changed since the cached plan), or None to force plan
    #: revalidation by fingerprint alone.
    delta_rows: np.ndarray | None
    #: The dirty-sender snapshot this graph absorbed — subtracted from
    #: the manager's dirty set only after a successful converge, so a
    #: failed epoch leaves the churn accounting intact.
    dirty_snapshot: set[int]
    #: WAL applied-watermark read *before* graph assembly: every log
    #: record ≤ it is in this graph, so the epoch's checkpoint may
    #: truncate the WAL through it.  None when no WAL is attached.
    wal_seq: int | None = None


def _budget_key(backend: str) -> str:
    """The name a backend's budgets are declared under: plain
    ``cuda-sharded`` is the ``cuda-sharded:cuda-csr`` composite."""
    return "cuda-sharded:cuda-csr" if backend == "cuda-sharded" else backend


class Manager:
    """In-memory attestation store keyed by Poseidon(pk); per-epoch score
    + proof computation with a proof cache (manager/mod.rs:72-78)."""

    def __init__(self, config: ManagerConfig | None = None, prover: Prover | None = None):
        self.config = config or ManagerConfig()
        if prover is None and self.config.prover not in ("plonk", "commitment"):
            raise ValueError(
                f"unknown prover {self.config.prover!r}: "
                "expected 'commitment' or 'plonk'"
            )
        # Lazy: PLONK keygen is ~20 s, so it runs on first use (or
        # explicitly via warm_prover() at node boot, the analog of the
        # reference's MANAGER_STORE init, server/src/main.rs:70-83)
        # rather than on every Manager construction.
        self._prover = prover
        self.cached_proofs: dict[Epoch, Proof] = {}
        self.attestations: dict[int, Attestation] = {}
        self.cached_results: dict[Epoch, ConvergenceResult] = {}
        #: The graph the most recent converge_epoch ran on.
        self.last_graph: TrustGraph | None = None
        #: Bucketing plan for the windowed backend (cuda-windowed):
        #: built on first converge,
        #: revalidated by fingerprint + layout version each epoch,
        #: seeded from a checkpoint at boot so a reboot skips
        #: reconstruction.
        self.window_plan: WindowPlan | None = None
        #: Warm-start state: the previous epoch's converged scores and
        #: the peer hash per score row (restored from checkpoints at
        #: boot, so warm start survives restart).
        self.last_scores: np.ndarray | None = None
        self.last_peer_hashes: list[int] | None = None
        #: Write-ahead attestation log (node/wal.py), attached by boot
        #: recovery AFTER the tail replay (so replay never re-appends).
        #: Accessed bare from every ingest root — attachment is a
        #: single reference publish, same GIL discipline as the
        #: attestation cache itself.
        self.wal = None
        #: WAL watermark of the last landed epoch — published with the
        #: warm-start pair under the state lock; the checkpoint
        #: truncates the log through it.
        self.last_wal_seq: int | None = None
        #: Guards the cross-epoch mutable state shared between the
        #: pipeline's host stage (prepare_epoch on the submit thread),
        #: the device stage (converge_prepared on the worker thread),
        #: and the ingest threads (apply_verified / bulk ingest): the
        #: dirty-sender set, the warm-start snapshot — scores and their
        #: peer-hash column must be read as a matched pair, or a warm
        #: seed built mid-publish maps scores onto the wrong peers —
        #: and the window-plan cache handoff.
        self._state_lock = threading.Lock()
        #: The device every converge runs on, resolved once here: None
        #: for the host backend, else the card (raising where there is
        #: none; the current card when the config names no index) unless
        #: the config asks for another device.
        self.device = None
        if self.config.backend not in HOST_BACKENDS:
            self.device = resolve_device(self.config.device)
            if self.device.type == "cuda" and self.device.index is None:
                import torch

                self.device = torch.device("cuda", torch.cuda.current_device())
        # Comm-budget check at config time (the kernel-budget analog runs
        # per converge): a sharded backend without a COMM_INVARIANTS entry
        # runs with its collectives and their bytes unpinned.  Its
        # declarations land with parallel/sharded.py, which
        # trust/backend.py imports.
        comm_key = _budget_key(self.config.backend)
        if comm_key.startswith("cuda-sharded") and comm_key not in COMM_INVARIANTS:
            logger.warning(
                "sharded trust backend %r has no COMM_INVARIANTS declaration; "
                "its collectives are not pinned",
                self.config.backend,
            )
        #: Senders whose attestation changed since the window plan last
        #: advanced — the delta-plan churn source.  Accumulates across
        #: failed epochs; cleared per successful converge.
        self._dirty_hashes: set[int] = set()
        #: Hash per peer id of the most recent build_graph call.
        self._id_order: list[int] = []
        _, self._group_pks = keyset_from_raw(self.config.fixed_set)
        self._group_hashes = [pk.hash() for pk in self._group_pks]
        #: The pk-sponge half of the protocol message hash — shared by
        #: every attestation against this group (hash it once, not once
        #: per signature; the admission plane's workers get it too).
        self._group_pks_hash = group_pks_hash(self._group_pks)
        # Poseidon pk-hash memo: hashing is 68 field-level rounds of
        # pure Python; never recompute for a seen key.
        self._hash_cache: dict[PublicKey, int] = dict(
            zip(self._group_pks, self._group_hashes)
        )

    @property
    def prover(self) -> Prover:
        if self._prover is None:
            if self.config.prover == "plonk":
                from ..zk.proof import PlonkEpochProver

                self._prover = PlonkEpochProver(
                    num_neighbours=self.config.num_neighbours,
                    num_iter=self.config.num_iter,
                    initial_score=self.config.initial_score,
                    scale=self.config.scale,
                    srs_path=self.config.srs_path,
                )
            else:
                self._prover = PoseidonCommitmentProver()
        return self._prover

    def warm_prover(self) -> None:
        """Force prover construction (PLONK keygen) now — called at node
        boot so the first epoch tick doesn't pay it."""
        _ = self.prover

    def _pk_hash(self, pk: PublicKey) -> int:
        h = self._hash_cache.get(pk)
        if h is None:
            h = pk.hash()
            self._hash_cache[pk] = h
        return h

    # -- ingest ---------------------------------------------------------

    def _structural_error(self, att: Attestation) -> tuple[str, str] | None:
        """The cheap pre-signature checks, shared by both ingest paths
        (manager/mod.rs:95-138 semantics plus score conservation).
        Returns ``(reason code, message)`` — the code labels the
        rejection-reason metric, the message goes into the error — or
        None when the attestation is structurally sound."""
        # Direct pk comparison is equivalent to the reference's
        # hash-list equality (Poseidon is injective on valid points) and
        # avoids N permutations per ingest.
        if att.neighbours != self._group_pks:
            return "group-mismatch", "neighbour group mismatch"
        if att.pk not in self._group_pks:
            return "sender-not-in-group", "sender not in group"
        # Conservation precondition: the circuit's Σscores == N·IS gate
        # means a non-SCALE-summing row would poison every future epoch
        # proof; reject it at the door instead (the reference accepts it
        # and would panic at proving time, main.rs:170 unwrap).
        if sum(att.scores) != self.config.scale:
            return (
                "non-conserving-scores",
                f"scores must sum to {self.config.scale}",
            )
        return None

    def add_attestation(self, att: Attestation) -> IngestResult:
        """Validate and cache one attestation (manager/mod.rs:95-138):
        the neighbour list must match the group, the sender must be a
        member, and the signature must verify over the protocol message
        hash.  Returns the same per-item :class:`IngestResult` as the
        bulk path (and IS the bulk path at batch size 1), so single-item
        and bulk ingestion report rejections uniformly instead of this
        path raising where the other returns."""
        return self.add_attestations_bulk([att])[0]

    def apply_verified(
        self, att: Attestation, raw: bytes | None = None, *, flush: bool = True
    ) -> IngestResult:
        """Cache an attestation whose structural AND signature checks
        already passed upstream — the admission plane's apply stage
        (ingest/plane.py) and the WAL replay path (node/wal.py).  With
        a WAL attached the record is appended (and, with ``flush``,
        fsync'd) BEFORE the cache insert: an acknowledged attestation
        survives ``kill -9`` at any instruction after this returns.
        ``raw`` is the wire payload when the caller already has it
        (skips re-serialization); batch callers pass ``flush=False``
        and call :meth:`flush_wal` once per batch."""
        if chaos.ACTIVE:
            chaos.fire("ingest.pre_apply")
        h = self._pk_hash(att.pk)
        seq = None
        if self.wal is not None:
            from .wal import encode_payload

            if raw is None:
                raw = AttestationData.from_attestation(att).to_bytes()
            # An OSError here (disk full, injected fault) propagates:
            # without the log record the attestation must NOT be
            # acknowledged — the plane maps it to reason="wal-error".
            seq = self.wal.append(
                encode_payload(len(att.neighbours), raw), flush=flush
            )
        self.attestations[h] = att
        if seq is not None:
            self.wal.mark_applied(seq)
        with self._state_lock:
            self._dirty_hashes.add(h)
        obs_metrics.ATTESTATIONS_ACCEPTED.inc()
        return IngestResult(True)

    def flush_wal(self) -> None:
        """Force buffered WAL records to disk — the batch-granular
        durability boundary (the admission plane calls this once per
        verify batch, before resolving the batch's verdicts)."""
        if self.wal is not None:
            self.wal.flush()

    def snapshot_attestations(self) -> list[tuple[int, bytes]]:
        """The cache as ``(num_neighbours, wire bytes)`` rows for the
        checkpoint: the graph column alone cannot reconstruct the cache
        post-recovery (epochs rebuild the graph FROM it), and the WAL
        only retains the tail past the checkpointed watermark."""
        return [
            (len(att.neighbours), AttestationData.from_attestation(att).to_bytes())
            for att in list(self.attestations.values())
        ]

    def restore_attestation(self, att: Attestation) -> None:
        """Re-install one checkpointed attestation at boot: cache
        insert + dirty mark only — no WAL append (it is already inside
        the snapshot's watermark), no accept metrics (it was counted
        when first accepted), no chaos hook."""
        h = self._pk_hash(att.pk)
        self.attestations[h] = att
        with self._state_lock:
            self._dirty_hashes.add(h)

    def add_attestations_bulk(self, atts: list[Attestation]) -> list[IngestResult]:
        """High-throughput ingest for event replay: run the shared
        structural checks per item, then batch the surviving signature
        verifications through the C++ runtime (one pass instead of A
        scalar-muls in Python).  Returns a per-item
        :class:`IngestResult` — acceptance plus the rejection reason,
        which also feeds the rejection-reason metric."""
        import time

        from ..crypto import native as cnative

        candidates: list[tuple[int, Attestation, int]] = []
        results: list[IngestResult | None] = [None] * len(atts)
        with TRACER.span("ingest", batch=len(atts)):
            survivors: list[tuple[int, Attestation]] = []
            for i, att in enumerate(atts):
                error = self._structural_error(att)
                if error is None:
                    survivors.append((i, att))
                else:
                    results[i] = IngestResult(False, error[0])
                    obs_metrics.ATTESTATIONS_REJECTED.inc(reason=error[0])
                    JOURNAL.record("ingest-reject", reason=error[0])
            # Every structural survivor attests against THE group, so
            # the pk-sponge half of the message hash is shared and the
            # per-row half batches through the native Poseidon runtime
            # (crypto.message_hash_batch) — ~6x over hashing each
            # attestation's message separately in Python.
            if survivors:
                mhs = message_hash_batch(
                    self._group_pks_hash, [list(a.scores) for _, a in survivors]
                )
                candidates = [(i, a, m) for (i, a), m in zip(survivors, mhs)]

            t0 = time.perf_counter()
            if candidates and cnative.available():
                sig_ok = cnative.eddsa_verify_batch(
                    [a.sig.big_r.x for _, a, _ in candidates],
                    [a.sig.big_r.y for _, a, _ in candidates],
                    [a.sig.s for _, a, _ in candidates],
                    [a.pk.point.x for _, a, _ in candidates],
                    [a.pk.point.y for _, a, _ in candidates],
                    [m for _, _, m in candidates],
                )
            else:
                sig_ok = [verify_sig(a.sig, a.pk, m) for _, a, m in candidates]
            if candidates:
                obs_metrics.SIG_VERIFY_SECONDS.observe(time.perf_counter() - t0)
                obs_metrics.SIGS_VERIFIED.inc(len(candidates))

            for (i, att, _), ok in zip(candidates, sig_ok):
                if ok:
                    try:
                        # The shared accept path: WAL append (buffered;
                        # one fsync per bulk call below) + cache insert.
                        results[i] = self.apply_verified(att, flush=False)
                    except OSError as exc:
                        results[i] = IngestResult(False, "wal-error")
                        obs_metrics.ATTESTATIONS_REJECTED.inc(reason="wal-error")
                        JOURNAL.record(
                            "ingest-reject", reason="wal-error", error=repr(exc)
                        )
                else:
                    results[i] = IngestResult(False, "bad-signature")
                    obs_metrics.ATTESTATIONS_REJECTED.inc(reason="bad-signature")
                    JOURNAL.record("ingest-reject", reason="bad-signature")
            # One fsync per bulk call: the verdicts below are durable.
            self.flush_wal()
        return [r for r in results if r is not None]

    def get_attestation(self, pk: PublicKey) -> Attestation:
        att = self.attestations.get(pk.hash())
        if att is None:
            raise EigenError.attestation_not_found()
        return att

    def generate_initial_attestations(self) -> None:
        """Self-sign uniform IS/N attestations for the whole fixed set
        (manager/mod.rs:149-167) — the circuit needs a score row from
        every participant."""
        cfg = self.config
        sks, pks = keyset_from_raw(cfg.fixed_set)
        score = cfg.initial_score // cfg.num_neighbours
        scores = [[score] * cfg.num_neighbours for _ in range(cfg.num_neighbours)]
        _, messages = calculate_message_hash(pks, scores)
        for sk, pk, msg, row in zip(sks, pks, messages, scores):
            sig = sign(sk, pk, msg)
            att = Attestation(sig=sig, pk=pk, neighbours=list(pks), scores=list(row))
            h = pk.hash()
            self.attestations[h] = att
            with self._state_lock:
                self._dirty_hashes.add(h)

    # -- per-epoch computation ------------------------------------------

    def gather_ops(self) -> list[list[int]]:
        """Score matrix in fixed-set order (manager/mod.rs:182-188);
        KeyError if a member has no attestation, like the reference's
        unwrap."""
        return [
            list(self.attestations[h].scores) for h in self._group_hashes
        ]

    def build_proof_job(self, epoch: Epoch):
        """Flatten this epoch's fixed-set statement into a
        :class:`~protocol_tpu_torch.prover.jobs.ProofJob` for the
        proving plane: per-member signature/pk/score integer tuples
        plus the protocol parameters — no protocol objects cross the
        worker process boundary.  The snapshot happens here, on the
        epoch tick, so later ingests never mutate an enqueued job."""
        from ..prover.jobs import ProofJob

        cfg = self.config
        atts = [self.attestations[h] for h in self._group_hashes]
        with self._state_lock:
            plan = self.window_plan
        # Plan fingerprints are hex digests; fold to an int so the job
        # payload stays flat ints (0 = no cached plan yet).
        raw_fp = getattr(plan, "fingerprint", 0) or 0
        fingerprint = int(raw_fp, 16) if isinstance(raw_fp, str) else int(raw_fp)
        return ProofJob(
            # Flat lineage IDs for the spawn boundary: the epoch's
            # sampled cohort (and earlier cohorts this proof covers);
            # () on the unsampled path.  Excluded from job_seed, so
            # sampling never perturbs proof bytes.
            lineage=LINEAGE.ids_for_epoch(epoch.number),
            epoch=epoch.number,
            ops=tuple(tuple(int(s) for s in a.scores) for a in atts),
            sigs=tuple(
                (a.sig.big_r.x, a.sig.big_r.y, a.sig.s) for a in atts
            ),
            pks=tuple((a.pk.point.x, a.pk.point.y) for a in atts),
            params=(
                cfg.num_neighbours,
                cfg.num_iter,
                cfg.initial_score,
                cfg.scale,
            ),
            prover=cfg.prover,
            srs_path=cfg.srs_path,
            check_circuit=cfg.check_circuit,
            graph_fingerprint=fingerprint,
            zk_backend=cfg.zk_backend,
            # The node's device, for a graft prove on another thread or
            # in a spawned worker (the knob is thread-local); the same
            # device calculate_proofs hands the knob.  Not in job_seed.
            zk_device=str(self.device) if self.device is not None else cfg.device,
        )

    def install_proof(self, epoch_number: int, pub_ins, proof_bytes: bytes) -> None:
        """Land an asynchronously produced proof in the cache (called
        from a proving-plane dispatcher thread; the dict insert is
        GIL-atomic, same discipline as the attestation cache)."""
        self.cache_proof(
            Epoch(int(epoch_number)),
            Proof(pub_ins=list(pub_ins), proof=proof_bytes),
        )

    def cache_proof(self, epoch: Epoch, proof: Proof) -> None:
        """Insert one epoch's proof and evict past the retention ring.

        The in-memory proof cache is a SERVING cache, not the durable
        record (checkpoints persist proofs; the proving plane owns the
        lifecycle): unbounded, it would grow one entry per epoch
        forever.  Oldest-epoch eviction keeps ``GET /proof/<epoch>``
        serving the recent window while boot recovery and the ring
        agree on what "recent" means."""
        self.cached_proofs[epoch] = proof
        while len(self.cached_proofs) > PROOF_CACHE_EPOCHS:
            self.cached_proofs.pop(min(self.cached_proofs, key=lambda e: e.number))

    def checkpoint_watermark(self) -> int | None:
        """WAL seq the next checkpoint may truncate through — the last
        landed epoch's watermark, read as a pair with the warm state."""
        with self._state_lock:
            return self.last_wal_seq

    def calculate_proofs(self, epoch: Epoch) -> None:
        """Converge the fixed set exactly and cache a proof of the
        resulting public inputs (manager/mod.rs:170-214)."""
        if chaos.ACTIVE:
            chaos.fire("prover.pre_enqueue")
        cfg = self.config
        atts = [self.attestations[h] for h in self._group_hashes]
        ops = [list(a.scores) for a in atts]
        init = [cfg.initial_score] * cfg.num_neighbours
        with TRACER.span("power_iterate"):
            pub_ins = power_iterate(init, ops, cfg.num_iter, cfg.scale)

        # Constraint-level statement check before emitting the proof —
        # the reference runs MockProver::assert_satisfied inside
        # gen_proof even in release (verifier/mod.rs:62-70).  The
        # synthesized system is handed to the prover so the k=14
        # circuit isn't built twice per epoch.
        witness = {"ops": ops, "attestations": atts}
        if cfg.check_circuit:
            from ..zk.circuit import prove_epoch_statement

            with TRACER.span("circuit_check"):
                witness["cs"] = prove_epoch_statement(
                    atts,
                    pub_ins,
                    num_neighbours=cfg.num_neighbours,
                    num_iter=cfg.num_iter,
                    initial_score=cfg.initial_score,
                    scale=cfg.scale,
                )

        # Proving time lands in telemetry, the structured analog of the
        # reference's "Proving time: {:?}" print (circuit/src/utils.rs:305-321).
        from ..prover.jobs import job_seed
        from ..utils.telemetry import TELEMETRY
        from ..zk.graft import use_zk_backend

        # The statement-bound blinding seed keeps the synchronous path
        # byte-identical to the pooled path for the same input (the
        # async-prover equivalence contract).
        seed = job_seed(self.build_proof_job(epoch))
        # The configured proving-kernel backend runs the prove; "graft"
        # on the node's device (the host backend's node names it in the
        # config: None is the card, raising where there is none).
        zk_device = self.device if self.device is not None else cfg.device
        with use_zk_backend(cfg.zk_backend, zk_device), TELEMETRY.timer("epoch.prove"), \
                TRACER.span("snark"):
            proof_bytes = self.prover.prove(pub_ins, witness, seed=seed)
        if __debug__:
            assert self.prover.verify(pub_ins, proof_bytes)
        self.cache_proof(epoch, Proof(pub_ins=pub_ins, proof=proof_bytes))
        # Sequential-prove lineage completion: this tick's proof covers
        # every cohort bound at or before this epoch (the async plane
        # does the same from its dispatcher when the proof lands).
        e2e = LINEAGE.epoch_proved(epoch.number)
        TIMELINE.record(
            epoch.number,
            proof={"state": "proved", "mode": "sync"},
            freshness={"completed": len(e2e)},
        )

    def _warm_t0(self, id_order: list[int]) -> np.ndarray | None:
        """Remap the previous epoch's fixed point onto the new graph's
        id space: surviving peers keep their score, departed peers'
        mass drops out, joined peers start at zero, and the result is
        L1-renormalized.  None (cold start) when there is no previous
        state or the overlap is empty — the backends treat None as
        "start from the pre-trust vector"."""
        # Scores and their peer-hash column publish together in
        # converge_prepared (pipeline device thread); read them as a
        # matched pair or the warm seed maps scores onto wrong peers.
        with self._state_lock:
            scores, hashes = self.last_scores, self.last_peer_hashes
        if scores is None or hashes is None or not len(hashes) or not len(scores):
            return None
        # Vectorized remap: a per-peer dict walk is seconds of pure
        # Python at a pod's 10M-peer scale; folding the
        # Poseidon hashes to 64-bit keys and matching via one sorted
        # searchsorted pass is far faster.  A low-64-bit collision
        # (≈ n²/2⁶⁴ odds) can only misplace one seed entry — the seed
        # is renormalized and the fixed point is start-independent, so
        # the failure mode is a marginally longer converge, never a
        # wrong score.
        from ..parallel.partition import keys_from_hashes

        prev_keys = keys_from_hashes(hashes)
        new_keys = keys_from_hashes(id_order)
        order = np.argsort(prev_keys, kind="stable")
        sorted_prev = prev_keys[order]
        pos = np.searchsorted(sorted_prev, new_keys)
        pos = np.minimum(pos, max(len(sorted_prev) - 1, 0))
        hit = (
            (sorted_prev[pos] == new_keys)
            if len(sorted_prev)
            else np.zeros(len(new_keys), bool)
        )
        j = order[pos]
        hit &= j < len(scores)
        prev_scores = np.maximum(np.asarray(scores, np.float64), 0.0)
        t0 = np.where(hit, prev_scores[np.minimum(j, len(scores) - 1)], 0.0)
        total = t0.sum()
        if not hit.any() or not np.isfinite(total) or total <= 0:
            return None
        return t0 / total

    @contextmanager
    def _plan_cache(self, backend, delta_rows: np.ndarray | None = None):
        """THE plan-cache handoff: seed the backend from the manager's
        cached WindowPlan (plus the churn hint for delta updates) and
        read back whatever plan the converge actually used, so
        checkpoints persist it.  Duck-typed — any backend exposing
        ``plan``/``delta_rows``/``last_plan`` participates, which
        covers both windowed rungs and future sharded composites
        without name dispatch (``cuda-windowed`` exposes all three)."""
        if hasattr(backend, "plan"):
            with self._state_lock:
                backend.plan = self.window_plan
        if hasattr(backend, "delta_rows"):
            backend.delta_rows = delta_rows
        try:
            yield backend
        finally:
            plan = getattr(backend, "last_plan", None)
            if plan is not None:
                with self._state_lock:
                    self.window_plan = plan

    def prepare_epoch(self, epoch: Epoch) -> PreparedEpoch:
        """Host stage of one epoch: snapshot the dirty-sender set,
        assemble the open graph, remap the warm-start seed, and derive
        the plan-delta churn hint.  Touches no device state — the
        pipeline overlaps this with the previous epoch's device work."""
        # Snapshot BEFORE assembly: an ingest racing build_graph stays
        # dirty for the next epoch (supersets are safe, misses are not).
        # The cached plan is snapshotted in the same critical section so
        # the churn hint below is derived against one coherent plan.
        with self._state_lock:
            dirty = set(self._dirty_hashes)
            cached_plan = self.window_plan
        # WAL watermark BEFORE assembly: every record at or below it is
        # already in the cache, so it is inside the graph built next —
        # the checkpoint of this epoch may truncate the log through it.
        # (A record appended after this read stays in the WAL for the
        # next epoch; supersets are safe, misses are not.)
        wal_seq = self.wal.applied_watermark() if self.wal is not None else None
        with TRACER.span("build_graph"):
            graph = self.build_graph()
        # A concurrent build_graph (pipelined checkpoint path) may have
        # extended the shared order; ids are append-only, so truncating
        # to this graph's peer count restores the matching column.
        id_order = list(self._id_order)[: graph.n]
        obs_metrics.GRAPH_PEERS.set(graph.n)
        obs_metrics.GRAPH_EDGES.set(graph.nnz)
        # This graph absorbed the attestation cache: every applied
        # lineage entry is now included-in-epoch, and the timeline's
        # ingest watermark records what the epoch saw.
        included = LINEAGE.bind_epoch(epoch.number)
        TIMELINE.record(
            epoch.number,
            ingest_watermark={
                "accepted_total": obs_metrics.ATTESTATIONS_ACCEPTED.value(),
                "attestations_cached": len(self.attestations),
                "lineage_included": len(included),
            },
            graph={"peers": int(graph.n), "edges": int(graph.nnz)},
        )
        t0 = self._warm_t0(id_order) if self.config.warm_start else None
        delta_rows = None
        if cached_plan is not None and dirty:
            pos = {h: i for i, h in enumerate(id_order)}
            rows = np.array(
                sorted(pos[h] for h in dirty if h in pos), dtype=np.int64
            )
            # Pod mode: this host's plan only encodes the out-edges of
            # peers it owns, so churn on other hosts' peers is not a
            # delta against it — clip the hint to owned rows (the
            # owned-elsewhere rows are some other host's delta).
            if rows.size and self.config.pod_hosts > 1:
                from ..parallel.partition import HostPartition, keys_from_hashes

                part = HostPartition(
                    self.config.pod_hosts, seed=self.config.pod_seed
                )
                keys = keys_from_hashes(id_order[int(r)] for r in rows)
                rows = rows[part.assign(keys) == self.config.pod_host_id]
            # Above the churn crossover a full rebuild is cheaper than
            # repacking that many windows.
            if rows.size and rows.size <= self.config.plan_delta_max_churn * max(
                graph.n, 1
            ):
                delta_rows = rows
        return PreparedEpoch(
            epoch=epoch,
            graph=graph,
            id_order=id_order,
            t0=t0,
            delta_rows=delta_rows,
            dirty_snapshot=dirty,
            wal_seq=wal_seq,
        )

    def converge_prepared(
        self,
        prepared: PreparedEpoch,
        *,
        alpha: float = 0.0,
        tol: float = 1e-6,
        max_iter: int = 50,
    ) -> ConvergenceResult:
        """Device stage of one epoch: converge the prepared graph on the
        configured TrustBackend, seeded warm and with the plan cache
        handed off through :meth:`_plan_cache`."""
        graph = prepared.graph
        key = _budget_key(self.config.backend)
        backend = (
            get_backend(key)
            if key in HOST_BACKENDS
            else get_backend(key, device=self.device)
        )
        # Every card backend declares the kernels a step launches
        # (analysis/budget.py); a configured backend outside the table
        # runs with its launch pattern unpinned — legal (constructing it
        # above proved it's registered) but worth a loud note in the
        # node log.
        if key not in HOST_BACKENDS and key not in KERNEL_INVARIANTS:
            logger.warning(
                "trust backend %r has no KERNEL_INVARIANTS declaration; "
                "its kernel launch pattern is not pinned",
                self.config.backend,
            )
        # Kernel-build watch: a steady-state delta epoch (warm seed +
        # delta-updated plan) runs kernels the epochs before it loaded,
        # so no kernel library may be built or loaded across this
        # converge.  The bracket reads the build counts at the host
        # boundary only.
        steady_state = prepared.t0 is not None and prepared.delta_rows is not None
        jit_snapshot = RECOMPILES.snapshot()
        with self._plan_cache(backend, prepared.delta_rows):
            result = backend.converge(
                graph, alpha=alpha, tol=tol, max_iter=max_iter, t0=prepared.t0
            )
        RECOMPILES.observe(
            jit_snapshot,
            steady_state=steady_state,
            epoch=prepared.epoch.number,
        )
        if chaos.ACTIVE:
            # The fixed point exists but nothing is published yet — a
            # crash here must recover every accepted attestation from
            # checkpoint + WAL and reconverge to the same fixed point.
            chaos.fire("epoch.post_converge")
        if prepared.t0 is not None:
            obs_metrics.WARM_START_APPLIED.inc()
        # The epoch landed: its churn is folded into the cached plan
        # (or the plan was rebuilt), so those senders are clean now.
        # One critical section publishes the epoch's outcome: the
        # dirty-set subtraction is a read-modify-write racing ingest
        # .add()s, and scores/peer-hashes must land as a matched pair
        # for the next _warm_t0.
        with self._state_lock:
            self._dirty_hashes -= prepared.dirty_snapshot
            self.last_graph = graph
            self.last_scores = result.scores
            self.last_peer_hashes = prepared.id_order
            self.last_wal_seq = prepared.wal_seq
        self.cached_results[prepared.epoch] = result
        # Bounded inspection ring: a ConvergenceResult holds the full
        # fixed point (8 MB an epoch at 1M peers).  Same ring shape as
        # EpochPipeline.outcomes.
        while len(self.cached_results) > RESULT_CACHE_EPOCHS:
            self.cached_results.pop(min(self.cached_results, key=lambda e: e.number))
        # Convergence health → the /metrics surface: the iteration
        # count, the final residual, and the full device-captured
        # trajectory (one observation per iteration, so the histogram's
        # per-epoch count equals the iteration count).
        obs_metrics.CONVERGENCE_ITERATIONS.set(result.iterations)
        obs_metrics.LAST_RESIDUAL.set(result.residual)
        if result.residuals is not None:
            for r in result.residuals:
                obs_metrics.CONVERGENCE_RESIDUAL.observe(float(r))
        # Score-integrity monitor: fixed-point drift vs the previous
        # epoch (aligned by peer hash), top movers, and the stall
        # detector over the residual trajectory — the /scores/drift
        # surface.
        DRIFT.observe(
            prepared.epoch.number,
            prepared.id_order,
            result.scores,
            result.residuals,
        )
        # The epoch's lineage cohort has a converged (not yet proven)
        # fixed point; the timeline gets the converge fragment.
        LINEAGE.epoch_converged(prepared.epoch.number)
        TIMELINE.record(
            prepared.epoch.number,
            converge={
                "iterations": int(result.iterations),
                "residual": float(result.residual),
                "backend": str(result.backend),
                "warm_start": prepared.t0 is not None,
                "delta_plan": prepared.delta_rows is not None,
            },
        )
        return result

    def converge_epoch(
        self, epoch: Epoch, *, alpha: float = 0.0, tol: float = 1e-6, max_iter: int = 50
    ) -> ConvergenceResult:
        """Scaled path: build the open trust graph from every cached
        attestation and converge it on the configured TrustBackend —
        the sequential composition of :meth:`prepare_epoch` (host) and
        :meth:`converge_prepared` (device); the epoch pipeline calls
        the two halves from different stages instead.  The graph used
        is kept as ``last_graph`` so checkpointing can persist exactly
        the graph the scores belong to."""
        return self.converge_prepared(
            self.prepare_epoch(epoch), alpha=alpha, tol=tol, max_iter=max_iter
        )

    def restore_warm_state(
        self,
        *,
        graph: TrustGraph | None = None,
        plan: WindowPlan | None = None,
        scores: np.ndarray | None = None,
        peer_hashes: list[int] | None = None,
    ) -> None:
        """Seed the cross-epoch state from a checkpoint (node boot).
        Publishes under the state lock so a concurrently starting epoch
        pipeline never observes a half-restored warm snapshot; scores
        and their peer-hash column are only installed as a pair."""
        with self._state_lock:
            if graph is not None:
                self.last_graph = graph
            if plan is not None:
                self.window_plan = plan
            if scores is not None and peer_hashes is not None:
                self.last_scores = scores
                self.last_peer_hashes = peer_hashes

    def build_graph(self) -> TrustGraph:
        """Assemble the open COO graph: peer ids are discovered from
        attestation senders and neighbours in first-seen order; the
        fixed set is the pre-trusted seed."""
        ids: dict[int, int] = {}

        def peer_id(h: int) -> int:
            if h not in ids:
                ids[h] = len(ids)
            return ids[h]

        for h in self._group_hashes:
            peer_id(h)

        src, dst, w = [], [], []
        # list() is a GIL-atomic copy: the asyncio ingest thread may be
        # inserting while an executor thread assembles the graph.
        for sender_hash, att in list(self.attestations.items()):
            s_id = peer_id(sender_hash)
            for pk, score in zip(att.neighbours, att.scores):
                if score == 0 or pk.is_null():
                    continue
                d_id = peer_id(self._pk_hash(pk))
                src.append(s_id)
                dst.append(d_id)
                w.append(float(score))
        n = len(ids)
        # id -> hash, assembly order: the warm-start remap and the
        # checkpoint's peer_hashes column both key scores by this.
        self._id_order = list(ids)
        pre = np.zeros(n, bool)
        pre[: len(self._group_hashes)] = True
        return TrustGraph(
            n,
            np.array(src, np.int32),
            np.array(dst, np.int32),
            np.array(w, np.float32),
            pre,
        )

    # -- queries --------------------------------------------------------

    def get_proof(self, epoch: Epoch) -> Proof:
        proof = self.cached_proofs.get(epoch)
        if proof is None:
            raise EigenError.proof_not_found()
        return proof

    def get_last_proof(self) -> Proof:
        if not self.cached_proofs:
            raise EigenError.proof_not_found()
        return self.cached_proofs[max(self.cached_proofs, key=lambda e: e.number)]

    def aggregate_proofs(self, epochs: list[Epoch]):
        """Batch-verify cached epoch SNARKs with one pairing check
        (``zk.aggregator``): fold every requested epoch's proof into a
        KZG accumulator and finalize it.  Returns ``(ok, accumulator)``.

        Requires the PLONK prover (commitment proofs have no pairing
        structure)."""
        from ..zk.aggregator import Snark, accumulate, finalize

        from .errors import EigenErrorCode

        # Cheap validation first: the config string and the proof cache
        # — never trigger a lazy keygen (or wait on the boot warm-up)
        # for a request that would fail anyway.
        if self.config.prover != "plonk":
            raise EigenError(
                EigenErrorCode.VERIFICATION_ERROR,
                "aggregation requires the plonk prover",
            )
        proofs = [self.get_proof(epoch) for epoch in epochs]
        if self._prover is None:
            raise EigenError(EigenErrorCode.PROVING_ERROR, "prover still warming up")
        prover = self.prover
        snarks = [
            Snark(
                vk=prover.vk,
                instances=proof.pub_ins,
                proof=proof.proof,
                transcript=prover.TRANSCRIPT,
            )
            for proof in proofs
        ]
        acc = accumulate(snarks)
        if acc is None:
            return False, None
        return finalize(acc, prover.vk), acc

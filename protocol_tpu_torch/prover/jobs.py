"""Proof jobs: the flat, picklable unit of work the proving plane moves
across the process boundary.

The port of ``protocol_tpu/prover/jobs.py``.  A :class:`ProofJob`
carries everything one epoch proof needs as plain integers and tuples —
signature components, public-key coordinates, score rows, the protocol
parameters — so a spawned prover worker imports only the port's
zk/crypto tree (no jax, nothing of ``protocol_tpu``, no node state, no
open-graph arrays) and two jobs with equal payloads are *the same
statement*.

Determinism: PLONK blinding is normally sampled from the system RNG,
which would make the pooled proof differ byte-for-byte from an
in-process proof of the same statement.  :func:`job_seed` derives the
blinding seed from the job payload itself (the RFC-6979 stance:
deterministic nonces bound to the witness), so in-process and pooled
proving are bit-identical — to each other and to the reference's — and
re-proving a superseded epoch is idempotent.

:func:`prove_job` is the single prove entry both paths share: the
worker processes call it through :mod:`~protocol_tpu_torch.prover.workers`,
and ``workers=0`` pools call it inline.  It rebuilds the epoch
statement (``power_iterate`` → circuit check → SNARK) under a local
span tree and returns the serialized spans with the proof, so the
prover-internal attribution (msm/ntt/gate_eval/... from either
engine's phase table) survives the process boundary and can be grafted
back into the epoch's stored trace.

One field is the port's own: ``zk_device``.  The graft engine's device
is thread-local in the port (``zk.graft.use_zk_backend``), so a job
proved on a dispatcher thread or in a spawned process would lose the
node's device; the job carries it instead (``None`` = the card, which
raises where there is none; never a fallback to the CPU).
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import Any

#: Chaos hooks for crash-recovery tests and the prover-storm bench's
#: crash mix (the ingest plane's ``CRASH_MARKER`` analog):
#: ``CRASH_MARKER`` hard-kills the worker on every attempt;
#: ``crash_once_marker(path)`` kills the first attempt only (the retry
#: observes the flag file and proceeds) — the "worker killed mid-MSM →
#: retry → proved" scenario.
CRASH_MARKER = "__crash-prover__"
_CRASH_ONCE_PREFIX = "__crash-prover-once__:"

#: Proof lifecycle states (the ``GET /proof/<epoch>`` surface).
QUEUED = "queued"
PROVING = "proving"
PROVED = "proved"
FAILED = "failed"
SUPERSEDED = "superseded"


def crash_once_marker(flag_path: str) -> str:
    """Chaos spec that kills the worker once: the first attempt creates
    ``flag_path`` and dies; the retry sees it and proves normally."""
    return _CRASH_ONCE_PREFIX + flag_path


@dataclass(frozen=True)
class ProofJob:
    """One epoch's proving work, flattened for the process boundary.

    ``sigs``/``pks``/``ops`` are row-aligned per fixed-set member:
    ``sigs[i] = (R.x, R.y, s)``, ``pks[i] = (x, y)``, ``ops[i]`` the
    member's score row.  ``params`` is ``(num_neighbours, num_iter,
    initial_score, scale)`` — together with ``prover``/``srs_path``
    it keys the per-worker-process prover cache.
    """

    epoch: int
    ops: tuple[tuple[int, ...], ...]
    sigs: tuple[tuple[int, int, int], ...]
    pks: tuple[tuple[int, int], ...]
    params: tuple[int, int, int, int]
    prover: str = "plonk"
    srs_path: str | None = None
    check_circuit: bool = True
    #: Fingerprint of the open graph this epoch converged (identity /
    #: bookkeeping only — the fixed-set statement is fully determined
    #: by the payload above).
    graph_fingerprint: int = 0
    #: Chaos hook (tests/bench): CRASH_MARKER or crash_once_marker().
    chaos: str | None = None
    #: Proving-kernel backend (``zk.graft.VALID_BACKENDS``): ``native``
    #: (the host runtime) or ``graft`` (the hand-written card kernels).
    #: Execution selection only — both produce byte-identical proofs, so
    #: it is excluded from :func:`job_seed` like the other bookkeeping
    #: fields, and pooled proofs survive a backend switch unchanged.
    zk_backend: str = "native"
    #: Lineage IDs (obs/lineage.py) whose end-to-end freshness this
    #: epoch's proof completes — flat ints across the spawn boundary,
    #: echoed back on the :class:`ProofResult`.  ``()`` on the
    #: unsampled path.  Bookkeeping only: excluded from
    #: :func:`job_seed`, so sampling never perturbs proof bytes.
    lineage: tuple[int, ...] = ()
    #: The device the graft engine proves on (a ``torch.device`` string:
    #: ``"cuda:0"``, ``"cpu"``; ``None`` = the card, raising where there
    #: is none).  Filled by ``Manager.build_proof_job`` from the node's
    #: device; ignored under ``native``.  Bookkeeping like ``zk_backend``:
    #: excluded from :func:`job_seed`, so the proof bytes are the
    #: reference's.
    zk_device: str | None = None


@dataclass
class ProofResult:
    """What a prove returns across the process boundary."""

    epoch: int
    pub_ins: tuple[int, ...]
    proof: bytes
    #: Serialized span tree of the worker-side prove
    #: (``prove{power_iterate, circuit_check, snark{msm, ntt, ...}}``)
    #: — grafted into the epoch's stored trace by the plane.
    spans: dict[str, Any]
    prove_seconds: float
    #: The job's lineage IDs, echoed back flat (spawn-boundary proof
    #: that sampling survives the worker round-trip).
    lineage: tuple[int, ...] = ()
    #: The worker process's registry snapshot
    #: (``obs.fleet.registry_snapshot``) — merged into the parent's
    #: fleet aggregator under a ``process`` label.
    metrics: dict[str, Any] | None = None


def job_seed(job: ProofJob) -> bytes:
    """Deterministic PLONK blinding seed bound to the statement: same
    (epoch, params, ops, sigs, pks) → same seed → same proof bytes."""
    h = hashlib.sha256(b"protocol_tpu.prove.seed.v1")
    h.update(job.epoch.to_bytes(8, "big"))
    for p in job.params:
        h.update(int(p).to_bytes(8, "big"))
    for row in job.ops:
        for x in row:
            h.update(int(x).to_bytes(32, "big"))
    for rx, ry, s in job.sigs:
        h.update(int(rx).to_bytes(32, "big"))
        h.update(int(ry).to_bytes(32, "big"))
        h.update(int(s).to_bytes(32, "big"))
    for x, y in job.pks:
        h.update(int(x).to_bytes(32, "big"))
        h.update(int(y).to_bytes(32, "big"))
    return h.digest()


def job_fingerprint(job: ProofJob) -> str:
    """Stable hex id of the statement (logs/journal)."""
    return job_seed(job).hex()[:16]


def _run_chaos(chaos: str | None) -> None:
    if chaos is None:
        return
    if chaos == CRASH_MARKER:
        os._exit(1)
    if chaos.startswith(_CRASH_ONCE_PREFIX):
        flag = chaos[len(_CRASH_ONCE_PREFIX) :]
        if not os.path.exists(flag):
            try:
                with open(flag, "x"):
                    pass
            except FileExistsError:
                return
            os._exit(1)
    if chaos.startswith("sleep:"):
        time.sleep(float(chaos.split(":", 1)[1]))


# Per-process prover cache (the SRS/proving-key caching satellite): one
# Prover instance per (params, prover kind, srs_path), built on first
# use — or ahead of time by the pool prewarm — so repeated jobs skip
# SRS load and keygen entirely.  Worker processes are single-threaded
# job loops (one dispatcher feeds each worker one job at a time), so a
# plain dict needs no lock; the in-process path (workers=0) calls
# prove_job from exactly one dispatcher thread per pool.
_PROVERS: dict[tuple, Any] = {}


def prover_for(
    params: tuple[int, int, int, int],
    prover: str = "plonk",
    srs_path: str | None = None,
):
    """The cached per-process Prover for these protocol parameters."""
    key = (tuple(int(p) for p in params), prover, srs_path)
    inst = _PROVERS.get(key)
    if inst is None:
        if prover == "plonk":
            from ..zk.proof import PlonkEpochProver

            n, it, init, scale = key[0]
            inst = PlonkEpochProver(
                num_neighbours=n,
                num_iter=it,
                initial_score=init,
                scale=scale,
                srs_path=srs_path,
            )
        else:
            from ..zk.proof import PoseidonCommitmentProver

            inst = PoseidonCommitmentProver()
        _PROVERS[key] = inst
    return inst


def prove_job(job: ProofJob, *, verify: bool = True) -> ProofResult:
    """Prove one epoch statement (worker-side, or inline for
    ``workers=0``): rebuild the attestations from the flat payload,
    run ``power_iterate`` → circuit check → SNARK under a local span
    tree, and return the proof with its serialized attribution."""
    _run_chaos(job.chaos)

    from ..crypto.babyjubjub import Point
    from ..crypto.eddsa import PublicKey, Signature
    from ..node.attestation import Attestation
    from ..obs import TRACER
    from ..trust.native import power_iterate

    num_neighbours, num_iter, initial_score, scale = job.params
    pks = [PublicKey(Point(x, y)) for x, y in job.pks]
    atts = [
        Attestation(
            sig=Signature.new(rx, ry, s),
            pk=pk,
            neighbours=list(pks),
            scores=list(row),
        )
        for (rx, ry, s), pk, row in zip(job.sigs, pks, job.ops)
    ]
    ops = [list(row) for row in job.ops]
    prover = prover_for(job.params, job.prover, job.srs_path)

    from ..zk.graft import use_zk_backend

    t0 = time.perf_counter()
    with TRACER.span("prove", epoch=job.epoch, pooled=True) as root:
        with TRACER.span("power_iterate"):
            pub_ins = power_iterate(
                [initial_score] * num_neighbours, ops, num_iter, scale
            )
        witness: dict[str, Any] = {"ops": ops, "attestations": atts}
        if job.check_circuit:
            from ..zk.circuit import prove_epoch_statement

            with TRACER.span("circuit_check"):
                witness["cs"] = prove_epoch_statement(
                    atts,
                    pub_ins,
                    num_neighbours=num_neighbours,
                    num_iter=num_iter,
                    initial_score=initial_score,
                    scale=scale,
                )
        with TRACER.span("snark"), use_zk_backend(job.zk_backend, job.zk_device):
            proof_bytes = prover.prove(pub_ins, witness, seed=job_seed(job))
    if verify:
        assert prover.verify(pub_ins, proof_bytes), (
            f"epoch {job.epoch}: freshly produced proof failed verification"
        )
    from ..obs.fleet import registry_snapshot

    # PROVE_SECONDS is observed by the plane when the result lands
    # (once, whichever process proved); the worker's own registry ships
    # its span-fed phase histograms in the snapshot below.
    prove_seconds = time.perf_counter() - t0
    return ProofResult(
        epoch=job.epoch,
        pub_ins=tuple(pub_ins),
        proof=proof_bytes,
        spans=root.to_dict(),
        prove_seconds=prove_seconds,
        lineage=tuple(job.lineage),
        metrics=registry_snapshot(source=f"prover-{os.getpid()}"),
    )


__all__ = [
    "CRASH_MARKER",
    "FAILED",
    "PROVED",
    "PROVING",
    "QUEUED",
    "SUPERSEDED",
    "ProofJob",
    "ProofResult",
    "crash_once_marker",
    "job_fingerprint",
    "job_seed",
    "prove_job",
    "prover_for",
]

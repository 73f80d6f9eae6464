"""Proof jobs: the flat unit of work one epoch proof needs.

A :class:`ProofJob` carries everything one epoch proof needs as plain
integers and tuples — signature components, public-key coordinates,
score rows, the protocol parameters — so two jobs with equal payloads
are *the same statement*.

Determinism: :func:`job_seed` derives the proof's blinding seed from
the job payload itself (the RFC-6979 stance: deterministic nonces bound
to the witness), so proving the same statement twice gives the same
bytes.  :func:`prover_for` keeps one prover a process per (params,
prover kind, SRS), so repeated proofs skip SRS load and keygen.  The
proving plane that moves jobs across a process boundary (``prove_job``,
which also needs the fleet registry's snapshot) is not ported yet
(ROADMAP A5c (ii)).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any


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
    #: Chaos hook of the proving plane's workers (tests/bench).
    chaos: str | None = None
    #: Proving-kernel backend of the PLONK prover: ``native`` or
    #: ``graft`` (the card kernels, on the device the node hands the
    #: knob).  Execution selection only — both produce byte-identical proofs, so it is
    #: excluded from :func:`job_seed` like the other bookkeeping
    #: fields, and pooled proofs survive a backend switch unchanged.
    zk_backend: str = "native"
    #: Lineage IDs (obs/lineage.py) whose end-to-end freshness this
    #: epoch's proof completes — flat ints across the spawn boundary,
    #: echoed back on the :class:`ProofResult`.  ``()`` on the
    #: unsampled path.  Bookkeeping only: excluded from
    #: :func:`job_seed`, so sampling never perturbs proof bytes.
    lineage: tuple[int, ...] = ()


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


# Per-process prover cache: one Prover instance per (params, prover
# kind, srs_path), built on first use, so repeated jobs skip SRS load
# and keygen entirely.
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

"""Proof wire types, the Prover interface and the commitment prover.

``Proof``/``ProofRaw`` mirror circuit/src/lib.rs:258-292: public inputs
as field elements / 32-byte LE reprs plus opaque proof bytes, JSON round-
trippable in the same shape the reference serves from ``GET /score``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..crypto import field
from ..crypto import permute_one


@dataclass
class Proof:
    pub_ins: list[int]
    proof: bytes

    def to_raw(self, backend: str = "") -> "ProofRaw":
        return ProofRaw(
            pub_ins=[field.to_le_bytes(x) for x in self.pub_ins],
            proof=self.proof,
            backend=backend,
        )


@dataclass
class ProofRaw:
    pub_ins: list[bytes]
    proof: bytes
    #: Which prover produced ``proof``: "plonk" / "commitment" / ""
    #: (unknown — proof from a peer that predates the tag).  Serialized
    #: as an extra JSON key; absent on reference-format payloads, so
    #: round-tripping stays wire-compatible both ways.
    backend: str = ""

    def to_proof(self) -> Proof:
        return Proof(
            pub_ins=[field.from_le_bytes(x) for x in self.pub_ins], proof=self.proof
        )

    def to_json(self) -> str:
        # serde serializes [u8; 32] and Vec<u8> as JSON integer arrays.
        obj = {
            "pub_ins": [list(x) for x in self.pub_ins],
            "proof": list(self.proof),
        }
        if self.backend:
            obj["backend"] = self.backend
        return json.dumps(obj)

    @classmethod
    def from_json(cls, s: str) -> "ProofRaw":
        obj = json.loads(s)
        return cls(
            pub_ins=[bytes(x) for x in obj["pub_ins"]],
            proof=bytes(obj["proof"]),
            backend=obj.get("backend", ""),
        )


class Prover:
    """Produces proof bytes binding public inputs to a witness."""

    name = "abstract"
    #: Wire tag served in ProofRaw.backend so clients dispatch without
    #: sniffing proof bytes.  Empty = unknown; clients fall back to
    #: shape detection.
    wire_tag = ""

    def prove(
        self, pub_ins: list[int], witness: dict, *, seed: bytes | None = None
    ) -> bytes:
        """``seed`` (optional) derives the blinding randomness
        deterministically — the async proving plane passes a
        statement-bound seed (:func:`protocol_tpu_torch.prover.jobs.job_seed`)
        so pooled and in-process proofs of the same statement are
        byte-identical.  None keeps system-RNG blinding."""
        raise NotImplementedError

    def verify(self, pub_ins: list[int], proof: bytes) -> bool:
        raise NotImplementedError


class PoseidonCommitmentProver(Prover):
    """Poseidon commitment chain over the public inputs and witness ops.

    NOT zero-knowledge and NOT succinctness-equivalent to the reference's
    KZG proof — a deterministic binding commitment standing in for the
    PLONK prover.  The wire shape (opaque bytes alongside pub_ins)
    matches, so the node/client flow is end-to-end testable.  The
    domain tag is the reference's, so both packages commit to the same
    bytes.
    """

    name = "poseidon-commitment"
    wire_tag = "commitment"
    DOMAIN = (
        int.from_bytes(b"protocol_tpu.commit.v1".ljust(32, b"\0"), "little") % field.MODULUS
    )

    def _digest(self, pub_ins: list[int], witness: dict) -> int:
        acc = self.DOMAIN
        for x in pub_ins:
            acc = permute_one([acc, x, 1, 0, 0])[0]
        for row in witness.get("ops", []):
            for x in row:
                acc = permute_one([acc, x, 2, 0, 0])[0]
        return acc

    def prove(
        self, pub_ins: list[int], witness: dict, *, seed: bytes | None = None
    ) -> bytes:
        # Commitment proofs are deterministic already; seed is accepted
        # for interface uniformity and ignored.
        return field.to_le_bytes(self._digest(pub_ins, witness)) + json.dumps(
            {"ops": [[int(x) for x in row] for row in witness.get("ops", [])]}
        ).encode()

    def verify(self, pub_ins: list[int], proof: bytes) -> bool:
        if len(proof) < 32:
            return False
        digest, payload = proof[:32], proof[32:]
        try:
            witness = json.loads(payload.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return False
        return digest == field.to_le_bytes(self._digest(pub_ins, witness))

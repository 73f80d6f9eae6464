"""Proof aggregation: KZG accumulation over the Poseidon transcript.

The working analog of the reference's aggregator (circuit/src/verifier/
aggregator.rs — left unfinished upstream: TODOs at :61-67,183-187,266
and a ``without_witnesses`` that returns self): verifying k PLONK
proofs costs 2 pairings each; accumulation folds them into ONE pairing
check.  Each proof's deferred verification yields an accumulator pair
(B_i, A_i) with e(B_i, g2) == e(A_i, τ·g2) iff the proof is valid;
a random linear combination with challenges r_i squeezed from a
Poseidon transcript over every (vk digest, instances, proof) binds the
batch: e(Σ r_i B_i, g2) == e(Σ r_i A_i, τ·g2) holds with overwhelming
probability only when every member holds.

All member proofs must share one SRS (same g2 / τ·g2), which the epoch
flow guarantees (one params file per deployment, data/params-14.bin
analog).  The in-circuit half (proving this accumulation inside another
PLONK circuit, snark-verifier's halo2 Loader) is exactly the part the
reference never finished; this module delivers the native half as a
sound, tested batch verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .bn254 import G1
from .plonk import R, VerifyingKey, verify_deferred
from .transcript import PoseidonWrite


@dataclass
class Snark:
    """One proof bundle (verifier/aggregator.rs:70-105 Snark analog)."""

    vk: VerifyingKey
    instances: list[int] | dict[str, list[int]]
    proof: bytes
    transcript: str = "poseidon"

    def instance_values(self) -> list[int]:
        if isinstance(self.instances, dict):
            out: list[int] = []
            for name in self.vk.instance_names:
                out.extend(self.instances[name])
            return out
        return list(self.instances)


@dataclass
class Accumulator:
    """Pending pairing check: e(lhs, g2) == e(rhs, tau_g2)."""

    lhs: G1
    rhs: G1

    def to_bytes(self) -> bytes:
        return b"".join(
            c.to_bytes(32, "little")
            for c in (self.lhs.x, self.lhs.y, self.rhs.x, self.rhs.y)
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Accumulator":
        from .bn254 import is_on_curve
        from .rns import FQ_MODULUS

        if len(data) != 128:
            raise ValueError(f"accumulator must be 128 bytes, got {len(data)}")
        vals = [int.from_bytes(data[i : i + 32], "little") for i in range(0, 128, 32)]
        if any(v >= FQ_MODULUS for v in vals):
            raise ValueError("accumulator coordinate non-canonical")
        lhs, rhs = G1(vals[0], vals[1]), G1(vals[2], vals[3])
        for p in (lhs, rhs):
            if not is_on_curve(p):
                raise ValueError("accumulator point not on curve")
        return cls(lhs, rhs)


def proof_chunks(proof: bytes) -> list[int]:
    """A proof blob as 31-byte little-endian field-sized chunks — the
    transcript absorption unit shared by the native accumulator and the
    in-circuit fold (agg_circuit.synthesize_fold must absorb the exact
    same scalars)."""
    return [
        int.from_bytes(proof[i : i + 31], "little") for i in range(0, len(proof), 31)
    ]


def check_shared_srs(snarks: list[Snark]) -> None:
    """Soundness precondition — must survive python -O."""
    if not snarks:
        raise ValueError("nothing to accumulate")
    srs = snarks[0].vk.srs
    for s in snarks:
        if s.vk.srs.g2 != srs.g2 or s.vk.srs.tau_g2 != srs.tau_g2:
            raise ValueError("all member proofs must share one SRS")


def absorb_members(t, snarks: list[Snark]) -> None:
    """The member-binding absorption order (vk digest, instances,
    proof length, proof chunks) — one definition for the native
    accumulator AND the fold circuit's challenge derivation, so the
    two can never drift apart."""
    for s in snarks:
        t.common_scalar(s.vk.digest)
        for v in s.instance_values():
            t.common_scalar(v)
        t.common_scalar(len(s.proof))
        for chunk in proof_chunks(s.proof):
            t.common_scalar(chunk)


def accumulate(snarks: list[Snark]) -> Accumulator | None:
    """Fold the snarks' deferred pairing checks into one accumulator;
    None when any snark fails a non-pairing check (bad transcript,
    malformed points, constraint mismatch at the challenge)."""
    check_shared_srs(snarks)

    # Challenge transcript binds every member (Poseidon, like the
    # reference's PoseidonRead accumulation transcript).
    t = PoseidonWrite()
    absorb_members(t, snarks)

    lhs, rhs = G1(0, 0), G1(0, 0)
    for s in snarks:
        pair = verify_deferred(s.vk, s.instances, s.proof, s.transcript)
        if pair is None:
            return None
        b, a = pair
        r = t.squeeze_challenge()
        lhs = lhs.add(b.mul(r))
        rhs = rhs.add(a.mul(r))
    return Accumulator(lhs=lhs, rhs=rhs)


def finalize(acc: Accumulator, vk: VerifyingKey) -> bool:
    """The single decisive pairing check."""
    from .fields import pairing_check

    srs = vk.srs
    return pairing_check([(acc.lhs, srs.g2), (acc.rhs.neg(), srs.tau_g2)])


def aggregate_verify(snarks: list[Snark]) -> bool:
    """Batch-verify: k proofs, one pairing check."""
    acc = accumulate(snarks)
    if acc is None:
        return False
    return finalize(acc, snarks[0].vk)

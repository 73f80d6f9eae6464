"""Attestation domain object and its wire codec.

The byte layout must stay interoperable with the reference
(server/src/manager/attestation.rs:22-81): fixed 32-byte little-endian
field reprs in the order ``sig.R.x ‖ sig.R.y ‖ sig.s ‖ pk.x ‖ pk.y ‖
(neighbour x,y)×N ‖ score×N`` — the payload written into the
AttestationStation ``bytes`` value.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field
from ..crypto.eddsa import PublicKey, Signature


@dataclass
class Attestation:
    """A peer's signed score vector over its neighbours
    (attestation.rs:96-116)."""

    sig: Signature
    pk: PublicKey
    neighbours: list[PublicKey]
    scores: list[int]


@dataclass
class AttestationData:
    """Raw wire form (attestation.rs:9-18)."""

    sig_r_x: bytes
    sig_r_y: bytes
    sig_s: bytes
    pk: tuple[bytes, bytes]
    neighbours: list[tuple[bytes, bytes]]
    scores: list[bytes]

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += self.sig_r_x
        out += self.sig_r_y
        out += self.sig_s
        out += self.pk[0]
        out += self.pk[1]
        for nx, ny in self.neighbours:
            out += nx
            out += ny
        for s in self.scores:
            out += s
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes, num_neighbours: int) -> "AttestationData":
        """Parse the fixed layout; score count is whatever remains
        (attestation.rs:40-81 drains scores until empty)."""
        need = 32 * (5 + 2 * num_neighbours)
        if len(data) < need or len(data) % 32 != 0:
            raise ValueError(
                f"attestation payload must be 32-byte aligned and >= {need} bytes"
            )
        fields = [data[i : i + 32] for i in range(0, len(data), 32)]
        sig_r_x, sig_r_y, sig_s, pk_x, pk_y = fields[:5]
        rest = fields[5:]
        neighbours = [
            (rest[2 * i], rest[2 * i + 1]) for i in range(num_neighbours)
        ]
        scores = rest[2 * num_neighbours :]
        return cls(
            sig_r_x=sig_r_x,
            sig_r_y=sig_r_y,
            sig_s=sig_s,
            pk=(pk_x, pk_y),
            neighbours=neighbours,
            scores=scores,
        )

    @classmethod
    def from_attestation(cls, att: Attestation) -> "AttestationData":
        return cls(
            sig_r_x=field.to_le_bytes(att.sig.big_r.x),
            sig_r_y=field.to_le_bytes(att.sig.big_r.y),
            sig_s=field.to_le_bytes(att.sig.s),
            pk=att.pk.to_raw(),
            neighbours=[pk.to_raw() for pk in att.neighbours],
            scores=[field.to_le_bytes(s) for s in att.scores],
        )

    def to_attestation(self, num_neighbours: int) -> Attestation:
        """Decode, zero-filling missing neighbours/scores and truncating
        extras (attestation.rs:118-137)."""
        sig = Signature.new(
            field.from_le_bytes(self.sig_r_x),
            field.from_le_bytes(self.sig_r_y),
            field.from_le_bytes(self.sig_s),
        )
        pk = PublicKey.from_raw(self.pk)
        neighbours = [PublicKey.null()] * num_neighbours
        scores = [0] * num_neighbours
        for i, raw in enumerate(self.neighbours[:num_neighbours]):
            neighbours[i] = PublicKey.from_raw(raw)
        for i, raw in enumerate(self.scores[:num_neighbours]):
            scores[i] = field.from_le_bytes(raw)
        return Attestation(sig=sig, pk=pk, neighbours=neighbours, scores=scores)

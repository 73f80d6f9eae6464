"""Poseidon Fiat-Shamir transcript (verifier/transcript/native.rs:
PoseidonRead / PoseidonWrite re-built).

Prover and verifier absorb the same protocol messages — Fr scalars
directly, G1 points as their Fq coordinates decomposed into 4×68-bit
Fr limbs (the loader convention, verifier/loader/native.rs) — and
squeeze challenges from the sponge.  Writing also appends a canonical
byte encoding so a proof blob can be replayed by the reader.
"""

from __future__ import annotations

from ..crypto import field
from ..crypto.poseidon import PoseidonSponge
from .bn254 import G1, is_on_curve
from .rns import WrongFieldInteger


class PoseidonTranscript:
    """Shared sponge state machine."""

    def __init__(self):
        self.sponge = PoseidonSponge()
        self._absorbed = False

    def common_scalar(self, scalar: int) -> None:
        self.sponge.update([scalar % field.MODULUS])
        self._absorbed = True

    def common_point(self, point: G1) -> None:
        if not is_on_curve(point):
            raise ValueError("point not on curve")
        for coord in (point.x, point.y):
            self.sponge.update(WrongFieldInteger.from_value(coord).to_fr_limbs())
        self._absorbed = True

    def squeeze_challenge(self) -> int:
        """Squeeze a challenge; re-absorbs it so successive challenges
        chain (the sponge keeps state across squeezes)."""
        if not self._absorbed:
            # Domain-separate an empty transcript.
            self.sponge.update([0])
        c = self.sponge.squeeze()
        self.sponge.update([c])
        self._absorbed = True
        return c


class PoseidonWrite(PoseidonTranscript):
    """Prover side: absorb + serialize."""

    def __init__(self):
        super().__init__()
        self._buf = bytearray()

    def write_scalar(self, scalar: int) -> None:
        self.common_scalar(scalar)
        self._buf += field.to_le_bytes(scalar % field.MODULUS)

    def write_point(self, point: G1) -> None:
        self.common_point(point)
        self._buf += point.x.to_bytes(32, "little")
        self._buf += point.y.to_bytes(32, "little")

    def finalize(self) -> bytes:
        return bytes(self._buf)


class KeccakTranscript:
    """Keccak Fiat-Shamir transcript — the EVM-flow analog of the
    reference's snark-verifier ``EvmTranscript`` (used by gen_proof for
    on-chain verification, verifier/mod.rs:70-83): scalars and point
    coordinates absorb as 32-byte big-endian words (EVM word order),
    and challenges are keccak256(state ‖ pending) reduced mod Fr, so a
    generated verifier contract replays the transcript with the native
    KECCAK256 opcode instead of ~60 Poseidon rounds per absorb."""

    def __init__(self):
        self.state = b"\0" * 32
        self.pending = bytearray()

    def common_scalar(self, scalar: int) -> None:
        self.pending += (scalar % field.MODULUS).to_bytes(32, "big")

    def common_point(self, point: G1) -> None:
        if not is_on_curve(point):
            raise ValueError("point not on curve")
        self.pending += point.x.to_bytes(32, "big")
        self.pending += point.y.to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        from ..crypto.keccak import keccak256

        digest = keccak256(self.state + bytes(self.pending))
        self.state = digest
        self.pending.clear()
        return int.from_bytes(digest, "big") % field.MODULUS


class KeccakWrite(KeccakTranscript):
    """Prover side: absorb + serialize (big-endian wire format)."""

    def __init__(self):
        super().__init__()
        self._buf = bytearray()

    def write_scalar(self, scalar: int) -> None:
        self.common_scalar(scalar)
        self._buf += (scalar % field.MODULUS).to_bytes(32, "big")

    def write_point(self, point: G1) -> None:
        self.common_point(point)
        self._buf += point.x.to_bytes(32, "big")
        self._buf += point.y.to_bytes(32, "big")

    def finalize(self) -> bytes:
        return bytes(self._buf)


class KeccakRead(KeccakTranscript):
    """Verifier side: replay a big-endian proof blob."""

    def __init__(self, proof: bytes):
        super().__init__()
        self._buf = proof
        self._off = 0

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._buf):
            raise ValueError("transcript exhausted")
        out = self._buf[self._off : self._off + n]
        self._off += n
        return out

    def read_scalar(self) -> int:
        raw = int.from_bytes(self._take(32), "big")
        if raw >= field.MODULUS:
            raise ValueError("non-canonical scalar encoding")
        self.common_scalar(raw)
        return raw

    def read_point(self) -> G1:
        from .rns import FQ_MODULUS

        x = int.from_bytes(self._take(32), "big")
        y = int.from_bytes(self._take(32), "big")
        if x >= FQ_MODULUS or y >= FQ_MODULUS:
            raise ValueError("non-canonical point encoding")
        point = G1(x, y)
        self.common_point(point)
        return point


class PoseidonRead(PoseidonTranscript):
    """Verifier side: replay a proof blob, re-deriving the identical
    challenge stream."""

    def __init__(self, proof: bytes):
        super().__init__()
        self._buf = proof
        self._off = 0

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._buf):
            raise ValueError("transcript exhausted")
        out = self._buf[self._off : self._off + n]
        self._off += n
        return out

    def read_scalar(self) -> int:
        scalar = field.from_le_bytes(self._take(32))
        self.common_scalar(scalar)
        return scalar

    def read_point(self) -> G1:
        x = int.from_bytes(self._take(32), "little")
        y = int.from_bytes(self._take(32), "little")
        # Canonicality mirrors field.from_le_bytes: a coordinate >= Fq
        # would alias another point mod Q (proof malleability) and break
        # affine arithmetic downstream.
        from .rns import FQ_MODULUS

        if x >= FQ_MODULUS or y >= FQ_MODULUS:
            raise ValueError("non-canonical point encoding")
        point = G1(x, y)
        self.common_point(point)
        return point

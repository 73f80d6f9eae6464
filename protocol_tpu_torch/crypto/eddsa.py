"""EdDSA over BabyJubJub with Poseidon as the internal hash.

Semantics match circuit/src/eddsa/native.rs exactly:

- secret keys are two Fr elements; random generation hashes a random field
  element with BLAKE-512 and reduces each 32-byte half wide
  (eddsa/native.rs:47-56),
- ``sign``: r = Poseidon(0, sk1, m, 0, 0); R = B8*r;
  S = r + Poseidon(R‖PK‖m)*sk0 mod suborder (eddsa/native.rs:106-127),
- ``verify``: reject S > suborder, check B8*S == R + PK*H(R‖PK‖m)
  (eddsa/native.rs:130-147).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..utils.codec import b58decode, to_short
from . import field
from .babyjubjub import B8, SUBORDER, Point
from .blake512 import blake512
from .poseidon import permute


@dataclass(frozen=True)
class SecretKey:
    """Two-part secret key (sk0 signs, sk1 seeds the nonce)."""

    sk0: int
    sk1: int

    @classmethod
    def from_raw(cls, parts: tuple[bytes, bytes]) -> "SecretKey":
        return cls(field.from_le_bytes(parts[0]), field.from_le_bytes(parts[1]))

    def to_raw(self) -> tuple[bytes, bytes]:
        return (field.to_le_bytes(self.sk0), field.to_le_bytes(self.sk1))

    @classmethod
    def from_bs58(cls, sk0_b58: str, sk1_b58: str) -> "SecretKey":
        """Decode the reference's bs58 secret-key pairs
        (server/src/utils.rs:27-50: raw 32-byte canonical reprs)."""
        return cls.from_raw((to_short(b58decode(sk0_b58)), to_short(b58decode(sk1_b58))))

    @classmethod
    def random(cls, rng=secrets) -> "SecretKey":
        a = (
            rng.randbelow(field.MODULUS)
            if hasattr(rng, "randbelow")
            else rng.randrange(field.MODULUS)
        )
        h = blake512(field.to_le_bytes(a))
        return cls(field.from_wide_bytes(h[:32]), field.from_wide_bytes(h[32:]))

    def public(self) -> "PublicKey":
        return PublicKey(B8.mul_scalar(self.sk0).affine())


@dataclass(frozen=True)
class PublicKey:
    point: Point

    @classmethod
    def from_raw(cls, parts: tuple[bytes, bytes]) -> "PublicKey":
        return cls(Point(field.from_le_bytes(parts[0]), field.from_le_bytes(parts[1])))

    def to_raw(self) -> tuple[bytes, bytes]:
        return (field.to_le_bytes(self.point.x), field.to_le_bytes(self.point.y))

    @classmethod
    def null(cls) -> "PublicKey":
        """PublicKey::default() — the (0,0) sentinel for empty set slots."""
        return cls(Point(0, 0))

    def is_null(self) -> bool:
        return self.point.x == 0 and self.point.y == 0

    def hash(self) -> int:
        """Poseidon(pk.x, pk.y, 0, 0, 0) — the pk-hash used as the
        attestation cache key and group identifier
        (server/src/manager/mod.rs:101-120)."""
        return permute([self.point.x, self.point.y, 0, 0, 0])[0]


@dataclass(frozen=True)
class Signature:
    big_r: Point
    s: int

    @classmethod
    def new(cls, r_x: int, r_y: int, s: int) -> "Signature":
        return cls(Point(r_x, r_y), s)


def sign(sk: SecretKey, pk: PublicKey, m: int) -> Signature:
    r = permute([0, sk.sk1, m, 0, 0])[0]
    big_r = B8.mul_scalar(r).affine()
    m_hash = permute([big_r.x, big_r.y, pk.point.x, pk.point.y, m])[0]
    # Integer (not field) arithmetic mod the suborder, on canonical reprs.
    s = (r + sk.sk0 * m_hash) % SUBORDER
    return Signature(big_r, s)


def verify(sig: Signature, pk: PublicKey, m: int) -> bool:
    if sig.s > SUBORDER:
        return False
    cl = B8.mul_scalar(sig.s)
    m_hash = permute([sig.big_r.x, sig.big_r.y, pk.point.x, pk.point.y, m])[0]
    pk_h = pk.point.mul_scalar(m_hash)
    cr = sig.big_r.projective().add(pk_h)
    return cr.affine() == cl.affine()

"""Bn254 (alt_bn128) G1 arithmetic over the base field Fq.

The proving stack's curve side (the reference gets this from
halo2curves; circuit/src/ecc/native.rs re-implements it over emulated
limbs for the aggregation circuit).  Used by the Poseidon transcript
(absorbing commitment points) and the future KZG layer.

y² = x³ + 3 over Fq; G1 generator (1, 2).
"""

from __future__ import annotations

from typing import NamedTuple

from .rns import FQ_MODULUS as Q

B = 3


class G1(NamedTuple):
    """Affine point; (0, 0) is the identity sentinel (matching the
    reference's EcPoint zero handling)."""

    x: int
    y: int

    def is_identity(self) -> bool:
        return self.x == 0 and self.y == 0

    def neg(self) -> "G1":
        if self.is_identity():
            return self
        return G1(self.x, (-self.y) % Q)

    def double(self) -> "G1":
        if self.is_identity() or self.y == 0:
            return IDENTITY
        lam = (3 * self.x * self.x) * pow(2 * self.y, -1, Q) % Q
        x3 = (lam * lam - 2 * self.x) % Q
        y3 = (lam * (self.x - x3) - self.y) % Q
        return G1(x3, y3)

    def add(self, other: "G1") -> "G1":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        if self.x == other.x:
            if (self.y + other.y) % Q == 0:
                return IDENTITY
            return self.double()
        lam = (other.y - self.y) * pow(other.x - self.x, -1, Q) % Q
        x3 = (lam * lam - self.x - other.x) % Q
        y3 = (lam * (self.x - x3) - self.y) % Q
        return G1(x3, y3)

    def mul(self, scalar: int) -> "G1":
        """Double-and-add over the scalar's bits (ecc/native.rs ladder
        semantics; not constant-time — verification-side use only)."""
        result = IDENTITY
        addend = self
        s = scalar
        while s:
            if s & 1:
                result = result.add(addend)
            addend = addend.double()
            s >>= 1
        return result


IDENTITY = G1(0, 0)
GENERATOR = G1(1, 2)

#: G1 group order equals the scalar field modulus Fr.
from ..crypto.field import MODULUS as GROUP_ORDER  # noqa: E402


def is_on_curve(p: G1) -> bool:
    if p.is_identity():
        return True
    return (p.y * p.y - (p.x**3 + B)) % Q == 0

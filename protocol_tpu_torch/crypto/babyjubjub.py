"""BabyJubJub twisted Edwards curve over Bn254 Fr.

ax^2 + y^2 = 1 + d x^2 y^2 with a = 168700, d = 168696, matching the
reference's curve parameters and projective formulas
(circuit/src/edwards/params.rs:46-114 for the constants and
add/double-2008-bbjlp, circuit/src/edwards/native.rs for the point API).
Points are immutable (x, y[, z]) tuples of field ints.
"""

from __future__ import annotations

from typing import NamedTuple

from . import field
from .field import MODULUS as P

# Curve coefficients (edwards/params.rs:47-53).
A = 0x292FC
D = 0x292F8

# The prime-order subgroup generator B8 (edwards/params.rs:55-64,
# from_raw 4x64 little-endian limbs composed into integers).
B8_X = 0x0BB77A6AD63E739B4EACB2E09D6277C12AB8D8010534E0B62893F3F6BB957051
B8_Y = 0x25797203F7A0B24925572E1CD16BF9EDFCE0051FB9E133774B3C257A872D7D8B

# Full-group generator G (edwards/params.rs:66-75).
G_X = 0x023343E3445B673D38BCBA38F25645ADB494B1255B1162BB40F41A59F4D4B45E
G_Y = 0x0C19139CB84C680A6E14116DA06056174A0CFA121E6E5C2450F87D64FC000001

# Order of the prime subgroup (edwards/params.rs:77-81).
SUBORDER = 0x060C89CE5C263405370A08B6D0302B0BAB3EEDB83920EE0A677297DC392126F1
SUBORDER_SIZE = 252


class Point(NamedTuple):
    """Affine point (edwards/native.rs::Point)."""

    x: int
    y: int

    def projective(self) -> "PointProjective":
        return PointProjective(self.x, self.y, 1)

    def mul_scalar(self, scalar: int) -> "PointProjective":
        """LSB-first double-and-add over the 256-bit canonical repr of the
        scalar (edwards/native.rs:74-87)."""
        r = PointProjective(0, 1, 1)
        exp = self.projective()
        s = scalar % P
        for _ in range(256):
            if s & 1:
                r = r.add(exp)
            exp = exp.double()
            s >>= 1
        return r

    def is_identity(self) -> bool:
        return self.x == 0 and self.y == 0


#: PublicKey::default() / the "null peer" marker is the (0, 0) point,
#: which is *not* on the curve — it acts purely as a sentinel
#: (eddsa/native.rs:68, native.rs filter semantics).
IDENTITY = Point(0, 0)


class PointProjective(NamedTuple):
    """Projective point (edwards/native.rs::PointProjective)."""

    x: int
    y: int
    z: int

    def affine(self) -> Point:
        if self.z % P == 0:
            return Point(0, 0)
        zinv = field.inv(self.z)
        return Point((self.x * zinv) % P, (self.y * zinv) % P)

    def double(self) -> "PointProjective":
        # dbl-2008-bbjlp (edwards/params.rs double()).
        x1, y1, z1 = self.x, self.y, self.z
        b = pow(x1 + y1, 2, P)
        c = (x1 * x1) % P
        d = (y1 * y1) % P
        e = (A * c) % P
        f = (e + d) % P
        h = (z1 * z1) % P
        j = (f - 2 * h) % P
        x3 = ((b - c - d) * j) % P
        y3 = (f * (e - d)) % P
        z3 = (f * j) % P
        return PointProjective(x3, y3, z3)

    def add(self, q: "PointProjective") -> "PointProjective":
        # add-2008-bbjlp (edwards/params.rs:89-113).
        a = (self.z * q.z) % P
        b = (a * a) % P
        c = (self.x * q.x) % P
        d = (self.y * q.y) % P
        e = (D * c * d) % P
        f = (b - e) % P
        g = (b + e) % P
        x3 = (a * f * ((self.x + self.y) * (q.x + q.y) - c - d)) % P
        y3 = (a * g * (d - A * c)) % P
        z3 = (f * g) % P
        return PointProjective(x3, y3, z3)


B8 = Point(B8_X, B8_Y)
G = Point(G_X, G_Y)


def is_on_curve(p: Point) -> bool:
    """Check a*x^2 + y^2 == 1 + d*x^2*y^2."""
    x2 = (p.x * p.x) % P
    y2 = (p.y * p.y) % P
    return (A * x2 + y2) % P == (1 + D * x2 % P * y2) % P

"""Bn254 extension-field tower, G2, and the optimal-ate pairing.

The reference gets all of this from `halo2curves::bn256` (used by the
KZG commitment scheme in circuit/src/utils.rs:259-303 and the
snark-verifier loaders, verifier/loader/native.rs).  This is a fresh
implementation of the public alt_bn128 parameters (EIP-196/197):

    Fq2  = Fq[u] / (u² + 1)
    Fq12 = Fq[w] / (w¹² − 18·w⁶ + 82)      (u ≡ w⁶ − 9)

G2 lives on the D-twist y² = x³ + 3/(9+u) over Fq2.  The pairing is
the ate pairing with loop count 6t+2 (t = 4965661367192848881),
implemented py_ecc-style: untwist Q into Fq12 and run the Miller loop
with affine line functions, then final-exponentiate.

Pure Python: the pairing only runs a handful of times per proof
verification (KZG check), never in the proving hot path.
"""

from __future__ import annotations

from typing import NamedTuple

from ..crypto.field import MODULUS as R  # Fr — the G1/G2 group order
from .rns import FQ_MODULUS as Q

# Curve parameter t; the ate loop count is 6t+2.
T_PARAM = 4965661367192848881
ATE_LOOP_COUNT = 6 * T_PARAM + 2  # 29793968203157093288

# Fq12 modulus polynomial w^12 - 18 w^6 + 82 as low-degree coeffs.
_FQ12_MOD = [82] + [0] * 5 + [-18] + [0] * 5


class FQP:
    """Element of Fq[w]/(m) for an arbitrary sparse monic modulus."""

    __slots__ = ("coeffs",)
    degree = 12
    mod_coeffs = _FQ12_MOD

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c % Q for c in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __eq__(self, other):
        return isinstance(other, FQP) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(tuple(self.coeffs))

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    def scale(self, k: int):
        return type(self)([c * k for c in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scale(other)
        d = self.degree
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(other.coeffs):
                    prod[i + j] += a * b
        # Reduce by the monic modulus: w^d = -mod_coeffs.
        for i in range(2 * d - 2, d - 1, -1):
            top = prod[i]
            if top:
                for j, m in enumerate(self.mod_coeffs):
                    if m:
                        prod[i - d + j] -= top * m
        return type(self)([c % Q for c in prod[:d]])

    def square(self):
        return self * self

    def pow(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[w] against the modulus polynomial."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = [m % Q for m in self.mod_coeffs] + [1]
        while _deg(low):
            r = _poly_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm, new = list(hm), list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv0 = pow(low[0], -1, Q)
        return type(self)([c * inv0 % Q for c in lm[:d]])

    def __repr__(self):
        return f"FQP{self.coeffs}"


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_div(a, b):
    """Quotient of polynomial division over Fq (py_ecc's poly_rounded_div)."""
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * len(a)
    binv = pow(b[degb], -1, Q)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % Q
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % Q
    return [x % Q for x in out[: _deg(out) + 1]]


class FQ2(FQP):
    """Fq[u]/(u²+1) — the G2 coordinate field."""

    degree = 2
    mod_coeffs = [1, 0]


FQ2_ONE = FQ2([1, 0])
FQ2_ZERO = FQ2([0, 0])

# Twist curve constant b2 = 3 / (9 + u).
B2 = FQ2([3, 0]) * FQ2([9, 1]).inv()


class G2(NamedTuple):
    """Affine point on the twist; None coords encode the identity."""

    x: FQ2 | None
    y: FQ2 | None

    def is_identity(self) -> bool:
        return self.x is None

    def neg(self) -> "G2":
        if self.is_identity():
            return self
        return G2(self.x, -self.y)

    def double(self) -> "G2":
        if self.is_identity():
            return self
        x, y = self.x, self.y
        if y.is_zero():
            return G2_IDENTITY
        lam = x.square().scale(3) * y.scale(2).inv()
        x3 = lam.square() - x.scale(2)
        y3 = lam * (x - x3) - y
        return G2(x3, y3)

    def add(self, other: "G2") -> "G2":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        if self.x == other.x:
            if (self.y + other.y).is_zero():
                return G2_IDENTITY
            return self.double()
        lam = (other.y - self.y) * (other.x - self.x).inv()
        x3 = lam.square() - self.x - other.x
        y3 = lam * (self.x - x3) - self.y
        return G2(x3, y3)

    def mul(self, scalar: int) -> "G2":
        # No mod-R reduction: g2_in_subgroup relies on mul(R) acting as
        # the integer R on points of unknown order (the twist's cofactor
        # is > 1, so out-of-subgroup points exist on-curve).
        result = G2_IDENTITY
        addend = self
        s = scalar
        while s:
            if s & 1:
                result = result.add(addend)
            addend = addend.double()
            s >>= 1
        return result


G2_IDENTITY = G2(None, None)

#: Standard alt_bn128 G2 generator (EIP-197 / halo2curves bn256 G2Affine::generator).
G2_GENERATOR = G2(
    FQ2(
        [
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ]
    ),
    FQ2(
        [
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ]
    ),
)


def g2_is_on_curve(p: G2) -> bool:
    if p.is_identity():
        return True
    return p.y.square() == p.x.square() * p.x + B2


def g2_in_subgroup(p: G2) -> bool:
    """Order-r check (the twist has cofactor > 1, so on-curve alone is
    not enough for untrusted G2 inputs)."""
    return p.mul(R).is_identity()


# -- untwist into Fq12 -------------------------------------------------

# Embedding Fq2 -> Fq12 sends u to w^6 - 9.  An Fq2 element a + b·u maps
# to (a - 9b) + b·w^6.  The untwist scales x by w^2 and y by w^3, which
# lands on y^2 = x^3 + 3 over Fq12 (since w^6 = 9 + u = xi, the twist
# constant 3/xi picks up exactly xi).

_W2 = FQP([0] * 2 + [1] + [0] * 9)
_W3 = FQP([0] * 3 + [1] + [0] * 8)


def _embed_fq2(e: FQ2) -> FQP:
    a, b = e.coeffs
    coeffs = [0] * 12
    coeffs[0] = (a - 9 * b) % Q
    coeffs[6] = b
    return FQP(coeffs)


def untwist(p: G2) -> tuple[FQP, FQP]:
    assert not p.is_identity()
    return _embed_fq2(p.x) * _W2, _embed_fq2(p.y) * _W3


def _embed_fq(a: int) -> FQP:
    return FQP([a] + [0] * 11)


# -- Miller loop -------------------------------------------------------


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 (Fq12 affine pairs) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 - x2).is_zero():
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = x1.square().scale(3) * y1.scale(2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _ec_double(p):
    x, y = p
    m = x.square().scale(3) * y.scale(2).inv()
    nx = m.square() - x.scale(2)
    ny = m * (x - nx) - y
    return (nx, ny)


def _ec_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _ec_double(p1)
    m = (y2 - y1) * (x2 - x1).inv()
    nx = m.square() - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def _frobenius_pt(p):
    """(x^q, y^q) on the untwisted curve — the q-power endomorphism."""
    x, y = p
    return (x.pow(Q), y.pow(Q))


def miller_loop(q: G2, p) -> FQP:
    """f_{6t+2,Q}(P) with the two frobenius correction steps.

    ``p`` is a bn254.G1 affine point; identity inputs short-circuit to 1
    (pairing with identity is the unit, halo2curves semantics).
    """
    if q.is_identity() or p.is_identity():
        return FQP.one()
    qx, qy = untwist(q)
    pt = (_embed_fq(p.x), _embed_fq(p.y))
    r = (qx, qy)
    f = FQP.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r, r, pt)
        r = _ec_double(r)
        if (ATE_LOOP_COUNT >> i) & 1:
            f = f * _linefunc(r, (qx, qy), pt)
            r = _ec_add(r, (qx, qy))
    q1 = _frobenius_pt((qx, qy))
    nq2 = _frobenius_pt(q1)
    nq2 = (nq2[0], -nq2[1])
    f = f * _linefunc(r, q1, pt)
    r = _ec_add(r, q1)
    f = f * _linefunc(r, nq2, pt)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def final_exponentiation(f: FQP) -> FQP:
    """f^((q^12-1)/r), easy part via conjugation + inversion, hard part
    by direct square-and-multiply (short enough in Python)."""
    # Easy part: f^(q^6 - 1) = conj(f) / f, then ^(q^2 + 1).
    conj = FQP(
        [c if i % 2 == 0 else (-c) % Q for i, c in enumerate(f.coeffs)]
    )  # w -> -w is the q^6 frobenius on this tower
    f = conj * f.inv()
    f = f.pow(Q * Q) * f
    # Hard part.
    return f.pow((Q**4 - Q**2 + 1) // R)


def pairing(q: G2, p) -> FQP:
    """e(P, Q) — the full optimal-ate pairing."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """Π e(P_i, Q_i) == 1 with one shared final exponentiation — the
    multi-pairing the KZG verifier uses (2 pairs)."""
    acc = FQP.one()
    for p, q in pairs:
        acc = acc * miller_loop(q, p)
    return final_exponentiation(acc) == FQP.one()

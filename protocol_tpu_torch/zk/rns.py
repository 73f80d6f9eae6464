"""Non-native ("wrong field") arithmetic: Bn254 base-field Fq emulated
in 4×68-bit limbs over the scalar field Fr.

Parity with circuit/src/integer/{rns.rs,native.rs}: the aggregation
pipeline must express G1 coordinates (Fq elements) as Fr limb vectors
and prove add/sub/mul/div relations through quotient/residue reduction
witnesses.  This module is the native half — it produces and checks the
witnesses the future in-circuit chips will constrain.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field

#: Bn254 base-field modulus (the curve's coordinate field Fq — the
#: "wrong" field when working over Fr).
FQ_MODULUS = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

NUM_LIMBS = 4
LIMB_BITS = 68
LIMB_MASK = (1 << LIMB_BITS) - 1


def decompose(value: int, n_limbs: int = NUM_LIMBS, bits: int = LIMB_BITS) -> tuple[int, ...]:
    """Split into little-endian fixed-width limbs (rns.rs decompose_big)."""
    assert 0 <= value < 1 << (n_limbs * bits)
    return tuple((value >> (bits * i)) & ((1 << bits) - 1) for i in range(n_limbs))


def compose(limbs: tuple[int, ...], bits: int = LIMB_BITS) -> int:
    """Inverse of decompose (rns.rs compose_big)."""
    return sum(limb << (bits * i) for i, limb in enumerate(limbs))


@dataclass(frozen=True)
class ReductionWitness:
    """The quotient/result pair proving ``lhs ∘ rhs ≡ result + q·Fq``
    (integer/native.rs::ReductionWitness).  ``quotient`` is small for
    add/sub and a full integer for mul/div."""

    result: "WrongFieldInteger"
    quotient: tuple[int, ...]
    op: str

    def check(self, a: "WrongFieldInteger", b: "WrongFieldInteger") -> bool:
        """Native verification of the reduction identity over the
        integers (what the in-circuit chips constrain limb-wise)."""
        q = compose(self.quotient)
        r = self.result.value()
        if self.op == "add":
            return a.value() + b.value() == q * FQ_MODULUS + r
        if self.op == "sub":
            return a.value() + q * FQ_MODULUS - b.value() == r
        if self.op == "mul":
            return a.value() * b.value() == q * FQ_MODULUS + r
        if self.op == "div":
            # a / b = r  ⇔  b·r = a + q·p
            return b.value() * r == a.value() + q * FQ_MODULUS
        raise ValueError(self.op)


@dataclass(frozen=True)
class WrongFieldInteger:
    """An Fq element as 4×68-bit limbs (integer/native.rs::Integer)."""

    limbs: tuple[int, ...]

    @classmethod
    def from_value(cls, value: int) -> "WrongFieldInteger":
        return cls(decompose(value % FQ_MODULUS))

    def value(self) -> int:
        return compose(self.limbs)

    def to_fr_limbs(self) -> tuple[int, ...]:
        """The limbs as Fr elements (each < 2^68 « Fr modulus), the form
        the loaders absorb into transcripts."""
        return tuple(limb % field.MODULUS for limb in self.limbs)

    def add(self, other: "WrongFieldInteger") -> ReductionWitness:
        total = self.value() + other.value()
        q, r = divmod(total, FQ_MODULUS)
        return ReductionWitness(
            result=WrongFieldInteger(decompose(r)), quotient=decompose(q), op="add"
        )

    def sub(self, other: "WrongFieldInteger") -> ReductionWitness:
        diff = (self.value() - other.value()) % FQ_MODULUS
        # One borrowed modulus at most, since both operands are < p.
        q = 1 if self.value() < other.value() else 0
        return ReductionWitness(
            result=WrongFieldInteger(decompose(diff)), quotient=decompose(q), op="sub"
        )

    def mul(self, other: "WrongFieldInteger") -> ReductionWitness:
        prod = self.value() * other.value()
        q, r = divmod(prod, FQ_MODULUS)
        return ReductionWitness(
            result=WrongFieldInteger(decompose(r)), quotient=decompose(q), op="mul"
        )

    def div(self, other: "WrongFieldInteger") -> ReductionWitness:
        inv = pow(other.value(), -1, FQ_MODULUS)
        r = (self.value() * inv) % FQ_MODULUS
        # b·r = a + q·p
        q = (other.value() * r - self.value()) // FQ_MODULUS
        return ReductionWitness(
            result=WrongFieldInteger(decompose(r)), quotient=decompose(q), op="div"
        )

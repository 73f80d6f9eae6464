"""In-circuit EdDSA verification (eddsa/mod.rs::EddsaChipset re-built on
this framework's gadgets).

Constrains the native `verify` (eddsa/native.rs:130-147) exactly:
s ≤ suborder, Cl = B8·s, M = Poseidon(R ‖ PK ‖ m),
Cr = R + PK·M, affine(Cr) == affine(Cl) via cross-multiplied projective
equality.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.babyjubjub import B8, SUBORDER
from .cs import Cell, ConstraintSystem
from .gadgets import Bits2NumChip, EdwardsChip, LessEqChip, PoseidonChip, StdGate


@dataclass
class EddsaChipset:
    cs: ConstraintSystem
    std: StdGate
    edwards: EdwardsChip
    poseidon: PoseidonChip
    b2n: Bits2NumChip

    def verify(
        self,
        pk: tuple[Cell, Cell],
        big_r: tuple[Cell, Cell],
        s: Cell,
        message: Cell,
    ) -> None:
        std = self.std
        one = std.constant(1)
        lessq = LessEqChip(self.cs, std, self.b2n)

        # s ≤ suborder (the reference's lt_eq over the 252-bit suborder).
        suborder = std.constant(SUBORDER)
        lessq.assert_le(s, suborder)

        # Cl = B8 · s.  252 ladder bits: s ≤ suborder < 2^252, and
        # s + P needs 254 bits, so the bit pattern is forced canonical.
        b8 = (std.constant(B8.x), std.constant(B8.y), one)
        cl = self.edwards.scalar_mul(b8, s, n_bits=252)

        # M = Poseidon(R.x, R.y, PK.x, PK.y, m)
        m_hash = self.poseidon.permute(
            [big_r[0], big_r[1], pk[0], pk[1], message]
        )[0]

        # Cr = R + PK·M.  M is a full field element, so the ladder needs
        # the strict (< P) canonical-bits check.
        pk_proj = (pk[0], pk[1], one)
        pk_h = self.edwards.scalar_mul(
            pk_proj, m_hash, n_bits=254, strict=True, std=std, lessq=lessq
        )
        r_proj = (big_r[0], big_r[1], one)
        cr = self.edwards.add_points(r_proj, pk_h)

        # affine(Cr) == affine(Cl):  Cr.x·Cl.z = Cl.x·Cr.z  and same
        # for y (z values are nonzero for valid signatures; a zero z
        # would make both sides 0 only if the other coordinate is 0 too).
        std.assert_equal(std.mul(cr[0], cl[2]), std.mul(cl[0], cr[2]))
        std.assert_equal(std.mul(cr[1], cl[2]), std.mul(cl[1], cr[2]))

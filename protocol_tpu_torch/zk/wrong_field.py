"""In-circuit non-native ("wrong field") arithmetic and emulated-Fq
elliptic-curve chips.

The in-circuit half of zk/rns.py — parity with the reference's
`integer/mod.rs:85-650` (IntegerAdd/Sub/Mul/Div chips over the
`Bn256_4_68` RNS) and `ecc/mod.rs:50-828` (G1 in emulated Fq), rebuilt
on this framework's ConstraintSystem/StdGate stack.  An Fq element
lives as 4×68-bit limb cells over Fr; every operation constrains the
reduction identity ``a ∘ b = q·p + r`` two ways:

- **native**: composed limbs checked mod Fr with one arithmetic row;
- **binary**: 136-bit CRT chunks ``t − r ≡ 0 (mod 2^272)`` with
  witnessed, range-checked carries (the reference's
  `constrain_binary_crt_exp`, rns.rs:331-350 — the rebuild additionally
  range-checks limbs and carries, which the unfinished reference
  aggregator never wired up).

Together the two residue systems pin the identity over the integers
(values < 2^512 « 2^272·Fr), so limb equality means Fq equality for
canonical (fully-reduced) values — and every chip output here is the
canonical remainder, so equality checks are plain limb equality.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field
from .chips import RangeCheckChip
from .cs import Cell, ConstraintSystem
from .gadgets import Bits2NumChip, StdGate
from .rns import FQ_MODULUS, LIMB_BITS, NUM_LIMBS, compose, decompose

P = field.MODULUS

#: 2^272 − FQ_MODULUS, decomposed — the reference's
#: `negative_wrong_modulus_decomposed` (rns.rs).
_P_PRIME = decompose((1 << (NUM_LIMBS * LIMB_BITS)) - FQ_MODULUS)
#: FQ_MODULUS mod Fr — the native-row modulus constant.
_P_IN_N = FQ_MODULUS % P
#: Limb weights mod Fr.
_SHIFT = [pow(2, LIMB_BITS * i, P) for i in range(NUM_LIMBS)]

#: Reduced values keep their top limb under 52 bits (254 = 3·68 + 50,
#: rounded up to the 4-bit lookup word), bounding any operand at 2^256
#: and any product at 2^512 — inside the 2^272·Fr CRT window.
_TOP_BITS = 52
#: CRT chunk carries are bounded by 2^70 (sum of ≤8 double-limb
#: products over a 136-bit chunk); checked at 72 bits.
_CARRY_BITS = 72


@dataclass(frozen=True)
class AssignedInteger:
    """An Fq element as four 68-bit limb cells (the reference's
    AssignedInteger, integer/mod.rs:650)."""

    limbs: tuple[Cell, ...]

    def values(self, std: StdGate) -> tuple[int, ...]:
        return tuple(std.cell_value(c) for c in self.limbs)

    def value(self, std: StdGate) -> int:
        return compose(self.values(std))


class IntegerChip:
    """Add/sub/mul/div over emulated Fq (integer/mod.rs chips).

    ``mul`` carries the full constraint set; ``sub`` and ``div`` are
    expressed through ``add``/``mul`` with rearranged roles (r = a−b ⇔
    b+r ≡ a; r = a/b ⇔ b·r ≡ a), which is sound because all chip
    values are canonical remainders.
    """

    def __init__(self, cs: ConstraintSystem, std: StdGate):
        self.cs = cs
        self.std = std
        self.rng8 = RangeCheckChip(cs, word_bits=8)
        self.rng4 = RangeCheckChip(cs, word_bits=4)

    # -- range helpers --------------------------------------------------

    def _assert_bits(self, cell: Cell, n_bits: int) -> None:
        """cell < 2^n_bits via 8-bit lookup words plus one 4-bit top
        word; n_bits must be ≡ 0 or 4 (mod 8)."""
        full, rem = divmod(n_bits, 8)
        if rem == 0:
            self.rng8.assert_range(cell, full)
            return
        assert rem == 4, n_bits
        v = self.std.cell_value(cell)
        lo = v & ((1 << (8 * full)) - 1)
        hi = v >> (8 * full)
        lo_c = self.std.witness(lo)
        hi_c = self.std.witness(hi)
        self.rng8.assert_range(lo_c, full)
        self.rng4.assert_word(hi_c)
        # cell = lo + hi·2^(8·full)
        acc = self.std.add_scaled(lo_c, hi_c, 1 << (8 * full))
        self.std.assert_equal(acc, cell)

    def _range_check_limbs(self, limbs: list[Cell], top_bits: int = _TOP_BITS) -> None:
        for i, c in enumerate(limbs):
            self._assert_bits(c, LIMB_BITS if i < NUM_LIMBS - 1 else top_bits)

    # -- witnessing -----------------------------------------------------

    def witness(self, value: int) -> AssignedInteger:
        """A canonical (reduced) Fq witness with range-checked limbs."""
        value %= FQ_MODULUS
        cells = [self.std.witness(v) for v in decompose(value)]
        self._range_check_limbs(cells)
        return AssignedInteger(tuple(cells))

    def constant(self, value: int) -> AssignedInteger:
        return AssignedInteger(
            tuple(self.std.constant(v) for v in decompose(value % FQ_MODULUS))
        )

    def from_limb_cells(self, limbs: list[Cell]) -> AssignedInteger:
        """Adopt externally-produced limb cells (e.g. instance columns),
        range-checking them to canonical-shape bounds."""
        assert len(limbs) == NUM_LIMBS
        self._range_check_limbs(list(limbs))
        return AssignedInteger(tuple(limbs))

    def assert_equal(self, a: AssignedInteger, b: AssignedInteger) -> None:
        for x, y in zip(a.limbs, b.limbs):
            self.std.assert_equal(x, y)

    # -- the reduction-identity core ------------------------------------

    def _compose_cell(self, limbs: tuple[Cell, ...]) -> Cell:
        acc = None
        for i, c in enumerate(limbs):
            acc = (
                self.std.add_scaled(acc, c, _SHIFT[i])
                if acc is not None
                else self.std.add_scaled(self.std.constant(0), c, _SHIFT[i])
            )
        return acc

    def _binary_crt(self, t_cells: list[Cell], r: AssignedInteger) -> None:
        """136-bit chunk identities with witnessed carries
        (rns.rs residues/constrain_binary_crt)."""
        std = self.std
        lsh1 = _SHIFT[1]
        lsh2 = pow(2, 2 * LIMB_BITS, P)
        t_vals = [std.cell_value(c) for c in t_cells]
        r_vals = r.values(std)
        carry_prev: Cell | None = None
        carry_prev_val = 0
        for i in (0, 2):
            u = (
                t_vals[i]
                + t_vals[i + 1] * (1 << LIMB_BITS)
                - r_vals[i]
                - r_vals[i + 1] * (1 << LIMB_BITS)
                + carry_prev_val
            )
            assert u % (1 << (2 * LIMB_BITS)) == 0 and u >= 0, "bad reduction witness"
            v = u >> (2 * LIMB_BITS)
            v_cell = std.witness(v)
            self._assert_bits(v_cell, _CARRY_BITS)
            # t_lo + t_hi·2^68 − r_lo − r_hi·2^68 − v·2^136 + v_prev = 0
            acc = std.add_scaled(t_cells[i], t_cells[i + 1], lsh1)
            acc = std.add_scaled(acc, r.limbs[i], P - 1)
            acc = std.add_scaled(acc, r.limbs[i + 1], (P - 1) * lsh1 % P)
            acc = std.add_scaled(acc, v_cell, (P - lsh2) % P)
            if carry_prev is not None:
                acc = std.add(acc, carry_prev)
            std.assert_zero(acc)
            carry_prev = v_cell
            carry_prev_val = v

    def add(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """r = a + b mod p with a short quotient (IntegerAddChip)."""
        std = self.std
        total = a.value(std) + b.value(std)
        q, r_val = divmod(total, FQ_MODULUS)
        assert q <= 1  # canonical operands wrap at most once
        q_cell = std.witness(q)
        std.assert_bool(q_cell)
        r_cells = [std.witness(v) for v in decompose(r_val)]
        self._range_check_limbs(r_cells)
        r = AssignedInteger(tuple(r_cells))
        # t_i = a_i + b_i + q·p'_i
        t_cells = [
            std.add_scaled(std.add(a.limbs[i], b.limbs[i]), q_cell, _P_PRIME[i])
            for i in range(NUM_LIMBS)
        ]
        self._binary_crt(t_cells, r)
        # native: compose(a) + compose(b) − q·p − compose(r) ≡ 0 (mod Fr)
        native = std.add(self._compose_cell(a.limbs), self._compose_cell(b.limbs))
        native = std.add_scaled(native, q_cell, (P - _P_IN_N) % P)
        native = std.add_scaled(native, self._compose_cell(r.limbs), P - 1)
        std.assert_zero(native)
        return r

    def sub(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """r = a − b mod p, constrained as b + r ≡ a."""
        std = self.std
        r_val = (a.value(std) - b.value(std)) % FQ_MODULUS
        r = self.witness(r_val)
        s = self.add(b, r)
        self.assert_equal(s, a)
        return r

    def neg(self, a: AssignedInteger) -> AssignedInteger:
        return self.sub(self.constant(0), a)

    def mul(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """r = a·b mod p with a full-width quotient (IntegerMulChip)."""
        std = self.std
        prod = a.value(std) * b.value(std)
        q_val, r_val = divmod(prod, FQ_MODULUS)
        q_cells = [std.witness(v) for v in decompose(q_val)]
        self._range_check_limbs(q_cells)
        r_cells = [std.witness(v) for v in decompose(r_val)]
        self._range_check_limbs(r_cells)
        q = AssignedInteger(tuple(q_cells))
        r = AssignedInteger(tuple(r_cells))
        # t_k = Σ_{i+j=k} a_i·b_j + q_i·p'_j   (k < 4; mod-2^272 terms)
        t_cells: list[Cell] = []
        for k in range(NUM_LIMBS):
            acc: Cell | None = None
            for i in range(k + 1):
                j = k - i
                ab = std.mul(a.limbs[i], b.limbs[j])
                acc = ab if acc is None else std.add(acc, ab)
                acc = std.add_scaled(acc, q.limbs[i], _P_PRIME[j])
            t_cells.append(acc)
        self._binary_crt(t_cells, r)
        # native row
        an = self._compose_cell(a.limbs)
        bn = self._compose_cell(b.limbs)
        qn = self._compose_cell(q.limbs)
        rn = self._compose_cell(r.limbs)
        prod_cell = std.mul(an, bn)
        acc = std.add_scaled(prod_cell, qn, (P - _P_IN_N) % P)
        acc = std.add_scaled(acc, rn, P - 1)
        std.assert_zero(acc)
        return r

    def div(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """r = a / b mod p, constrained as b·r ≡ a (IntegerDivChip);
        unsatisfiable when b = 0 and a ≠ 0."""
        std = self.std
        inv = pow(b.value(std), -1, FQ_MODULUS)
        r = self.witness(a.value(std) * inv % FQ_MODULUS)
        prod = self.mul(b, r)
        self.assert_equal(prod, a)
        return r

    def select(self, cond: Cell, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """cond ? a : b, limbwise (cond boolean-constrained by caller)."""
        return AssignedInteger(
            tuple(
                self.std.select(cond, x, y) for x, y in zip(a.limbs, b.limbs)
            )
        )


@dataclass(frozen=True)
class AssignedPoint:
    """Affine G1 point in emulated Fq (ecc/mod.rs AssignedPoint)."""

    x: AssignedInteger
    y: AssignedInteger

    def values(self, std: StdGate) -> tuple[int, int]:
        return (self.x.value(std), self.y.value(std))


class EccChip:
    """Emulated-Fq G1 arithmetic (ecc/mod.rs:50-828 re-designed):
    incomplete affine add/double (division forces the exceptional
    x₁ = x₂ cases unsatisfiable) and double-and-add scalar
    multiplication over challenge scalars.

    Completeness caveat (documented, matching halo2wrong-style
    incomplete addition): scalar_mul uses an accumulator offset so the
    incomplete add never sees ±P collisions for Fiat-Shamir-derived
    scalars; an adversarial scalar choice can only make the *prover*
    fail, never admit a wrong result.
    """

    def __init__(self, cs: ConstraintSystem, std: StdGate, integer: IntegerChip):
        self.cs = cs
        self.std = std
        self.int = integer
        self.b2n = Bits2NumChip(cs)

    def witness(self, x: int, y: int) -> AssignedPoint:
        pt = AssignedPoint(self.int.witness(x), self.int.witness(y))
        self.assert_on_curve(pt)
        return pt

    def constant(self, x: int, y: int) -> AssignedPoint:
        return AssignedPoint(self.int.constant(x), self.int.constant(y))

    def assert_on_curve(self, p: AssignedPoint) -> None:
        """y² = x³ + 3."""
        y2 = self.int.mul(p.y, p.y)
        x2 = self.int.mul(p.x, p.x)
        x3 = self.int.mul(x2, p.x)
        rhs = self.int.add(x3, self.int.constant(3))
        self.int.assert_equal(y2, rhs)

    def add_incomplete(self, p: AssignedPoint, q: AssignedPoint) -> AssignedPoint:
        """P + Q for P ≠ ±Q (EccAddConfig): λ = (y₂−y₁)/(x₂−x₁)."""
        dy = self.int.sub(q.y, p.y)
        dx = self.int.sub(q.x, p.x)
        lam = self.int.div(dy, dx)
        lam2 = self.int.mul(lam, lam)
        x3 = self.int.sub(self.int.sub(lam2, p.x), q.x)
        y3 = self.int.sub(self.int.mul(lam, self.int.sub(p.x, x3)), p.y)
        return AssignedPoint(x3, y3)

    def double(self, p: AssignedPoint) -> AssignedPoint:
        """2P (EccDoubleConfig): λ = 3x²/2y."""
        x2 = self.int.mul(p.x, p.x)
        three_x2 = self.int.add(self.int.add(x2, x2), x2)
        two_y = self.int.add(p.y, p.y)
        lam = self.int.div(three_x2, two_y)
        lam2 = self.int.mul(lam, lam)
        x3 = self.int.sub(self.int.sub(lam2, p.x), p.x)
        y3 = self.int.sub(self.int.mul(lam, self.int.sub(p.x, x3)), p.y)
        return AssignedPoint(x3, y3)

    def select(self, cond: Cell, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        return AssignedPoint(
            self.int.select(cond, a.x, b.x), self.int.select(cond, a.y, b.y)
        )

    def _aux(self) -> tuple[int, int]:
        """A deterministic non-trivial curve point (x³+3 a QR) scanned
        from a fixed seed — not any input's known multiple."""
        x = int.from_bytes(b"protocol-tpu-ecc-aux".ljust(32, b"\0"), "little")
        while True:
            x %= FQ_MODULUS
            rhs = (pow(x, 3, FQ_MODULUS) + 3) % FQ_MODULUS
            y = pow(rhs, (FQ_MODULUS + 1) // 4, FQ_MODULUS)
            if y * y % FQ_MODULUS == rhs:
                return x, y
            x += 1

    def scalar_mul(
        self, p: AssignedPoint, scalar: Cell, n_bits: int
    ) -> AssignedPoint:
        """scalar·P by left-to-right double-and-(select)-add
        (EccMulConfig re-designed).  The accumulator starts at the AUX
        offset and finishes with a constrained subtraction of
        AUX·2^n_bits, so the incomplete adds never meet the identity."""
        std = self.std
        bits = self.b2n.decompose(scalar, n_bits)  # little-endian bit cells
        ax, ay = self._aux()
        acc = self.constant(ax, ay)
        for bit in reversed(bits):
            acc = self.double(acc)
            with_p = self.add_incomplete(acc, p)
            acc = self.select(bit, with_p, acc)
        # Subtract AUX·2^n_bits (a constant point).
        off = _g1_mul_native((ax, ay), 1 << n_bits)
        neg_off = self.constant(off[0], (FQ_MODULUS - off[1]) % FQ_MODULUS)
        return self.add_incomplete(acc, neg_off)


def _g1_mul_native(pt: tuple[int, int], k: int) -> tuple[int, int]:
    """Native affine scalar mul for constant-point offsets."""
    from .bn254 import G1

    r = G1(pt[0], pt[1]).mul(k)
    return (r.x, r.y)

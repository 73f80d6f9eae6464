"""Gadget library: the constraint-level vocabulary every circuit builds
from (the analog of circuit/src/gadgets/ + the chip halves of poseidon/
edwards/eddsa).

All arithmetic chipsets share one *standard gate* (StdGate) — a single
row relation

    sa·a + sb·b + sc·c + sd·d + se·e + s_ab·a·b + s_cd·c·d + s_const = 0

(the same shape as the reference's main gate, gadgets/main.rs:58-91)
with per-row fixed selectors.  Higher gadgets (bit decomposition, ≤
comparison, set membership, Poseidon rounds, Edwards scalar-mul) use
dedicated columns and rotation gates.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field
from ..crypto.babyjubjub import A as BJJ_A, D as BJJ_D
from ..crypto.poseidon import POSEIDON_5, HashParams
from .cs import Cell, ConstraintSystem

P = field.MODULUS


@dataclass
class StdGate:
    """The shared arithmetic row gate and its chipset operations.

    Each operation allocates fresh rows, assigns witnesses, sets the
    row's fixed selectors, and returns the output cell.  Inputs are
    passed as cells so equality wiring (copy constraints) keeps the
    composition sound, like the reference's chip outputs.
    """

    cs: ConstraintSystem

    def __post_init__(self):
        c = self.cs
        self.a = c.column("std_a")
        self.b = c.column("std_b")
        self.c = c.column("std_c")
        self.d = c.column("std_d")
        self.e = c.column("std_e")
        self.q = {
            name: c.column(f"std_{name}", "fixed")
            for name in ("sa", "sb", "sc", "sd", "se", "s_ab", "s_cd", "s_const")
        }
        if not any(g.name == "std" for g in c.gates):
            c.gate(
                "std",
                "std",
                lambda v: (
                    v[self.q["sa"]] * v[self.a]
                    + v[self.q["sb"]] * v[self.b]
                    + v[self.q["sc"]] * v[self.c]
                    + v[self.q["sd"]] * v[self.d]
                    + v[self.q["se"]] * v[self.e]
                    + v[self.q["s_ab"]] * v[self.a] * v[self.b]
                    + v[self.q["s_cd"]] * v[self.c] * v[self.d]
                    + v[self.q["s_const"]]
                ),
            )

    # -- row helper -----------------------------------------------------

    def row(self, assignments: dict, selectors: dict) -> int:
        """One standard-gate row.  ``assignments``: column->(value|cell)
        — cells are copied in via equality constraints."""
        r = self.cs.alloc_rows(1)
        for col, val in assignments.items():
            if isinstance(val, Cell):
                here = self.cs.assign(col, r, self.cs.value(val.column, val.row))
                self.cs.copy(here, val)
            else:
                self.cs.assign(col, r, val)
        for name, val in selectors.items():
            self.cs.assign(self.q[name], r, val)
        self.cs.enable("std", r)
        return r

    def witness(self, value: int) -> Cell:
        """An unconstrained witness cell (constrained by later use)."""
        r = self.cs.alloc_rows(1)
        return self.cs.assign(self.a, r, value)

    def constant(self, value: int) -> Cell:
        """A cell constrained to a fixed constant: a - value = 0."""
        r = self.row({self.a: value}, {"sa": 1, "s_const": -value % P})
        return Cell(self.a, r)

    def cell_value(self, cell: Cell) -> int:
        return self.cs.value(cell.column, cell.row)

    # -- chipset operations (gadgets/main.rs:131-607) -------------------

    def add(self, x: Cell, y: Cell) -> Cell:
        out = (self.cell_value(x) + self.cell_value(y)) % P
        r = self.row({self.a: x, self.b: y, self.c: out}, {"sa": 1, "sb": 1, "sc": P - 1})
        return Cell(self.c, r)

    def sub(self, x: Cell, y: Cell) -> Cell:
        out = (self.cell_value(x) - self.cell_value(y)) % P
        r = self.row({self.a: x, self.b: y, self.c: out}, {"sa": 1, "sb": P - 1, "sc": P - 1})
        return Cell(self.c, r)

    def mul(self, x: Cell, y: Cell) -> Cell:
        out = (self.cell_value(x) * self.cell_value(y)) % P
        r = self.row({self.a: x, self.b: y, self.c: out}, {"s_ab": 1, "sc": P - 1})
        return Cell(self.c, r)

    def mul_add(self, x: Cell, y: Cell, z: Cell) -> Cell:
        """x·y + z in one row."""
        out = (self.cell_value(x) * self.cell_value(y) + self.cell_value(z)) % P
        r = self.row(
            {self.a: x, self.b: y, self.c: out, self.d: z},
            {"s_ab": 1, "sc": P - 1, "sd": 1},
        )
        return Cell(self.c, r)

    def assert_bool(self, x: Cell) -> None:
        """x² − x = 0 (IsBoolChipset)."""
        self.row({self.a: x, self.b: x}, {"s_ab": 1, "sa": P - 1})

    def add_scaled(self, acc: Cell, x: Cell, k: int) -> Cell:
        """acc + k·x in one row (k a circuit constant)."""
        out = (self.cell_value(acc) + k * self.cell_value(x)) % P
        r = self.row(
            {self.a: x, self.c: out, self.d: acc},
            {"sa": k % P, "sc": P - 1, "sd": 1},
        )
        return Cell(self.c, r)

    def linear_const(self, x: Cell, k: int, c: int) -> Cell:
        """k·x + c in one row."""
        out = (k * self.cell_value(x) + c) % P
        r = self.row({self.a: x, self.c: out}, {"sa": k % P, "sc": P - 1, "s_const": c % P})
        return Cell(self.c, r)

    def assert_equal(self, x: Cell, y: Cell) -> None:
        self.cs.copy(x, y)

    def assert_zero(self, x: Cell) -> None:
        self.row({self.a: x}, {"sa": 1})

    def inverse(self, x: Cell) -> Cell:
        """Witness x⁻¹ with x·inv = 1 (InverseChipset); an unsatisfiable
        row results for x = 0, like the reference's invert().unwrap()."""
        xv = self.cell_value(x)
        inv = field.inv(xv) if xv else 0
        r = self.row({self.a: x, self.b: inv}, {"s_ab": 1, "s_const": P - 1})
        return Cell(self.b, r)

    def is_zero(self, x: Cell) -> Cell:
        """out = 1 iff x = 0 (IsZeroChipset): x·out = 0 and
        x·inv + out − 1 = 0."""
        xv = self.cell_value(x)
        inv = field.inv(xv) if xv else 0
        out_v = 1 if xv == 0 else 0
        r1 = self.row({self.a: x, self.b: out_v}, {"s_ab": 1})
        out = Cell(self.b, r1)
        self.row(
            {self.a: x, self.b: inv, self.c: out},
            {"s_ab": 1, "sc": 1, "s_const": P - 1},
        )
        return out

    def is_equal(self, x: Cell, y: Cell) -> Cell:
        return self.is_zero(self.sub(x, y))

    def select(self, cond: Cell, x: Cell, y: Cell) -> Cell:
        """cond ? x : y with boolean cond (SelectChipset)."""
        self.assert_bool(cond)
        t1 = self.mul(cond, x)
        t2 = self.mul(cond, y)
        # out = t1 + y - t2
        out_v = (self.cell_value(t1) + self.cell_value(y) - self.cell_value(t2)) % P
        r = self.row(
            {self.a: t1, self.b: y, self.c: t2, self.d: out_v},
            {"sa": 1, "sb": 1, "sc": P - 1, "sd": P - 1},
        )
        return Cell(self.d, r)

    def logical_and(self, x: Cell, y: Cell) -> Cell:
        self.assert_bool(x)
        self.assert_bool(y)
        return self.mul(x, y)


class Bits2NumChip:
    """LSB-first bit decomposition with a running weighted sum
    (gadgets/bits2num.rs re-designed as a rotation gate): per row,
    bit² − bit = 0 and acc_next = acc + bit·pw, with pw a fixed power
    of two."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.bit = cs.column("b2n_bit")
        self.acc = cs.column("b2n_acc")
        self.pw = cs.column("b2n_pw", "fixed")
        if not any(g.name == "b2n" for g in cs.gates):
            cs.gate(
                "b2n",
                "b2n",
                lambda v: [
                    v[self.bit] * v[self.bit] - v[self.bit],
                    v[self.acc, 1] - v[self.acc] - v[self.bit] * v[self.pw],
                ],
            )
            # The running sum must start at zero, or arbitrary bit
            # patterns could "decompose" any value.
            cs.gate("b2n_init", "b2n_init", lambda v: v[self.acc])

    def decompose(self, value_cell: Cell, n_bits: int) -> list[Cell]:
        """Allocate n_bits rows; returns the bit cells and constrains
        acc_final == value."""
        cs = self.cs
        value = cs.value(value_cell.column, value_cell.row)
        bits = [(value >> i) & 1 for i in range(n_bits)]
        start = cs.alloc_rows(n_bits + 1)
        acc = 0
        cells = []
        for i, b in enumerate(bits):
            r = start + i
            cells.append(cs.assign(self.bit, r, b))
            cs.assign(self.acc, r, acc)
            cs.assign(self.pw, r, pow(2, i, P))
            cs.enable("b2n", r)
            if i == 0:
                cs.enable("b2n_init", r)
            acc = (acc + b * pow(2, i, P)) % P
        final = cs.assign(self.acc, start + n_bits, acc)
        cs.copy(final, value_cell)
        return cells


class LessEqChip:
    """x ≤ y for 252-bit operands (gadgets/lt_eq.rs's shifted-difference
    trick): decompose z = y + 2^252 − x into 253 bits and constrain the
    top bit to 1 (no borrow ⇔ x ≤ y)."""

    N_SHIFT = 252

    def __init__(self, cs: ConstraintSystem, std: StdGate, b2n: Bits2NumChip):
        self.cs = cs
        self.std = std
        self.b2n = b2n

    def assert_le(self, x: Cell, y: Cell) -> None:
        # Range-constrain both operands to 252 bits first (the reference
        # decomposes its inputs, lt_eq.rs:108+) — without this, field
        # elements near the modulus wrap the shifted difference and the
        # top-bit test passes vacuously.
        self.b2n.decompose(x, self.N_SHIFT)
        self.b2n.decompose(y, self.N_SHIFT)
        shift = self.std.constant(pow(2, self.N_SHIFT, P))
        z = self.std.add(self.std.sub(y, x), shift)
        bits = self.b2n.decompose(z, self.N_SHIFT + 1)
        one = self.std.constant(1)
        self.cs.copy(bits[self.N_SHIFT], one)

    def is_le_const(self, x: Cell, y_const: int, x_bits: int) -> Cell:
        """Boolean cell: x ≤ y_const, for x range-constrained here to
        ``x_bits`` (≤ 252) bits and a constant y_const < 2^252."""
        assert x_bits <= self.N_SHIFT and 0 <= y_const < (1 << self.N_SHIFT)
        self.b2n.decompose(x, x_bits)
        # z = y + 2^252 − x; top bit ⇔ x ≤ y.
        z = self.std.linear_const(x, P - 1, (y_const + (1 << self.N_SHIFT)) % P)
        bits = self.b2n.decompose(z, self.N_SHIFT + 1)
        return bits[self.N_SHIFT]


class SetChip:
    """Membership via product of differences (gadgets/set.rs): target ∈
    set ⇔ Π(target − item) = 0."""

    def __init__(self, std: StdGate):
        self.std = std

    def assert_member(self, target: Cell, items: list[Cell]) -> None:
        prod = self.std.constant(1)
        for item in items:
            prod = self.std.mul(prod, self.std.sub(target, item))
        self.std.assert_zero(prod)

    def is_member(self, target: Cell, items: list[Cell]) -> Cell:
        prod = self.std.constant(1)
        for item in items:
            prod = self.std.mul(prod, self.std.sub(target, item))
        return self.std.is_zero(prod)


class PoseidonChip:
    """The width-5 Hades permutation as rotation gates
    (poseidon/mod.rs FullRoundChip/PartialRoundChip re-designed):
    state lives in 5 advice columns; each round row constrains the next
    row's state to the round function of this row's."""

    def __init__(self, cs: ConstraintSystem, params: HashParams = POSEIDON_5):
        self.cs = cs
        self.params = params
        w = params.width
        pre = f"pos{w}"
        self._sel_full = f"{pre}_full"
        self._sel_partial = f"{pre}_partial"
        self.state = [cs.column(f"{pre}_s{i}") for i in range(w)]
        self.rc = [cs.column(f"{pre}_rc{i}", "fixed") for i in range(w)]
        mds = params.mds

        def pow5(x):
            x2 = x * x % P
            x4 = x2 * x2 % P
            return x4 * x % P

        def full_poly(v):
            cur = [pow5((v[self.state[j]] + v[self.rc[j]]) % P) for j in range(w)]  # noqa: B023
            return [
                (v[self.state[i], 1] - sum(mds[i][j] * cur[j] for j in range(w))) % P
                for i in range(w)
            ]

        def partial_poly(v):
            cur = [(v[self.state[j]] + v[self.rc[j]]) % P for j in range(w)]
            cur[0] = pow5(cur[0])
            return [
                (v[self.state[i], 1] - sum(mds[i][j] * cur[j] for j in range(w))) % P
                for i in range(w)
            ]

        if cs.register_chip(pre, (params.round_constants, params.mds)):
            cs.gate(f"{pre}_full", self._sel_full, full_poly)
            cs.gate(f"{pre}_partial", self._sel_partial, partial_poly)

    def permute(self, inputs: list[Cell]) -> list[Cell]:
        """Allocate the 68 round rows + result row; wires the input
        cells into row 0 and returns the final state cells."""
        cs = self.cs
        params = self.params
        w = params.width
        half_full = params.full_rounds // 2
        total_rounds = params.full_rounds + params.partial_rounds
        start = cs.alloc_rows(total_rounds + 1)

        # Row-0 state: copies of the inputs.
        values = [cs.value(c.column, c.row) for c in inputs]
        for j in range(w):
            here = cs.assign(self.state[j], start, values[j])
            cs.copy(here, inputs[j])

        rc = params.round_constants
        state = list(values)
        for rnd in range(total_rounds):
            row = start + rnd
            for j in range(w):
                cs.assign(self.rc[j], row, rc[rnd * w + j])
            if rnd < half_full or rnd >= half_full + params.partial_rounds:
                cs.enable(self._sel_full, row)
                state = [field.pow5((state[j] + rc[rnd * w + j]) % P) for j in range(w)]
            else:
                cs.enable(self._sel_partial, row)
                state = [(state[j] + rc[rnd * w + j]) % P for j in range(w)]
                state[0] = field.pow5(state[0])
            state = [
                sum(params.mds[i][j] * state[j] for j in range(w)) % P for i in range(w)
            ]
            for j in range(w):
                cs.assign(self.state[j], row + 1, state[j])

        return [Cell(self.state[j], start + total_rounds) for j in range(w)]


class PoseidonSpongeChip:
    """Absorb-chunks-and-permute sponge (poseidon/sponge.rs +
    gadgets/absorb.rs): chunk elements are added lane-wise to the
    running state with std-gate adds, then permuted."""

    def __init__(self, cs: ConstraintSystem, std: StdGate, poseidon: PoseidonChip):
        self.cs = cs
        self.std = std
        self.poseidon = poseidon

    def squeeze(self, inputs: list[Cell]) -> Cell:
        assert inputs
        w = self.poseidon.params.width
        zero = self.std.constant(0)
        state: list[Cell] = [zero] * w
        for off in range(0, len(inputs), w):
            chunk = list(inputs[off : off + w])
            chunk += [zero] * (w - len(chunk))
            merged = [self.std.add(chunk[j], state[j]) for j in range(w)]
            state = self.poseidon.permute(merged)
        return state[0]


class EdwardsChip:
    """BabyJubJub projective ops in-circuit (edwards/mod.rs re-designed).

    Point addition is one row constraining (x3,y3,z3) on the next row to
    the add-2008-bbjlp polynomials of two source points laid out across
    six advice columns; scalar multiplication is a 256-row double-and-add
    region sharing the bit column with a running scalar accumulator
    (StrictScalarMulChipset's bits2num fusion)."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        # Columns: accumulator point r, doubling point e, bit, scalar acc.
        self.rx = cs.column("ed_rx")
        self.ry = cs.column("ed_ry")
        self.rz = cs.column("ed_rz")
        self.ex = cs.column("ed_ex")
        self.ey = cs.column("ed_ey")
        self.ez = cs.column("ed_ez")
        self.bit = cs.column("ed_bit")
        self.acc = cs.column("ed_acc")
        self.pw = cs.column("ed_pw", "fixed")
        # Intermediate products of the bbjlp addition (a = z1·z2,
        # c = x1·x2, d = y1·y2) witnessed per row so the add/select
        # constraints stay at degree ≤ 6 incl. selector.  Without them
        # the cleared-denominator x3 polynomial reaches degree 9 and
        # forces a 16× quotient extension domain on the whole circuit.
        self.ta = cs.column("ed_ta")
        self.tc = cs.column("ed_tc")
        self.td = cs.column("ed_td")

        def add_poly(x1, y1, z1, x2, y2, z2):
            a = z1 * z2 % P
            b = a * a % P
            c = x1 * x2 % P
            d = y1 * y2 % P
            e = BJJ_D * c % P * d % P
            f = (b - e) % P
            g = (b + e) % P
            x3 = a * f % P * ((x1 + y1) * (x2 + y2) - c - d) % P
            y3 = a * g % P * ((d - BJJ_A * c) % P) % P
            z3 = f * g % P
            return x3, y3, z3

        def double_poly(x1, y1, z1):
            b = (x1 + y1) * (x1 + y1) % P
            c = x1 * x1 % P
            d = y1 * y1 % P
            e = BJJ_A * c % P
            f = (e + d) % P
            h = z1 * z1 % P
            j = (f - 2 * h) % P
            x3 = (b - c - d) * j % P
            y3 = f * (e - d) % P
            z3 = f * j % P
            return x3, y3, z3

        self._add_poly = add_poly
        self._double_poly = double_poly

        def add_poly_witnessed(v):
            """The bbjlp addition of (rx,ry,rz)+(ex,ey,ez) expressed in
            the witnessed intermediates ta/tc/td: degree ≤ 5 instead of
            the cleared-denominator degree 8/9."""
            ta, tc, td = v[self.ta], v[self.tc], v[self.td]
            b = ta * ta % P
            e = BJJ_D * tc % P * td % P
            f = (b - e) % P
            g = (b + e) % P
            x3 = (
                ta * f % P * ((v[self.rx] + v[self.ry]) * (v[self.ex] + v[self.ey]) - tc - td)
                % P
            )
            y3 = ta * g % P * ((td - BJJ_A * tc) % P) % P
            z3 = f * g % P
            return x3, y3, z3

        def intermediate_cons(v):
            return [
                (v[self.ta] - v[self.rz] * v[self.ez]) % P,
                (v[self.tc] - v[self.rx] * v[self.ex]) % P,
                (v[self.td] - v[self.ry] * v[self.ey]) % P,
            ]

        def mul_step(v):
            bit = v[self.bit]
            ex, ey, ez = v[self.ex], v[self.ey], v[self.ez]
            rx, ry, rz = v[self.rx], v[self.ry], v[self.rz]
            dx, dy, dz = double_poly(ex, ey, ez)
            ax, ay, az = add_poly_witnessed(v)
            # select(bit, add, keep) per coordinate
            sel = [
                (bit * ax + (1 - bit) * rx) % P,
                (bit * ay + (1 - bit) * ry) % P,
                (bit * az + (1 - bit) * rz) % P,
            ]
            return intermediate_cons(v) + [
                bit * bit - bit,
                (v[self.rx, 1] - sel[0]) % P,
                (v[self.ry, 1] - sel[1]) % P,
                (v[self.rz, 1] - sel[2]) % P,
                (v[self.ex, 1] - dx) % P,
                (v[self.ey, 1] - dy) % P,
                (v[self.ez, 1] - dz) % P,
                (v[self.acc, 1] - v[self.acc] - bit * v[self.pw]) % P,
            ]

        def add_gate(v):
            ax, ay, az = add_poly_witnessed(v)
            return intermediate_cons(v) + [
                (v[self.rx, 1] - ax) % P,
                (v[self.ry, 1] - ay) % P,
                (v[self.rz, 1] - az) % P,
            ]

        def init_gate(v):
            # The double-and-add region must start from the identity
            # (0, 1, 1) with a zeroed scalar accumulator.
            return [
                v[self.rx],
                (v[self.ry] - 1) % P,
                (v[self.rz] - 1) % P,
                v[self.acc],
            ]

        if not any(g.name == "ed_mul" for g in cs.gates):
            cs.gate("ed_mul", "ed_mul", mul_step)
            cs.gate("ed_add", "ed_add", add_gate)
            cs.gate("ed_init", "ed_init", init_gate)

    def _point_values(self, pt: tuple[Cell, Cell, Cell]) -> tuple[int, int, int]:
        return tuple(self.cs.value(c.column, c.row) for c in pt)

    def scalar_mul(
        self,
        point: tuple[Cell, Cell, Cell],
        scalar: Cell,
        n_bits: int = 254,
        strict: bool = False,
        std: "StdGate | None" = None,
        lessq: "LessEqChip | None" = None,
    ) -> tuple[Cell, Cell, Cell]:
        """(point · scalar) with the scalar simultaneously re-composed
        from its bits and copy-constrained to ``scalar``.

        The recomposition is mod P, so a bit pattern encoding
        ``scalar + P`` would satisfy the copy while multiplying by a
        different integer.  Callers must either bound the scalar below
        2^n_bits for n_bits ≤ 253 (e.g. the ≤-suborder EdDSA s) or pass
        ``strict=True``, which splits the bits into low-128/high-126
        words and constrains the integer value < P (the reference's
        strict variant, edwards/mod.rs:359-410)."""
        cs = self.cs
        sval = cs.value(scalar.column, scalar.row)
        ex, ey, ez = self._point_values(point)
        start = cs.alloc_rows(n_bits + 1)
        bit_cells: list[Cell] = []

        rx, ry, rz = 0, 1, 1
        acc = 0
        for i in range(n_bits):
            row = start + i
            bit = (sval >> i) & 1
            bit_cells.append(cs.assign(self.bit, row, bit))
            cs.assign(self.rx, row, rx)
            cs.assign(self.ry, row, ry)
            cs.assign(self.rz, row, rz)
            ex_c = cs.assign(self.ex, row, ex)
            ey_c = cs.assign(self.ey, row, ey)
            ez_c = cs.assign(self.ez, row, ez)
            if i == 0:
                cs.copy(ex_c, point[0])
                cs.copy(ey_c, point[1])
                cs.copy(ez_c, point[2])
            cs.assign(self.acc, row, acc)
            cs.assign(self.pw, row, pow(2, i, P))
            cs.assign(self.ta, row, rz * ez % P)
            cs.assign(self.tc, row, rx * ex % P)
            cs.assign(self.td, row, ry * ey % P)
            cs.enable("ed_mul", row)
            if i == 0:
                cs.enable("ed_init", row)

            if bit:
                rx, ry, rz = self._add_poly(rx, ry, rz, ex, ey, ez)
            ex, ey, ez = self._double_poly(ex, ey, ez)
            acc = (acc + bit * pow(2, i, P)) % P

        last = start + n_bits
        cs.assign(self.rx, last, rx)
        cs.assign(self.ry, last, ry)
        cs.assign(self.rz, last, rz)
        cs.assign(self.ex, last, ex)
        cs.assign(self.ey, last, ey)
        cs.assign(self.ez, last, ez)
        acc_cell = cs.assign(self.acc, last, acc)
        cs.copy(acc_cell, scalar)

        if strict:
            assert std is not None and lessq is not None and n_bits == 254
            self._assert_canonical(bit_cells, std, lessq)
        return (Cell(self.rx, last), Cell(self.ry, last), Cell(self.rz, last))

    def _assert_canonical(
        self, bit_cells: list[Cell], std: "StdGate", lessq: "LessEqChip"
    ) -> None:
        """Constrain the 254-bit pattern to encode an integer < P:
        value = h·2^128 + l with l the low 128 and h the high 126 bits;
        value < P ⇔ h < PH ∨ (h = PH ∧ l < PL)."""
        ph, pl = P >> 128, P & ((1 << 128) - 1)
        low = std.constant(0)
        for i in range(128):
            low = std.add_scaled(low, bit_cells[i], pow(2, i, P))
        high = std.constant(0)
        for i in range(128, 254):
            high = std.add_scaled(high, bit_cells[i], pow(2, i - 128, P))
        lt_h = lessq.is_le_const(high, ph - 1, 126)
        eq_h = std.is_equal(high, std.constant(ph))
        lt_l = lessq.is_le_const(low, pl - 1, 128)
        ok = std.add(lt_h, std.mul(eq_h, lt_l))
        std.assert_equal(ok, std.constant(1))

    def add_points(
        self, p1: tuple[Cell, Cell, Cell], p2: tuple[Cell, Cell, Cell]
    ) -> tuple[Cell, Cell, Cell]:
        cs = self.cs
        x1, y1, z1 = self._point_values(p1)
        x2, y2, z2 = self._point_values(p2)
        row = cs.alloc_rows(2)
        for col, cell, val in (
            (self.rx, p1[0], x1),
            (self.ry, p1[1], y1),
            (self.rz, p1[2], z1),
            (self.ex, p2[0], x2),
            (self.ey, p2[1], y2),
            (self.ez, p2[2], z2),
        ):
            here = cs.assign(col, row, val)
            cs.copy(here, cell)
        cs.assign(self.ta, row, z1 * z2 % P)
        cs.assign(self.tc, row, x1 * x2 % P)
        cs.assign(self.td, row, y1 * y2 % P)
        cs.enable("ed_add", row)
        x3, y3, z3 = self._add_poly(x1, y1, z1, x2, y2, z2)
        cs.assign(self.rx, row + 1, x3)
        cs.assign(self.ry, row + 1, y3)
        cs.assign(self.rz, row + 1, z3)
        return (Cell(self.rx, row + 1), Cell(self.ry, row + 1), Cell(self.rz, row + 1))

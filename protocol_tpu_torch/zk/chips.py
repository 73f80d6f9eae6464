"""Higher gadget chips: lookup range checks, Merkle path, Rescue-Prime.

Parity targets: gadgets/range.rs (LookupShortWordCheckChip /
LookupRangeCheckChip / RangeChipset), merkle_tree/mod.rs
(MerklePathChip), rescue_prime/mod.rs (the chip half of the alternate
hash) — re-built on this framework's lookup argument and rotation
gates.
"""

from __future__ import annotations

from ..crypto import field
from ..crypto.poseidon import RESCUE_PRIME_5, _INV5_EXP, HashParams
from .cs import Cell, ConstraintSystem
from .gadgets import StdGate

P = field.MODULUS


class RangeCheckChip:
    """K-bit word range checks via a lookup table, and running-sum
    decomposition for wider ranges (gadgets/range.rs re-designed).

    ``assert_word(x)`` looks x up in the [0, 2^K) table;
    ``assert_range(x, n_words)`` decomposes x into K-bit words with a
    weighted running sum (each word looked up) proving
    x < 2^(K·n_words).
    """

    def __init__(self, cs: ConstraintSystem, word_bits: int = 8):
        self.cs = cs
        self.word_bits = word_bits
        # Columns/selectors are per-width: two widths sharing one table
        # would check words against the wrong range.
        pre = f"rng{word_bits}"
        self._sel_word = f"{pre}_word"
        self._sel_sum = f"{pre}_sum"
        self._sel_init = f"{pre}_init"
        self.word = cs.column(f"{pre}_word")
        self.acc = cs.column(f"{pre}_acc")
        self.pw = cs.column(f"{pre}_pw", "fixed")
        if cs.register_chip(pre, word_bits):
            cs.lookup(
                f"{pre}_lookup", self._sel_word, [self.word], frozenset(range(1 << word_bits))
            )
            cs.gate(
                f"{pre}_sum",
                self._sel_sum,
                lambda v: (v[self.acc, 1] - v[self.acc] - v[self.word] * v[self.pw]) % P,
            )
            cs.gate(f"{pre}_init", self._sel_init, lambda v: v[self.acc])

    def assert_word(self, x: Cell) -> None:
        """x < 2^word_bits (LookupShortWordCheckChip)."""
        r = self.cs.alloc_rows(1)
        here = self.cs.assign(self.word, r, self.cs.value(x.column, x.row))
        self.cs.copy(here, x)
        self.cs.enable(self._sel_word, r)

    def assert_range(self, x: Cell, n_words: int) -> None:
        """x < 2^(word_bits·n_words) via word decomposition with every
        word table-checked (LookupRangeCheckChip)."""
        cs = self.cs
        k = self.word_bits
        value = cs.value(x.column, x.row)
        start = cs.alloc_rows(n_words + 1)
        acc = 0
        for i in range(n_words):
            word = (value >> (k * i)) & ((1 << k) - 1)
            r = start + i
            cs.assign(self.word, r, word)
            cs.assign(self.acc, r, acc)
            cs.assign(self.pw, r, pow(2, k * i, P))
            cs.enable(self._sel_word, r)
            cs.enable(self._sel_sum, r)
            if i == 0:
                cs.enable(self._sel_init, r)
            acc = (acc + word * pow(2, k * i, P)) % P
        final = cs.assign(self.acc, start + n_words, acc)
        cs.copy(final, x)


class MerklePathChip:
    """Prove a value's authentication path hashes to a root
    (merkle_tree/mod.rs:35 re-built): per level, the chip constrains
    parent = Poseidon(left, right, 0, 0, 0) and that the claimed value /
    prior parent appears among the pair — fixing the reference's
    OR-accumulator bug (its verify() is vacuously true,
    merkle_tree/native.rs:100-110)."""

    def __init__(self, cs: ConstraintSystem, std: StdGate, poseidon_chip):
        self.cs = cs
        self.std = std
        self.poseidon = poseidon_chip

    def verify_path(self, value: Cell, pairs: list[tuple[Cell, Cell]], root: Cell) -> None:
        std = self.std
        zero = std.constant(0)
        current = value
        for left, right in pairs:
            # current ∈ {left, right}: (current-left)·(current-right) = 0
            d1 = std.sub(current, left)
            d2 = std.sub(current, right)
            std.assert_zero(std.mul(d1, d2))
            current = self.poseidon.permute([left, right, zero, zero, zero])[0]
        std.assert_equal(current, root)


class RescuePrimeChip:
    """Rescue-Prime permutation in-circuit (rescue_prime/mod.rs:30).

    Each round row constrains, with S the state at the row and S' at
    the next: S' = MDS·inv5(MDS·sbox5(S) + rc_a) + rc_b.  The inverse
    S-box (x^{1/5}) is witnessed and checked forward: for the witnessed
    intermediate u, u^5 must equal the pre-inverse value — keeping the
    gate degree at 5 instead of the astronomic 1/5 exponent."""

    def __init__(self, cs: ConstraintSystem, params: HashParams = RESCUE_PRIME_5):
        self.cs = cs
        self.params = params
        w = params.width
        pre = f"rp{w}"
        self._sel = f"{pre}_round"
        self.state = [cs.column(f"{pre}_s{i}") for i in range(w)]
        # Witnessed post-inverse-sbox intermediate.
        self.mid = [cs.column(f"{pre}_m{i}") for i in range(w)]
        self.rc_a = [cs.column(f"{pre}_rca{i}", "fixed") for i in range(w)]
        self.rc_b = [cs.column(f"{pre}_rcb{i}", "fixed") for i in range(w)]
        mds = params.mds

        def round_poly(v):
            w_ = len(self.state)
            fwd = [field.pow5(v[self.state[j]]) for j in range(w_)]
            mixed = [
                (sum(mds[i][j] * fwd[j] for j in range(w_)) + v[self.rc_a[i]]) % P
                for i in range(w_)
            ]
            out = []
            # mid^5 == mixed  (the witnessed inverse S-box, checked forward)
            for i in range(w_):
                out.append((field.pow5(v[self.mid[i]]) - mixed[i]) % P)
            # next state = MDS·mid + rc_b
            for i in range(w_):
                nxt = (
                    sum(mds[i][j] * v[self.mid[j]] for j in range(w_))
                    + v[self.rc_b[i]]
                ) % P
                out.append((v[self.state[i], 1] - nxt) % P)
            return out

        if cs.register_chip(pre, (params.round_constants, params.mds)):
            cs.gate(f"{pre}_round", self._sel, round_poly)

    def permute(self, inputs: list[Cell]) -> list[Cell]:
        cs = self.cs
        params = self.params
        w = params.width
        rc = params.round_constants
        mds = params.mds
        n_rounds = params.full_rounds - 1
        start = cs.alloc_rows(n_rounds + 1)

        values = [cs.value(c.column, c.row) for c in inputs]
        for j in range(w):
            here = cs.assign(self.state[j], start, values[j])
            cs.copy(here, inputs[j])

        state = list(values)
        for rnd in range(n_rounds):
            row = start + rnd
            fwd = [field.pow5(x) for x in state]
            mixed = [
                (sum(mds[i][j] * fwd[j] for j in range(w)) + rc[rnd * w + i]) % P
                for i in range(w)
            ]
            mid = [pow(x, _INV5_EXP, P) for x in mixed]
            nxt = [
                (sum(mds[i][j] * mid[j] for j in range(w)) + rc[(rnd + 1) * w + i]) % P
                for i in range(w)
            ]
            for j in range(w):
                cs.assign(self.rc_a[j], row, rc[rnd * w + j])
                cs.assign(self.rc_b[j], row, rc[(rnd + 1) * w + j])
                cs.assign(self.mid[j], row, mid[j])
                cs.assign(self.state[j], row + 1, nxt[j])
            cs.enable(self._sel, row)
            state = nxt

        return [Cell(self.state[j], start + n_rounds) for j in range(w)]

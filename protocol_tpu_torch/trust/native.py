"""Exact (field / rational) trust kernels — the parity reference for
every device backend.

Two kernels, mirroring the reference's two designs:

- ``power_iterate`` — the stateless kernel the server actually runs and
  the ZK circuit constrains (circuit/src/circuit.rs:425-470 ``native()``):
  I iterations of ``new_s[i] = Σ_j ops[j][i]·s[j]`` over the Bn254 field,
  then unscale by ``SCALE^-I``.
- ``EigenTrustSet`` — the richer set-managed kernel
  (circuit/src/native.rs:37-234): dynamic membership, per-peer signed
  opinions, ``filter_peers`` nullification/redistribution, credit
  normalization, fixed-iteration convergence.

The set kernel computes in exact rationals (``fractions.Fraction``) with a
``to_field`` mapping p/q ↦ p·q⁻¹ mod r; the field image of the rational
result equals the reference's in-field computation because every reference
division is a field inversion of a value that is the image of a nonzero
rational.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from fractions import Fraction

from ..crypto import field
from ..crypto.eddsa import PublicKey, Signature


def power_iterate(
    initial: list[int], ops: list[list[int]], num_iter: int, scale: int
) -> list[int]:
    """Field-exact power iteration (circuit/src/circuit.rs:425-470).

    ``ops[i][j]`` is peer i's (scaled integer) score for peer j; rows are
    expected to sum to ``scale`` so total score is conserved.  Returns the
    unscaled field elements — equal to the true integer scores whenever
    the integer result is divisible by ``scale**num_iter``.
    """
    n = len(initial)
    assert len(ops) == n and all(len(row) == n for row in ops)
    s = [x % field.MODULUS for x in initial]
    for _ in range(num_iter):
        s = [
            sum(ops[j][i] * s[j] for j in range(n)) % field.MODULUS
            for i in range(n)
        ]
    inv_scale = field.inv(pow(scale, num_iter, field.MODULUS))
    return [field.mul(x, inv_scale) for x in s]


def power_iterate_rational(
    initial: list[int], ops: list[list[int]], num_iter: int, scale: int
) -> list[Fraction]:
    """The same dynamics over exact rationals — the mathematical ground
    truth the floating-point device kernels approximate."""
    n = len(initial)
    s = [Fraction(x) for x in initial]
    for _ in range(num_iter):
        s = [sum(Fraction(ops[j][i]) * s[j] for j in range(n)) for i in range(n)]
    return [x / scale**num_iter for x in s]


def fraction_to_field(x: Fraction) -> int:
    """Map p/q into Fr as p·q⁻¹ mod r."""
    return field.mul(x.numerator % field.MODULUS, field.inv(x.denominator % field.MODULUS))


@dataclass
class Opinion:
    """A signed score vector from one peer (circuit/src/native.rs:13-35)."""

    sig: Signature
    message_hash: int
    scores: list[tuple[PublicKey, int]]

    @classmethod
    def empty(cls, num_neighbours: int) -> "Opinion":
        return cls(
            sig=Signature.new(0, 0, 0),
            message_hash=0,
            scores=[(PublicKey.null(), 0)] * num_neighbours,
        )


@dataclass
class EigenTrustSet:
    """Set-managed EigenTrust (circuit/src/native.rs::EigenTrustSet).

    Unlike the reference's compile-time constants (NUM_NEIGHBOURS=6,
    NUM_ITERATIONS=20, native.rs:9-11), set size / iteration count /
    initial score are runtime parameters.
    """

    num_neighbours: int = 6
    num_iterations: int = 20
    initial_score: int = 1000
    set: list[tuple[PublicKey, int]] = dc_field(default_factory=list)
    ops: dict[PublicKey, Opinion] = dc_field(default_factory=dict)

    def __post_init__(self):
        if not self.set:
            self.set = [(PublicKey.null(), 0)] * self.num_neighbours

    def add_member(self, pk: PublicKey) -> None:
        positions = [i for i, (x, _) in enumerate(self.set) if x == pk]
        assert not positions, "member already in the set"
        free = [i for i, (x, _) in enumerate(self.set) if x.is_null()]
        index = free[0]  # IndexError if full, like the reference's unwrap
        self.set[index] = (pk, self.initial_score)

    def remove_member(self, pk: PublicKey) -> None:
        positions = [i for i, (x, _) in enumerate(self.set) if x == pk]
        assert positions, "member not in the set"
        self.set[positions[0]] = (PublicKey.null(), 0)
        self.ops.pop(pk, None)

    def update_op(self, from_pk: PublicKey, op: Opinion) -> None:
        assert any(x == from_pk for x, _ in self.set), "unknown sender"
        self.ops[from_pk] = op

    def filter_peers(
        self,
    ) -> tuple[list[tuple[PublicKey, int]], dict[PublicKey, Opinion]]:
        """Nullify invalid/self/absent scores and evenly redistribute
        all-zero opinions (circuit/src/native.rs:146-234)."""
        n = self.num_neighbours
        filtered_set = list(self.set)
        filtered_ops: dict[PublicKey, Opinion] = {}

        for i in range(n):
            pk_i, _ = filtered_set[i]
            if pk_i.is_null():
                continue

            op = self.ops.get(pk_i, Opinion.empty(n))
            scores = list(op.scores)

            for j in range(n):
                set_pk_j, _ = filtered_set[j]
                op_pk_j, op_score_j = scores[j]

                is_diff = set_pk_j != op_pk_j
                is_null = set_pk_j.is_null()
                is_self = set_pk_j == pk_i

                if is_diff or is_null or is_self:
                    op_score_j = 0
                if is_diff:
                    op_pk_j = set_pk_j
                scores[j] = (op_pk_j, op_score_j)

            if sum(score for _, score in scores) == 0:
                for j in range(n):
                    pk_j, _ = scores[j]
                    if pk_j != pk_i and not pk_j.is_null():
                        scores[j] = (pk_j, 1)

            filtered_ops[pk_i] = Opinion(op.sig, op.message_hash, scores)

        return filtered_set, filtered_ops

    def converge_rational(self) -> list[Fraction]:
        """Exact-rational convergence (circuit/src/native.rs:83-144).

        Raises ZeroDivisionError for a lone peer with an all-null opinion
        (the reference's ``invert().unwrap()`` panic) and AssertionError
        below 2 valid peers, in the reference's order.
        """
        n = self.num_neighbours
        filtered_set, filtered_ops = self.filter_peers()

        # Normalize each valid peer's opinion: distribute its credits
        # proportionally to its (filtered) scores.
        normalized: dict[PublicKey, list[Fraction]] = {}
        for pk, credits in filtered_set:
            if pk.is_null():
                continue
            scores = filtered_ops[pk].scores
            total = sum(score for _, score in scores)
            if total == 0:
                raise ZeroDivisionError("opinion sum is zero")  # invert(0)
            normalized[pk] = [Fraction(score * credits, total) for _, score in scores]

        valid_peers = sum(1 for pk, _ in filtered_set if not pk.is_null())
        assert valid_peers >= 2, "Insufficient peers for calculation!"

        s = [Fraction(credits) for _, credits in filtered_set]
        zero_row = [Fraction(0)] * n
        for _ in range(self.num_iterations):
            rows = [
                normalized.get(filtered_set[i][0], zero_row) if not filtered_set[i][0].is_null() else zero_row
                for i in range(n)
            ]
            s = [sum(rows[j][i] * s[j] for j in range(n)) for i in range(n)]
        return s

    def converge(self) -> list[int]:
        """Field image of the rational convergence — matches the
        reference's in-field result."""
        return [fraction_to_field(x) for x in self.converge_rational()]

    def to_arrays(self):
        """Bridge to the vectorized kernels: ``(ops, match, valid,
        credits)`` numpy arrays aligned to set order, consumed by
        ``ops.dense.filter_and_normalize``.

        ``ops[i, j]`` is peer i's raw (pre-filter) score for slot j;
        ``match[i, j]`` whether the opinion's j-th pk equals set slot
        j's pk (mismatches are nullified by the kernel exactly like
        filter_peers does).
        """
        import numpy as np

        n = self.num_neighbours
        ops = np.zeros((n, n), dtype=np.float64)
        match = np.zeros((n, n), dtype=bool)
        valid = np.array([not pk.is_null() for pk, _ in self.set])
        credits = np.array([score for _, score in self.set], dtype=np.float64)
        for i, (pk_i, _) in enumerate(self.set):
            if pk_i.is_null():
                continue
            op = self.ops.get(pk_i, Opinion.empty(n))
            for j in range(n):
                op_pk, score = op.scores[j]
                ops[i, j] = float(score)
                match[i, j] = op_pk == self.set[j][0]
        return ops, match, valid, credits

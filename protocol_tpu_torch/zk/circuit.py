"""The EigenTrust circuit: prove that the published global scores are
the converged trust of N signed opinions.

Constraint-level rebuild of circuit/src/circuit.rs:59-421:

1. witness the N public keys, signatures, and the N×N ops matrix;
2. pks_hash = sponge(pk_xs ‖ pk_ys); per peer, scores_hash =
   sponge(ops_i) and message = Poseidon(pks_hash, scores_hash, 0, 0, 0)
   (circuit/src/lib.rs:225-256 in-circuit);
3. verify each peer's EdDSA signature over its message;
4. run the I×N×N power iteration in-constraints;
5. bind the instance column: instance·SCALE^I == computed score and
   Σ instance == N·INITIAL_SCORE (total-score conservation,
   circuit.rs:380-418).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field
from ..node.attestation import Attestation
from .cs import Cell, ConstraintSystem
from .eddsa import EddsaChipset
from .gadgets import (
    Bits2NumChip,
    EdwardsChip,
    PoseidonChip,
    PoseidonSpongeChip,
    StdGate,
)

P = field.MODULUS


@dataclass
class EigenTrustCircuit:
    """Const-generic analog: EigenTrust<N, I, INITIAL_SCORE, SCALE> as
    runtime parameters."""

    num_neighbours: int = 5
    num_iter: int = 10
    initial_score: int = 1000
    scale: int = 1000

    def synthesize(
        self,
        cs: ConstraintSystem,
        attestations: list[Attestation],
        pub_scores: list[int],
    ) -> None:
        """Build the full witness + constraints for one epoch.

        ``attestations[i]`` is peer i's signed opinion (aligned to the
        set order); ``pub_scores`` the claimed converged scores (the
        public instance).
        """
        n, iters = self.num_neighbours, self.num_iter
        assert len(attestations) == n and len(pub_scores) == n

        std = StdGate(cs)
        poseidon = PoseidonChip(cs)
        sponge = PoseidonSpongeChip(cs, std, poseidon)
        edwards = EdwardsChip(cs)
        b2n = Bits2NumChip(cs)
        eddsa = EddsaChipset(cs, std, edwards, poseidon, b2n)

        inst_col = cs.column("instance", "instance")
        inst_cells = [cs.assign(inst_col, r, pub_scores[r]) for r in range(n)]

        zero = std.constant(0)

        # Witness keys / signatures / ops.
        pk_cells = [
            (std.witness(att.pk.point.x), std.witness(att.pk.point.y))
            for att in attestations
        ]
        sig_cells = [
            (
                std.witness(att.sig.big_r.x),
                std.witness(att.sig.big_r.y),
                std.witness(att.sig.s),
            )
            for att in attestations
        ]
        ops_cells = [
            [std.witness(score) for score in att.scores] for att in attestations
        ]

        # Message hashes (circuit/src/lib.rs:225-256).
        pks_hash = sponge.squeeze(
            [pk[0] for pk in pk_cells] + [pk[1] for pk in pk_cells]
        )
        for i in range(n):
            scores_hash = sponge.squeeze(list(ops_cells[i]))
            message = poseidon.permute([pks_hash, scores_hash, zero, zero, zero])[0]
            rx, ry, s = sig_cells[i]
            eddsa.verify(pk_cells[i], (rx, ry), s, message)

        # Power iteration (circuit.rs:347-378): I rounds of
        # new_s[i] = Σ_j ops[j][i] · s[j].
        init = std.constant(self.initial_score)
        s_vec = [init] * n
        for _ in range(iters):
            new_s = []
            for i in range(n):
                acc = zero
                for j in range(n):
                    acc = std.mul_add(ops_cells[j][i], s_vec[j], acc)
                new_s.append(acc)
            s_vec = new_s

        # Instance binding (circuit.rs:380-418): pub·SCALE^I == s and
        # Σ pub == N·INITIAL_SCORE.
        scale_pow = std.constant(pow(self.scale, iters, P))
        total = zero
        for i in range(n):
            scaled = std.mul(inst_cells[i], scale_pow)
            std.assert_equal(scaled, s_vec[i])
            total = std.add(total, inst_cells[i])
        expected_total = std.constant((n * self.initial_score) % P)
        std.assert_equal(total, expected_total)


def prove_epoch_statement(
    attestations: list[Attestation], pub_scores: list[int], **params
) -> ConstraintSystem:
    """Build and return the satisfied constraint system for an epoch (a
    MockProver-style construction; raises AssertionError on an invalid
    statement)."""
    cs = ConstraintSystem()
    EigenTrustCircuit(**params).synthesize(cs, attestations, pub_scores)
    cs.assert_satisfied()
    return cs

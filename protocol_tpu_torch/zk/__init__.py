"""Proof layer: the constraint system (``cs``, ``gadgets``, ``chips``,
``eddsa``) and the epoch statement (``circuit``), KZG commitments
(``kzg``) over Bn254 (``bn254``, ``fields``), the PLONK engine
(``plonk``) with its Fiat-Shamir transcripts (``transcript``) and its
native runtime (``native``), the proving-kernel backend knob
(``graft``), and the ``Proof``/``ProofRaw`` wire types with the PLONK
and Poseidon commitment provers (``proof``).  Proof aggregation and
the EVM verifier are not ported yet (ROADMAP A5c (i-b), A12)."""

from .circuit import EigenTrustCircuit, prove_epoch_statement  # noqa: F401
from .cs import ConstraintSystem  # noqa: F401
from .proof import (  # noqa: F401
    PlonkEpochProver,
    PoseidonCommitmentProver,
    Proof,
    ProofRaw,
    Prover,
)

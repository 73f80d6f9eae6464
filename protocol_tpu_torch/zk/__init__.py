"""Proof layer: the constraint system (``cs``, ``gadgets``, ``chips``,
``eddsa``) and the epoch statement (``circuit``), KZG commitments
(``kzg``) over Bn254 (``bn254``, ``fields``), the PLONK engine
(``plonk``) with its Fiat-Shamir transcripts (``transcript``) and its
native runtime (``native``), the proving-kernel backend knob
(``graft``), the ``Proof``/``ProofRaw`` wire types with the PLONK
and Poseidon commitment provers (``proof``), and proof aggregation: the
native KZG accumulation (``aggregator``) and its in-circuit fold
(``agg_circuit`` over the emulated-Fq chips of ``wrong_field``), and
the EVM verifier contract generated from a verifying key
(``evm_verifier``, run on ``evm``)."""

from .circuit import EigenTrustCircuit, prove_epoch_statement  # noqa: F401
from .cs import ConstraintSystem  # noqa: F401
from .proof import (  # noqa: F401
    PlonkEpochProver,
    PoseidonCommitmentProver,
    Proof,
    ProofRaw,
    Prover,
)

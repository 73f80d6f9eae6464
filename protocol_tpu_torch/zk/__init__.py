"""Proof layer: the ``Proof``/``ProofRaw`` wire types, the ``Prover``
interface and the Poseidon commitment prover (``proof``).  The PLONK
prover and its circuit are not ported yet (ROADMAP A5c)."""

from .proof import PoseidonCommitmentProver, Proof, ProofRaw, Prover  # noqa: F401

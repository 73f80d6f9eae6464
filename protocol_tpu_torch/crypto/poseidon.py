"""Poseidon and Rescue-Prime permutations over Bn254 Fr.

Implements the Hades design (full/partial S-box rounds + MDS mixing) with
the reference's parameter tables, matching
circuit/src/poseidon/native/mod.rs:34-98 (permutation),
circuit/src/poseidon/native/sponge.rs:29-58 (sponge), and
circuit/src/rescue_prime/native/mod.rs:28-57 (Rescue-Prime) bit-exactly —
validated by the golden vectors from those files' tests.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import field
from ._hash_params import (
    POSEIDON_BN254_5X5_FULL_ROUNDS,
    POSEIDON_BN254_5X5_MDS,
    POSEIDON_BN254_5X5_PARTIAL_ROUNDS,
    POSEIDON_BN254_5X5_ROUND_CONSTANTS,
    POSEIDON_BN254_10X5_FULL_ROUNDS,
    POSEIDON_BN254_10X5_MDS,
    POSEIDON_BN254_10X5_PARTIAL_ROUNDS,
    POSEIDON_BN254_10X5_ROUND_CONSTANTS,
    RESCUE_PRIME_BN254_5X5_FULL_ROUNDS,
    RESCUE_PRIME_BN254_5X5_MDS,
    RESCUE_PRIME_BN254_5X5_PARTIAL_ROUNDS,
    RESCUE_PRIME_BN254_5X5_ROUND_CONSTANTS,
)

P = field.MODULUS

# x^(1/5) exponent: the inverse of 5 mod (P - 1), used by the Rescue-Prime
# inverse S-box (params/poseidon sbox_inv_f's hard-coded limbs).
_INV5_EXP = pow(5, -1, P - 1)


@dataclass(frozen=True)
class HashParams:
    """Round parameters for a Hades-style permutation
    (params/mod.rs::RoundParams)."""

    width: int
    full_rounds: int
    partial_rounds: int
    round_constants: tuple[int, ...]
    mds: tuple[tuple[int, ...], ...]

    def round_constants_count(self) -> int:
        return (self.full_rounds + self.partial_rounds) * self.width


POSEIDON_5 = HashParams(
    width=5,
    full_rounds=POSEIDON_BN254_5X5_FULL_ROUNDS,
    partial_rounds=POSEIDON_BN254_5X5_PARTIAL_ROUNDS,
    round_constants=POSEIDON_BN254_5X5_ROUND_CONSTANTS,
    mds=POSEIDON_BN254_5X5_MDS,
)

POSEIDON_10 = HashParams(
    width=10,
    full_rounds=POSEIDON_BN254_10X5_FULL_ROUNDS,
    partial_rounds=POSEIDON_BN254_10X5_PARTIAL_ROUNDS,
    round_constants=POSEIDON_BN254_10X5_ROUND_CONSTANTS,
    mds=POSEIDON_BN254_10X5_MDS,
)

RESCUE_PRIME_5 = HashParams(
    width=5,
    full_rounds=RESCUE_PRIME_BN254_5X5_FULL_ROUNDS,
    partial_rounds=RESCUE_PRIME_BN254_5X5_PARTIAL_ROUNDS,
    round_constants=RESCUE_PRIME_BN254_5X5_ROUND_CONSTANTS,
    mds=RESCUE_PRIME_BN254_5X5_MDS,
)


def _apply_mds(state: list[int], mds: tuple[tuple[int, ...], ...]) -> list[int]:
    width = len(state)
    return [
        sum(state[j] * mds[i][j] for j in range(width)) % P for i in range(width)
    ]


_sbox = field.pow5


def permute(inputs: list[int] | tuple[int, ...], params: HashParams = POSEIDON_5) -> list[int]:
    """The Hades permutation: half the full rounds, then the partial
    rounds (single S-box on lane 0), then the remaining full rounds
    (poseidon/native/mod.rs:34-98)."""
    width = params.width
    assert len(inputs) == width
    half_full = params.full_rounds // 2
    rc = params.round_constants
    mds = params.mds

    state = [x % P for x in inputs]
    idx = 0
    for _ in range(half_full):
        state = [(state[i] + rc[idx + i]) % P for i in range(width)]
        idx += width
        state = [_sbox(x) for x in state]
        state = _apply_mds(state, mds)

    for _ in range(params.partial_rounds):
        state = [(state[i] + rc[idx + i]) % P for i in range(width)]
        idx += width
        state[0] = _sbox(state[0])
        state = _apply_mds(state, mds)

    for _ in range(half_full):
        state = [(state[i] + rc[idx + i]) % P for i in range(width)]
        idx += width
        state = [_sbox(x) for x in state]
        state = _apply_mds(state, mds)

    return state


def rescue_prime_permute(
    inputs: list[int] | tuple[int, ...], params: HashParams = RESCUE_PRIME_5
) -> list[int]:
    """Rescue-Prime: alternating forward/inverse S-box layers with two MDS
    applications per round (rescue_prime/native/mod.rs:28-57)."""
    width = params.width
    assert len(inputs) == width
    rc = params.round_constants
    mds = params.mds

    state = [x % P for x in inputs]
    for r in range(params.full_rounds - 1):
        state = [_sbox(x) for x in state]
        state = _apply_mds(state, mds)
        state = [(state[i] + rc[r * width + i]) % P for i in range(width)]
        state = [pow(x, _INV5_EXP, P) for x in state]
        state = _apply_mds(state, mds)
        state = [(state[i] + rc[(r + 1) * width + i]) % P for i in range(width)]
    return state


def poseidon(inputs: list[int] | tuple[int, ...]) -> int:
    """Hash a width-5 input block, returning lane 0 of the permutation —
    the usage pattern of PoseidonNativeHasher throughout the reference
    (e.g. manager/mod.rs:108, eddsa/native.rs:108)."""
    return permute(inputs, POSEIDON_5)[0]


class PoseidonSponge:
    """Absorb-then-squeeze sponge over the width-5 Poseidon
    (poseidon/native/sponge.rs).  Inputs accumulate until ``squeeze``,
    which folds WIDTH-sized chunks into the state by lane-wise addition and
    permutes after each chunk."""

    def __init__(self, params: HashParams = POSEIDON_5):
        self.params = params
        self.inputs: list[int] = []
        self.state: list[int] = [0] * params.width

    def update(self, inputs: list[int] | tuple[int, ...]) -> None:
        self.inputs.extend(x % P for x in inputs)

    def squeeze(self) -> int:
        assert self.inputs, "squeeze on empty sponge"
        width = self.params.width
        for off in range(0, len(self.inputs), width):
            chunk = self.inputs[off : off + width]
            chunk = chunk + [0] * (width - len(chunk))
            merged = [(chunk[i] + self.state[i]) % P for i in range(width)]
            self.state = permute(merged, self.params)
        self.inputs.clear()
        return self.state[0]

"""The in-circuit aggregation stack: Poseidon transcript chipset and
the accumulation-fold circuit.

This is the rebuild of the half the reference never finished — the
in-circuit side of proof aggregation (`verifier/transcript/mod.rs:35`
PoseidonReadChipset, `verifier/loader/mod.rs` Halo2 loader,
`verifier/aggregator.rs:178-322` — all left with TODOs and a
`without_witnesses` that returns `self`, so upstream keygen cannot even
run).  Scope here, honestly stated:

- **PoseidonTranscriptChip**: exact in-circuit mirror of the native
  `PoseidonTranscript` (zk/transcript.py) — chunked absorb, chained
  squeezes with challenge re-absorption.
- **fold circuit**: given k member snarks whose deferred pairing pairs
  (Bᵢ, Aᵢ) were produced natively by `verify_deferred`, prove that the
  Fiat-Shamir challenges cᵢ derive from the member data through the
  in-circuit transcript and that the revealed accumulator is the
  scalar fold ``lhs = Σ rᵢ·Bᵢ, rhs = Σ rᵢ·Aᵢ`` computed with the
  in-circuit emulated-Fq ECC chips (zk/wrong_field.py).

The fold scalars rᵢ are the low ``challenge_bits`` of cᵢ and enter the
circuit as *public inputs*: a truncation constrained in-circuit would
need a canonical 254-bit range proof (the classic mod-P decomposition
ambiguity), so the native/EVM wrapper checks ``rᵢ == cᵢ mod 2^bits``
instead — one public-input comparison.  Batching soundness is
2^-challenge_bits.  Full succinct verification of each member inside
the circuit (deriving Bᵢ/Aᵢ in-circuit) is future work beyond both
this rebuild and the reference.

Public instance layout (one instance column):
``[per member: cᵢ, rᵢ, Bᵢ.x·4, Bᵢ.y·4, Aᵢ.x·4, Aᵢ.y·4] ++
[lhs.x·4, lhs.y·4, rhs.x·4, rhs.y·4]``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import field
from .aggregator import (
    Accumulator,
    Snark,
    absorb_members,
    check_shared_srs,
    proof_chunks,
)
from .bn254 import G1
from .cs import Cell, ConstraintSystem
from .gadgets import PoseidonChip, StdGate
from .plonk import verify_deferred
from .rns import decompose
from .transcript import PoseidonTranscript
from .wrong_field import AssignedPoint, EccChip, IntegerChip

P = field.MODULUS


class PoseidonTranscriptChip:
    """In-circuit Fiat-Shamir transcript with the native semantics of
    ``PoseidonTranscript`` (verifier/transcript/mod.rs:35 analog):
    scalars buffer until a squeeze folds them into the sponge state in
    width-5 chunks; each squeezed challenge is re-absorbed so
    successive challenges chain."""

    def __init__(self, std: StdGate, poseidon: PoseidonChip):
        self.std = std
        self.poseidon = poseidon
        self.zero = std.constant(0)
        self.state: list[Cell] = [self.zero] * poseidon.params.width
        self.pending: list[Cell] = []
        self._absorbed = False

    def common_scalar(self, cell: Cell) -> None:
        self.pending.append(cell)
        self._absorbed = True

    def squeeze_challenge(self) -> Cell:
        std, w = self.std, self.poseidon.params.width
        if not self._absorbed:
            self.pending = [self.zero]
        assert self.pending, "squeeze on empty transcript chip"
        for off in range(0, len(self.pending), w):
            chunk = list(self.pending[off : off + w])
            chunk += [self.zero] * (w - len(chunk))
            merged = [std.add(chunk[j], self.state[j]) for j in range(w)]
            self.state = self.poseidon.permute(merged)
        c = self.state[0]
        self.pending = [c]
        self._absorbed = True
        return c


@dataclass
class FoldWitness:
    """Everything the fold circuit needs about one member, produced
    natively by ``prepare_fold``."""

    vk_digest: int
    instances: list[int]
    proof: bytes
    b: G1  # deferred pair lhs
    a: G1  # deferred pair rhs
    challenge: int  # full Fr transcript challenge c_i
    scalar: int  # r_i = c_i mod 2^challenge_bits


@dataclass
class FoldStatement:
    """Native result bundle: member witnesses + folded accumulator +
    the circuit's public-instance vector."""

    members: list[FoldWitness]
    accumulator: Accumulator
    challenge_bits: int

    def public_inputs(self) -> list[int]:
        pub: list[int] = []
        for m in self.members:
            pub.append(m.challenge)
            pub.append(m.scalar)
            for coord in (m.b.x, m.b.y, m.a.x, m.a.y):
                pub.extend(decompose(coord))
        for coord in (
            self.accumulator.lhs.x,
            self.accumulator.lhs.y,
            self.accumulator.rhs.x,
            self.accumulator.rhs.y,
        ):
            pub.extend(decompose(coord))
        return pub


def prepare_fold(snarks: list[Snark], challenge_bits: int = 128) -> FoldStatement:
    """Native half of the fold (the same member-binding transcript as
    aggregator.accumulate, with the truncated fold scalars the circuit
    uses): derive per-member deferred pairs and transcript challenges,
    fold with rᵢ."""
    check_shared_srs(snarks)
    t = PoseidonTranscript()
    absorb_members(t, snarks)

    members: list[FoldWitness] = []
    lhs, rhs = G1(0, 0), G1(0, 0)
    mask = (1 << challenge_bits) - 1
    for s in snarks:
        pair = verify_deferred(s.vk, s.instances, s.proof, s.transcript)
        if pair is None:
            raise ValueError("member proof failed deferred verification")
        b, a = pair
        c = t.squeeze_challenge()
        r = c & mask
        members.append(
            FoldWitness(
                vk_digest=s.vk.digest,
                instances=s.instance_values(),
                proof=s.proof,
                b=b,
                a=a,
                challenge=c,
                scalar=r,
            )
        )
        lhs = lhs.add(b.mul(r))
        rhs = rhs.add(a.mul(r))
    return FoldStatement(
        members=members,
        accumulator=Accumulator(lhs=lhs, rhs=rhs),
        challenge_bits=challenge_bits,
    )


def synthesize_fold(stmt: FoldStatement) -> ConstraintSystem:
    """Build the fold circuit for a prepared statement (the working
    analog of Aggregator::synthesize, verifier/aggregator.rs:225-322)."""
    cs = ConstraintSystem()
    std = StdGate(cs)
    poseidon = PoseidonChip(cs)
    integer = IntegerChip(cs, std)
    ecc = EccChip(cs, std, integer)
    transcript = PoseidonTranscriptChip(std, poseidon)

    pub = stmt.public_inputs()
    inst_col = cs.column("instance", "instance")
    inst_cells = [cs.assign(inst_col, r, v) for r, v in enumerate(pub)]
    inst_iter = iter(inst_cells)

    # Absorb every member exactly like the native transcript.
    for m in stmt.members:
        transcript.common_scalar(std.witness(m.vk_digest))
        for v in m.instances:
            transcript.common_scalar(std.witness(v))
        transcript.common_scalar(std.constant(len(m.proof)))
        for chunk in proof_chunks(m.proof):
            transcript.common_scalar(std.witness(chunk))

    # Per member: challenge equality, pair points, scalar mul, fold.
    acc_lhs: AssignedPoint | None = None
    acc_rhs: AssignedPoint | None = None
    member_points: list[tuple[Cell, AssignedPoint, AssignedPoint]] = []
    for m in stmt.members:
        c = transcript.squeeze_challenge()
        c_inst = next(inst_iter)
        cs.copy(c_inst, c)
        r_inst = next(inst_iter)
        b_pt = ecc.witness(m.b.x, m.b.y)
        a_pt = ecc.witness(m.a.x, m.a.y)
        for pt in (b_pt, a_pt):
            for coord in (pt.x, pt.y):
                for limb in coord.limbs:
                    cs.copy(next(inst_iter), limb)
        member_points.append((r_inst, b_pt, a_pt))

    for r_inst, b_pt, a_pt in member_points:
        rb = ecc.scalar_mul(b_pt, r_inst, stmt.challenge_bits)
        ra = ecc.scalar_mul(a_pt, r_inst, stmt.challenge_bits)
        acc_lhs = rb if acc_lhs is None else ecc.add_incomplete(acc_lhs, rb)
        acc_rhs = ra if acc_rhs is None else ecc.add_incomplete(acc_rhs, ra)

    for pt in (acc_lhs, acc_rhs):
        for coord in (pt.x, pt.y):
            for limb in coord.limbs:
                cs.copy(next(inst_iter), limb)
    assert next(inst_iter, None) is None, "instance layout mismatch"
    return cs


def verify_fold(
    fold_vk,
    snarks: list[Snark],
    fold_proof: bytes,
    challenge_bits: int = 128,
    transcript: str = "poseidon",
) -> bool:
    """Full verification of a fold proof: recompute the expected public
    inputs natively (transcript challenges, deferred pairs, truncated
    scalars, folded accumulator), check the PLONK proof against them,
    then run the one decisive pairing check."""
    from . import plonk
    from .aggregator import finalize

    try:
        stmt = prepare_fold(snarks, challenge_bits)
    except ValueError:
        return False
    pub = stmt.public_inputs()
    if not plonk.verify(fold_vk, pub, fold_proof, transcript=transcript):
        return False
    return finalize(stmt.accumulator, snarks[0].vk)

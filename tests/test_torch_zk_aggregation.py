"""The port's proof aggregation against the reference package's.

``zk.wrong_field`` (emulated-Fq integers and G1 in-circuit), the native
KZG accumulation ``zk.aggregator`` and the fold circuit
``zk.agg_circuit``, each checked as the reference's own tests check it
(``tests/test_wrong_field.py``, ``test_zk_aggregation.py``,
``test_agg_circuit.py`` and ``test_plonk.py``'s aggregation cases), then
held against the reference on the same inputs: the same member proofs
give the same accumulator bytes, the same fold instance and the same
circuit, trace cell for trace cell.

The fold circuit over two small members has 240,838 rows at
``challenge_bits=16`` (k = 18), so proving it is marked ``slow``, as is
the manager case that proves two epochs on the host.
"""

import json
import random

import pytest

from protocol_tpu.zk import agg_circuit as ref_agg_circuit
from protocol_tpu.zk import aggregator as ref_aggregator
from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu.zk import wrong_field as ref_wrong_field
from protocol_tpu.zk.cs import ConstraintSystem as RefConstraintSystem
from protocol_tpu.zk.gadgets import StdGate as RefStdGate
from protocol_tpu.zk.kzg import Setup as RefSetup
from protocol_tpu_torch.crypto import field
from protocol_tpu_torch.zk import plonk
from protocol_tpu_torch.zk.agg_circuit import (
    PoseidonTranscriptChip,
    prepare_fold,
    synthesize_fold,
    verify_fold,
)
from protocol_tpu_torch.zk.aggregator import (
    Accumulator,
    Snark,
    accumulate,
    aggregate_verify,
    finalize,
)
from protocol_tpu_torch.zk.bn254 import G1, GENERATOR, GROUP_ORDER, IDENTITY, is_on_curve
from protocol_tpu_torch.zk.cs import ConstraintSystem
from protocol_tpu_torch.zk.gadgets import PoseidonChip, StdGate
from protocol_tpu_torch.zk.kzg import Setup
from protocol_tpu_torch.zk.rns import FQ_MODULUS, WrongFieldInteger, compose
from protocol_tpu_torch.zk.transcript import PoseidonRead, PoseidonTranscript, PoseidonWrite
from protocol_tpu_torch.zk.wrong_field import EccChip, IntegerChip

P = field.MODULUS
#: The test tier's batching width; the production default is 128.
BITS = 16


def trace_of(cs) -> dict:
    """A constraint system's assigned cells by (column name, row)."""
    return {(c.name, r): v for c, rows in cs.trace.items() for r, v in rows.items()}


# -- wrong field -----------------------------------------------------------


def _chips(mods=(ConstraintSystem, StdGate, IntegerChip)):
    cs_cls, std_cls, int_cls = mods
    cs = cs_cls()
    std = std_cls(cs)
    return cs, std, int_cls(cs, std)


REF_CHIPS = (RefConstraintSystem, RefStdGate, ref_wrong_field.IntegerChip)


class TestIntegerChip:
    def test_witness_roundtrip_and_range(self):
        cs, std, chip = _chips()
        v = random.Random(1).randrange(FQ_MODULUS)
        a = chip.witness(v)
        assert a.value(std) == v
        cs.assert_satisfied()

    def test_add_sub_mul_div_match_native(self):
        cs, std, chip = _chips()
        rng = random.Random(2)
        for _ in range(3):
            x, y = rng.randrange(FQ_MODULUS), rng.randrange(1, FQ_MODULUS)
            a, b = chip.witness(x), chip.witness(y)
            assert chip.add(a, b).value(std) == (x + y) % FQ_MODULUS
            assert chip.sub(a, b).value(std) == (x - y) % FQ_MODULUS
            assert chip.mul(a, b).value(std) == (x * y) % FQ_MODULUS
            assert chip.div(a, b).value(std) == x * pow(y, -1, FQ_MODULUS) % FQ_MODULUS
            wa, wb = WrongFieldInteger.from_value(x), WrongFieldInteger.from_value(y)
            assert wa.mul(wb).result.value() == (x * y) % FQ_MODULUS
        cs.assert_satisfied()

    def test_tampered_mul_result_unsatisfiable(self):
        cs, std, chip = _chips()
        r = chip.mul(chip.witness(1234567), chip.witness(7654321))
        cell = r.limbs[0]
        cs.trace[cell.column][cell.row] = (cs.value(cell.column, cell.row) + 1) % P
        with pytest.raises(AssertionError):
            cs.assert_satisfied()

    def test_tampered_quotient_unsatisfiable(self):
        cs, std, chip = _chips()
        chip.mul(chip.witness(FQ_MODULUS - 2), chip.witness(FQ_MODULUS - 3))
        col = std.a
        tampered = False
        for row in sorted(cs.trace[col]):
            orig = cs.trace[col][row]
            cs.trace[col][row] = (orig + 1) % P
            try:
                cs.assert_satisfied()
            except AssertionError:
                tampered = True
                cs.trace[col][row] = orig
                break
            cs.trace[col][row] = orig
        assert tampered, "no witness perturbation was caught"

    def test_non_canonical_limb_rejected(self):
        cs, std, chip = _chips()
        cells = [std.witness(v) for v in ((1 << 68) + 5, 0, 0, 0)]
        with pytest.raises(AssertionError):
            chip.from_limb_cells(cells)
            cs.assert_satisfied()

    @pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
    def test_trace_equal_to_the_reference(self, op):
        """The same operation on the same operands assigns the same cells
        in both packages."""
        rng = random.Random(3)
        x, y = rng.randrange(FQ_MODULUS), rng.randrange(1, FQ_MODULUS)
        out = []
        for mods in ((ConstraintSystem, StdGate, IntegerChip), REF_CHIPS):
            cs, std, chip = _chips(mods)
            r = getattr(chip, op)(chip.witness(x), chip.witness(y))
            out.append((r.value(std), cs.n_rows, trace_of(cs)))
        assert out[0] == out[1]


class TestEccChip:
    def _ecc(self, mods=(ConstraintSystem, StdGate, IntegerChip), ecc_cls=EccChip):
        cs, std, integer = _chips(mods)
        return cs, std, ecc_cls(cs, std, integer)

    def test_add_double_match_native(self):
        cs, std, ecc = self._ecc()
        g = G1(1, 2)
        p2, q2 = g.mul(5), g.mul(11)
        a, b = ecc.witness(p2.x, p2.y), ecc.witness(q2.x, q2.y)
        expect = p2.add(q2)
        assert ecc.add_incomplete(a, b).values(std) == (expect.x, expect.y)
        expect2 = p2.add(p2)
        assert ecc.double(a).values(std) == (expect2.x, expect2.y)
        cs.assert_satisfied()

    def test_off_curve_point_rejected(self):
        cs, std, ecc = self._ecc()
        with pytest.raises(AssertionError):
            ecc.witness(3, 5)
            cs.assert_satisfied()

    def test_scalar_mul_matches_native(self):
        cs, std, ecc = self._ecc()
        base = G1(1, 2).mul(7)
        k = 0xB7
        out = ecc.scalar_mul(ecc.witness(base.x, base.y), ecc.std.witness(k), n_bits=8)
        expect = base.mul(k)
        assert out.values(std) == (expect.x, expect.y)
        cs.assert_satisfied()

    def test_scalar_mul_tampered_bit_unsatisfiable(self):
        cs, std, ecc = self._ecc()
        base = G1(1, 2).mul(3)
        ecc.scalar_mul(ecc.witness(base.x, base.y), ecc.std.witness(0x5), n_bits=4)
        bit_col = ecc.b2n.bit
        row = min(cs.trace[bit_col])
        cs.trace[bit_col][row] = 1 - cs.trace[bit_col][row]
        with pytest.raises(AssertionError):
            cs.assert_satisfied()

    def test_scalar_mul_trace_equal_to_the_reference(self):
        out = []
        for mods, ecc_cls in (((ConstraintSystem, StdGate, IntegerChip), EccChip),
                              (REF_CHIPS, ref_wrong_field.EccChip)):
            cs, std, ecc = self._ecc(mods, ecc_cls)
            base = G1(1, 2).mul(9)
            r = ecc.scalar_mul(ecc.witness(base.x, base.y), ecc.std.witness(0x3C), n_bits=6)
            out.append((r.values(std), cs.n_rows, trace_of(cs)))
        assert out[0] == out[1]


# -- native arithmetic the aggregation rests on ------------------------------


rng = random.Random(21)


class TestRns:
    @pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
    def test_reduction_witnesses(self, op):
        for _ in range(10):
            a = WrongFieldInteger.from_value(rng.randrange(FQ_MODULUS))
            b = WrongFieldInteger.from_value(rng.randrange(1, FQ_MODULUS))
            witness = getattr(a, op)(b)
            assert witness.check(a, b), op
            expect = {
                "add": (a.value() + b.value()) % FQ_MODULUS,
                "sub": (a.value() - b.value()) % FQ_MODULUS,
                "mul": (a.value() * b.value()) % FQ_MODULUS,
                "div": a.value() * pow(b.value(), -1, FQ_MODULUS) % FQ_MODULUS,
            }[op]
            assert witness.result.value() == expect

    def test_forged_witness_rejected(self):
        a, b = WrongFieldInteger.from_value(123), WrongFieldInteger.from_value(456)
        w = a.mul(b)
        forged = type(w)(result=WrongFieldInteger.from_value(w.result.value() + 1),
                         quotient=w.quotient, op="mul")
        assert not forged.check(a, b)

    def test_fr_limbs_fit_scalar_field(self):
        v = WrongFieldInteger.from_value(FQ_MODULUS - 1)
        assert all(x < P for x in v.to_fr_limbs())
        assert compose(v.limbs) == FQ_MODULUS - 1


class TestBn254G1:
    def test_group_order(self):
        assert is_on_curve(GENERATOR)
        assert GENERATOR.mul(GROUP_ORDER) == IDENTITY

    def test_scalar_mul_matches_addition_chain(self):
        acc = IDENTITY
        for k in range(8):
            assert acc == GENERATOR.mul(k)
            acc = acc.add(GENERATOR)

    def test_identity_laws(self):
        p = GENERATOR.mul(5)
        assert IDENTITY.add(p) == p and p.add(IDENTITY) == p
        assert IDENTITY.double() == IDENTITY
        assert p.add(p.neg()) == IDENTITY


class TestPoseidonTranscript:
    def test_transcript_binds_messages(self):
        w1, w2 = PoseidonWrite(), PoseidonWrite()
        w1.write_scalar(1)
        w2.write_scalar(2)
        assert w1.squeeze_challenge() != w2.squeeze_challenge()

    def test_successive_challenges_differ(self):
        w = PoseidonWrite()
        w.write_scalar(9)
        assert w.squeeze_challenge() != w.squeeze_challenge()

    def test_off_curve_point_rejected(self):
        with pytest.raises(ValueError, match="not on curve"):
            PoseidonWrite().write_point(G1(5, 5))

    def test_truncated_proof_rejected(self):
        w = PoseidonWrite()
        w.write_scalar(7)
        with pytest.raises(ValueError, match="exhausted"):
            PoseidonRead(w.finalize()[:16]).read_scalar()


# -- native accumulation ---------------------------------------------------


def _abc_circuit(cs_cls, std_cls, a, b, c, pub):
    cs = cs_cls()
    std = std_cls(cs)
    out = std.add(std.mul(std.witness(a), std.witness(b)), std.witness(c))
    inst = cs.column("instance", "instance")
    cs.copy(cs.assign(inst, 0, pub), out)
    return cs


MEMBERS = [(b"1", (3, 4, 5)), (b"2", (2, 8, 3)), (b"3", (6, 6, 6))]


@pytest.fixture(scope="module")
def batch():
    """Three proofs of ``a·b + c = pub`` on one SRS, made by each package
    from the same setup seed and proving seeds: (port snarks, reference
    snarks)."""
    out = []
    for plonk_mod, setup_cls, snark_cls, cs_cls, std_cls in (
        (plonk, Setup, Snark, ConstraintSystem, StdGate),
        (ref_plonk, RefSetup, ref_aggregator.Snark, RefConstraintSystem, RefStdGate),
    ):
        srs = setup_cls.generate(8, seed=b"agg-test")
        pk = plonk_mod.compile_circuit(_abc_circuit(cs_cls, std_cls, 3, 4, 5, 17), srs=srs)
        snarks = []
        for seed, (a, b, c) in MEMBERS:
            pub = a * b + c
            proof = plonk_mod.prove(pk, _abc_circuit(cs_cls, std_cls, a, b, c, pub), [pub],
                                    seed=seed)
            snarks.append(snark_cls(pk.vk, [pub], proof))
        out.append(snarks)
    return tuple(out)


class TestAggregation:
    def test_batch_of_three_verifies(self, batch):
        assert aggregate_verify(batch[0])

    def test_single_also_verifies(self, batch):
        assert aggregate_verify(batch[0][:1])

    def test_wrong_instance_member_rejects_batch(self, batch):
        s = batch[0]
        bad = Snark(s[0].vk, [20], s[1].proof)
        assert not aggregate_verify([s[0], bad, s[2]])

    def test_tampered_member_rejects_batch(self, batch):
        s = batch[0]
        t = bytearray(s[2].proof)
        t[40] ^= 1
        assert not aggregate_verify([s[0], s[1], Snark(s[2].vk, s[2].instances, bytes(t))])

    def test_accumulator_roundtrip(self, batch):
        acc = accumulate(batch[0])
        assert acc is not None
        assert finalize(Accumulator.from_bytes(acc.to_bytes()), batch[0][0].vk)

    def test_accumulator_refuses_bad_bytes(self, batch):
        data = accumulate(batch[0]).to_bytes()
        with pytest.raises(ValueError, match="128 bytes"):
            Accumulator.from_bytes(data[:-1])
        with pytest.raises(ValueError, match="non-canonical"):
            Accumulator.from_bytes(FQ_MODULUS.to_bytes(32, "little") + data[32:])
        with pytest.raises(ValueError, match="not on curve"):
            Accumulator.from_bytes((1).to_bytes(32, "little") + data[32:])

    def test_mixed_srs_refused(self, batch):
        other = Setup.generate(8, seed=b"other")
        pk = plonk.compile_circuit(_abc_circuit(ConstraintSystem, StdGate, 3, 4, 5, 17), srs=other)
        with pytest.raises(ValueError, match="share one SRS"):
            accumulate([batch[0][0], Snark(pk.vk, [17], batch[0][0].proof)])
        with pytest.raises(ValueError, match="nothing to accumulate"):
            accumulate([])

    def test_deferred_pairing_matches_direct(self, batch):
        from protocol_tpu_torch.zk.fields import pairing_check

        s = batch[0][0]
        b, a = plonk.verify_deferred(s.vk, s.instances, s.proof)
        assert pairing_check([(b, s.vk.srs.g2), (a.neg(), s.vk.srs.tau_g2)])
        assert plonk.verify(s.vk, s.instances, s.proof)

    @pytest.mark.parametrize("members", [[0], [0, 1, 2], [2, 0]])
    def test_accumulator_bytes_equal_to_the_reference(self, batch, members):
        ours, theirs = batch
        for i in members:
            assert ours[i].proof == theirs[i].proof
        got = accumulate([ours[i] for i in members])
        want = ref_aggregator.accumulate([theirs[i] for i in members])
        assert got.to_bytes() == want.to_bytes()
        assert finalize(got, ours[0].vk) and ref_aggregator.finalize(want, theirs[0].vk)


# -- the fold circuit ------------------------------------------------------


class TestTranscriptChip:
    def test_matches_native_transcript(self):
        cs = ConstraintSystem()
        std = StdGate(cs)
        chip = PoseidonTranscriptChip(std, PoseidonChip(cs))
        native = PoseidonTranscript()
        seq = [3, 1 << 100, P - 2, 7, 9, 11, 13, 17]
        for v in seq[:3]:
            chip.common_scalar(std.witness(v))
            native.common_scalar(v)
        assert std.cell_value(chip.squeeze_challenge()) == native.squeeze_challenge()
        for v in seq[3:]:
            chip.common_scalar(std.witness(v))
            native.common_scalar(v)
        assert std.cell_value(chip.squeeze_challenge()) == native.squeeze_challenge()
        assert std.cell_value(chip.squeeze_challenge()) == native.squeeze_challenge()
        cs.assert_satisfied()

    def test_empty_squeeze_matches_native(self):
        cs = ConstraintSystem()
        std = StdGate(cs)
        chip = PoseidonTranscriptChip(std, PoseidonChip(cs))
        assert std.cell_value(chip.squeeze_challenge()) == PoseidonTranscript().squeeze_challenge()
        cs.assert_satisfied()


def _mul_add(cs_cls, std_cls):
    """out = 3*4 + 5, bound to the public instance (``test_plonk.py``'s
    member circuit)."""
    return _abc_circuit(cs_cls, std_cls, 3, 4, 5, 17)


def member_snarks(n=2, seed=b"agg", ref=False):
    """``n`` small mul-add member proofs on one SRS, by the port, or by
    the reference with ``ref``: the same bytes either way."""
    plonk_mod, setup_cls, snark_cls, cs_cls, std_cls = (
        (ref_plonk, RefSetup, ref_aggregator.Snark, RefConstraintSystem, RefStdGate) if ref
        else (plonk, Setup, Snark, ConstraintSystem, StdGate)
    )
    srs = setup_cls.generate(6, seed=seed)
    snarks = []
    for i in range(n):
        cs = _mul_add(cs_cls, std_cls)
        pk = plonk_mod.compile_circuit(cs, srs=srs)
        proof = plonk_mod.prove(pk, cs, [17], seed=b"m%d" % i, transcript="poseidon")
        snarks.append(snark_cls(vk=pk.vk, instances=[17], proof=proof))
    return snarks


@pytest.fixture(scope="module")
def members():
    return member_snarks(), member_snarks(ref=True)


@pytest.fixture(scope="module")
def fold(members):
    """The prepared statement over the port's two members and its
    synthesized circuit."""
    stmt = prepare_fold(members[0], challenge_bits=BITS)
    return stmt, synthesize_fold(stmt)


class TestFoldCircuit:
    def test_fold_constraints_and_native_agreement(self, members, fold):
        stmt, cs = fold
        assert finalize(stmt.accumulator, members[0][0].vk)
        cs.assert_satisfied()
        # 240,838 rows: k = 18 (a power of two above the rows).
        assert cs.n_rows == 240_838

    def test_tampered_member_pair_unsatisfiable(self, members):
        stmt = prepare_fold(members[0], challenge_bits=BITS)
        stmt.members[0].b = stmt.members[0].b.add(stmt.members[0].a)
        with pytest.raises((AssertionError, ValueError)):
            synthesize_fold(stmt).assert_satisfied()

    def test_tampered_challenge_unsatisfiable(self, members):
        stmt = prepare_fold(members[0], challenge_bits=BITS)
        stmt.members[0].challenge = (stmt.members[0].challenge + 1) % P
        with pytest.raises(AssertionError):
            synthesize_fold(stmt).assert_satisfied()

    def test_statement_and_rows_equal_to_the_reference(self, members, fold):
        ours, theirs = members
        assert [s.proof for s in ours] == [s.proof for s in theirs]
        stmt, cs = fold
        ref_stmt = ref_agg_circuit.prepare_fold(theirs, challenge_bits=BITS)
        assert stmt.public_inputs() == ref_stmt.public_inputs()
        assert stmt.accumulator.to_bytes() == ref_stmt.accumulator.to_bytes()
        assert cs.n_rows == ref_agg_circuit.synthesize_fold(ref_stmt).n_rows

    def test_failing_member_refused(self, members):
        s = members[0]
        bad = Snark(s[0].vk, [18], s[0].proof)
        with pytest.raises(ValueError, match="deferred verification"):
            prepare_fold([bad, s[1]], challenge_bits=BITS)
        assert not verify_fold(None, [bad, s[1]], b"", challenge_bits=BITS)


@pytest.mark.slow
class TestFoldProof:
    def test_fold_proof_roundtrip(self, members, fold):
        stmt, cs = fold
        pk = plonk.compile_circuit(cs)
        proof = plonk.prove(pk, cs, stmt.public_inputs(), transcript="poseidon")
        assert verify_fold(pk.vk, members[0], proof, challenge_bits=BITS)
        assert not verify_fold(pk.vk, member_snarks(seed=b"agg2"), proof, challenge_bits=BITS)


# -- the node surface -----------------------------------------------------


class TestAggregationSurface:
    def test_commitment_prover_rejects_aggregation(self):
        from protocol_tpu_torch.node.epoch import Epoch
        from protocol_tpu_torch.node.errors import EigenError
        from protocol_tpu_torch.node.manager import Manager, ManagerConfig
        from protocol_tpu_torch.node.server import handle_request

        mgr = Manager(ManagerConfig(prover="commitment", device="cpu"))
        mgr.generate_initial_attestations()
        mgr.calculate_proofs(Epoch(1))
        with pytest.raises(EigenError):
            mgr.aggregate_proofs([Epoch(1)])
        assert handle_request("GET", "/aggregate?epochs=1", mgr)[0] == 400

    @pytest.mark.parametrize("path", ["/aggregate", "/aggregate?epochs=", "/aggregate?epochs=x",
                                      "/aggregate?epochs=9"])
    def test_aggregate_bad_queries(self, path):
        from protocol_tpu_torch.node.manager import Manager, ManagerConfig
        from protocol_tpu_torch.node.server import handle_request

        mgr = Manager(ManagerConfig(prover="commitment", device="cpu"))
        assert handle_request("GET", path, mgr)[0] == 400


@pytest.mark.slow
class TestAggregationSurfaceSlow:
    def test_manager_aggregates_two_epochs(self):
        from protocol_tpu_torch.node.bootstrap import FIXED_SET
        from protocol_tpu_torch.node.epoch import Epoch
        from protocol_tpu_torch.node.manager import Manager, ManagerConfig
        from protocol_tpu_torch.node.server import handle_request

        mgr = Manager(ManagerConfig(prover="plonk", num_neighbours=2, num_iter=1,
                                    fixed_set=list(FIXED_SET[:2]), device="cpu"))
        mgr.generate_initial_attestations()
        mgr.calculate_proofs(Epoch(3))
        mgr.calculate_proofs(Epoch(7))
        ok, acc = mgr.aggregate_proofs([Epoch(3), Epoch(7)])
        assert ok and acc is not None
        status, body = handle_request("GET", "/aggregate?epochs=3,7", mgr)
        obj = json.loads(body)
        assert status == 200 and obj["ok"] and obj["epochs"] == [3, 7]
        assert len(bytes.fromhex(obj["accumulator"])) == 128
        proof = mgr.cached_proofs[Epoch(7)]
        bad = bytearray(proof.proof)
        bad[11] ^= 1
        mgr.cached_proofs[Epoch(7)] = type(proof)(pub_ins=proof.pub_ins, proof=bytes(bad))
        assert not mgr.aggregate_proofs([Epoch(3), Epoch(7)])[0]

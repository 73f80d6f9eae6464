"""The port's proof-system arithmetic against the reference package's on
the same seeded inputs: Keccak-256 on fixed vectors, Bn254 G1 and the
foreign-field limbs, the Fq2/Fq12 tower, G2 and the ate pairing, the
Poseidon and Keccak Fiat-Shamir transcripts, and the KZG setup's bytes
(generated from a seed and read from the committed ``data/srs-15.bin``)."""

import pathlib
import random

import numpy as np
import pytest

from protocol_tpu.crypto import keccak as ref_keccak
from protocol_tpu.zk import bn254 as ref_bn254
from protocol_tpu.zk import fields as ref_fields
from protocol_tpu.zk import kzg as ref_kzg
from protocol_tpu.zk import rns as ref_rns
from protocol_tpu.zk import transcript as ref_transcript
from protocol_tpu_torch.crypto import keccak
from protocol_tpu_torch.crypto.field import MODULUS as R
from protocol_tpu_torch.zk import bn254, fields, kzg, rns, transcript

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def g1(mod, p):
    return mod.G1(p.x, p.y)


class TestKeccak:
    @pytest.mark.parametrize(
        "data, digest",
        [
            (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
            (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
        ],
    )
    def test_known_digests(self, data, digest):
        assert keccak.keccak256(data).hex() == digest
        assert ref_keccak.keccak256(data).hex() == digest

    @pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 271, 272, 1000])
    def test_equal_to_the_reference_about_the_rate(self, length):
        data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
        assert keccak.keccak256(data) == ref_keccak.keccak256(data)

    def test_selector_and_topic(self):
        assert keccak.selector("transfer(address,uint256)").hex() == "a9059cbb"
        sig = "Transfer(address,address,uint256)"
        assert keccak.event_topic(sig) == ref_keccak.event_topic(sig)


class TestCurveAndLimbs:
    def test_g1_group_law_equal(self):
        rnd = random.Random(7)
        for _ in range(4):
            a, b = rnd.randrange(R), rnd.randrange(R)
            p, q = bn254.GENERATOR.mul(a), bn254.GENERATOR.mul(b)
            rp, rq = ref_bn254.GENERATOR.mul(a), ref_bn254.GENERATOR.mul(b)
            assert tuple(p.add(q)) == tuple(rp.add(rq))
            assert tuple(p.double()) == tuple(rp.double())
            assert bn254.is_on_curve(p.add(q))
        assert bn254.GENERATOR.mul(R).is_identity()
        assert bn254.GENERATOR.add(bn254.GENERATOR.neg()) == bn254.IDENTITY

    def test_foreign_field_limbs_equal(self):
        rnd = random.Random(8)
        for _ in range(8):
            v = rnd.randrange(rns.FQ_MODULUS)
            assert rns.decompose(v) == ref_rns.decompose(v)
            assert rns.compose(rns.decompose(v)) == v


class TestPairing:
    def test_fq12_inverse_equal(self):
        rnd = random.Random(9)
        coeffs = [rnd.randrange(1 << 60) for _ in range(12)]
        x, rx = fields.FQP(coeffs), ref_fields.FQP(coeffs)
        assert x.inv().coeffs == rx.inv().coeffs
        assert x * x.inv() == fields.FQP.one()

    def test_g2_equal_and_in_subgroup(self):
        p = fields.G2_GENERATOR.mul(12345)
        rp = ref_fields.G2_GENERATOR.mul(12345)
        assert [list(c.coeffs) for c in p] == [list(c.coeffs) for c in rp]
        assert fields.g2_is_on_curve(p) and fields.g2_in_subgroup(p)

    def test_bilinearity(self):
        a, b = 1234567, 987654321
        e = fields.pairing(fields.G2_GENERATOR, bn254.GENERATOR)
        assert e != fields.FQP.one()
        eab = fields.pairing(fields.G2_GENERATOR.mul(b), bn254.GENERATOR.mul(a))
        assert eab == e.pow(a * b % R)
        ref_eab = ref_fields.pairing(ref_fields.G2_GENERATOR.mul(b), ref_bn254.GENERATOR.mul(a))
        assert eab.coeffs == ref_eab.coeffs

    def test_pairing_check(self):
        a = 31337
        pairs = [(bn254.GENERATOR.mul(a), fields.G2_GENERATOR),
                 (bn254.GENERATOR.neg(), fields.G2_GENERATOR.mul(a))]
        assert fields.pairing_check(pairs)
        assert not fields.pairing_check(
            [pairs[0], (bn254.GENERATOR.neg(), fields.G2_GENERATOR.mul(a + 1))]
        )


class TestTranscripts:
    @pytest.mark.parametrize("kind", ["poseidon", "keccak"])
    def test_write_then_read_equal_to_the_reference(self, kind):
        cls = {"poseidon": "Poseidon", "keccak": "Keccak"}[kind]
        rnd = random.Random(10)
        scalars = [rnd.randrange(R) for _ in range(3)]
        points = [bn254.GENERATOR.mul(rnd.randrange(R)) for _ in range(2)]
        ours = getattr(transcript, f"{cls}Write")()
        theirs = getattr(ref_transcript, f"{cls}Write")()
        challenges = []
        for t, mod in ((ours, bn254), (theirs, ref_bn254)):
            t.common_scalar(5)
            for s in scalars:
                t.write_scalar(s)
            for p in points:
                t.write_point(g1(mod, p))
            challenges.append(t.squeeze_challenge())
        assert challenges[0] == challenges[1]
        proof = ours.finalize()
        assert proof == theirs.finalize()
        reader = getattr(transcript, f"{cls}Read")(proof)
        reader.common_scalar(5)
        assert [reader.read_scalar() for _ in scalars] == scalars
        assert [tuple(reader.read_point()) for _ in points] == [tuple(p) for p in points]
        assert reader.squeeze_challenge() == challenges[0]


class TestSetup:
    @pytest.mark.parametrize("k", [3, 7])
    def test_generate_bytes_equal(self, k):
        ours = kzg.Setup.generate(k, seed=b"parity")
        theirs = ref_kzg.Setup.generate(k, seed=b"parity")
        assert ours.to_bytes() == theirs.to_bytes()
        assert kzg.Setup.from_bytes(ours.to_bytes()).to_bytes() == ours.to_bytes()

    def test_committed_srs_round_trip(self):
        blob = (DATA / "srs-15.bin").read_bytes()
        srs = kzg.Setup.from_bytes(blob)
        assert srs.k == 15 and len(srs.g1_powers) == 1 << 15
        assert srs.to_bytes() == blob
        assert fields.pairing_check(
            [(srs.g1_powers[1], srs.g2), (srs.g1_powers[0].neg(), srs.tau_g2)]
        )
        with pytest.raises(ValueError, match="magic"):
            kzg.Setup.from_bytes(b"X" + blob[1:])
        with pytest.raises(ValueError, match="length"):
            kzg.Setup.from_bytes(blob[:-1])

    def test_commit_open_verify(self):
        srs = kzg.Setup.generate(6, seed=b"kzg")
        rnd = random.Random(11)
        coeffs = [rnd.randrange(R) for _ in range(40)]
        c = srs.commit(coeffs)
        theirs = ref_kzg.Setup.generate(6, seed=b"kzg")
        assert tuple(c) == tuple(theirs.commit(coeffs))
        z = rnd.randrange(R)
        y, w = srs.open(coeffs, z)
        assert y == kzg._eval_poly(coeffs, z)
        assert srs.verify(c, z, y, w)
        assert not srs.verify(c, z, (y + 1) % R, w)

"""The port's host crypto and the other host leaves the node needs, held
bit for bit against the reference package on the same seeded inputs:
field elements, Poseidon states, BabyJubJub points, EdDSA keys and
signatures, message hashes, the attestation wire form, the C++ runtime
the port builds from ``native/``, the peer partition, the exact
fixed-set kernels and the proof-job seed."""

import random

import numpy as np
import pytest

from protocol_tpu import crypto as ref_crypto
from protocol_tpu.crypto import babyjubjub as ref_bjj
from protocol_tpu.crypto import blake512 as ref_blake
from protocol_tpu.crypto import eddsa as ref_eddsa
from protocol_tpu.crypto import field as ref_field
from protocol_tpu.crypto import poseidon as ref_poseidon
from protocol_tpu.node import attestation as ref_att
from protocol_tpu.node import bootstrap as ref_boot
from protocol_tpu.parallel import partition as ref_part
from protocol_tpu.prover import jobs as ref_jobs
from protocol_tpu.trust import native as ref_native
from protocol_tpu.utils.codec import b58encode as ref_b58encode
from protocol_tpu_torch import crypto
from protocol_tpu_torch.crypto import babyjubjub, blake512, eddsa, field, poseidon
from protocol_tpu_torch.crypto import native as cnative
from protocol_tpu_torch.node import attestation, bootstrap
from protocol_tpu_torch.parallel import partition
from protocol_tpu_torch.prover import jobs
from protocol_tpu_torch.trust import native
from protocol_tpu_torch.utils.codec import b58decode, b58encode

ALICE_PK_HASH = "92tZdMN2SjXbT9byaHHt7hDDNXUphjwRt5UB3LDbgSmR"


def elements(seed: int, n: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(field.MODULUS) for _ in range(n)]


class TestField:
    def test_arithmetic_bit_equal(self):
        xs, ys = elements(1, 64), elements(2, 64)
        for x, y in zip(xs, ys):
            assert field.add(x, y) == ref_field.add(x, y)
            assert field.mul(x, y) == ref_field.mul(x, y)
            assert field.sub(x, y) == ref_field.sub(x, y)
            assert field.inv(y) == ref_field.inv(y)
            assert field.to_le_bytes(x) == ref_field.to_le_bytes(x)

    def test_wide_reduction_bit_equal(self):
        rng = random.Random(3)
        for _ in range(32):
            wide = bytes(rng.randrange(256) for _ in range(64))
            assert field.from_wide_bytes(wide) == ref_field.from_wide_bytes(wide)


class TestPoseidon:
    def test_permute_bit_equal(self):
        for i in range(8):
            state = elements(10 + i, 5)
            assert poseidon.permute(state) == ref_poseidon.permute(state)

    def test_sponge_bit_equal(self):
        xs = elements(20, 23)
        ours, theirs = poseidon.PoseidonSponge(), ref_poseidon.PoseidonSponge()
        ours.update(xs)
        theirs.update(xs)
        assert ours.squeeze() == theirs.squeeze()

    def test_native_permute_batch_equals_python(self):
        states = [elements(30 + i, 5) for i in range(17)]
        assert cnative.available()
        assert cnative.poseidon_permute_batch(states) == [poseidon.permute(s) for s in states]
        assert crypto.permute_one(states[0]) == ref_poseidon.permute(states[0])

    def test_native_library_builds_into_the_port_build_dir(self):
        path = cnative.library_path()
        assert path.parent.name == "protocol_tpu_torch" and path.parent.parent.name == "build"
        assert path.name.startswith("libprotocol_native-") and path.exists()


class TestCurveAndBlake:
    def test_blake512_bit_equal(self):
        for data in (b"", b"\x00", bytes(range(111)), bytes(144)):
            assert blake512.blake512(data) == ref_blake.blake512(data)

    def test_mul_scalar_bit_equal(self):
        for k in elements(40, 4):
            ours = babyjubjub.B8.mul_scalar(k).affine()
            theirs = ref_bjj.B8.mul_scalar(k).affine()
            assert (ours.x, ours.y) == (theirs.x, theirs.y)


class TestEddsa:
    def test_alice_pk_hash_anchor(self):
        sk = eddsa.SecretKey.from_bs58(*bootstrap.FIXED_SET[0])
        assert b58encode(field.to_le_bytes(sk.public().hash())) == ALICE_PK_HASH

    def test_bootstrap_keys_bit_equal(self):
        assert bootstrap.FIXED_SET == ref_boot.FIXED_SET
        assert (bootstrap.NUM_ITER, bootstrap.NUM_NEIGHBOURS, bootstrap.INITIAL_SCORE,
                bootstrap.SCALE) == (ref_boot.NUM_ITER, ref_boot.NUM_NEIGHBOURS,
                                     ref_boot.INITIAL_SCORE, ref_boot.SCALE)
        sks, pks = bootstrap.keyset_from_raw(bootstrap.FIXED_SET)
        ref_sks, ref_pks = ref_boot.keyset_from_raw(ref_boot.FIXED_SET)
        assert [(s.sk0, s.sk1) for s in sks] == [(s.sk0, s.sk1) for s in ref_sks]
        assert [p.to_raw() for p in pks] == [p.to_raw() for p in ref_pks]
        assert [p.hash() for p in pks] == [p.hash() for p in ref_pks]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_keys_and_signatures_bit_equal(self, seed):
        sk = eddsa.SecretKey.random(random.Random(seed))
        ref_sk = ref_eddsa.SecretKey.random(random.Random(seed))
        assert (sk.sk0, sk.sk1) == (ref_sk.sk0, ref_sk.sk1)
        pk, ref_pk = sk.public(), ref_sk.public()
        assert pk.to_raw() == ref_pk.to_raw()
        m = elements(50 + seed, 1)[0]
        sig, ref_sig = eddsa.sign(sk, pk, m), ref_eddsa.sign(ref_sk, ref_pk, m)
        assert (sig.big_r.x, sig.big_r.y, sig.s) == (ref_sig.big_r.x, ref_sig.big_r.y, ref_sig.s)
        assert eddsa.verify(sig, pk, m) and not eddsa.verify(sig, pk, field.add(m, 1))

    def test_bs58_roundtrip_of_secret_keys(self):
        sk = eddsa.SecretKey.random(random.Random(7))
        a, b = (b58encode(part) for part in sk.to_raw())
        assert (a, b) == tuple(ref_b58encode(part) for part in sk.to_raw())
        assert eddsa.SecretKey.from_bs58(a, b) == sk
        assert b58decode(a) == sk.to_raw()[0]


class TestMessageHash:
    def test_calculate_message_hash_bit_equal(self):
        _, pks = bootstrap.keyset_from_raw(bootstrap.FIXED_SET)
        _, ref_pks = ref_boot.keyset_from_raw(ref_boot.FIXED_SET)
        scores = [[200] * 5, [400, 300, 150, 150, 0], [0, 0, 0, 0, 1000]]
        assert crypto.calculate_message_hash(pks, scores) == ref_crypto.calculate_message_hash(
            ref_pks, scores
        )
        assert crypto.group_pks_hash(pks) == ref_crypto.group_pks_hash(ref_pks)

    def test_message_hash_batch_bit_equal_at_ragged_rows(self):
        pks_hash = elements(60, 1)[0]
        rng = random.Random(61)
        rows = [[rng.randrange(1000) for _ in range(k)] for k in (1, 5, 6, 11, 64)]
        assert crypto.message_hash_batch(pks_hash, rows) == ref_crypto.message_hash_batch(
            pks_hash, rows
        )


class TestNativeBatchVerify:
    def test_equals_python_verify(self):
        sks = [eddsa.SecretKey.random(random.Random(70 + i)) for i in range(6)]
        pks = [sk.public() for sk in sks]
        msgs = elements(80, 6)
        sigs = [eddsa.sign(sk, pk, m) for sk, pk, m in zip(sks, pks, msgs)]
        # Break two: a wrong message and a shifted s.
        msgs[1] = field.add(msgs[1], 1)
        sigs[4] = eddsa.Signature(sigs[4].big_r, field.add(sigs[4].s, 1))
        ok = cnative.eddsa_verify_batch(
            [s.big_r.x for s in sigs], [s.big_r.y for s in sigs], [s.s for s in sigs],
            [p.point.x for p in pks], [p.point.y for p in pks], msgs,
        )
        python = [eddsa.verify(s, p, m) for s, p, m in zip(sigs, pks, msgs)]
        assert ok.tolist() == python == [True, False, True, True, False, True]

    def test_pk_hash_batch_equals_python(self):
        pks = [eddsa.SecretKey.random(random.Random(90 + i)).public() for i in range(4)]
        assert cnative.pk_hash_batch([p.point.x for p in pks], [p.point.y for p in pks]) == [
            p.hash() for p in pks
        ]


class TestAttestationWire:
    def test_wire_bytes_cross_decode(self):
        sks, pks = ref_boot.keyset_from_raw(ref_boot.FIXED_SET)
        scores = [400, 300, 150, 150, 0]
        _, msgs = ref_crypto.calculate_message_hash(pks, [scores])
        att = ref_att.Attestation(
            sig=ref_eddsa.sign(sks[2], pks[2], msgs[0]), pk=pks[2], neighbours=list(pks),
            scores=scores,
        )
        raw = ref_att.AttestationData.from_attestation(att).to_bytes()
        ours = attestation.AttestationData.from_bytes(raw, 5).to_attestation(5)
        assert attestation.AttestationData.from_attestation(ours).to_bytes() == raw
        assert ours.scores == scores and ours.pk.to_raw() == pks[2].to_raw()


class TestPartition:
    def test_mix64_and_keys_bit_equal(self):
        hashes = elements(100, 257)
        keys = partition.keys_from_hashes(hashes)
        np.testing.assert_array_equal(keys, ref_part.keys_from_hashes(hashes))
        np.testing.assert_array_equal(partition.mix64(keys), ref_part.mix64(keys))

    @pytest.mark.parametrize("hosts,seed", [(1, 0), (3, 0), (4, 7)])
    def test_owners_bit_equal(self, hosts, seed):
        keys = partition.keys_from_hashes(elements(110 + hosts, 500))
        ours = partition.HostPartition(hosts, seed=seed).assign(keys)
        np.testing.assert_array_equal(ours, ref_part.HostPartition(hosts, seed=seed).assign(keys))
        assert ours.dtype == np.int32


class TestExactKernels:
    def test_power_iterate_bit_equal(self):
        ops = [[0, 300, 300, 200, 200], [250, 0, 250, 250, 250], [500, 500, 0, 0, 0],
               [100, 200, 300, 0, 400], [200, 200, 200, 400, 0]]
        init = [1000] * 5
        assert native.power_iterate(init, ops, 10, 1000) == ref_native.power_iterate(
            init, ops, 10, 1000
        )

    def test_eigentrust_set_bit_equal(self):
        def run(mod_eddsa, mod_native, mod_field):
            sks = [mod_eddsa.SecretKey.random(random.Random(120 + i)) for i in range(3)]
            pks = [sk.public() for sk in sks]
            s = mod_native.EigenTrustSet(num_neighbours=4, num_iterations=12, initial_score=1000)
            for pk in pks:
                s.add_member(pk)
            rows = [[0, 7, 3, 0], [5, 0, 5, 0], [0, 0, 0, 0]]
            for i, pk in enumerate(pks):
                nbrs = pks + [mod_eddsa.PublicKey.null()]
                op = mod_native.Opinion(
                    mod_eddsa.Signature.new(0, 0, 0), 0, list(zip(nbrs, rows[i]))
                )
                s.update_op(pk, op)
            return s.converge()

        assert run(eddsa, native, field) == run(ref_eddsa, ref_native, ref_field)


def test_job_seed_bit_equal():
    kw = dict(
        epoch=9, ops=((0, 500, 500), (1000, 0, 0)), sigs=((1, 2, 3), (4, 5, 6)),
        pks=((7, 8), (9, 10)), params=(2, 10, 1000, 1000), prover="commitment",
        check_circuit=False, graph_fingerprint=11,
    )
    assert jobs.job_seed(jobs.ProofJob(**kw)) == ref_jobs.job_seed(ref_jobs.ProofJob(**kw))
    assert jobs.job_fingerprint(jobs.ProofJob(**kw)) == ref_jobs.job_fingerprint(
        ref_jobs.ProofJob(**kw)
    )

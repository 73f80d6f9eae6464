"""The port's EVM verifier codegen (``protocol_tpu_torch.zk.evm_verifier``)
beside the reference's.

The reference's ``tests/test_evm_verifier.py`` re-targeted at the port:
a generated verifier accepts a keccak-transcript proof with plausible
gas, refuses a wrong instance and flipped, truncated and extended
proofs and a Poseidon-transcript proof, agrees with the Python verifier,
runs lookup and Poseidon circuits, round-trips its artifact, and the
wrapper reverts with its two messages.  Then parity, each case to
"bytes equal": at one seeded SRS both packages generate the same runtime
for the mul-add, range-lookup and Poseidon circuits, both EVMs return
the same verdict and gas for the same calldata, the wrapper's bytes
match, and the committed ``data/et_verifier.bin`` loads in both and
verifies the committed ``data/et_proof.json`` at the same gas."""

from pathlib import Path

import pytest

from protocol_tpu.zk import chips as ref_chips
from protocol_tpu.zk import cs as ref_cs
from protocol_tpu.zk import evm_verifier as ref_ev
from protocol_tpu.zk import gadgets as ref_gadgets
from protocol_tpu.zk import kzg as ref_kzg
from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu_torch.crypto.poseidon import permute
from protocol_tpu_torch.evm import EVM
from protocol_tpu_torch.zk import chips, cs, gadgets, kzg, plonk
from protocol_tpu_torch.zk import evm_verifier as ev
from protocol_tpu_torch.zk.cs import ConstraintSystem
from protocol_tpu_torch.zk.evm_verifier import (
    GeneratedVerifier,
    evm_verify,
    generate_evm_verifier,
    generate_wrapper,
    infer_n_t,
)
from protocol_tpu_torch.zk.gadgets import PoseidonChip, StdGate

DATA = Path(__file__).resolve().parent.parent / "data"
PORT = (cs, gadgets, chips, kzg, plonk, ev)
REF = (ref_cs, ref_gadgets, ref_chips, ref_kzg, ref_plonk, ref_ev)


def _mul_add_setup():
    c = ConstraintSystem()
    std = StdGate(c)
    out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
    c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
    pk = plonk.compile_circuit(c)
    proof = plonk.prove(pk, c, [17], seed=b"t", transcript="keccak")
    return pk, proof, generate_evm_verifier(pk.vk, infer_n_t(pk.vk, proof), 1)


@pytest.fixture(scope="module")
def mul_add():
    return _mul_add_setup()


class TestEvmVerifier:
    def test_valid_proof_accepted_with_gas(self, mul_add):
        _pk, proof, gen = mul_add
        ok, gas = evm_verify(gen, [17], proof)
        assert ok
        assert 100_000 < gas < 2_000_000

    def test_rejections(self, mul_add):
        _pk, proof, gen = mul_add
        assert not evm_verify(gen, [18], proof)[0]
        for off in (3, len(proof) // 2, len(proof) - 17):
            bad = bytearray(proof)
            bad[off] ^= 1
            assert not evm_verify(gen, [17], bytes(bad))[0]
        assert not evm_verify(gen, [17], proof[:-32])[0]
        assert not evm_verify(gen, [17], proof + b"\0" * 32)[0]

    def test_poseidon_transcript_proof_rejected(self, mul_add):
        pk, _proof, gen = mul_add
        c = ConstraintSystem()
        std = StdGate(c)
        out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
        c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
        pproof = plonk.prove(pk, c, [17], seed=b"t")
        assert not evm_verify(gen, [17], pproof)[0]

    def test_matches_python_verifier_gas_free(self, mul_add):
        pk, proof, gen = mul_add
        assert plonk.verify(pk.vk, [17], proof, transcript="keccak")
        assert evm_verify(gen, [17], proof)[0]

    def test_lookup_circuit_on_evm(self):
        c, inst = range_lookup(cs, gadgets, chips)
        pk = plonk.compile_circuit(c)
        proof = plonk.prove(pk, c, inst, seed=b"t", transcript="keccak")
        gen = generate_evm_verifier(pk.vk, infer_n_t(pk.vk, proof), 1)
        assert evm_verify(gen, inst, proof)[0]
        bad = bytearray(proof)
        bad[100] ^= 1
        assert not evm_verify(gen, inst, bytes(bad))[0]

    def test_poseidon_circuit_on_evm(self):
        c = ConstraintSystem()
        std = StdGate(c)
        outs = PoseidonChip(c).permute([std.witness(i + 1) for i in range(5)])
        expected = permute([1, 2, 3, 4, 5])
        c.copy(c.assign(c.column("instance", "instance"), 0, expected[0]), outs[0])
        pk = plonk.compile_circuit(c)
        proof = plonk.prove(pk, c, [expected[0]], seed=b"x", transcript="keccak")
        gen = generate_evm_verifier(pk.vk, infer_n_t(pk.vk, proof), 1)
        assert evm_verify(gen, [expected[0]], proof)[0]

    def test_artifact_roundtrip(self, mul_add):
        _pk, proof, gen = mul_add
        restored = GeneratedVerifier.from_bytes(gen.to_bytes())
        assert restored.runtime == gen.runtime and restored.n_t == gen.n_t
        assert evm_verify(restored, [17], proof)[0]
        with pytest.raises(ValueError, match="magic"):
            GeneratedVerifier.from_bytes(b"NOTMAGIC" + gen.to_bytes()[8:])


class TestWrapper:
    def test_missing_verifier_message(self):
        evm = EVM()
        w = evm.deploy_runtime(generate_wrapper(0xDEAD))
        r = evm.call(w, b"\0" * 64)
        assert not r.success
        assert b"verifier-missing" in r.returndata

    def test_failed_verification_message(self, mul_add):
        _pk, proof, gen = mul_add
        evm = EVM()
        w = evm.deploy_runtime(generate_wrapper(evm.deploy_runtime(gen.runtime)))
        bad = bytearray(proof)
        bad[3] ^= 1
        r = evm.call(w, gen.calldata([17], bytes(bad)), gas=500_000_000)
        assert not r.success
        assert b"verification-failed" in r.returndata


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def mul_add_circuit(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
    c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
    return c, [17]


def range_lookup(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    rng = chips_mod.RangeCheckChip(c, word_bits=4)
    x = std.witness(13)
    rng.assert_word(x)
    rng.assert_range(std.witness(200), 2)
    c.copy(c.assign(c.column("instance", "instance"), 0, 13), x)
    return c, [13]


def poseidon_circuit(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    outs = gadgets_mod.PoseidonChip(c).permute([std.witness(i + 1) for i in range(5)])
    expected = permute([1, 2, 3, 4, 5])[0]
    c.copy(c.assign(c.column("instance", "instance"), 0, expected), outs[0])
    return c, [expected]


CIRCUITS = {"mul_add": mul_add_circuit, "range_lookup": range_lookup, "poseidon": poseidon_circuit}


def generated(build, package):
    """(instances, keccak proof, generated verifier, its debug runtime)
    of a circuit in one package, at the seeded SRS of size k + 1."""
    cs_mod, gadgets_mod, chips_mod, kzg_mod, plonk_mod, ev_mod = package
    c, inst = build(cs_mod, gadgets_mod, chips_mod)
    k = (max(c.n_rows + 1, max((len(lk.table) for lk in c.lookups), default=0) + 1, 4)
         - 1).bit_length()
    pk = plonk_mod.compile_circuit(c, kzg_mod.Setup.generate(k + 1, seed=b"evm-parity"))
    proof = plonk_mod.prove(pk, c, inst, seed=b"parity", transcript="keccak")
    n_t = ev_mod.infer_n_t(pk.vk, proof)
    gen = ev_mod.generate_evm_verifier(pk.vk, n_t, len(inst))
    debug = ev_mod.generate_evm_verifier(pk.vk, n_t, len(inst), _debug="combined")
    return inst, proof, gen, debug


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_generated_verifier_equals_the_references(name):
    """Bytes equal: the proof, the runtime (and the codegen's debug
    runtime), the artifact bytes, and each EVM's (verdict, gas) on the
    proof and on a flipped byte."""
    inst, proof, gen, debug = generated(CIRCUITS[name], PORT)
    r_inst, r_proof, r_gen, r_debug = generated(CIRCUITS[name], REF)
    assert (inst, proof) == (r_inst, r_proof)
    assert gen.runtime == r_gen.runtime and debug.runtime == r_debug.runtime
    assert gen.to_bytes() == r_gen.to_bytes()
    bad = bytearray(proof)
    bad[len(proof) // 3] ^= 1
    for p in (proof, bytes(bad)):
        assert evm_verify(gen, inst, p) == ref_ev.evm_verify(r_gen, inst, p)
    assert evm_verify(gen, inst, proof)[0]
    assert gen.calldata(inst, proof) == r_gen.calldata(inst, proof)


def test_wrapper_equals_the_references():
    for addr in (0x1000, 0xDEAD, (1 << 160) - 1):
        assert generate_wrapper(addr) == ref_ev.generate_wrapper(addr)
    assert ev._revert_with(b"verification-failed") == ref_ev._revert_with(b"verification-failed")


def test_committed_artifact_verifies_at_the_references_gas():
    """``data/et_verifier.bin`` loads in both packages to the same fields
    and writes back byte for byte; the committed k = 14 proof verifies
    on both EVMs at the same gas."""
    from protocol_tpu_torch.zk.proof import ProofRaw

    blob = (DATA / "et_verifier.bin").read_bytes()
    ours, theirs = GeneratedVerifier.from_bytes(blob), ref_ev.GeneratedVerifier.from_bytes(blob)
    assert (ours.runtime, ours.n_t, ours.calldata_len) == (
        theirs.runtime, theirs.n_t, theirs.calldata_len)
    assert ours.to_bytes() == blob and GeneratedVerifier.MAGIC == ref_ev.GeneratedVerifier.MAGIC
    proof = ProofRaw.from_json((DATA / "et_proof.json").read_text()).to_proof()
    assert len(ours.calldata(proof.pub_ins, proof.proof)) == ours.calldata_len
    got = evm_verify(ours, proof.pub_ins, proof.proof)
    assert got[0] and got == ref_ev.evm_verify(theirs, proof.pub_ins, proof.proof)

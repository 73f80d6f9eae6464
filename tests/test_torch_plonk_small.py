"""The port's PLONK engine against the reference package's on the small
circuits of ``tests/test_plonk.py`` (mul-add, a Poseidon permutation,
the bits2num rotation gate, a range lookup): at one seeded SRS the two
packages compile the same verifying key, prove the same bytes at the
same blinding seed, and each verifies the other's proof; both reject
tampered, truncated and extended proofs and wrong instances."""

import pytest

from protocol_tpu.zk import chips as ref_chips
from protocol_tpu.zk import cs as ref_cs
from protocol_tpu.zk import gadgets as ref_gadgets
from protocol_tpu.zk import kzg as ref_kzg
from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu_torch.crypto import field
from protocol_tpu_torch.crypto.poseidon import permute
from protocol_tpu_torch.zk import chips, cs, gadgets, kzg, plonk

P = field.MODULUS
PORT = (cs, gadgets, chips, kzg, plonk)
REF = (ref_cs, ref_gadgets, ref_chips, ref_kzg, ref_plonk)


def mul_add(cs_mod, gadgets_mod, chips_mod):
    """out = 3*4 + 5, bound to the public instance."""
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
    c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
    return c, [17]


def poseidon(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    outs = gadgets_mod.PoseidonChip(c).permute([std.witness(i + 1) for i in range(5)])
    expected = permute([1, 2, 3, 4, 5])[0]
    c.copy(c.assign(c.column("instance", "instance"), 0, expected), outs[0])
    return c, [expected]


def bits2num(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    val = std.witness(0b101101)
    gadgets_mod.Bits2NumChip(c).decompose(val, 8)
    c.copy(c.assign(c.column("instance", "instance"), 0, 0b101101), val)
    return c, [0b101101]


def range_lookup(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    rng = chips_mod.RangeCheckChip(c, word_bits=4)
    x = std.witness(13)
    rng.assert_word(x)
    rng.assert_range(std.witness(200), 2)
    c.copy(c.assign(c.column("instance", "instance"), 0, 13), x)
    return c, [13]


CIRCUITS = {"mul_add": mul_add, "poseidon": poseidon, "bits2num": bits2num,
            "range_lookup": range_lookup}


def min_k(c) -> int:
    """The domain ``compile_circuit`` picks for ``c`` (plonk.py's rule)."""
    max_table = max((len(lk.table) for lk in c.lookups), default=0)
    return (max(c.n_rows + 1, max_table + 1, 4) - 1).bit_length()


_CACHE: dict = {}


def compiled(name, package):
    """(constraint system, instances, proving key) of a circuit in one
    package, at the seeded SRS of size k + 1."""
    key = (name, package is PORT)
    if key not in _CACHE:
        cs_mod, gadgets_mod, chips_mod, kzg_mod, plonk_mod = package
        c, inst = CIRCUITS[name](cs_mod, gadgets_mod, chips_mod)
        c.assert_satisfied()
        k = min_k(c)
        srs = kzg_mod.Setup.generate(k + 1, seed=f"small-{name}".encode())
        _CACHE[key] = (c, inst, plonk_mod.compile_circuit(c, srs=srs))
    return _CACHE[key]


def vk_view(vk):
    return {
        "k": vk.k, "ext_factor": vk.ext_factor,
        "names": (vk.advice_names, vk.instance_names, vk.fixed_names),
        "slots": vk.slot_of_name, "gate_rots": vk.gate_rots,
        "gates": [(g.name, g.sel_slot, len(g.constraints)) for g in vk.gates],
        "perm": (vk.perm_slots, vk.perm_tags, vk.chunks),
        "fixed": [tuple(c) for c in vk.fixed_commits],
        "sigma": [tuple(c) for c in vk.sigma_commits],
        "lookups": [(lk.name, lk.sel_slot, lk.input_slots, lk.table_fixed_idx, lk.pad)
                    for lk in vk.lookups],
        "digest": vk.digest, "srs": vk.srs.to_bytes(),
    }


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_verifying_keys_equal(name):
    _, _, pk = compiled(name, PORT)
    _, _, ref_pk = compiled(name, REF)
    assert vk_view(pk.vk) == vk_view(ref_pk.vk)
    assert pk.vk.digest == pk.vk.compute_digest()
    if name == "poseidon":
        assert len(pk.vk.chunks) >= 2
    if name == "range_lookup":
        assert len(pk.vk.lookups) == 1


@pytest.mark.parametrize("transcript", ["poseidon", "keccak"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proofs_byte_identical_and_cross_verify(name, transcript):
    c, inst, pk = compiled(name, PORT)
    rc, _, ref_pk = compiled(name, REF)
    seed = f"seed-{name}".encode()
    proof = plonk.prove(pk, c, inst, seed=seed, transcript=transcript)
    ref_proof = ref_plonk.prove(ref_pk, rc, inst, seed=seed, transcript=transcript)
    assert proof == ref_proof
    assert plonk.verify(pk.vk, inst, ref_proof, transcript=transcript)
    assert ref_plonk.verify(ref_pk.vk, inst, proof, transcript=transcript)
    assert plonk.prove(pk, c, inst, seed=b"other", transcript=transcript) != proof


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_bad_proofs_rejected_by_both(name):
    c, inst, pk = compiled(name, PORT)
    _, _, ref_pk = compiled(name, REF)
    proof = plonk.prove(pk, c, inst, seed=b"bad", transcript="keccak")
    flipped = []
    for off in (0, len(proof) // 2, len(proof) - 1):
        bad = bytearray(proof)
        bad[off] ^= 1
        flipped.append(bytes(bad))
    wrong = [(inst[0] + 1) % P]
    for vk, verify in ((pk.vk, plonk.verify), (ref_pk.vk, ref_plonk.verify)):
        assert verify(vk, inst, proof, transcript="keccak")
        assert not verify(vk, wrong, proof, transcript="keccak")
        assert not verify(vk, inst, proof[:-32], transcript="keccak")
        assert not verify(vk, inst, proof + b"\0" * 32, transcript="keccak")
        assert not verify(vk, inst, proof, transcript="poseidon")
        for bad in flipped:
            assert not verify(vk, inst, bad, transcript="keccak")


def test_out_of_table_witness_unprovable():
    _, _, pk = compiled("range_lookup", PORT)
    c = cs.ConstraintSystem()
    std = gadgets.StdGate(c)
    rng = chips.RangeCheckChip(c, word_bits=4)
    x = std.witness(21)  # 21 >= 16: not in the 4-bit table
    r = c.alloc_rows(1)
    c.copy(c.assign(rng.word, r, 21), x)
    c.enable(rng._sel_word, r)
    rng.assert_range(std.witness(200), 2)
    c.copy(c.assign(c.column("instance", "instance"), 0, 21), x)
    with pytest.raises(AssertionError, match="not in table"):
        plonk.prove(pk, c, [21], seed=b"bad")

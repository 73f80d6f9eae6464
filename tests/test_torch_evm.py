"""The port's EVM (``protocol_tpu_torch.evm``) beside the reference's.

The reference's ``tests/test_evm.py`` re-targeted at the port: opcode
semantics, gas, the Bn254 precompiles and a wrapper-style STATICCALL
flow.  Then parity, each case to "bytes equal": the assembler's bytes
for the same items, ``(success, returndata, gas_used, error, logs)`` of
the reference tests' programs (and a few more that reach memory
expansion, LOG, EXP, the forwarded-gas rule and the out-of-gas path) run
through both interpreters, and the precompiles' ``(success, output,
gas)`` on seeded points, scalars and operand lengths, with and without
a gas limit."""

import numpy as np
import pytest

from protocol_tpu import evm as ref_evm
from protocol_tpu.evm import machine as ref_machine
from protocol_tpu_torch.crypto.keccak import keccak256
from protocol_tpu_torch.evm import EVM, Precompiles, asm, op
from protocol_tpu_torch.evm import machine
from protocol_tpu_torch.zk.bn254 import GENERATOR
from protocol_tpu_torch.zk.fields import G2_GENERATOR

FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def run(code: bytes, calldata: bytes = b"", gas: int = 10_000_000):
    evm = EVM()
    addr = evm.deploy_runtime(code)
    return evm.call(addr, calldata, gas)


def ret_word(*pre) -> tuple:
    """asm suffix: store top of stack at mem[0] and return 32 bytes."""
    return (*pre, 0, "MSTORE", 32, 0, "RETURN")


def g1_words(p) -> bytes:
    return p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big")


def g2_words(q) -> bytes:
    return (
        q.x.coeffs[1].to_bytes(32, "big")
        + q.x.coeffs[0].to_bytes(32, "big")
        + q.y.coeffs[1].to_bytes(32, "big")
        + q.y.coeffs[0].to_bytes(32, "big")
    )


class TestInterpreter:
    def test_arithmetic(self):
        r = run(asm(*ret_word(7, 5, "ADD")))
        assert r.success and int.from_bytes(r.returndata, "big") == 12

    def test_mulmod(self):
        r = run(asm(*ret_word(FR, 3, FR - 1, "MULMOD")))
        assert int.from_bytes(r.returndata, "big") == FR - 3

    def test_sub_order(self):
        r = run(asm(*ret_word(3, 10, "SUB")))
        assert int.from_bytes(r.returndata, "big") == 7  # 10 - 3

    def test_calldataload(self):
        r = run(asm(*ret_word(0, "CALLDATALOAD")), calldata=(99).to_bytes(32, "big"))
        assert int.from_bytes(r.returndata, "big") == 99

    def test_keccak(self):
        r = run(asm(0xAB, 0, "MSTORE8", 1, 0, "KECCAK256", 0, "MSTORE", 32, 0, "RETURN"))
        assert r.returndata == keccak256(b"\xab")

    def test_jump_loop(self):
        r = run(SUM_LOOP)
        assert r.success, r.error
        assert int.from_bytes(r.returndata, "big") == 15

    def test_revert_propagates(self):
        r = run(asm(0, 0, "REVERT"))
        assert not r.success and r.error == "revert"

    def test_out_of_gas(self):
        r = run(asm(*ret_word(7, 5, "ADD")), gas=4)
        assert not r.success and "gas" in r.error

    def test_bad_jump_rejected(self):
        r = run(asm(4, "JUMP", "STOP", "STOP"))
        assert not r.success and "jump" in r.error

    def test_gas_metered(self):
        r = run(asm(*ret_word(7, 5, "ADD")))
        assert 0 < r.gas_used < 100


class TestPrecompiles:
    def test_ec_add(self):
        ok, out, gas = Precompiles.run(0x06, g1_words(GENERATOR) * 2)
        g2 = GENERATOR.double()
        assert ok and gas == 150
        assert int.from_bytes(out[:32], "big") == g2.x
        assert int.from_bytes(out[32:], "big") == g2.y

    def test_ec_mul(self):
        ok, out, _ = Precompiles.run(0x07, g1_words(GENERATOR) + (5).to_bytes(32, "big"))
        assert ok and int.from_bytes(out[:32], "big") == GENERATOR.mul(5).x

    def test_ec_add_rejects_off_curve(self):
        ok, _, _ = Precompiles.run(0x06, (1).to_bytes(32, "big") * 2 + bytes(64))
        assert not ok

    def test_modexp_inverse(self):
        a = 12345
        data = (32).to_bytes(32, "big") * 3 + a.to_bytes(32, "big") \
            + (FR - 2).to_bytes(32, "big") + FR.to_bytes(32, "big")
        ok, out, _ = Precompiles.run(0x05, data)
        assert ok and a * int.from_bytes(out, "big") % FR == 1

    def test_pairing_check_via_evm(self):
        """e(G, H)·e(−G, H) == 1 through the 0x08 precompile."""
        data = g1_words(GENERATOR) + g2_words(G2_GENERATOR) \
            + g1_words(GENERATOR.neg()) + g2_words(G2_GENERATOR)
        ok, out, gas = Precompiles.run(0x08, data)
        assert ok and int.from_bytes(out, "big") == 1
        assert gas == 45000 + 34000 * 2

    def test_pairing_nondegenerate(self):
        ok, out, _ = Precompiles.run(0x08, g1_words(GENERATOR) + g2_words(G2_GENERATOR))
        assert ok and int.from_bytes(out, "big") == 0


class TestStaticcallFlow:
    def test_wrapper_staticcalls_inner(self):
        evm = EVM()
        inner = evm.deploy_runtime(asm(*ret_word(1, 0, "CALLDATALOAD", "ADD")))
        outer = evm.deploy_runtime(forwarder(inner))
        r = evm.call(outer, (41).to_bytes(32, "big"))
        assert r.success, r.error
        assert int.from_bytes(r.returndata, "big") == 42

    def test_staticcall_enforces_read_only(self):
        evm = EVM()
        inner = evm.deploy_runtime(asm(7, 1, "SSTORE", *ret_word(1)))
        outer = evm.deploy_runtime(asm(*ret_word(32, 0, 0, 0, inner, "GAS", "STATICCALL")))
        r = evm.call(outer, b"")
        assert r.success, r.error
        assert int.from_bytes(r.returndata, "big") == 0
        assert evm.storage.get(inner, {}).get(1) is None

    def test_sstore_allowed_outside_static(self):
        evm = EVM()
        addr = evm.deploy_runtime(asm(7, 1, "SSTORE", *ret_word(1)))
        r = evm.call(addr, b"")
        assert r.success, r.error
        assert evm.storage[addr][1] == 7

    def test_modexp_oversize_consumes_forwarded_gas(self):
        evm = EVM()
        outer = evm.deploy_runtime(MODEXP_FORWARD)
        r = evm.call(outer, (2000).to_bytes(32, "big") * 3, gas=1_000_000)
        assert r.success, r.error
        assert int.from_bytes(r.returndata, "big") == 0
        assert r.gas_used > 50_000

    def test_modexp_unpaid_pow_never_runs(self):
        head = b"".join(x.to_bytes(32, "big") for x in (1024, 1024, 1024))
        ok, out, gas = Precompiles.run(0x05, head + b"\xff" * 3072, gas_limit=100)
        assert not ok and out == b"" and gas > 100

    def test_staticcall_precompile_from_bytecode(self):
        r = run(EC_MUL_CALL)
        assert r.success, r.error
        assert int.from_bytes(r.returndata[:32], "big") == GENERATOR.mul(3).x


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

SUM_LOOP_ITEMS = (
    0, 5, ("label", "loop"), "DUP1", "ISZERO", ("ref", "end"), "JUMPI", "DUP1", "SWAP2", "ADD",
    "SWAP1", 1, "SWAP1", "SUB", ("ref", "loop"), "JUMP", ("label", "end"), "POP", 0, "MSTORE",
    32, 0, "RETURN",
)
SUM_LOOP = asm(*SUM_LOOP_ITEMS)
EC_MUL_ITEMS = (
    GENERATOR.x, 0, "MSTORE", GENERATOR.y, 32, "MSTORE", 3, 64, "MSTORE",
    64, 0, 96, 0, 0x07, "GAS", "STATICCALL", "POP", 64, 0, "RETURN",
)
EC_MUL_CALL = asm(*EC_MUL_ITEMS)
MODEXP_FORWARD_ITEMS = (
    "CALLDATASIZE", 0, 0, "CALLDATACOPY",
    *ret_word(32, 0, "CALLDATASIZE", 0, 0x05, 50_000, "STATICCALL"),
)
MODEXP_FORWARD = asm(*MODEXP_FORWARD_ITEMS)


def forwarder_items(inner: int) -> tuple:
    return (
        "CALLDATASIZE", 0, 0, "CALLDATACOPY",
        32, 0, "CALLDATASIZE", 0, inner, "GAS", "STATICCALL",
        ("ref", "ok"), "JUMPI", 0, 0, "REVERT", ("label", "ok"), 32, 0, "RETURN",
    )


def forwarder(inner: int) -> bytes:
    return asm(*forwarder_items(inner))


#: name -> (asm items, calldata, gas): the reference tests' programs and
#: a few that reach memory expansion, LOG, EXP, SIGNEXTEND, the signed
#: ops, a bad opcode and the out-of-gas path.
PROGRAMS = {
    "add": (ret_word(7, 5, "ADD"), b"", 10_000_000),
    "mulmod": (ret_word(FR, 3, FR - 1, "MULMOD"), b"", 10_000_000),
    "sub": (ret_word(3, 10, "SUB"), b"", 10_000_000),
    "calldataload": (ret_word(0, "CALLDATALOAD"), (99).to_bytes(32, "big"), 10_000_000),
    "keccak": ((0xAB, 0, "MSTORE8", 1, 0, "KECCAK256", 0, "MSTORE", 32, 0, "RETURN"), b"",
               10_000_000),
    "loop": (SUM_LOOP_ITEMS, b"", 10_000_000),
    "revert": ((0, 0, "REVERT"), b"", 10_000_000),
    "out_of_gas": (ret_word(7, 5, "ADD"), b"", 4),
    "bad_jump": ((4, "JUMP", "STOP", "STOP"), b"", 10_000_000),
    "ec_mul_call": (EC_MUL_ITEMS, b"", 10_000_000),
    "modexp_forward": (MODEXP_FORWARD_ITEMS, (2000).to_bytes(32, "big") * 3, 1_000_000),
    "memory_expansion": (ret_word(1, 70_000, "MSTORE", 70_000, "MLOAD"), b"", 10_000_000),
    "memory_out_of_gas": (ret_word(1, 2_000_000, "MSTORE", 0), b"", 100_000),
    # LOG3 and LOG1 as raw bytes: the assembler names no LOG opcode.
    "logs": ((0xBEEF, 0, "MSTORE", 7, 6, 5, 32, 0, b"\xa3", 9, 40, 31, b"\xa1", "STOP"), b"",
             10_000_000),
    "exp": (ret_word(FR, 3, "EXP"), b"", 10_000_000),
    "signed": (ret_word(3, (1 << 256) - 7, "SDIV", 4, (1 << 256) - 9, "SMOD", "ADD", 200, 0,
                        "SIGNEXTEND", "ADD", (1 << 256) - 16, 2, "SAR", "XOR"), b"", 10_000_000),
    "bytes_shifts": (ret_word(0x1234, 30, "BYTE", 0xFF, 8, "SHL", "OR", 3, "NOT", 250, "SHR",
                              "AND", "MSIZE", "PC", "ADD", "ADD"), b"", 10_000_000),
    "invalid_opcode": ((1, b"\x0c"), b"", 10_000_000),
    "calldatacopy_codecopy": (("CALLDATASIZE", 0, 3, "CALLDATACOPY", 16, 2, 40, "CODECOPY", 96,
                               0, "RETURN"), bytes(range(45)), 10_000_000),
    "stack_underflow": (("ADD",), b"", 10_000_000),
}


def outcome(receipt) -> tuple:
    logs = [(lg.address, list(lg.topics), lg.data) for lg in receipt.logs]
    return receipt.success, receipt.returndata, receipt.gas_used, receipt.error, logs


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_outcome_equals_the_references(name):
    """Bytes equal: the assembled code, and success, returndata, gas
    used, error text and logs of one call in each interpreter."""
    items, calldata, gas = PROGRAMS[name]
    code = asm(*items)
    assert code == ref_evm.asm(*items)
    ours, theirs = EVM(), ref_evm.EVM()
    got = outcome(ours.call(ours.deploy_runtime(code), calldata, gas))
    want = outcome(theirs.call(theirs.deploy_runtime(code), calldata, gas))
    assert got == want


def test_nested_calls_equal_the_references():
    """A forwarder STATICCALLing a contract that writes storage (refused
    in the static frame) and one that adds: returndata, gas and storage
    equal, and ``deploy`` of creation code returns the same address."""
    creation = asm(*ret_word(1, 0, "CALLDATALOAD", "ADD"))
    results = []
    for mod in (machine, ref_machine):
        evm = mod.EVM()
        adder = evm.deploy_runtime(creation)
        writer = evm.deploy_runtime(asm(7, 1, "SSTORE", *ret_word(1)))
        deployed = evm.deploy(asm(32, 0, 0, "CODECOPY", 32, 0, "RETURN"))
        rows = [outcome(evm.call(evm.deploy_runtime(forwarder(t)), (41).to_bytes(32, "big")))
                for t in (adder, writer, 0xDEAD)]
        results.append((adder, writer, deployed, evm.code[deployed], rows,
                        {a: dict(s) for a, s in evm.storage.items()}))
    assert results[0] == results[1]


def test_opcode_tables_equal_the_references():
    assert machine._OPCODES == ref_machine._OPCODES
    assert machine._GAS == ref_machine._GAS
    assert all(op(name) == ref_evm.op(name) for name in machine._OPCODES)
    assert machine.EVM.DEFAULT_CALLER == ref_machine.EVM.DEFAULT_CALLER


@pytest.mark.parametrize("seed", range(3))
def test_precompiles_equal_the_references_on_seeded_inputs(seed):
    """Bytes equal: (success, output, gas) of ecAdd, ecMul, pairing and
    modexp in both packages on seeded scalars, points (valid, off the
    curve, out of range, the identity), lengths and gas limits."""
    rng = np.random.default_rng(seed)

    def scalar(bits=254):
        return int.from_bytes(rng.bytes(32), "big") % (1 << bits)

    a, b, s = scalar() % FR, scalar() % FR, scalar(256)
    pa, pb = GENERATOR.mul(a), GENERATOR.mul(b)
    w = lambda x: x.to_bytes(32, "big")  # noqa: E731
    qa = G2_GENERATOR.mul(a)
    calls = [
        (0x06, g1_words(pa) + g1_words(pb), None),
        (0x06, g1_words(pa) + bytes(64), None),
        (0x06, g1_words(pa) + w(1) + w(3), None),
        (0x06, w(FQ) + w(2) + g1_words(pb), None),
        (0x06, g1_words(pa), 149),
        (0x07, g1_words(pa) + w(s), None),
        (0x07, g1_words(pb) + w(0), None),
        (0x07, g1_words(pb) + w(FR + 5), None),
        (0x07, g1_words(pa)[:40], None),
        (0x07, g1_words(pa) + w(s), 5999),
        (0x08, g1_words(pa) + g2_words(G2_GENERATOR) + g1_words(GENERATOR.neg()) + g2_words(qa),
         None),
        (0x08, g1_words(pa) + g2_words(qa), None),
        (0x08, bytes(64) + g2_words(qa) + g1_words(pb) + bytes(128), None),
        (0x08, g1_words(pa) + g2_words(qa)[:100], None),
        (0x08, g1_words(pa) + w(1) * 4, None),
        (0x08, g1_words(pa) + g2_words(qa), 78_999),
        (0x08, b"", None),
    ]
    blen, elen, mlen = (int(x) for x in rng.integers(1, 70, 3))
    body = rng.bytes(blen + elen + mlen)
    head = w(blen) + w(elen) + w(mlen)
    calls += [
        (0x05, head + body, None),
        (0x05, head + body[:-5], None),
        (0x05, w(32) * 3 + w(a) + w(FR - 2) + w(FR), None),
        (0x05, w(32) * 2 + w(0) + w(a) + w(b), None),
        (0x05, w(1024) * 3 + b"\xff" * 3072, 100),
        (0x05, w(2000) * 3, None),
        (0x05, w(40) + w(40) + w(40) + rng.bytes(120), 150),
    ]
    for addr, data, limit in calls:
        assert Precompiles.run(addr, data, limit) == ref_evm.Precompiles.run(addr, data, limit), \
            (hex(addr), data.hex(), limit)
    with pytest.raises(machine.EvmError):
        Precompiles.run(0x09, b"")

"""A compact EVM interpreter with Bn254 precompiles and gas metering.

The port of ``protocol_tpu/evm/machine.py``; the precompiles run over
this package's Bn254 stack (``zk.bn254``, ``zk.fields``).

Covers the opcode/precompile profile that generated PLONK verifier
contracts use (and small glue contracts like EtVerifierWrapper.sol):
arithmetic incl. ADDMOD/MULMOD, comparisons, bit ops, KECCAK256,
calldata/memory/returndata, control flow, STATICCALL into other
contracts and precompiles 0x05 (modexp), 0x06 (ecAdd), 0x07 (ecMul),
0x08 (pairing).  Gas follows Istanbul numbers for the metered subset —
close enough that reported verification gas is meaningful, which is all
the reference's dbg!(gas_used) provides (verifier/mod.rs:123-130).

No state trie, no value transfer: contracts are deployed
either as raw runtime code or by executing creation code.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..crypto.keccak import keccak256

U256 = (1 << 256) - 1
_SIGN_BIT = 1 << 255

#: Bn254 base field / curve order for the precompiles.
_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class EvmError(Exception):
    pass


class OutOfGas(EvmError):
    pass


# ---------------------------------------------------------------------------
# Assembler helpers
# ---------------------------------------------------------------------------

_OPCODES = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08, "MULMOD": 0x09,
    "EXP": 0x0A, "SIGNEXTEND": 0x0B,
    "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13, "EQ": 0x14,
    "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18, "NOT": 0x19,
    "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D,
    "KECCAK256": 0x20,
    "ADDRESS": 0x30, "CALLER": 0x33, "CALLVALUE": 0x34,
    "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37,
    "CODESIZE": 0x38, "CODECOPY": 0x39,
    "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E, "EXTCODESIZE": 0x3B,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57,
    "PC": 0x58, "MSIZE": 0x59, "GAS": 0x5A, "JUMPDEST": 0x5B,
    "PUSH0": 0x5F,
    "RETURN": 0xF3, "STATICCALL": 0xFA, "REVERT": 0xFD, "INVALID": 0xFE,
}
for _i in range(1, 33):
    _OPCODES[f"PUSH{_i}"] = 0x5F + _i
for _i in range(1, 17):
    _OPCODES[f"DUP{_i}"] = 0x7F + _i
    _OPCODES[f"SWAP{_i}"] = 0x8F + _i

_OPNAMES = {v: k for k, v in _OPCODES.items()}


def op(name: str) -> int:
    return _OPCODES[name]


def asm(*items) -> bytes:
    """Tiny assembler: strings are opcodes; ints become minimal PUSHes;
    ("label", name) defines a JUMPDEST, ("ref", name) a 2-byte push of
    its offset (two-pass)."""
    # Pass 1: layout.
    code: list = []
    labels: dict[str, int] = {}
    pos = 0
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            labels[it[1]] = pos
            code.append(("op", 0x5B))
            pos += 1
        elif isinstance(it, tuple) and it[0] == "ref":
            code.append(it)
            pos += 4  # PUSH3 + 3 bytes (verifier contracts exceed 64KB)
        elif isinstance(it, str):
            code.append(("op", _OPCODES[it]))
            pos += 1
        elif isinstance(it, int):
            if it == 0:
                code.append(("op", 0x5F))
                pos += 1
            else:
                blen = max(1, (it.bit_length() + 7) // 8)
                code.append(("push", it, blen))
                pos += 1 + blen
        elif isinstance(it, bytes):
            code.append(("raw", it))
            pos += len(it)
        else:  # pragma: no cover
            raise TypeError(f"bad asm item {it!r}")
    # Pass 2: emit.
    out = bytearray()
    for it in code:
        if it[0] == "op":
            out.append(it[1])
        elif it[0] == "push":
            out.append(0x5F + it[2])
            out += it[1].to_bytes(it[2], "big")
        elif it[0] == "raw":
            out += it[1]
        else:  # ref
            out.append(0x62)  # PUSH3
            out += labels[it[1]].to_bytes(3, "big")
    return bytes(out)


# ---------------------------------------------------------------------------
# Precompiles
# ---------------------------------------------------------------------------


class Precompiles:
    """0x05 modexp, 0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing (Istanbul
    gas), implemented over the framework's own Bn254 stack."""

    #: Istanbul static costs, shared by the pre-check and the
    #: implementations so a repricing can't drift between them.
    EC_ADD_GAS = 150
    EC_MUL_GAS = 6000
    PAIRING_BASE_GAS = 45000
    PAIRING_PER_PAIR_GAS = 34000

    @staticmethod
    def pairing_gas(data: bytes) -> int:
        return Precompiles.PAIRING_BASE_GAS + Precompiles.PAIRING_PER_PAIR_GAS * (
            len(data) // 192
        )

    @staticmethod
    def run(addr: int, data: bytes, gas_limit: int | None = None) -> tuple[bool, bytes, int]:
        """-> (success, returndata, gas_cost).  When ``gas_limit`` is
        given, the cost is computed and checked *before* any expensive
        work, so hostile inputs can't burn CPU they haven't paid for."""
        if addr == 0x05:
            return Precompiles._modexp(data, gas_limit)
        if addr == 0x06:
            if gas_limit is not None and gas_limit < Precompiles.EC_ADD_GAS:
                return False, b"", Precompiles.EC_ADD_GAS
            return Precompiles._ec_add(data)
        if addr == 0x07:
            if gas_limit is not None and gas_limit < Precompiles.EC_MUL_GAS:
                return False, b"", Precompiles.EC_MUL_GAS
            return Precompiles._ec_mul(data)
        if addr == 0x08:
            if gas_limit is not None and gas_limit < Precompiles.pairing_gas(data):
                return False, b"", Precompiles.pairing_gas(data)
            return Precompiles._pairing(data)
        raise EvmError(f"unsupported precompile {addr:#x}")

    @staticmethod
    def _word(data: bytes, i: int) -> int:
        chunk = data[32 * i : 32 * i + 32]
        return int.from_bytes(chunk.ljust(32, b"\0"), "big")

    @staticmethod
    def _modexp(data: bytes, gas_limit: int | None = None):
        blen = Precompiles._word(data, 0)
        elen = Precompiles._word(data, 1)
        mlen = Precompiles._word(data, 2)
        if max(blen, elen, mlen) > 1024:
            # Failing precompile: the call handler consumes the forwarded gas.
            return False, b"", 0
        body = data[96:].ljust(blen + elen + mlen, b"\0")
        # EIP-2565 gas, computed from the lengths + exponent head before
        # the pow runs so unpaid work never executes.
        e_head = int.from_bytes(body[blen : blen + 32].ljust(32, b"\0")[: min(elen, 32)], "big")
        words = (max(blen, mlen) + 7) // 8
        mult = words * words
        adj = (
            max(e_head.bit_length() - 1, 0)
            if elen <= 32
            else 8 * (elen - 32) + max(e_head.bit_length() - 1, 0)
        )
        gas = max(200, mult * max(adj, 1) // 3)
        if gas_limit is not None and gas > gas_limit:
            return False, b"", gas
        b = int.from_bytes(body[:blen], "big")
        e = int.from_bytes(body[blen : blen + elen], "big")
        m = int.from_bytes(body[blen + elen : blen + elen + mlen], "big")
        out = pow(b, e, m) if m else 0
        return True, out.to_bytes(mlen, "big") if mlen else b"", gas

    @staticmethod
    def _g1(data: bytes, off_words: int):
        from ..zk.bn254 import G1, is_on_curve

        x = Precompiles._word(data, off_words)
        y = Precompiles._word(data, off_words + 1)
        if x >= _FQ or y >= _FQ:
            raise EvmError("ec point coordinate out of range")
        p = G1(x, y)
        if not is_on_curve(p):
            raise EvmError("ec point not on curve")
        return p

    @staticmethod
    def _ec_add(data: bytes):
        try:
            a = Precompiles._g1(data, 0)
            b = Precompiles._g1(data, 2)
        except EvmError:
            return False, b"", Precompiles.EC_ADD_GAS
        c = a.add(b)
        return True, c.x.to_bytes(32, "big") + c.y.to_bytes(32, "big"), Precompiles.EC_ADD_GAS

    @staticmethod
    def _ec_mul(data: bytes):
        try:
            a = Precompiles._g1(data, 0)
        except EvmError:
            return False, b"", Precompiles.EC_MUL_GAS
        s = Precompiles._word(data, 2)
        c = a.mul(s % _FR) if s else a.mul(0)
        return True, c.x.to_bytes(32, "big") + c.y.to_bytes(32, "big"), Precompiles.EC_MUL_GAS

    @staticmethod
    def _pairing(data: bytes):
        from ..zk.bn254 import G1
        from ..zk.fields import FQ2, G2, g2_in_subgroup, g2_is_on_curve, pairing_check

        if len(data) % 192 != 0:
            return False, b"", Precompiles.PAIRING_BASE_GAS
        n = len(data) // 192
        gas = Precompiles.pairing_gas(data)
        pairs = []
        for i in range(n):
            base = 6 * i
            try:
                p = Precompiles._g1(data, base)
            except EvmError:
                return False, b"", gas
            # EVM ABI: G2 as (x_imag, x_real, y_imag, y_real).
            xi, xr = Precompiles._word(data, base + 2), Precompiles._word(data, base + 3)
            yi, yr = Precompiles._word(data, base + 4), Precompiles._word(data, base + 5)
            if max(xi, xr, yi, yr) >= _FQ:
                return False, b"", gas
            q = G2(FQ2([xr, xi]), FQ2([yr, yi]))
            is_zero_q = xi == xr == yi == yr == 0
            if not is_zero_q and not (g2_is_on_curve(q) and g2_in_subgroup(q)):
                return False, b"", gas
            if p.is_identity() or is_zero_q:
                continue  # e(O, Q) = e(P, O) = 1
            pairs.append((p, q))
        ok = pairing_check(pairs) if pairs else True
        return True, (1 if ok else 0).to_bytes(32, "big"), gas


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


@dataclass
class Log:
    """One emitted event: address, up to four topics, data blob."""

    address: int
    topics: list
    data: bytes


@dataclass
class Receipt:
    success: bool
    returndata: bytes
    gas_used: int
    error: str | None = None
    logs: list = dc_field(default_factory=list)


_GAS = {  # metered subset (Istanbul-ish)
    0x00: 0, 0x01: 3, 0x02: 5, 0x03: 3, 0x04: 5, 0x05: 5, 0x06: 5, 0x07: 5,
    0x08: 8, 0x09: 8, 0x0A: 10, 0x0B: 5,
    0x10: 3, 0x11: 3, 0x12: 3, 0x13: 3, 0x14: 3, 0x15: 3, 0x16: 3, 0x17: 3,
    0x18: 3, 0x19: 3, 0x1A: 3, 0x1B: 3, 0x1C: 3, 0x1D: 3,
    0x30: 2, 0x33: 2, 0x34: 2, 0x35: 3, 0x36: 2, 0x38: 2,
    0x3D: 2, 0x50: 2, 0x51: 3, 0x52: 3, 0x53: 3,
    0x54: 800, 0x55: 20000, 0x56: 8, 0x57: 10, 0x58: 2, 0x59: 2, 0x5A: 2,
    0x5B: 1, 0x5F: 2,
    0xF3: 0, 0xFD: 0,
    0xA0: 375, 0xA1: 750, 0xA2: 1125, 0xA3: 1500, 0xA4: 1875,
}


class EVM:
    """Single-shot executor over an in-memory contract map."""

    def __init__(self):
        self.code: dict[int, bytes] = {}
        self.storage: dict[int, dict[int, int]] = {}
        self._next_addr = 0x1000

    # -- deployment -----------------------------------------------------

    def deploy_runtime(self, runtime: bytes) -> int:
        """Install runtime bytecode directly (the reference deploys its
        Yul verifier's compiled runtime the same way, utils.rs:90-103)."""
        addr = self._next_addr
        self._next_addr += 1
        self.code[addr] = bytes(runtime)
        return addr

    def deploy(self, creation: bytes, gas: int = 30_000_000) -> int:
        """Execute creation code; the returned body becomes runtime."""
        r = self._execute(creation, b"", gas, depth=0, self_addr=0)
        if not r.success:
            raise EvmError(f"constructor reverted: {r.error or r.returndata.hex()}")
        return self.deploy_runtime(r.returndata)

    # -- calls ----------------------------------------------------------

    #: Default msg.sender when none is given (a recognizable dummy).
    DEFAULT_CALLER = 0xCA11E5

    def call(
        self, addr: int, calldata: bytes, gas: int = 30_000_000, caller: int | None = None
    ) -> Receipt:
        code = self.code.get(addr)
        if code is None:
            raise EvmError(f"no contract at {addr:#x}")
        return self._execute(
            code, bytes(calldata), gas, depth=0, self_addr=addr,
            caller=self.DEFAULT_CALLER if caller is None else caller,
        )

    # -- core loop ------------------------------------------------------

    def _execute(
        self,
        code: bytes,
        calldata: bytes,
        gas: int,
        depth: int,
        self_addr: int,
        static: bool = False,
        caller: int | None = None,
    ) -> Receipt:
        if depth > 8:
            return Receipt(False, b"", 0, "call depth exceeded")
        if caller is None:
            caller = self.DEFAULT_CALLER
        logs: list[Log] = []
        stack: list[int] = []
        mem = bytearray()
        ret_buf = b""
        pc = 0
        gas_left = gas
        jumpdests = _jumpdests(code)
        store = self.storage.setdefault(self_addr, {})

        def use(n: int):
            nonlocal gas_left
            gas_left -= n
            if gas_left < 0:
                raise OutOfGas(f"out of gas at pc={pc}")

        def mem_expand(end: int):
            if end <= len(mem):
                return
            new_words = (end + 31) // 32
            old_words = (len(mem) + 31) // 32
            cost = (3 * new_words + new_words * new_words // 512) - (
                3 * old_words + old_words * old_words // 512
            )
            use(cost)
            mem.extend(b"\0" * (new_words * 32 - len(mem)))

        def mread(off: int, size: int) -> bytes:
            if size == 0:
                return b""
            mem_expand(off + size)
            return bytes(mem[off : off + size])

        def mwrite(off: int, data: bytes):
            if not data:
                return
            mem_expand(off + len(data))
            mem[off : off + len(data)] = data

        def push(v: int):
            if len(stack) >= 1024:
                raise EvmError("stack overflow")
            stack.append(v & U256)

        def pop() -> int:
            if not stack:
                raise EvmError("stack underflow")
            return stack.pop()

        try:
            while pc < len(code):
                opcode = code[pc]
                base = _GAS.get(opcode)
                if base is None and not (0x60 <= opcode <= 0x9F) and opcode not in (
                    0x20,
                    0x37,
                    0x39,
                    0x3B,
                    0x3E,
                    0xFA,
                ):
                    raise EvmError(f"invalid opcode {opcode:#04x} at pc={pc}")
                if base is not None:
                    use(base)
                elif 0x60 <= opcode <= 0x9F:
                    use(3)

                if opcode == 0x00:  # STOP
                    return Receipt(True, b"", gas - gas_left, logs=logs)
                elif opcode == 0x01:
                    push(pop() + pop())
                elif opcode == 0x02:
                    push(pop() * pop())
                elif opcode == 0x03:
                    a, b = pop(), pop()
                    push(a - b)
                elif opcode == 0x04:
                    a, b = pop(), pop()
                    push(a // b if b else 0)
                elif opcode == 0x05:  # SDIV
                    a, b = _sgn(pop()), _sgn(pop())
                    push(0 if b == 0 else abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1))
                elif opcode == 0x06:
                    a, b = pop(), pop()
                    push(a % b if b else 0)
                elif opcode == 0x07:  # SMOD
                    a, b = _sgn(pop()), _sgn(pop())
                    push(0 if b == 0 else (abs(a) % abs(b)) * (1 if a >= 0 else -1))
                elif opcode == 0x08:  # ADDMOD
                    a, b, m = pop(), pop(), pop()
                    push((a + b) % m if m else 0)
                elif opcode == 0x09:  # MULMOD
                    a, b, m = pop(), pop(), pop()
                    push((a * b) % m if m else 0)
                elif opcode == 0x0A:  # EXP
                    a, b = pop(), pop()
                    use(50 * max(1, (b.bit_length() + 7) // 8) - 0 if b else 0)
                    push(pow(a, b, 1 << 256))
                elif opcode == 0x0B:  # SIGNEXTEND
                    k, v = pop(), pop()
                    if k < 31:
                        bit = 8 * (k + 1) - 1
                        if v & (1 << bit):
                            v |= U256 ^ ((1 << (bit + 1)) - 1)
                        else:
                            v &= (1 << (bit + 1)) - 1
                    push(v)
                elif opcode == 0x10:
                    push(1 if pop() < pop() else 0)
                elif opcode == 0x11:
                    push(1 if pop() > pop() else 0)
                elif opcode == 0x12:
                    push(1 if _sgn(pop()) < _sgn(pop()) else 0)
                elif opcode == 0x13:
                    push(1 if _sgn(pop()) > _sgn(pop()) else 0)
                elif opcode == 0x14:
                    push(1 if pop() == pop() else 0)
                elif opcode == 0x15:
                    push(1 if pop() == 0 else 0)
                elif opcode == 0x16:
                    push(pop() & pop())
                elif opcode == 0x17:
                    push(pop() | pop())
                elif opcode == 0x18:
                    push(pop() ^ pop())
                elif opcode == 0x19:
                    push(pop() ^ U256)
                elif opcode == 0x1A:  # BYTE
                    i, v = pop(), pop()
                    push((v >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
                elif opcode == 0x1B:  # SHL
                    s, v = pop(), pop()
                    push(v << s if s < 256 else 0)
                elif opcode == 0x1C:  # SHR
                    s, v = pop(), pop()
                    push(v >> s if s < 256 else 0)
                elif opcode == 0x1D:  # SAR
                    s, v = pop(), _sgn(pop())
                    push((v >> s) if s < 256 else (0 if v >= 0 else U256))
                elif opcode == 0x20:  # KECCAK256
                    off, size = pop(), pop()
                    use(30 + 6 * ((size + 31) // 32))
                    push(int.from_bytes(keccak256(mread(off, size)), "big"))
                elif opcode == 0x30:
                    push(self_addr)
                elif opcode == 0x33:
                    push(caller)
                elif opcode == 0x34:
                    push(0)
                elif opcode == 0x35:  # CALLDATALOAD
                    off = pop()
                    push(int.from_bytes(calldata[off : off + 32].ljust(32, b"\0"), "big"))
                elif opcode == 0x36:
                    push(len(calldata))
                elif opcode == 0x37:  # CALLDATACOPY
                    dst, src, size = pop(), pop(), pop()
                    use(3 + 3 * ((size + 31) // 32))
                    mwrite(dst, calldata[src : src + size].ljust(size, b"\0"))
                elif opcode == 0x38:
                    push(len(code))
                elif opcode == 0x39:  # CODECOPY
                    dst, src, size = pop(), pop(), pop()
                    use(3 + 3 * ((size + 31) // 32))
                    mwrite(dst, code[src : src + size].ljust(size, b"\0"))
                elif opcode == 0x3B:  # EXTCODESIZE
                    use(700)
                    push(len(self.code.get(pop(), b"")))
                elif opcode == 0x3D:
                    push(len(ret_buf))
                elif opcode == 0x3E:  # RETURNDATACOPY
                    dst, src, size = pop(), pop(), pop()
                    use(3 + 3 * ((size + 31) // 32))
                    if src + size > len(ret_buf):
                        raise EvmError("returndatacopy out of bounds")
                    mwrite(dst, ret_buf[src : src + size])
                elif opcode == 0x50:
                    pop()
                elif opcode == 0x51:  # MLOAD
                    off = pop()
                    push(int.from_bytes(mread(off, 32), "big"))
                elif opcode == 0x52:  # MSTORE
                    off, v = pop(), pop()
                    mwrite(off, v.to_bytes(32, "big"))
                elif opcode == 0x53:  # MSTORE8
                    off, v = pop(), pop()
                    mwrite(off, bytes([v & 0xFF]))
                elif opcode == 0x54:  # SLOAD
                    push(store.get(pop(), 0))
                elif opcode == 0x55:  # SSTORE
                    if static:
                        raise EvmError("state modification in static context")
                    k, v = pop(), pop()
                    store[k] = v
                elif opcode == 0x56:  # JUMP
                    pc = pop()
                    if pc not in jumpdests:
                        raise EvmError(f"bad jump target {pc}")
                    continue
                elif opcode == 0x57:  # JUMPI
                    dst, cond = pop(), pop()
                    if cond:
                        pc = dst
                        if pc not in jumpdests:
                            raise EvmError(f"bad jump target {pc}")
                        continue
                elif opcode == 0x58:
                    push(pc)
                elif opcode == 0x59:
                    push(len(mem))
                elif opcode == 0x5A:
                    push(max(gas_left, 0))
                elif opcode == 0x5B:
                    pass  # JUMPDEST
                elif opcode == 0x5F:
                    push(0)
                elif 0x60 <= opcode <= 0x7F:  # PUSH1..32
                    nbytes = opcode - 0x5F
                    push(int.from_bytes(code[pc + 1 : pc + 1 + nbytes].ljust(nbytes, b"\0"), "big"))
                    pc += nbytes
                elif 0x80 <= opcode <= 0x8F:  # DUP
                    i = opcode - 0x7F
                    if len(stack) < i:
                        raise EvmError("stack underflow")
                    push(stack[-i])
                elif 0x90 <= opcode <= 0x9F:  # SWAP
                    i = opcode - 0x8F
                    if len(stack) < i + 1:
                        raise EvmError("stack underflow")
                    stack[-1], stack[-1 - i] = stack[-1 - i], stack[-1]
                elif 0xA0 <= opcode <= 0xA4:  # LOG0..LOG4
                    if static:
                        raise EvmError("log in static context")
                    off, size = pop(), pop()
                    use(8 * size)
                    topics = [pop() for _ in range(opcode - 0xA0)]
                    logs.append(Log(self_addr, topics, mread(off, size)))
                elif opcode == 0xF3:  # RETURN
                    off, size = pop(), pop()
                    return Receipt(True, mread(off, size), gas - gas_left, logs=logs)
                elif opcode == 0xFA:  # STATICCALL
                    use(700)
                    call_gas, to, in_off, in_size, out_off, out_size = (
                        pop(),
                        pop(),
                        pop(),
                        pop(),
                        pop(),
                        pop(),
                    )
                    data = mread(in_off, in_size)
                    sub_gas = min(call_gas, max(gas_left - gas_left // 64, 0))
                    if 1 <= to <= 0x09:
                        ok, out, pgas = Precompiles.run(to, data, sub_gas)
                        # Real EVM: a failing precompile (or one whose cost
                        # exceeds the forwarded gas) consumes the forwarded
                        # gas and the call fails; success pays metered cost.
                        if ok and pgas <= sub_gas:
                            use(pgas)
                        else:
                            ok, out = False, b""
                            use(sub_gas)
                    elif to in self.code:
                        r = self._execute(
                            self.code[to], data, sub_gas, depth + 1, to,
                            static=True, caller=self_addr,
                        )
                        use(r.gas_used)
                        ok, out = r.success, r.returndata
                    else:
                        ok, out = True, b""  # call to empty account
                    ret_buf = out
                    mwrite(out_off, out[:out_size].ljust(min(out_size, len(out)), b"\0"))
                    push(1 if ok else 0)
                elif opcode == 0xFD:  # REVERT
                    off, size = pop(), pop()
                    return Receipt(False, mread(off, size), gas - gas_left, "revert")
                elif opcode == 0xFE:
                    raise EvmError("invalid opcode 0xfe")
                else:  # pragma: no cover
                    raise EvmError(f"unhandled opcode {opcode:#04x}")
                pc += 1
            return Receipt(True, b"", gas - gas_left, logs=logs)
        except OutOfGas as e:
            return Receipt(False, b"", gas, str(e))
        except EvmError as e:
            return Receipt(False, b"", gas - max(gas_left, 0), str(e))


def _sgn(v: int) -> int:
    return v - (1 << 256) if v & _SIGN_BIT else v


def _jumpdests(code: bytes) -> set[int]:
    out = set()
    pc = 0
    while pc < len(code):
        opcode = code[pc]
        if opcode == 0x5B:
            out.add(pc)
        if 0x60 <= opcode <= 0x7F:
            pc += opcode - 0x5F
        pc += 1
    return out

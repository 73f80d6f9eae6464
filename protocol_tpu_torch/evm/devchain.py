"""In-process development chain — the Anvil analog.

The port of ``protocol_tpu/evm/devchain.py``.  The upstream
chain-integration tests spawn a real Anvil devnet in-process
(client/src/lib.rs:185-221, client/src/utils.rs:169-206); no Ethereum
node or web3 is needed here, since the package has its own EVM
(``evm/machine.py``), so the dev chain runs on that: deploy contracts,
send transactions with a real ``msg.sender``, collect event logs per
block, and answer the narrow JSON-RPC-shaped queries the node's event
source needs (eth_blockNumber / eth_getLogs).

Ships a hand-assembled AttestationStation runtime with the reference
registry's exact external surface — ``attest(AttestationData[])``
batches under selector 0x5eb5ea10 emitting
``AttestationCreated(address indexed, address indexed, bytes32 indexed,
bytes)`` (contracts/AttestationStation.sol; the event log is the
protocol's entire transport).  Storage keeps one word
per (creator, about, key): keccak(val) at the Solidity-shaped nested
mapping slot — a documented deviation (the protocol never reads the
getter; nodes replay events).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..crypto.keccak import keccak256
from .machine import EVM, Receipt

#: keccak("AttestationCreated(address,address,bytes32,bytes)")
ATTESTATION_CREATED_TOPIC = int.from_bytes(
    keccak256(b"AttestationCreated(address,address,bytes32,bytes)"), "big"
)
ATTEST_SELECTOR = 0x5EB5EA10  # reference att_station.rs:54


# ---------------------------------------------------------------------------
# Minimal assembler
# ---------------------------------------------------------------------------

_OPS = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16,
    "SHL": 0x1B, "SHR": 0x1C, "KECCAK256": 0x20, "CALLER": 0x33,
    "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37,
    "EXTCODESIZE": 0x3B, "GAS": 0x5A,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "SLOAD": 0x54,
    "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57, "JUMPDEST": 0x5B,
    "LOG2": 0xA2, "LOG4": 0xA4, "STATICCALL": 0xFA,
    "RETURN": 0xF3, "REVERT": 0xFD,
    "DUP1": 0x80, "DUP2": 0x81, "DUP3": 0x82, "DUP4": 0x83, "DUP5": 0x84,
    "SWAP1": 0x90, "SWAP2": 0x91, "SWAP3": 0x92,
}


def assemble(items: list) -> bytes:
    """Tiny two-pass assembler: ints become minimal PUSHes, strings are
    opcodes, ("label", name) marks a JUMPDEST, ("ref", name) pushes its
    address (2 bytes)."""
    # Pass 1: layout.
    size = 0
    labels: dict[str, int] = {}
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            labels[it[1]] = size
            size += 1  # JUMPDEST
        elif isinstance(it, tuple) and it[0] == "ref":
            size += 3  # PUSH2 xx xx
        elif isinstance(it, int):
            n = max(1, (it.bit_length() + 7) // 8)
            size += 1 + n
        else:
            size += 1
    out = bytearray()
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            out.append(0x5B)
        elif isinstance(it, tuple) and it[0] == "ref":
            out.append(0x61)
            out += labels[it[1]].to_bytes(2, "big")
        elif isinstance(it, int):
            n = max(1, (it.bit_length() + 7) // 8)
            out.append(0x5F + n)
            out += it.to_bytes(n, "big")
        else:
            out.append(_OPS[it])
    return bytes(out)


def attestation_station_runtime() -> bytes:
    """The AttestationStation runtime, assembled directly (no solc
    needed).  Memory map: 0x00..0x40 scratch for slot hashing,
    0x40 event-data ABI head (offset word), 0x60 val length, 0x80+ val
    bytes."""
    a: list = []
    E = a.extend

    # selector check: calldataload(0) >> 224 == ATTEST_SELECTOR
    E([0, "CALLDATALOAD", 224, "SHR", ATTEST_SELECTOR, "EQ", ("ref", "ok"), "JUMPI"])
    E([0, 0, "REVERT", ("label", "ok")])
    # arr = 4 + calldataload(4)  (absolute offset of the length word)
    E([4, "CALLDATALOAD", 4, "ADD"])          # stack: [arr]
    # i = 0
    E([0])                                     # stack: [arr, i]

    E([("label", "loop")])
    # if i >= n: done    (n = calldataload(arr))
    E(["DUP1", "DUP3", "CALLDATALOAD", "GT", "ISZERO", ("ref", "done"), "JUMPI"])
    # elem = arr + 32 + calldataload(arr + 32 + 32*i)
    E(["DUP1", 32, "MUL", "DUP3", "ADD", 32, "ADD"])       # [arr, i, p] p = arr+32+32i
    E(["CALLDATALOAD", "DUP3", "ADD", 32, "ADD"])          # [arr, i, elem]
    # about = calldataload(elem); key = calldataload(elem+32)
    # val_off = elem + calldataload(elem+64); val_len = calldataload(val_off)
    E(["DUP1", 64, "ADD", "CALLDATALOAD", "DUP2", "ADD"])  # [arr, i, elem, vptr]
    E(["DUP1", "CALLDATALOAD"])                            # [arr, i, elem, vptr, vlen]
    # memory: 0x40 <- 0x20 (abi head), 0x60 <- vlen, 0x80.. <- val bytes
    E([0x20, 0x40, "MSTORE"])
    E(["DUP1", 0x60, "MSTORE"])
    E(["DUP1", "DUP3", 32, "ADD", 0x80, "CALLDATACOPY"])   # calldatacopy(0x80, vptr+32, vlen)
    # zero the ABI padding (a shorter val must not leak the previous
    # iteration's bytes): mstore(0x80+vlen, 0)
    E([0, "DUP2", 0x80, "ADD", "MSTORE"])
    # event data size = 0x40 + ceil32(vlen)   (DIV pops numerator first)
    E([32, "DUP2", 31, "ADD", "DIV", 32, "MUL", 0x40, "ADD"])  # [.., vptr, vlen, dsize]
    # topics: key, about, caller, sig  (LOG4 pops topics in order t1..t4
    # after off/size: off, size, t1(sig), t2(creator), t3(about), t4(key))
    E(["DUP4", 32, "ADD", "CALLDATALOAD"])                 # key   [.., dsize, key]
    E(["DUP5", "CALLDATALOAD"])                            # about [.., dsize, key, about]
    E(["CALLER"])                                          # [.., dsize, key, about, caller]
    E([ATTESTATION_CREATED_TOPIC])                         # [.., key, about, caller, sig]
    E(["DUP5", 0x40, "LOG4"])                              # log4(0x40, dsize, sig, caller, about, key)
    # storage: slot = keccak(key ++ keccak(about ++ keccak(caller ++ 0)));
    # elem sits 4th from the top throughout ([.., elem, vptr, vlen, dsize]).
    E(["CALLER", 0x00, "MSTORE", 0, 0x20, "MSTORE", 64, 0x00, "KECCAK256"])
    E([0x20, "MSTORE", "DUP4", "CALLDATALOAD", 0x00, "MSTORE", 64, 0x00, "KECCAK256"])
    E([0x20, "MSTORE", "DUP4", 32, "ADD", "CALLDATALOAD", 0x00, "MSTORE", 64, 0x00, "KECCAK256"])
    # value word = keccak(val bytes)
    E(["SWAP1", "POP"])                                    # drop dsize: [arr, i, elem, vptr, vlen, slot]
    E(["SWAP1", 0x80, "KECCAK256"])                        # keccak(mem[0x80:0x80+vlen]) -> [.., vptr? ...]
    E(["SWAP1", "SSTORE"])                                 # sstore(slot, hash)
    # pop vptr, elem; i += 1
    E(["POP", "POP"])
    E([1, "ADD"])                                          # [arr, i+1]
    E([("ref", "loop"), "JUMP"])

    E([("label", "done"), "STOP"])
    return assemble(a)


#: keccak4("verify(uint256[5],bytes)") — EtVerifierWrapper.sol:26-28.
VERIFY_SELECTOR = int.from_bytes(
    keccak256(b"verify(uint256[5],bytes)")[:4], "big"
)
#: keccak("Verified(address)") — EtVerifierWrapper.sol:20.
VERIFIED_TOPIC = int.from_bytes(keccak256(b"Verified(address)"), "big")


def et_wrapper_runtime(verifier_addr: int) -> bytes:
    """EtVerifierWrapper runtime (contracts/EtVerifierWrapper.sol),
    assembled: ``verify(uint256[5] pubIns, bytes proof)`` unpacks its
    ABI calldata, staticcalls the raw verifier with the packed
    ``pubIns ‖ proof`` payload, reverts when the verifier rejects, and
    emits ``Verified(msg.sender)``."""
    a: list = []
    E = a.extend
    E([0, "CALLDATALOAD", 224, "SHR", VERIFY_SELECTOR, "EQ", ("ref", "sel"), "JUMPI"])
    E([0, 0, "REVERT", ("label", "sel")])
    # verifier.code.length == 0 -> VerifierMissing (plain revert here)
    E([verifier_addr, "EXTCODESIZE", ("ref", "present"), "JUMPI"])
    E([0, 0, "REVERT", ("label", "present")])
    # mem[0:160] = pubIns; proof tail follows
    E([160, 4, 0, "CALLDATACOPY"])
    # boff = calldataload(164); plen = calldataload(4+boff)
    E([164, "CALLDATALOAD", 4, "ADD"])                      # [pptr] (abs len word)
    E(["DUP1", "CALLDATALOAD"])                             # [pptr, plen]
    E(["DUP1", "DUP3", 32, "ADD", 160, "CALLDATACOPY"])     # copy(160, pptr+32, plen)
    # staticcall(gas, verifier, 0, 160+plen, 0, 0)
    E([0, 0, "DUP3", 160, "ADD", 0, verifier_addr, "GAS", "STATICCALL"])
    E([("ref", "ok"), "JUMPI"])
    E([0, 0, "REVERT", ("label", "ok")])
    E(["CALLER", VERIFIED_TOPIC, 0, 0, "LOG2"])
    E(["STOP"])
    return assemble(a)


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


@dataclass
class ChainLog:
    """A mined log: machine.Log plus chain coordinates (the
    eth_getLogs response shape the event source consumes)."""

    address: int
    topics: list[int]
    data: bytes
    block_number: int
    tx_index: int


@dataclass
class DevChain:
    """Blocks are one-transaction: every successful transact() mines."""

    evm: EVM = dc_field(default_factory=EVM)
    block_number: int = 0
    logs: list[ChainLog] = dc_field(default_factory=list)

    def deploy_runtime(self, runtime: bytes) -> int:
        addr = self.evm.deploy_runtime(runtime)
        self.block_number += 1
        return addr

    def deploy_attestation_station(self) -> int:
        return self.deploy_runtime(attestation_station_runtime())

    def transact(self, to: int, data: bytes, sender: int) -> Receipt:
        r = self.evm.call(to, data, caller=sender)
        if r.success:
            self.block_number += 1
            for i, log in enumerate(r.logs):
                self.logs.append(
                    ChainLog(
                        address=log.address,
                        topics=log.topics,
                        data=log.data,
                        block_number=self.block_number,
                        tx_index=i,
                    )
                )
        return r

    def call(self, to: int, data: bytes) -> Receipt:
        """eth_call semantics: runs on ephemeral state — storage writes
        are rolled back and no block is mined."""
        snapshot = {a: dict(s) for a, s in self.evm.storage.items()}
        try:
            return self.evm.call(to, data)
        finally:
            self.evm.storage = snapshot

    # -- the JSON-RPC-shaped surface the event source needs -------------

    def eth_block_number(self) -> int:
        return self.block_number

    def eth_get_logs(
        self,
        address: int | None = None,
        from_block: int = 0,
        to_block: int | None = None,
        topic0: int | None = None,
    ) -> list[ChainLog]:
        hi = self.block_number if to_block is None else to_block
        return [
            lg
            for lg in self.logs
            if from_block <= lg.block_number <= hi
            and (address is None or lg.address == address)
            and (topic0 is None or (lg.topics and lg.topics[0] == topic0))
        ]


def _word(x) -> bytes:
    """One ABI word from an int, bytes32, or 0x-hex address string."""
    if isinstance(x, bytes):
        return x.rjust(32, b"\0")
    if isinstance(x, str):
        return bytes.fromhex(x.removeprefix("0x")).rjust(32, b"\0")
    return int(x).to_bytes(32, "big")


def encode_attest_batch(batch: list[tuple]) -> bytes:
    """The canonical ``attest((address,bytes32,bytes)[])`` argument
    encoding (no selector) for (about, key, val) triples — shared by
    the dev chain tests and the client's chain submission so the ABI
    layout has exactly one definition (att_station.rs:54 parity)."""
    n = len(batch)
    body = _word(n)
    offsets = []
    elems = []
    off = 32 * n
    for about, key, val in batch:
        offsets.append(off)
        pad = (-len(val)) % 32
        elem = (
            _word(about) + _word(key) + _word(0x60) + _word(len(val)) + val + b"\0" * pad
        )
        elems.append(elem)
        off += len(elem)
    body += b"".join(_word(o) for o in offsets) + b"".join(elems)
    return _word(0x20) + body


def encode_attest_calldata(batch: list[tuple]) -> bytes:
    """Selector-prefixed attest() calldata for the dev chain."""
    return ATTEST_SELECTOR.to_bytes(4, "big") + encode_attest_batch(batch)

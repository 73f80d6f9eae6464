"""The port's dev chain (``protocol_tpu_torch.evm.devchain``) beside the
reference's.

The reference's ``tests/test_devchain.py`` re-targeted at the port: the
hand-assembled AttestationStation (events, storage, padding, ephemeral
calls), the client attesting on-chain and a node's event source
replaying the log, the stream polling new blocks, and the committed
proof verified on-chain through the wrapper.  Then parity, each case to
"bytes equal": the second assembler's bytes, the station and wrapper
runtimes, the topics and selectors, the attest calldata, and the logs,
block numbers, storage and contract addresses of the same transactions
on each package's chain."""

import asyncio
from pathlib import Path

import numpy as np
import pytest

from protocol_tpu.evm import devchain as ref_devchain
from protocol_tpu_torch.crypto import field
from protocol_tpu_torch.crypto.keccak import keccak256
from protocol_tpu_torch.evm import devchain
from protocol_tpu_torch.evm.devchain import (
    ATTESTATION_CREATED_TOPIC,
    VERIFIED_TOPIC,
    DevChain,
    encode_attest_calldata,
    et_wrapper_runtime,
)
from protocol_tpu_torch.node.ethereum import ChainEventSource, DevChainRpc

DATA = Path(__file__).resolve().parent.parent / "data"
P = field.MODULUS


def _station_chain():
    chain = DevChain()
    addr = chain.deploy_attestation_station()
    return chain, addr


class TestAttestationStationContract:
    def test_attest_batch_emits_and_stores(self):
        chain, addr = _station_chain()
        sender, about, key = 0xA11CE, 0xB0B, 0xDEAD
        val = b"some attestation payload bytes"
        r = chain.transact(addr, encode_attest_calldata([(about, key, val)]), sender)
        assert r.success and len(r.logs) == 1
        lg = chain.logs[0]
        assert lg.topics == [ATTESTATION_CREATED_TOPIC, sender, about, key]
        assert int.from_bytes(lg.data[32:64], "big") == len(val)
        assert lg.data[64 : 64 + len(val)] == val
        h1 = keccak256(sender.to_bytes(32, "big") + (0).to_bytes(32, "big"))
        h2 = keccak256(about.to_bytes(32, "big") + h1)
        slot = int.from_bytes(keccak256(key.to_bytes(32, "big") + h2), "big")
        assert chain.evm.storage[addr][slot] == int.from_bytes(keccak256(val), "big")

    def test_bad_selector_reverts(self):
        chain, addr = _station_chain()
        assert not chain.transact(addr, b"\x00\x01\x02\x03", 1).success
        assert chain.block_number == 1  # reverted tx does not mine

    def test_batch_padding_does_not_leak_previous_val(self):
        chain, addr = _station_chain()
        r = chain.transact(addr, encode_attest_calldata([(1, 2, b"A" * 40), (3, 4, b"B" * 5)]), 9)
        assert r.success
        second = chain.logs[1].data
        assert second[64:69] == b"B" * 5
        assert second[69:96] == b"\0" * 27

    def test_call_is_ephemeral(self):
        chain, addr = _station_chain()
        before_blocks = chain.block_number
        chain.call(addr, encode_attest_calldata([(7, 8, b"query-only")]))
        assert chain.block_number == before_blocks
        assert chain.evm.storage.get(addr, {}) == {}
        assert chain.logs == []


class TestEventSourceOverDevChain:
    def test_client_attest_node_replay_roundtrip(self):
        """The client signs and submits on-chain; the event source
        replays the log from block 0 and a manager accepts the
        attestation."""
        from protocol_tpu_torch.client.client import DevChainBackend, EigenTrustClient
        from protocol_tpu_torch.node.attestation import AttestationData
        from protocol_tpu_torch.node.manager import Manager, ManagerConfig
        from tests.test_torch_client import bootstrap_nodes, make_config

        chain, addr = _station_chain()
        cfg = make_config(None, event_fixture=None, as_address=f"0x{addr:040x}")
        client = EigenTrustClient(cfg, bootstrap_nodes(), chain=DevChainBackend(chain))
        sent = client.attest()

        events = list(ChainEventSource(DevChainRpc(chain), cfg.as_address).replay())
        assert len(events) == 1
        ev = events[0]
        assert ev.key == sent.key and ev.val == sent.val
        assert int(ev.creator, 16) == DevChainBackend.SENDER

        mgr = Manager(ManagerConfig(prover="commitment"))
        n = mgr.config.num_neighbours
        mgr.add_attestation(AttestationData.from_bytes(ev.val, n).to_attestation(n))
        assert len(mgr.attestations) == 1

    def test_stream_polls_new_blocks(self):
        chain, addr = _station_chain()
        source = ChainEventSource(DevChainRpc(chain), f"0x{addr:040x}")

        async def scenario():
            got = []
            stream = source.stream(poll_interval=0.01)

            async def consume():
                async for ev in stream:
                    got.append(ev)
                    if len(got) >= 2:
                        return

            chain.transact(addr, encode_attest_calldata([(1, 2, b"one")]), 7)
            task = asyncio.create_task(consume())
            await asyncio.sleep(0.05)
            chain.transact(addr, encode_attest_calldata([(3, 4, b"two")]), 7)
            await asyncio.wait_for(task, timeout=5)
            return got

        assert [e.val for e in asyncio.run(scenario())] == [b"one", b"two"]


class TestOnChainVerify:
    def test_wrapper_verifies_committed_proof(self):
        """The committed verifier and the wrapper on the port's dev
        chain; the client's chain-mode verify accepts the committed
        proof, the wrapper logs ``Verified(sender)``, and a flipped
        public-input byte is refused.  The same transactions on the
        reference's chain leave the same logs and gas."""
        from protocol_tpu.client.client import DevChainBackend as RefDevChainBackend
        from protocol_tpu_torch.client.client import DevChainBackend, EigenTrustClient
        from protocol_tpu_torch.zk.evm_verifier import GeneratedVerifier
        from protocol_tpu_torch.zk.proof import ProofRaw
        from tests.test_torch_client import bootstrap_nodes, make_config

        gen = GeneratedVerifier.from_bytes((DATA / "et_verifier.bin").read_bytes())
        raw = ProofRaw.from_json((DATA / "et_proof.json").read_text())

        chain = DevChain()
        verifier = chain.deploy_runtime(gen.runtime)
        wrapper = chain.deploy_runtime(et_wrapper_runtime(verifier))
        cfg = make_config(None, event_fixture=None,
                          et_verifier_wrapper_address=f"0x{wrapper:040x}")
        seen = []

        class Recording(DevChainBackend):
            def transact(self, to, calldata):
                seen.append((to, calldata))
                return super().transact(to, calldata)

        client = EigenTrustClient(cfg, bootstrap_nodes(), chain=Recording(chain))
        assert client.use_chain()
        assert client.verify(raw)
        assert DevChainBackend.SENDER == RefDevChainBackend.SENDER
        assert any(lg.topics[:2] == [VERIFIED_TOPIC, DevChainBackend.SENDER] for lg in chain.logs)
        bad = ProofRaw(pub_ins=[bytes([raw.pub_ins[0][0] ^ 1]) + raw.pub_ins[0][1:]]
                       + raw.pub_ins[1:], proof=raw.proof, backend=raw.backend)
        assert not client.verify(bad)
        assert chain.block_number == 3  # two deploys and the one accepted verify

        ref = ref_devchain.DevChain()
        ref_verifier = ref.deploy_runtime(gen.runtime)
        assert ref.deploy_runtime(ref_devchain.et_wrapper_runtime(ref_verifier)) == wrapper
        ours_receipt = chain.evm.call(wrapper, seen[0][1], caller=DevChainBackend.SENDER)
        ref_receipt = ref.transact(wrapper, seen[0][1], sender=RefDevChainBackend.SENDER)
        assert ref_receipt.success and ours_receipt.success
        assert ours_receipt.gas_used == ref_receipt.gas_used
        assert [(lg.address, lg.topics, lg.data, lg.block_number) for lg in ref.logs] == \
            [(lg.address, lg.topics, lg.data, lg.block_number) for lg in chain.logs]


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def test_runtimes_topics_and_selectors_equal_the_references():
    """Bytes equal: the station runtime, the wrapper runtime for several
    verifier addresses, the event topics and the selectors."""
    assert devchain.attestation_station_runtime() == ref_devchain.attestation_station_runtime()
    for addr in (0x1000, 0x1001, 0xDEAD, (1 << 160) - 1):
        assert et_wrapper_runtime(addr) == ref_devchain.et_wrapper_runtime(addr)
    assert (ATTESTATION_CREATED_TOPIC, VERIFIED_TOPIC) == (
        ref_devchain.ATTESTATION_CREATED_TOPIC, ref_devchain.VERIFIED_TOPIC)
    assert isinstance(ATTESTATION_CREATED_TOPIC, int)
    assert (devchain.ATTEST_SELECTOR, devchain.VERIFY_SELECTOR) == (
        ref_devchain.ATTEST_SELECTOR, ref_devchain.VERIFY_SELECTOR)


def test_second_assembler_equals_the_references():
    items = [0, 1, 255, 256, 1 << 200, "CALLER", ("label", "a"), "DUP3", ("ref", "a"),
             ("ref", "b"), "JUMPI", ("label", "b"), "LOG4", "STOP"]
    assert devchain.assemble(items) == ref_devchain.assemble(items)
    assert devchain._OPS == ref_devchain._OPS


@pytest.mark.parametrize("seed", range(3))
def test_attest_transactions_equal_the_references(seed):
    """The same seeded batches (addresses as ints, hex strings and bytes;
    payloads of 0 to 100 bytes) from the same senders, one of them a bad
    selector: the calldata, each receipt's success and gas, the mined
    logs, the block numbers, the storage and the addresses are equal."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(4):
        batch = []
        for _ in range(int(rng.integers(1, 4))):
            about = int.from_bytes(rng.bytes(20), "big")
            about = [about, f"0x{about:040x}", about.to_bytes(20, "big")][int(rng.integers(0, 3))]
            batch.append((about, rng.bytes(32), rng.bytes(int(rng.integers(0, 101)))))
        batches.append(batch)
    senders = [int(x) for x in rng.integers(1, 1 << 40, len(batches))]
    chains = []
    for mod in (devchain, ref_devchain):
        chain = mod.DevChain()
        addr = chain.deploy_attestation_station()
        receipts = []
        for batch, sender in zip(batches, senders):
            data = mod.encode_attest_calldata(batch)
            r = chain.transact(addr, data, sender)
            receipts.append((data, r.success, r.gas_used))
        r = chain.transact(addr, b"\xde\xad\xbe\xef", 3)
        receipts.append((r.success, r.gas_used))
        logs = [(lg.address, lg.topics, lg.data, lg.block_number, lg.tx_index)
                for lg in chain.eth_get_logs(address=addr, topic0=mod.ATTESTATION_CREATED_TOPIC)]
        chains.append((addr, receipts, logs, chain.eth_block_number(),
                       chain.eth_get_logs(from_block=3, to_block=4) != [], chain.evm.storage))
    assert chains[0] == chains[1]
    assert all(ok for _, ok, _ in chains[0][1][:-1]) and chains[0][1][-1][0] is False

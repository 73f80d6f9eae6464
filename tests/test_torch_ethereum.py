"""The port's chain event sources (``protocol_tpu_torch.node.ethereum``)
beside the reference's.

The reference's suites re-targeted at the port: all of
``tests/test_ethereum_rpc.py`` (the ``_Web3Rpc`` transport through a
stub ``web3`` module replaying recorded JSON-RPC responses: topic
normalization, the ``get_logs`` query shape, ``block_number``, the
shared decode, the actionable error without web3) and
``tests/test_durability.py::TestRpcRetryWall`` (retries with backoff,
the resumable cursor, a hung call timing out as a retry, driven by the
``rpc.get_logs`` chaos point).  Then parity (the event topic, the event
JSON, the decode of the same logs) and the node's chain-event loop: a
``DevChainRpc``-backed source resumes from the checkpoint manifest's
block cursor, its events reach the cache through the admission plane,
and the cursor advances on disk.
"""

import asyncio
import sys
import time
import types

import pytest

from protocol_tpu.node import ethereum as ref_eth
from protocol_tpu_torch import chaos
from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.checkpoint import CheckpointStore
from protocol_tpu_torch.node.config import ProtocolConfig
from protocol_tpu_torch.node.ethereum import (
    ATTESTATION_CREATED_TOPIC,
    AttestationCreatedEvent,
    ChainEventSource,
    DevChainRpc,
    FixtureEventSource,
    RetryPolicy,
    Web3EventSource,
    _Web3Rpc,
    have_web3,
)
from protocol_tpu_torch.node.server import Node
from protocol_tpu_torch.obs import metrics as obs_metrics

CONTRACT = "0x" + "ab" * 20
CREATOR = 0x1234567890ABCDEF1234567890ABCDEF12345678
ABOUT = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA09
KEY = bytes.fromhex("05" * 32)
VAL = bytes(range(96))  # 5-neighbour attestation payloads are ~this size


def _abi_dynamic_bytes(val: bytes) -> bytes:
    """ABI encoding of one dynamic ``bytes`` argument: offset word,
    length word, payload padded to a 32-byte boundary."""
    pad = (-len(val)) % 32
    return (
        (32).to_bytes(32, "big") + len(val).to_bytes(32, "big") + val + b"\x00" * pad
    )


#: The recorded JSON-RPC responses, in wire shape (lowercase hex
#: strings) — what an ``eth_getLogs`` result entry for one
#: AttestationCreated event and an ``eth_blockNumber`` call look like.
RECORDED = {
    "eth_blockNumber": "0x10",
    "eth_getLogs": [
        {
            "topics": [
                ATTESTATION_CREATED_TOPIC,
                "0x" + f"{CREATOR:064x}",
                "0x" + f"{ABOUT:064x}",
                "0x" + KEY.hex(),
            ],
            "data": "0x" + _abi_dynamic_bytes(VAL).hex(),
        }
    ],
}


class _HexBytes(bytes):
    """web3.py returns HexBytes (a bytes subclass) for topics/data."""


def _fake_web3_module(recorded: dict, queries: list) -> types.ModuleType:
    """A web3 stub replaying the recorded responses: hex-string wire
    values are normalized to HexBytes exactly like web3.py does, and
    every get_logs query is captured for shape assertions."""

    class _Eth:
        @property
        def block_number(self):
            return int(recorded["eth_blockNumber"], 16)

        def get_logs(self, query):
            queries.append(dict(query))
            return [
                {
                    "topics": [
                        _HexBytes(bytes.fromhex(t[2:])) for t in log["topics"]
                    ],
                    "data": _HexBytes(bytes.fromhex(log["data"][2:])),
                }
                for log in recorded["eth_getLogs"]
            ]

    class Web3:
        class HTTPProvider:
            def __init__(self, url):
                self.url = url

        def __init__(self, provider):
            self.provider = provider
            self.eth = _Eth()

        @staticmethod
        def to_checksum_address(addr):
            # EIP-55 casing is cosmetic for the stub; byte identity is
            # what the query-shape assertions check.
            return addr

    mod = types.ModuleType("web3")
    mod.Web3 = Web3
    return mod


@pytest.fixture
def rpc_fixture(monkeypatch):
    queries: list = []
    monkeypatch.setitem(sys.modules, "web3", _fake_web3_module(RECORDED, queries))
    return queries


class TestWeb3RpcFixture:
    def test_replay_decodes_recorded_logs(self, rpc_fixture):
        source = Web3EventSource("http://node:8545", CONTRACT)
        events = list(source.replay(from_block=0))
        assert len(events) == 1
        ev = events[0]
        assert ev.creator == f"0x{CREATOR:040x}"
        assert ev.about == f"0x{ABOUT:040x}"
        assert ev.key == KEY
        assert ev.val == VAL

    def test_get_logs_query_shape(self, rpc_fixture):
        source = Web3EventSource("http://node:8545", CONTRACT)
        list(source.replay(from_block=7, to_block=12))
        (query,) = rpc_fixture
        assert query["fromBlock"] == 7
        assert query["toBlock"] == 12
        assert query["address"] == CONTRACT
        # One-element topic filter pinned to the AttestationCreated
        # topic0 — anything broader would replay foreign events.
        assert query["topics"] == [ATTESTATION_CREATED_TOPIC]

    def test_open_ended_replay_omits_to_block(self, rpc_fixture):
        source = Web3EventSource("http://node:8545", CONTRACT)
        list(source.replay(from_block=0))
        (query,) = rpc_fixture
        assert "toBlock" not in query

    def test_block_number_normalizes(self, rpc_fixture):
        rpc = _Web3Rpc("http://node:8545")
        assert rpc.block_number() == 16

    def test_log_topic_normalization(self, rpc_fixture):
        """web3's HexBytes topics become plain ints on the _Log shim —
        the contract ChainEventSource._decode relies on."""
        rpc = _Web3Rpc("http://node:8545")
        logs = rpc.get_logs(
            address=int(CONTRACT, 16),
            from_block=0,
            to_block=None,
            topic0=int(ATTESTATION_CREATED_TOPIC, 16),
        )
        (log,) = logs
        assert all(isinstance(t, int) for t in log.topics)
        assert log.topics[0] == int(ATTESTATION_CREATED_TOPIC, 16)
        assert log.topics[1] == CREATOR
        assert isinstance(log.data, bytes)

    def test_without_web3_raises_actionable_error(self):
        if have_web3():  # pragma: no cover - image carries no web3
            pytest.skip("real web3 installed; the gated path is live")
        with pytest.raises(RuntimeError, match="web3.py is not installed"):
            Web3EventSource("http://node:8545", CONTRACT)


# ---------------------------------------------------------------------------
# tests/test_durability.py::TestRpcRetryWall
# ---------------------------------------------------------------------------


@pytest.fixture
def _reset_chaos():
    yield
    chaos.reset()


class _FlakyRpc:
    """Stub RPC backend: a fixed head, no logs — the chaos schedule
    injects the failures."""

    def __init__(self, head: int = 9):
        self.head = head
        self.calls: list[tuple] = []

    def block_number(self) -> int:
        return self.head

    def get_logs(self, address, from_block, to_block, topic0):
        self.calls.append((from_block, to_block))
        return []


@pytest.mark.usefixtures("_reset_chaos")
class TestRpcRetryWall:
    def _drive(self, source, cursor, advances, seconds=1.5):
        async def run():
            agen = source.stream(poll_interval=0.01, cursor=cursor, on_advance=advances.append)
            try:
                await asyncio.wait_for(agen.__anext__(), timeout=seconds)
            except (StopAsyncIteration, asyncio.TimeoutError):
                pass
            finally:
                await agen.aclose()

        asyncio.run(run())

    def test_get_logs_failures_retry_and_recover(self):
        chaos.configure(
            {"seed": 1, "faults": [{"point": "rpc.get_logs", "kind": "rpc-error", "times": 2}]}
        )
        rpc = _FlakyRpc()
        source = ChainEventSource(rpc, "0x" + "11" * 20, retry=RetryPolicy(base_s=0.01, cap_s=0.05))
        retries0 = obs_metrics.RPC_RETRIES.value(op="get_logs")
        advances: list[int] = []
        self._drive(source, None, advances)
        assert obs_metrics.RPC_RETRIES.value(op="get_logs") - retries0 == 2
        assert advances and advances[0] == rpc.head + 1
        assert rpc.calls[0] == (0, rpc.head), "replay still starts at block 0"

    def test_cursor_resumes_where_replay_left_off(self):
        rpc = _FlakyRpc()
        source = ChainEventSource(rpc, "0x" + "11" * 20, retry=RetryPolicy(base_s=0.01, cap_s=0.05))
        advances: list[int] = []
        self._drive(source, 5, advances)
        assert rpc.calls[0] == (5, rpc.head), "cursor must skip replayed blocks"

    def test_hung_call_times_out_as_retry(self):
        class _HungRpc(_FlakyRpc):
            def __init__(self):
                super().__init__()
                self.slow = True

            def block_number(self) -> int:
                if self.slow:
                    self.slow = False
                    time.sleep(0.3)
                return self.head

        rpc = _HungRpc()
        source = ChainEventSource(
            rpc, "0x" + "11" * 20, retry=RetryPolicy(base_s=0.01, cap_s=0.05, timeout_s=0.05)
        )
        retries0 = obs_metrics.RPC_RETRIES.value(op="block_number")
        advances: list[int] = []
        self._drive(source, None, advances)
        assert obs_metrics.RPC_RETRIES.value(op="block_number") - retries0 >= 1
        assert advances, "the stream must recover after the timeout"

    def test_chaos_points_are_declared_on_import(self):
        declared = chaos.registry()
        assert {"rpc.block_number", "rpc.get_logs", "checkpoint.post_save"} <= set(declared)


# ---------------------------------------------------------------------------
# parity and the node's chain-event loop
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self, topics, data):
        self.topics = topics
        self.data = data


class _DevChain:
    """The dev chain's two RPC methods over a list of (block, log)."""

    def __init__(self, logs, head):
        self.logs, self.head = logs, head
        self.queries: list[tuple] = []

    def eth_block_number(self):
        return self.head

    def eth_get_logs(self, address, from_block, to_block, topic0):
        self.queries.append((address, from_block, to_block, topic0))
        hi = self.head if to_block is None else to_block
        return [log for block, log in self.logs
                if from_block <= block <= hi and log.topics[0] == topic0]


def signed_rows(rows):
    sks, pks = keyset_from_raw(FIXED_SET)
    _, msgs = calculate_message_hash(pks, rows)
    return [
        Attestation(sig=sign(sks[i], pks[i], m), pk=pks[i], neighbours=list(pks), scores=row)
        for i, (row, m) in enumerate(zip(rows, msgs))
    ]


def attestation_log(i: int, att: Attestation) -> _Log:
    val = AttestationData.from_attestation(att).to_bytes()
    return _Log(
        [int(ATTESTATION_CREATED_TOPIC, 16), 0x1000 + i, 0x2000 + i, i],
        _abi_dynamic_bytes(val),
    )


class TestParity:
    def test_topic_and_event_json_equal_the_references(self, tmp_path):
        assert ATTESTATION_CREATED_TOPIC == ref_eth.ATTESTATION_CREATED_TOPIC
        ev = AttestationCreatedEvent(creator=f"0x{CREATOR:040x}", about=f"0x{ABOUT:040x}",
                                     key=KEY, val=VAL)
        ref_ev = ref_eth.AttestationCreatedEvent(creator=ev.creator, about=ev.about, key=KEY,
                                                 val=VAL)
        assert ev.to_json() == ref_ev.to_json()
        path = tmp_path / "events.jsonl"
        path.write_text(ev.to_json() + "\n\n" + ref_ev.to_json() + "\n")
        ours = [e.to_json() for e in FixtureEventSource(path).replay()]
        theirs = [e.to_json() for e in ref_eth.FixtureEventSource(path).replay()]
        assert ours == theirs and len(ours) == 2

    def test_same_logs_decode_the_same(self):
        logs = [(b, attestation_log(b, a)) for b, a in enumerate(signed_rows([[200] * 5] * 3))]
        chain = _DevChain(logs, head=2)
        contract = "0x" + "ab" * 20
        ours = [e.to_json() for e in ChainEventSource(DevChainRpc(chain), contract).replay(1)]
        theirs = [e.to_json() for e in
                  ref_eth.ChainEventSource(ref_eth.DevChainRpc(chain), contract).replay(1)]
        assert ours == theirs and len(ours) == 2
        assert chain.queries[0] == chain.queries[1] == (int(contract, 16), 1, None,
                                                        int(ATTESTATION_CREATED_TOPIC, 16))

    def test_retry_policy_defaults_equal(self):
        assert RetryPolicy() == RetryPolicy(**vars(ref_eth.RetryPolicy()))


class TestNodeEventSources:
    def test_fixture_wins_then_web3_then_idle(self, rpc_fixture, tmp_path, monkeypatch):
        node = Node.from_config(ProtocolConfig(prover="commitment", device="cpu",
                                               event_fixture=str(tmp_path / "e.jsonl")))
        assert isinstance(node._event_source(), FixtureEventSource)
        node = Node.from_config(ProtocolConfig(prover="commitment", device="cpu",
                                               as_contract_address=CONTRACT))
        source = node._event_source()
        assert isinstance(source, Web3EventSource)
        assert source.contract_address == CONTRACT
        monkeypatch.delitem(sys.modules, "web3")
        monkeypatch.setattr(sys, "path", [])
        assert node._event_source() is None

    def test_chain_loop_resumes_from_the_checkpoint_cursor(self, tmp_path):
        """The node's event loop over a chain source: the replay starts
        at the cursor the checkpoint manifest holds, the events after it
        reach the cache through the admission plane, and the cursor on
        disk advances past the head."""
        rows = [[0, 400, 300, 200, 100], [250, 0, 250, 250, 250], [500, 300, 0, 100, 100]]
        logs = [(block, attestation_log(i, att))
                for i, (block, att) in enumerate(zip((1, 4, 6), signed_rows(rows)))]
        chain = _DevChain(logs, head=7)
        ckpt = tmp_path / "ckpt"
        CheckpointStore(ckpt).save_block_cursor(3)
        node = Node.from_config(ProtocolConfig(
            epoch_interval=3600, endpoint=((127, 0, 0, 1), 0), prover="commitment",
            device="cpu", checkpoint_dir=str(ckpt), wal_fsync=False))
        node._event_source = lambda: ChainEventSource(DevChainRpc(chain), CONTRACT)

        async def scenario():
            await node.start()
            deadline = time.monotonic() + 30
            want = {tuple(r) for r in rows[1:]}
            while time.monotonic() < deadline:
                got = {tuple(a.scores) for a in node.manager.attestations.values()}
                if want <= got and CheckpointStore(ckpt).block_cursor() == 8:
                    break
                await asyncio.sleep(0.05)
            await node.stop()

        asyncio.run(scenario())
        got = {tuple(a.scores) for a in node.manager.attestations.values()}
        assert {tuple(r) for r in rows[1:]} <= got
        assert tuple(rows[0]) not in got, "a block before the cursor was replayed"
        assert chain.queries[0][1:3] == (3, 7)
        assert CheckpointStore(ckpt).block_cursor() == 8

"""Chain event ingestion: AttestationCreated replay.

The port of ``protocol_tpu/node/ethereum.py``.  The reference's only
peer-to-peer transport is the AttestationStation contract's event log,
replayed from block 0 on boot (server/src/main.rs:139-143,
data/AttestationStation.sol:13-18).  Two sources implement that here:

- ``FixtureEventSource`` — a JSONL file of recorded events;
- ``Web3EventSource``    — live JSON-RPC via web3.py when installed
  (the import is gated behind :func:`have_web3`; nothing is fetched).

``ChainEventSource`` replays over any RPC backend with
``block_number``/``get_logs``; ``DevChainRpc`` adapts any object with
the dev chain's ``eth_block_number``/``eth_get_logs`` methods.
"""

from __future__ import annotations

import json
import logging
import random
from dataclasses import dataclass
from pathlib import Path
from typing import AsyncIterator, Callable, Iterator

from .. import chaos
from ..crypto.keccak import event_topic
from ..obs.metrics import RPC_RETRIES

log = logging.getLogger(__name__)

chaos.declare("rpc.block_number", "chain head poll about to hit the RPC backend")
chaos.declare("rpc.get_logs", "event-log fetch about to hit the RPC backend")

#: keccak256("AttestationCreated(address,address,bytes32,bytes)") — the
#: event topic emitted by AttestationStation.sol:13-18.
ATTESTATION_CREATED_TOPIC = (
    "0x" + event_topic("AttestationCreated(address,address,bytes32,bytes)").hex()
)


@dataclass
class AttestationCreatedEvent:
    """Decoded AttestationCreated(creator, about, key, val)."""

    creator: str
    about: str
    key: bytes
    val: bytes

    def to_json(self) -> str:
        return json.dumps(
            {
                "creator": self.creator,
                "about": self.about,
                "key": "0x" + self.key.hex(),
                "val": "0x" + self.val.hex(),
            }
        )

    @classmethod
    def from_json(cls, line: str) -> "AttestationCreatedEvent":
        obj = json.loads(line)
        return cls(
            creator=obj["creator"],
            about=obj["about"],
            key=bytes.fromhex(obj["key"].removeprefix("0x")),
            val=bytes.fromhex(obj["val"].removeprefix("0x")),
        )


class FixtureEventSource:
    """Replays events from a JSONL fixture, then (optionally) tails the
    file for appended events — the fixture analog of an event
    subscription."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def replay(self) -> Iterator[AttestationCreatedEvent]:
        if not self.path.exists():
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield AttestationCreatedEvent.from_json(line)

    async def stream(self, poll_interval: float = 0.5) -> AsyncIterator[AttestationCreatedEvent]:
        """Tail the fixture by byte offset — appended lines are parsed
        once, never re-reading the prefix."""
        import asyncio

        offset = 0
        pending = b""
        while True:
            if self.path.exists():
                with open(self.path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
                offset += len(chunk)
                pending += chunk
                while b"\n" in pending:
                    line, pending = pending.split(b"\n", 1)
                    line = line.strip()
                    if line:
                        yield AttestationCreatedEvent.from_json(line.decode())
            await asyncio.sleep(poll_interval)


@dataclass(frozen=True)
class RetryPolicy:
    """The RPC retry wall's knobs: exponential backoff (full jitter)
    with a per-call timeout.  A transient transport failure becomes a
    counted retry (``eigentrust_rpc_retries_total{op}``) and a pause,
    never a dead event loop — the node's only peer-to-peer transport
    must survive an RPC endpoint that flaps for hours."""

    base_s: float = 0.5
    cap_s: float = 30.0
    #: Per-call deadline: a hung endpoint is a retry, not a stall.
    timeout_s: float = 10.0


class ChainEventSource:
    """AttestationCreated replay/stream over an abstract RPC backend —
    the ethers-equivalent of server/src/ethereum.rs, with the transport
    pluggable so the same decode/replay/poll logic runs against web3
    (live) or an in-process dev chain (the Anvil analog used in
    tests).

    The backend needs two methods:
    ``block_number() -> int`` and
    ``get_logs(address, from_block, to_block, topic0) -> iterable`` of
    logs with ``topics: list[int]`` and ``data: bytes``.

    ``stream`` wraps both behind the retry wall (:class:`RetryPolicy`)
    and supports a **resumable block cursor**: pass ``cursor`` (the
    next block to fetch, persisted in the checkpoint manifest by the
    node) and ``on_advance`` to be told each time the cursor moves, so
    a restart resumes the replay where it left off instead of from
    block 0.
    """

    def __init__(self, rpc, contract_address: str, retry: RetryPolicy | None = None):
        self._rpc = rpc
        self.contract_address = contract_address
        self.retry = retry or RetryPolicy()
        self._rng = random.Random()

    def replay(
        self, from_block: int = 0, to_block=None
    ) -> Iterator[AttestationCreatedEvent]:
        if chaos.ACTIVE:
            chaos.fire("rpc.get_logs")
        logs = self._rpc.get_logs(
            address=int(self.contract_address, 16),
            from_block=from_block,
            to_block=to_block,
            topic0=int(ATTESTATION_CREATED_TOPIC, 16),
        )
        for log_ in logs:
            yield self._decode(log_)

    def _block_number(self) -> int:
        if chaos.ACTIVE:
            chaos.fire("rpc.block_number")
        return self._rpc.block_number()

    @staticmethod
    def _decode(log) -> AttestationCreatedEvent:
        data = bytes(log.data)
        # ABI: dynamic bytes → offset (32) + length (32) + payload.
        length = int.from_bytes(data[32:64], "big")
        mask160 = (1 << 160) - 1
        return AttestationCreatedEvent(
            creator=f"0x{log.topics[1] & mask160:040x}",
            about=f"0x{log.topics[2] & mask160:040x}",
            key=log.topics[3].to_bytes(32, "big"),
            val=data[64 : 64 + length],
        )

    async def _call(self, op: str, fn: Callable):
        """One RPC call off-loop with the policy's per-call deadline —
        a sync transport (web3, the dev chain) must never park the
        node's event loop, and a hung one must become a retry."""
        import asyncio

        return await asyncio.wait_for(
            asyncio.get_running_loop().run_in_executor(None, fn),
            timeout=self.retry.timeout_s,
        )

    async def stream(
        self,
        poll_interval: float = 2.0,
        *,
        cursor: int | None = None,
        on_advance: Callable[[int], None] | None = None,
    ) -> AsyncIterator[AttestationCreatedEvent]:
        """Replay from the cursor (default block 0,
        server/src/main.rs:139-143) then poll new blocks — the ethers
        event-stream analog over plain JSON-RPC, behind the retry
        wall: every ``block_number``/``get_logs`` failure or timeout
        backs off exponentially with full jitter, counted on
        ``eigentrust_rpc_retries_total{op}``, and the stream resumes
        from the last *delivered* block so no event is skipped."""
        import asyncio

        next_block = int(cursor) if cursor is not None else 0
        backoff = self.retry.base_s
        while True:
            op = "block_number"
            try:
                head = await self._call(op, self._block_number)
                if head >= next_block:
                    op = "get_logs"
                    lo, hi = next_block, head
                    events = await self._call(
                        op, lambda: list(self.replay(from_block=lo, to_block=hi))
                    )
                    for ev in events:
                        yield ev
                    next_block = head + 1
                    if on_advance is not None:
                        on_advance(next_block)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception as exc:  # noqa: BLE001 - the retry wall's whole job
                RPC_RETRIES.inc(op=op)
                delay = self._rng.uniform(0, backoff)
                log.warning(
                    "chain rpc %s failed (%r); retrying in %.2fs", op, exc, delay
                )
                await asyncio.sleep(delay)
                backoff = min(backoff * 2, self.retry.cap_s)
                continue
            backoff = self.retry.base_s
            await asyncio.sleep(poll_interval)


class DevChainRpc:
    """RPC backend over an in-process dev chain: any object with
    ``eth_block_number()`` and ``eth_get_logs(address=, from_block=,
    to_block=, topic0=)``, such as ``evm.devchain.DevChain``."""

    def __init__(self, chain):
        self._chain = chain

    def block_number(self) -> int:
        return self._chain.eth_block_number()

    def get_logs(self, address, from_block, to_block, topic0):
        return self._chain.eth_get_logs(
            address=address, from_block=from_block, to_block=to_block, topic0=topic0
        )


class _Web3Rpc:  # pragma: no cover - needs web3
    """RPC backend over web3.py, normalizing HexBytes topics to ints."""

    class _Log:
        def __init__(self, raw):
            self.topics = [int.from_bytes(bytes(t), "big") for t in raw["topics"]]
            self.data = bytes(raw["data"])

    def __init__(self, node_url: str):
        from web3 import Web3  # type: ignore

        self._w3 = Web3(Web3.HTTPProvider(node_url))

    def block_number(self) -> int:
        return self._w3.eth.block_number

    def get_logs(self, address, from_block, to_block, topic0):
        query = {
            "fromBlock": from_block,
            "address": self._w3.to_checksum_address(f"0x{address:040x}"),
            "topics": [f"0x{topic0:064x}"],
        }
        if to_block is not None:
            query["toBlock"] = to_block
        return [self._Log(raw) for raw in self._w3.eth.get_logs(query)]


class Web3EventSource(ChainEventSource):
    """Live AttestationCreated stream over JSON-RPC via web3.py."""

    def __init__(self, node_url: str, contract_address: str):
        try:
            rpc = _Web3Rpc(node_url)
        except ImportError as e:  # pragma: no cover - needs web3
            raise RuntimeError(
                "web3.py is not installed; use a FixtureEventSource or a "
                "DevChainRpc-backed ChainEventSource, or install web3 for "
                "live chain ingestion"
            ) from e
        super().__init__(rpc, contract_address)


def have_web3() -> bool:
    try:
        import web3  # noqa: F401

        return True
    except ImportError:
        return False

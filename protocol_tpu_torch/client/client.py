"""EigenTrustClient and its configuration (client/src/lib.rs:31-150).

The port of ``protocol_tpu/client/client.py``.

Chain submission is transport-pluggable: a ``Transport`` either sends a
real transaction (web3, when installed) or appends the encoded event to
a fixture log (the zero-dependency path used in tests and air-gapped
runs — the node ingests either identically).
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass, field as dc_field
from pathlib import Path

from ..crypto import calculate_message_hash, field
from ..crypto.eddsa import SecretKey, sign
from ..node.attestation import Attestation, AttestationData
from ..node.bootstrap import BootstrapNode, keyset_from_raw
from ..node.ethereum import AttestationCreatedEvent
from ..zk.proof import ProofRaw


class ClientError(Exception):
    pass


#: EtVerifierWrapper.NUM_PUB_INS (contracts/EtVerifierWrapper.sol).
ET_WRAPPER_NUM_PUB_INS = 5


def _web3(node_url: str):
    """Shared web3 construction (raises ClientError when absent)."""
    try:
        from web3 import Web3  # type: ignore
    except ImportError as e:
        raise ClientError("web3 is not installed; chain mode unavailable") from e
    return Web3(Web3.HTTPProvider(node_url))


def web3_transact(w3, tx: dict):
    """Send a transaction and wait for its receipt, raising ClientError
    on revert — the one transact/wait/status path used by attest,
    verify, and deploy."""
    receipt = w3.eth.wait_for_transaction_receipt(w3.eth.send_transaction(tx))
    if receipt["status"] != 1:
        raise ClientError("transaction reverted")
    return receipt


class Web3Chain:  # pragma: no cover - needs web3
    """Chain backend over web3.py with an unlocked dev account (e.g.
    Anvil): the live counterpart of DevChainBackend."""

    def __init__(self, node_url: str):
        self._w3 = _web3(node_url)

    def transact(self, to: str, calldata: bytes) -> bool:
        w3 = self._w3
        tx = {
            "from": w3.eth.accounts[0],
            "to": w3.to_checksum_address(to),
            "data": "0x" + calldata.hex(),
        }
        try:
            receipt = web3_transact(w3, tx)
        except ClientError:
            return False  # reverted
        except Exception as e:  # gas-estimation revert surfaces pre-send
            if "revert" in str(e).lower() or type(e).__name__ == "ContractLogicError":
                return False
            raise
        del receipt  # web3_transact already raised on status != 1
        return True


class DevChainBackend:
    """Chain backend over the in-process dev chain (evm/devchain.py) —
    the Anvil analog the chain-integration tests drive."""

    #: The unlocked "account 0" all transactions originate from.
    SENDER = 0xDE5_0000_0000_0000_0000_0000_0000_0000_0CA11

    def __init__(self, chain):
        self._chain = chain

    def transact(self, to: str, calldata: bytes) -> bool:
        r = self._chain.transact(int(to, 16), calldata, sender=self.SENDER)
        return r.success


@dataclass
class ClientConfig:
    """client-config.json shape (client/src/lib.rs:31-40)."""

    ops: list[int]
    secret_key: tuple[str, str]
    as_address: str
    et_verifier_wrapper_address: str
    mnemonic: str
    ethereum_node_url: str
    server_url: str
    event_fixture: str | None = None
    #: Path to the generated EVM verifier artifact (data/et_verifier.bin
    #: analog); enables local contract-level verification.
    et_verifier_bin: str | None = None

    @classmethod
    def from_json(cls, text: str) -> "ClientConfig":
        obj = json.loads(text)
        return cls(
            ops=[int(x) for x in obj["ops"]],
            secret_key=(obj["secret_key"][0], obj["secret_key"][1]),
            as_address=obj["as_address"],
            et_verifier_wrapper_address=obj["et_verifier_wrapper_address"],
            mnemonic=obj["mnemonic"],
            ethereum_node_url=obj["ethereum_node_url"],
            server_url=obj["server_url"],
            event_fixture=obj.get("event_fixture"),
            et_verifier_bin=obj.get("et_verifier_bin"),
        )

    def to_json(self) -> str:
        out = {
            "ops": self.ops,
            "secret_key": list(self.secret_key),
            "as_address": self.as_address,
            "et_verifier_wrapper_address": self.et_verifier_wrapper_address,
            "mnemonic": self.mnemonic,
            "ethereum_node_url": self.ethereum_node_url,
            "server_url": self.server_url,
        }
        if self.event_fixture:
            out["event_fixture"] = self.event_fixture
        if self.et_verifier_bin:
            out["et_verifier_bin"] = self.et_verifier_bin
        return json.dumps(out, indent=4)

    @classmethod
    def load(cls, path: str | Path) -> "ClientConfig":
        return cls.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json() + "\n")


@dataclass
class EigenTrustClient:
    config: ClientConfig
    user_secrets: list[BootstrapNode] = dc_field(default_factory=list)
    #: Chain transaction backend; defaults to web3 over
    #: ethereum_node_url, tests inject a DevChainBackend.
    chain: object | None = None

    def _chain_backend(self):
        if self.chain is None:
            self.chain = Web3Chain(self.config.ethereum_node_url)
        return self.chain

    def _identity(self) -> SecretKey:
        return SecretKey.from_bs58(*self.config.secret_key)

    def _build(self) -> tuple[Attestation, int]:
        """Sign the configured score vector over the bootstrap set
        (client/src/lib.rs:54-97); returns the attestation and the
        group pks_hash (the AttestationStation key)."""
        pairs = [(n.sk0, n.sk1) for n in self.user_secrets]
        _, user_publics = keyset_from_raw(pairs)

        sk = self._identity()
        pk = sk.public()
        ops = [field.from_u128(x) for x in self.config.ops]
        pks_hash, message_hashes = calculate_message_hash(user_publics, [ops])
        sig = sign(sk, pk, message_hashes[0])
        return Attestation(sig=sig, pk=pk, neighbours=user_publics, scores=ops), pks_hash

    def build_attestation(self) -> Attestation:
        return self._build()[0]

    def attest(self) -> AttestationCreatedEvent:
        """Build, sign, and submit the attestation
        (client/src/lib.rs:54-120).  Returns the event as submitted."""
        att, pks_hash = self._build()
        payload = AttestationData.from_attestation(att).to_bytes()

        event = AttestationCreatedEvent(
            creator="0x" + "00" * 20,
            about="0x" + "00" * 20,
            key=field.to_le_bytes(pks_hash),
            val=payload,
        )
        if self.config.event_fixture:
            with open(self.config.event_fixture, "a") as f:
                f.write(event.to_json() + "\n")
            return event
        return self._attest_chain(event)

    def _attest_chain(self, event: AttestationCreatedEvent) -> AttestationCreatedEvent:
        """Submit AttestationStation.attest through the chain backend
        (client/src/lib.rs:103-119)."""
        from ..evm.devchain import encode_attest_calldata

        calldata = encode_attest_calldata([(event.about, event.key, event.val)])
        if not self._chain_backend().transact(self.config.as_address, calldata):
            raise ClientError("attest transaction reverted")
        return event

    def fetch_proof(self) -> ProofRaw:
        """GET {server_url}/score (client/src/main.rs:105-107)."""
        url = f"{self.config.server_url}/score"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
        return ProofRaw.from_json(body)

    def use_chain(self) -> bool:
        """On-chain mode iff no fixture is configured and a wrapper
        address is set — NOT keyed on web3 importability, so the
        fixture/air-gapped path keeps working in web3-equipped
        environments."""
        has_wrapper = bool(
            self.config.et_verifier_wrapper_address.strip().removeprefix("0x").strip("0")
        )
        return self.config.event_fixture is None and has_wrapper

    def verify(self, proof_raw: ProofRaw) -> bool:
        """Verify the fetched proof: on-chain via the EtVerifierWrapper
        in chain mode (client/src/lib.rs:122-149); otherwise locally —
        through the in-process EVM when an et_verifier.bin artifact is
        available (the reference's contract-level verification,
        verifier/mod.rs:117-134), or with the commitment prover for
        commitment-backend nodes."""
        if self.use_chain():
            return self._verify_chain(proof_raw)
        proof = proof_raw.to_proof()
        # Dispatch on the explicit backend tag when the node sent one;
        # for untagged (reference-format) payloads fall back to shape:
        # commitment proofs are 32-byte digest + JSON payload.
        is_commitment = (
            proof_raw.backend == "commitment"
            if proof_raw.backend
            else proof.proof[32:33] == b"{"
        )
        if is_commitment:
            from ..zk.proof import PoseidonCommitmentProver

            return PoseidonCommitmentProver().verify(proof.pub_ins, proof.proof)
        from ..zk.evm_verifier import evm_verify

        ok, _gas = evm_verify(self._verifier_artifact(), proof.pub_ins, proof.proof)
        return ok

    def _verifier_artifact(self):
        """Load the EVM verifier artifact; a configured path that does
        not exist is a deployment error, not a silent fallback."""
        from ..zk.evm_verifier import GeneratedVerifier

        path = Path(self.config.et_verifier_bin or "data/et_verifier.bin")
        if not path.exists():
            raise ClientError(
                f"SNARK proof received but verifier artifact {path} is missing "
                "(generate it with PlonkEpochProver.generate_verifier_artifact)"
            )
        return GeneratedVerifier.from_bytes(path.read_bytes())

    def _verify_chain(self, proof_raw: ProofRaw) -> bool:
        """Transact EtVerifierWrapper.verify(uint256[5], bytes) through
        the chain backend (client/src/lib.rs:122-149).  A reverting
        wrapper (bad proof) returns False rather than raising."""
        from ..crypto.keccak import selector

        n = len(proof_raw.pub_ins)
        if n != ET_WRAPPER_NUM_PUB_INS:
            raise ClientError(
                f"wrapper expects {ET_WRAPPER_NUM_PUB_INS} public inputs, got {n}"
            )
        pub_words = b"".join(
            int.from_bytes(x, "little").to_bytes(32, "big") for x in proof_raw.pub_ins
        )
        proof = proof_raw.proof
        # verify(uint256[N],bytes): N inline words, bytes offset, then
        # the bytes tail.
        calldata = (
            selector(f"verify(uint256[{n}],bytes)")
            + pub_words
            + ((n + 1) * 32).to_bytes(32, "big")
            + len(proof).to_bytes(32, "big")
            + proof
            + b"\x00" * ((-len(proof)) % 32)
        )
        return self._chain_backend().transact(
            self.config.et_verifier_wrapper_address, calldata
        )


def abi_encode_attest(about: str, key: bytes, val: bytes) -> bytes:
    """ABI-encode ``attest(AttestationData[])`` arguments for one entry
    — delegates to the canonical batch encoder (evm/devchain.py) so the
    layout has one definition."""
    from ..evm.devchain import encode_attest_batch

    return encode_attest_batch([(about, key, val)])

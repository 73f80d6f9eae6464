"""The port's client (``protocol_tpu_torch.client``) beside the reference's.

The reference's ``tests/test_client.py`` re-targeted at the port: the
signed attestation passes a manager's validation, the fixture transport,
the whole loop over a fixture chain (attest, a port node on the CPU
ingests it, proves the epoch, serves ``/score``, the client verifies),
the ABI layout and the CLI's subcommands, each against a ``tmp_path``
copy of ``data/``.  Then parity, each case to "bytes equal": the signed
attestation and its event, the attest and ``verify(uint256[5],bytes)``
calldata, and the CLI's standard output, saved configuration and exit
messages for the same arguments in each package, including ``verify``
of a served commitment proof and of the committed k = 14 proof on the
committed ``data/et_verifier.bin``."""

import asyncio
import http.server
import json
import shutil
import sys
import threading
from pathlib import Path

import pytest

from protocol_tpu.client import cli as ref_cli
from protocol_tpu.client import client as ref_client
from protocol_tpu_torch.client import cli
from protocol_tpu_torch.client.cli import main as cli_main
from protocol_tpu_torch.client.client import (
    ClientConfig,
    ClientError,
    DevChainBackend,
    EigenTrustClient,
    abi_encode_attest,
)
from protocol_tpu_torch.node.attestation import AttestationData
from protocol_tpu_torch.node.bootstrap import NUM_NEIGHBOURS, read_bootstrap_csv
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig

DATA = Path(__file__).resolve().parents[1] / "data"
ROW = [300, 100, 100, 300, 200]


def make_config(tmp_path, **overrides):
    cfg = ClientConfig.load(DATA / "client-config.json")
    if tmp_path is not None:
        cfg.event_fixture = str(tmp_path / "events.jsonl")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def bootstrap_nodes():
    return read_bootstrap_csv(DATA / "bootstrap-nodes.csv")


def data_dir(root: Path) -> Path:
    d = root / "data"
    d.mkdir(parents=True)
    for name in ("client-config.json", "bootstrap-nodes.csv"):
        (d / name).write_text((DATA / name).read_text())
    return d


class TestClientAttest:
    def test_attestation_is_node_valid(self, tmp_path):
        client = EigenTrustClient(make_config(tmp_path), bootstrap_nodes())
        att = client.build_attestation()
        assert Manager(ManagerConfig(prover="commitment")).add_attestation(att).accepted
        assert att.scores == ROW

    def test_attest_writes_fixture_event(self, tmp_path):
        cfg = make_config(tmp_path)
        client = EigenTrustClient(cfg, bootstrap_nodes())
        event = client.attest()
        lines = Path(cfg.event_fixture).read_text().strip().splitlines()
        assert len(lines) == 1
        att = AttestationData.from_bytes(event.val, NUM_NEIGHBOURS).to_attestation(NUM_NEIGHBOURS)
        assert att.pk == client.build_attestation().pk

    def test_full_protocol_loop(self, tmp_path):
        """attest → a port node (``device="cpu"``) ingests the fixture →
        the epoch's commitment proof → ``/score`` → the client verifies."""
        from protocol_tpu_torch.node.config import ProtocolConfig
        from protocol_tpu_torch.node.server import Node

        cfg = make_config(tmp_path)
        client = EigenTrustClient(cfg, bootstrap_nodes())
        client.attest()

        async def scenario():
            node = Node.from_config(ProtocolConfig(
                epoch_interval=3600, endpoint=((127, 0, 0, 1), 0),
                event_fixture=cfg.event_fixture, prover="commitment", device="cpu"))
            await node.start()
            alice_hash = client.build_attestation().pk.hash()
            for _ in range(100):
                att = node.manager.attestations.get(alice_hash)
                if att is not None and att.scores == ROW:
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError("fixture event was not ingested")
            node.manager.calculate_proofs(Epoch(0))
            port = node._server.sockets[0].getsockname()[1]
            cfg.server_url = f"http://127.0.0.1:{port}"
            proof_raw = await asyncio.get_running_loop().run_in_executor(None, client.fetch_proof)
            await node.stop()
            return proof_raw, json.loads(proof_raw.proof[32:].decode())

        proof_raw, payload = asyncio.run(scenario())
        assert client.verify(proof_raw)
        assert ROW in payload["ops"]

    def test_missing_verifier_artifact_names_the_generator(self, tmp_path):
        """A SNARK proof with no artifact at the configured path is a
        deployment error naming the port's generator."""
        from protocol_tpu_torch.zk.proof import ProofRaw

        raw = ProofRaw.from_json((DATA / "et_proof.json").read_text())
        cfg = make_config(None, event_fixture=None, et_verifier_wrapper_address="0x" + "00" * 20,
                          et_verifier_bin=str(tmp_path / "missing.bin"))
        with pytest.raises(ClientError, match="PlonkEpochProver.generate_verifier_artifact"):
            EigenTrustClient(cfg, bootstrap_nodes()).verify(raw)


class TestAbiEncoding:
    def test_attest_calldata_layout(self):
        data = abi_encode_attest("0x" + "11" * 20, b"\x22" * 32, b"\xab\xcd")
        assert data[:32] == (0x20).to_bytes(32, "big")
        assert data[32:64] == (1).to_bytes(32, "big")
        assert data[96:128].endswith(b"\x11" * 20)
        assert data[128:160] == b"\x22" * 32
        assert data[192:224] == (2).to_bytes(32, "big")
        assert data[224:226] == b"\xab\xcd"


class TestCli:
    def test_show(self, tmp_path, capsys):
        cli_main(["--data-dir", str(data_dir(tmp_path)), "show"])
        assert json.loads(capsys.readouterr().out)["ops"] == ROW

    def test_update_score(self, tmp_path):
        d = data_dir(tmp_path)
        cli_main(["--data-dir", str(d), "update", "score", "Bob 777"])
        assert ClientConfig.load(d / "client-config.json").ops[1] == 777

    def test_update_score_rejects_negative(self, tmp_path):
        with pytest.raises(SystemExit, match="Failed to parse score"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "score", "Bob -5"])

    def test_update_score_unknown_name(self, tmp_path):
        with pytest.raises(SystemExit, match="Invalid neighbour name"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "score", "Mallory 1"])

    def test_update_bad_field(self, tmp_path):
        with pytest.raises(SystemExit, match="Invalid config field"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "nope", "x"])

    def test_update_missing_value(self, tmp_path):
        with pytest.raises(SystemExit, match="provide the update data"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "score"])

    def test_update_address_validated(self, tmp_path):
        d = data_dir(tmp_path)
        with pytest.raises(SystemExit, match="Failed to parse address"):
            cli_main(["--data-dir", str(d), "update", "as_address", "nothex"])
        cli_main(["--data-dir", str(d), "update", "as_address", "0x" + "ab" * 20])
        assert ClientConfig.load(d / "client-config.json").as_address == "0x" + "ab" * 20

    def test_update_node_url_validated(self, tmp_path):
        with pytest.raises(SystemExit, match="Failed to parse node url"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "node_url", "ftp://x"])

    def test_update_sk_validated(self, tmp_path):
        with pytest.raises(SystemExit, match="expected 2 bs58 values"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "sk", "only-one"])

    def test_unknown_identity_rejected_for_signing_commands(self, tmp_path):
        d = data_dir(tmp_path)
        cfg = ClientConfig.load(d / "client-config.json")
        cfg.secret_key = ("1111", "2222")
        cfg.save(d / "client-config.json")
        with pytest.raises(SystemExit, match="not in bootstrap-nodes.csv"):
            cli_main(["--data-dir", str(d), "attest"])
        cli_main(["--data-dir", str(d), "show"])
        nodes = read_bootstrap_csv(d / "bootstrap-nodes.csv")
        cli_main(["--data-dir", str(d), "update", "sk", f"{nodes[1].sk0},{nodes[1].sk1}"])
        saved = ClientConfig.load(d / "client-config.json")
        assert saved.secret_key == (nodes[1].sk0, nodes[1].sk1)

    def test_update_sk_rejects_non_bootstrap_key(self, tmp_path):
        with pytest.raises(SystemExit, match="not one of the bootstrap identities"):
            cli_main(["--data-dir", str(data_dir(tmp_path)), "update", "sk", "1111,2222"])

    def test_default_data_dir_is_the_repositorys(self):
        assert cli.DEFAULT_DATA_DIR == DATA


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def test_attestation_and_calldata_equal_the_references(tmp_path):
    """Bytes equal, for each bootstrap identity attesting its own row:
    the signed attestation's payload, the fixture event line, the attest
    calldata a chain receives, and the wrapper's ``verify`` calldata for
    the committed proof."""
    from protocol_tpu.zk.proof import ProofRaw as RefProofRaw
    from protocol_tpu_torch.zk.proof import ProofRaw

    from protocol_tpu_torch.client import client as port_client

    nodes = bootstrap_nodes()
    for i, node in enumerate(nodes):
        row = [0 if j == i else 100 * (j + 1) for j in range(len(nodes))]
        sent = {}
        for mod, tag in ((port_client, "port"), (ref_client, "ref")):
            fixture = tmp_path / f"{tag}{i}.jsonl"
            cfg = mod.ClientConfig.load(DATA / "client-config.json")
            cfg.secret_key, cfg.ops, cfg.event_fixture = (node.sk0, node.sk1), row, str(fixture)
            client = mod.EigenTrustClient(cfg, read_bootstrap_csv(DATA / "bootstrap-nodes.csv"))
            event = client.attest()
            calls = []

            class Recording:
                def transact(self, to, calldata):
                    calls.append((to, calldata))
                    return True

            client.config.event_fixture = None
            client.chain = Recording()
            client.attest()
            client.config.et_verifier_wrapper_address = "0x" + "9f" * 20
            raw_mod = ProofRaw if tag == "port" else RefProofRaw
            client.verify(raw_mod.from_json((DATA / "et_proof.json").read_text()))
            sent[tag] = (AttestationData.from_attestation(client.build_attestation()).to_bytes(),
                         event.to_json(), fixture.read_text(), calls)
        assert sent["port"] == sent["ref"]
        assert [to for to, _ in sent["port"][3]] == [
            "0x5fbdb2315678afecb367f032d93f642f64180aa3", "0x" + "9f" * 20]


class _Served:
    """One proof body served at ``/score`` on a free local port."""

    def __init__(self, body: str):
        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                payload = body.encode()
                self.send_response(200 if self.path == "/score" else 404)
                self.send_header("content-length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def run_cli(main, d: Path, argv: list, capsys) -> tuple:
    """(stdout, the exit message or the error's type and text) of one
    CLI run on data directory ``d``, with ``d`` written as ``<data>``."""
    try:
        main(["--data-dir", str(d), *argv])
        ended = None
    except SystemExit as e:
        ended = ("SystemExit", str(e.code))
    except ClientError as e:
        ended = ("ClientError", str(e))
    except ref_client.ClientError as e:
        ended = ("ClientError", str(e))
    out = capsys.readouterr().out.replace(str(d), "<data>")
    saved = (d / "client-config.json").read_text().replace(str(d), "<data>")
    return out, ended, saved


CLI_CASES = {
    "show": [["show"]],
    "update_score": [["update", "score", "Bob 777"], ["show"]],
    "update_errors": [["update"], ["update", "score"], ["update", "nope", "x"],
                      ["update", "score", "Bob -5"], ["update", "score", "Bob"],
                      ["update", "score", "Mallory 1"], ["update", "score", f"Bob {1 << 128}"]],
    "update_address": [["update", "as_address", "nothex"],
                       ["update", "as_address", "0x" + "AB" * 20]],
    "update_mnemonic": [["update", "mnemonic", "one two"],
                        ["update", "mnemonic", " ".join(["abandon"] * 12)]],
    "update_node_url": [["update", "node_url", "ftp://x"],
                        ["update", "node_url", "https://rpc.example"]],
    "update_sk": [["update", "sk", "only-one"], ["update", "sk", "0OIl,1111"],
                  ["update", "sk", "1111,2222"],
                  ["update", "sk", "ARVqgNQtnV4JTKqgajGEpuapYEnWz93S5vwRDoRYWNh8,"
                                   "2u1LC2JmKwkzUccS9hd5yS2DUUGTuYQ8MA7y28A9SgQY"], ["show"]],
    "no_solc": [["compile-contracts"]],
    "no_web3": [["deploy-contracts"], ["attest"]],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_output_equals_the_references(case, tmp_path, capsys, monkeypatch):
    """Bytes equal: stdout, exit message and saved configuration after
    each command of the case, in each package on its own copy of
    ``data/``; ``solc`` and ``web3`` are absent in both."""
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    monkeypatch.setitem(sys.modules, "web3", None)
    outputs = []
    for main, tag in ((cli_main, "port"), (ref_cli.main, "ref")):
        d = data_dir(tmp_path / tag)
        outputs.append([run_cli(main, d, argv, capsys) for argv in CLI_CASES[case]])
    assert outputs[0] == outputs[1]


def test_cli_attest_to_fixture_equals_the_references(tmp_path, capsys):
    """``attest`` with an event fixture: the same line, the same event."""
    outputs = []
    for main, tag in ((cli_main, "port"), (ref_cli.main, "ref")):
        d = data_dir(tmp_path / tag)
        cfg = json.loads((d / "client-config.json").read_text())
        cfg["event_fixture"] = str(d / "events.jsonl")
        (d / "client-config.json").write_text(json.dumps(cfg))
        outputs.append((run_cli(main, d, ["attest"], capsys), (d / "events.jsonl").read_text()))
    assert outputs[0] == outputs[1]
    assert outputs[0][0][0] == "attestation submitted (640 bytes) -> <data>/events.jsonl\n"


def commitment_proof_json(tamper: bool = False) -> str:
    """A port node's commitment proof of the bootstrap group's epoch 0."""
    from protocol_tpu_torch.zk.proof import ProofRaw

    m = Manager(ManagerConfig(prover="commitment", check_circuit=False))
    m.generate_initial_attestations()
    m.calculate_proofs(Epoch(0))
    raw = m.get_proof(Epoch(0)).to_raw("commitment")
    if tamper:
        raw = ProofRaw(pub_ins=[bytes([raw.pub_ins[0][0] ^ 1]) + raw.pub_ins[0][1:]]
                       + raw.pub_ins[1:], proof=raw.proof, backend=raw.backend)
    return raw.to_json()


@pytest.mark.parametrize("served", ["commitment", "commitment_tampered", "committed_plonk"])
def test_cli_verify_equals_the_references(served, tmp_path, capsys):
    """``verify`` against a served proof with no wrapper address, so both
    clients verify locally: a commitment proof and its tampered copy
    through the commitment prover, and the committed k = 14 PLONK proof
    through the committed ``data/et_verifier.bin`` on each package's
    EVM.  The same stdout or exit message."""
    body = ((DATA / "et_proof.json").read_text() if served == "committed_plonk"
            else commitment_proof_json(tamper=served.endswith("tampered")))
    outputs = []
    with _Served(body) as server:
        for main, tag in ((cli_main, "port"), (ref_cli.main, "ref")):
            d = data_dir(tmp_path / tag)
            cfg = json.loads((d / "client-config.json").read_text())
            cfg.update(server_url=server.url, et_verifier_wrapper_address="0x" + "00" * 20,
                       et_verifier_bin=str(DATA / "et_verifier.bin"))
            (d / "client-config.json").write_text(json.dumps(cfg))
            outputs.append(run_cli(main, d, ["verify"], capsys))
    assert outputs[0] == outputs[1]
    want = ("", ("SystemExit", "verification failed")) if served.endswith("tampered") else \
        ("Successful verification!\n", None)
    assert outputs[0][:2] == want

"""Client CLI (client/src/main.rs:27-216).

Subcommands: show, compile-contracts, deploy-contracts, attest, update,
verify.  Run: ``python -m protocol_tpu_torch.client.cli <subcommand>``.
The port of ``protocol_tpu/client/cli.py``: the same subcommands,
messages and exit codes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..node.bootstrap import read_bootstrap_csv
from ..utils.codec import b58decode
from .client import ClientConfig, EigenTrustClient

DEFAULT_DATA_DIR = Path(__file__).resolve().parents[2] / "data"

#: Validated `update` fields (client/src/main.rs:43-62).
UPDATE_FIELDS = ("as_address", "mnemonic", "node_url", "score", "sk")


def load_context(data_dir: Path, *, require_identity: bool = False):
    config = ClientConfig.load(data_dir / "client-config.json")
    nodes = read_bootstrap_csv(data_dir / "bootstrap-nodes.csv")
    # Commands that sign need the configured identity to be a bootstrap
    # identity (client/src/main.rs:70-71); config-repair commands must
    # stay usable with a bad key, or `update sk` could never fix it.
    if require_identity and not any(
        (n.sk0, n.sk1) == tuple(config.secret_key) for n in nodes
    ):
        raise SystemExit("configured secret key is not in bootstrap-nodes.csv")
    return config, nodes


def cmd_show(config: ClientConfig, _nodes) -> None:
    print(config.to_json())


def cmd_attest(config: ClientConfig, nodes) -> None:
    client = EigenTrustClient(config, nodes)
    event = client.attest()
    dest = config.event_fixture or config.as_address
    print(f"attestation submitted ({len(event.val)} bytes) -> {dest}")


def cmd_verify(config: ClientConfig, nodes) -> None:
    client = EigenTrustClient(config, nodes)
    proof_raw = client.fetch_proof()
    if client.verify(proof_raw):
        print("Successful verification!")
    else:
        raise SystemExit("verification failed")


def cmd_compile_contracts(_config, _nodes) -> None:
    """Compile contracts/ with solc when available
    (client/src/utils.rs:118-158)."""
    import shutil
    import subprocess

    solc = shutil.which("solc")
    contracts = Path(__file__).resolve().parents[2] / "contracts"
    if solc is None:
        raise SystemExit(
            "solc not found; install solc or use pre-compiled artifacts in data/"
        )
    out = contracts / "build"
    out.mkdir(exist_ok=True)
    subprocess.run(
        [solc, "--bin", "--abi", "--overwrite", "-o", str(out)]
        + [str(p) for p in contracts.glob("*.sol")],
        check=True,
    )
    print(f"Finished compiling! -> {out}")


def cmd_deploy_contracts(config: ClientConfig, _nodes, data_dir: Path) -> None:
    """Deploy AttestationStation, the raw PLONK verifier (from a
    provided bytecode artifact), and the wrapper pointing at it
    (client/src/main.rs:79-100)."""
    from .client import ClientError, _web3, web3_transact

    build = Path(__file__).resolve().parents[2] / "contracts" / "build"
    try:
        w3 = _web3(config.ethereum_node_url)
    except ClientError as e:
        raise SystemExit(str(e))

    def deploy(name: str, bytecode_hex: str) -> str:
        try:
            receipt = web3_transact(
                w3, {"from": w3.eth.accounts[0], "data": "0x" + bytecode_hex}
            )
        except ClientError:
            raise SystemExit(f"{name} deployment reverted")
        addr = receipt["contractAddress"]
        if len(w3.eth.get_code(addr)) == 0:
            raise SystemExit(f"{name} deployed no code")
        print(f"{name} deployed. Address: {addr}")
        return addr

    def load_bytecode(path: Path) -> str:
        """Accept solc hex-text output or raw binary creation bytecode
        (the generated-verifier artifact form)."""
        raw = path.read_bytes()
        try:
            text = raw.decode("ascii").strip().removeprefix("0x")
            bytes.fromhex(text)
            return text
        except (UnicodeDecodeError, ValueError):
            return raw.hex()

    as_bin = build / "AttestationStation.bin"
    if not as_bin.exists():
        raise SystemExit(f"{as_bin} missing; run compile-contracts first")
    deploy("AttestationStation", load_bytecode(as_bin))

    # The raw verifier is an external artifact (generated PLONK verifier
    # creation bytecode): data/et_verifier.bin if present.
    verifier_bin = data_dir / "et_verifier.bin"
    if not verifier_bin.exists():
        print(
            f"no raw verifier artifact at {verifier_bin}; skipping verifier + wrapper deploy"
        )
        return
    verifier_addr = deploy("EtVerifier", load_bytecode(verifier_bin))

    wrapper_bin = build / "EtVerifierWrapper.bin"
    if not wrapper_bin.exists():
        raise SystemExit(f"{wrapper_bin} missing; run compile-contracts first")
    # Constructor takes (address verifier_): append the ABI-encoded arg.
    ctor_arg = bytes.fromhex(verifier_addr.removeprefix("0x")).rjust(32, b"\x00")
    deploy("EtVerifierWrapper", load_bytecode(wrapper_bin) + ctor_arg.hex())


def cmd_update(config: ClientConfig, nodes, field: str | None, value: str | None, data_dir: Path) -> None:
    """Validated config update (client/src/main.rs:125-216)."""
    if field is None:
        raise SystemExit("Please provide a field to update.")
    if value is None:
        raise SystemExit('Please provide the update data, e.g. update score "Alice 100"')
    if field not in UPDATE_FIELDS:
        raise SystemExit(f"Invalid config field. Available: {', '.join(UPDATE_FIELDS)}")

    if field == "as_address":
        addr = value.lower().removeprefix("0x")
        if len(addr) != 40 or any(c not in "0123456789abcdef" for c in addr):
            raise SystemExit("Failed to parse address.")
        config.as_address = value
    elif field == "mnemonic":
        if len(value.split()) not in (12, 15, 18, 21, 24):
            raise SystemExit("Failed to parse mnemonic.")
        config.mnemonic = value
    elif field == "node_url":
        if not value.startswith(("http://", "https://")):
            raise SystemExit("Failed to parse node url.")
        config.ethereum_node_url = value
    elif field == "score":
        parts = value.split(" ")
        if len(parts) != 2:
            raise SystemExit('Invalid input format. Expected: "Alice 100"')
        name, score = parts
        # u128 semantics: non-negative integers only (a negative value
        # would wrap to a near-modulus field element at attest time).
        try:
            score_val = int(score)
            if score_val < 0 or score_val >= 1 << 128:
                raise ValueError
        except ValueError:
            raise SystemExit("Failed to parse score.")
        names = [n.name for n in nodes]
        if name not in names:
            raise SystemExit(f"Invalid neighbour name: {name!r}, available: {names}")
        config.ops[names.index(name)] = score_val
    elif field == "sk":
        sk_parts = value.split(",")
        if len(sk_parts) != 2:
            raise SystemExit(
                "Invalid secret key passed, expected 2 bs58 values separated by commas"
            )
        try:
            for part in sk_parts:
                if len(b58decode(part)) > 32:
                    raise ValueError
        except ValueError:
            raise SystemExit("Failed to decode secret key. Expecting bs58 encoded values.")
        # Saving a non-bootstrap key would brick attest/verify; reject
        # here while the config is still writable.
        if not any((n.sk0, n.sk1) == (sk_parts[0], sk_parts[1]) for n in nodes):
            raise SystemExit("secret key is not one of the bootstrap identities")
        config.secret_key = (sk_parts[0], sk_parts[1])

    config.save(data_dir / "client-config.json")
    print("Client configuration updated.")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="protocol-tpu-client", description="EigenTrust client wallet")
    parser.add_argument("--data-dir", default=str(DEFAULT_DATA_DIR))
    sub = parser.add_subparsers(dest="mode", required=True)
    sub.add_parser("show")
    sub.add_parser("compile-contracts")
    sub.add_parser("deploy-contracts")
    sub.add_parser("attest")
    sub.add_parser("verify")
    update = sub.add_parser("update")
    update.add_argument("field", nargs="?")
    update.add_argument("value", nargs="?")
    args = parser.parse_args(argv)

    data_dir = Path(args.data_dir)
    config, nodes = load_context(
        data_dir, require_identity=args.mode in ("attest", "verify")
    )

    if args.mode == "show":
        cmd_show(config, nodes)
    elif args.mode == "attest":
        cmd_attest(config, nodes)
    elif args.mode == "verify":
        cmd_verify(config, nodes)
    elif args.mode == "compile-contracts":
        cmd_compile_contracts(config, nodes)
    elif args.mode == "deploy-contracts":
        cmd_deploy_contracts(config, nodes, data_dir)
    elif args.mode == "update":
        cmd_update(config, nodes, args.field, args.value, data_dir)


if __name__ == "__main__":
    main(sys.argv[1:])

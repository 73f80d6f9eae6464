"""Client wallet: build/sign/submit attestations, fetch and verify proofs.

The port of ``protocol_tpu/client``, over this package's node, EVM and
verifier; the client runs on the host.

A rebuild of the upstream ``client`` crate (client/src): a CLI with
show / compile-contracts / deploy-contracts / attest / update / verify
subcommands and an EigenTrustClient that signs the configured score
vector and submits it to the AttestationStation.
"""

from .client import ClientConfig, EigenTrustClient  # noqa: F401

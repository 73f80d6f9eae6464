"""The port's PLONK epoch prover on the committed deployment artifacts:
a prover built from ``data/srs-15.bin`` for the default 5-member
statement (k = 14) verifies the reference's committed epoch proof
``data/et_proof.json`` and rejects its tampered copies, and the EVM
verifier it generates for that proof's quotient-chunk count is the
committed ``data/et_verifier.bin`` byte for byte.  The k = 14 prove,
byte-identical to the reference's, and ``generate_verifier_artifact``
(a sample prove, then codegen) are in the slow tier."""

import pathlib

import pytest

from protocol_tpu_torch.crypto import field
from protocol_tpu_torch.zk.proof import PlonkEpochProver, ProofRaw

P = field.MODULUS
DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
SRS = str(DATA / "srs-15.bin")


@pytest.fixture(scope="module")
def prover(tmp_path_factory):
    """Cold keygen on a fresh key cache."""
    return PlonkEpochProver(srs_path=SRS, cache_dir=str(tmp_path_factory.mktemp("keys")))


@pytest.fixture(scope="module")
def committed():
    return ProofRaw.from_json((DATA / "et_proof.json").read_text()).to_proof()


def test_committed_proof_verifies(prover, committed):
    assert prover.vk.k == 14
    assert len(committed.pub_ins) == 5 and sum(committed.pub_ins) % P == 5 * 1000
    assert prover.verify(committed.pub_ins, committed.proof)


def test_committed_proof_tamper_rejected(prover, committed):
    bad_ins = [(committed.pub_ins[0] + 1) % P] + committed.pub_ins[1:]
    assert not prover.verify(bad_ins, committed.proof)
    flipped = bytearray(committed.proof)
    flipped[7] ^= 1
    assert not prover.verify(committed.pub_ins, bytes(flipped))
    assert not prover.verify(committed.pub_ins, committed.proof[:-32])


@pytest.mark.slow
def test_default_epoch_proof_equal_to_the_reference(prover, tmp_path):
    """The reference node's default 5-member epoch on the committed SRS,
    proved by both packages at the same seed (k = 14)."""
    from protocol_tpu.node.epoch import Epoch as RefEpoch
    from protocol_tpu.node.manager import Manager as RefManager
    from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
    from protocol_tpu.zk.proof import PlonkEpochProver as RefPlonkEpochProver
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig

    theirs = RefPlonkEpochProver(srs_path=SRS, cache_dir=str(tmp_path / "ref"))
    assert theirs.vk.digest == prover.vk.digest
    ref = RefManager(RefManagerConfig(srs_path=SRS), prover=theirs)
    ref.generate_initial_attestations()
    ref.calculate_proofs(RefEpoch(2))
    m = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", srs_path=SRS),
                prover=prover)
    m.generate_initial_attestations()
    m.calculate_proofs(Epoch(2))
    ours, want = m.get_proof(Epoch(2)), ref.get_proof(RefEpoch(2))
    assert (ours.pub_ins, ours.proof) == (list(want.pub_ins), want.proof)
    assert theirs.verify(ours.pub_ins, ours.proof)


def test_generated_verifier_is_the_committed_artifact(prover, committed):
    """Bytes equal: the runtime ``generate_evm_verifier`` emits for the
    port's k = 14 key at the committed proof's quotient-chunk count, with
    its ``n_t`` and calldata length, against ``data/et_verifier.bin``."""
    from protocol_tpu_torch.zk.evm_verifier import (
        GeneratedVerifier,
        generate_evm_verifier,
        infer_n_t,
    )

    blob = (DATA / "et_verifier.bin").read_bytes()
    gen = generate_evm_verifier(prover.vk, infer_n_t(prover.vk, committed.proof), 5)
    assert gen.runtime == GeneratedVerifier.from_bytes(blob).runtime
    assert gen.to_bytes() == blob


@pytest.mark.slow
def test_verifier_artifact_is_the_committed_one(prover):
    """``generate_verifier_artifact()``: one sample prove of the keygen's
    dummy statement, then codegen; the artifact is the committed one and
    the sample proof verifies on the port's EVM."""
    from protocol_tpu_torch.zk.evm_verifier import evm_verify

    gen, pub, sample = prover.generate_verifier_artifact()
    assert gen.to_bytes() == (DATA / "et_verifier.bin").read_bytes()
    assert prover.verify(pub, sample)
    assert evm_verify(gen, pub, sample)[0]

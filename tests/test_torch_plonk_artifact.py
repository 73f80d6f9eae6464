"""The port's PLONK epoch prover on the committed deployment artifacts:
a prover built from ``data/srs-15.bin`` for the default 5-member
statement (k = 14) verifies the reference's committed epoch proof
``data/et_proof.json`` and rejects its tampered copies.  The k = 14
prove, byte-identical to the reference's, is in the slow tier."""

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

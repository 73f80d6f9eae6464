"""A default-configuration node of the port (``prover="plonk"``,
``check_circuit=True``) beside the reference package's, on the same
2-peer group and the committed ``data/srs-15.bin``: the port's node
converges its open graph on ``cuda-windowed`` (``device="cpu"``), checks
the epoch statement and proves it, and its proof is byte-identical to
the reference node's; each package verifies the other's proof, and a
checkpoint either package saves with its PLONK proof recovers in the
other, where the proof verifies; both nodes aggregate the proof to the
same accumulator; the EVM verifier artifact each package generates for
the statement is the same bytecode, and the port's sample proof verifies
on the port's EVM; ``zk_backend="graft"`` proves on the node's device."""

import pathlib

import pytest

from protocol_tpu.node import checkpoint as ref_ckpt
from protocol_tpu.node import wal as ref_wal
from protocol_tpu.node.epoch import Epoch as RefEpoch
from protocol_tpu.node.manager import Manager as RefManager
from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
from protocol_tpu.prover.jobs import prover_for as ref_prover_for
from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu_torch.crypto import field
from protocol_tpu_torch.node import checkpoint, wal
from protocol_tpu_torch.node.bootstrap import FIXED_SET
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.obs import TRACER
from protocol_tpu_torch.prover.jobs import prover_for
from protocol_tpu_torch.zk import plonk
from protocol_tpu_torch.zk.proof import PlonkEpochProver, PoseidonCommitmentProver, ProofRaw

P = field.MODULUS
SRS = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "srs-15.bin")
#: The smallest epoch statement: 2 peers, 1 iteration (k = 13).
PARAMS = (2, 1, 1000, 1000)


def group() -> dict:
    return dict(num_neighbours=2, num_iter=1, fixed_set=list(FIXED_SET[:2]))


@pytest.fixture(scope="module")
def provers():
    """Each package's PLONK prover for the 2-peer statement on the
    committed SRS, through its per-process prover cache."""
    ours = prover_for(PARAMS, "plonk", SRS)
    theirs = ref_prover_for(PARAMS, "plonk", SRS)
    assert isinstance(ours, PlonkEpochProver) and ours.vk.k == 13
    return ours, theirs


@pytest.fixture(scope="module")
def epoch_proofs(provers):
    """One proved epoch in each package's node: (port manager, its
    proof, reference manager, its proof)."""
    ours, theirs = provers
    m = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", srs_path=SRS, **group()),
                prover=ours)
    assert (m.config.prover, m.config.check_circuit) == ("plonk", True)
    m.generate_initial_attestations()
    m.converge_epoch(Epoch(1), alpha=0.1)
    m.calculate_proofs(Epoch(1))
    ref = RefManager(RefManagerConfig(srs_path=SRS, **group()), prover=theirs)
    ref.generate_initial_attestations()
    ref.calculate_proofs(RefEpoch(1))
    return m, m.get_proof(Epoch(1)), ref, ref.get_proof(RefEpoch(1))


def test_verifying_keys_equal(provers):
    ours, theirs = provers
    vk, ref_vk = ours.vk, theirs.vk
    assert vk.digest == ref_vk.digest == vk.compute_digest()
    assert [tuple(c) for c in vk.fixed_commits] == [tuple(c) for c in ref_vk.fixed_commits]
    assert [tuple(c) for c in vk.sigma_commits] == [tuple(c) for c in ref_vk.sigma_commits]
    assert (vk.advice_names, vk.fixed_names, vk.chunks) == (
        ref_vk.advice_names, ref_vk.fixed_names, ref_vk.chunks)


def test_prover_cache_keeps_one_prover(provers):
    assert prover_for(PARAMS, "plonk", SRS) is provers[0]
    commitment = prover_for(PARAMS, "commitment")
    assert isinstance(commitment, PoseidonCommitmentProver)
    assert prover_for(PARAMS, "commitment") is commitment


def test_epoch_proof_byte_identical(epoch_proofs):
    m, proof, ref, ref_proof = epoch_proofs
    assert proof.pub_ins == ref_proof.pub_ins
    assert sum(proof.pub_ins) % P == 2 * 1000
    assert proof.proof == ref_proof.proof
    assert m.prover.name == "plonk-kzg" and m.prover.wire_tag == "plonk"
    assert proof.to_raw("plonk").to_json() == ref_proof.to_raw("plonk").to_json()


def test_each_package_verifies_the_others_proof(epoch_proofs, provers):
    _, proof, _, ref_proof = epoch_proofs
    ours, theirs = provers
    assert ours.verify(ref_proof.pub_ins, ref_proof.proof)
    assert theirs.verify(proof.pub_ins, proof.proof)
    assert plonk.verify(ours.vk, ref_proof.pub_ins, ref_proof.proof, transcript="keccak")
    assert ref_plonk.verify(theirs.vk, proof.pub_ins, proof.proof, transcript="keccak")
    bad = [(proof.pub_ins[0] + 1) % P] + proof.pub_ins[1:]
    assert not ours.verify(bad, proof.proof) and not theirs.verify(bad, proof.proof)
    flipped = bytearray(proof.proof)
    flipped[7] ^= 1
    assert not ours.verify(proof.pub_ins, bytes(flipped))
    assert not theirs.verify(proof.pub_ins, bytes(flipped))


def test_epoch_trace_holds_the_circuit_check_and_the_prove_attribution(provers):
    m = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", **group()),
                prover=provers[0])
    m.generate_initial_attestations()
    with TRACER.epoch(905) as root:
        m.calculate_proofs(Epoch(905))
    assert {"power_iterate", "circuit_check", "snark"} <= set(root.child_names())
    snark = root.find("snark").child_names()
    assert {"msm", "ntt", "gate_eval", "commit", "quotient", "open"} <= set(snark)
    proof = m.get_proof(Epoch(905))
    assert m.prover.verify(proof.pub_ins, proof.proof)


class TestCheckpointCrossLoad:
    def test_port_checkpoint_recovers_in_the_reference(self, epoch_proofs, provers, tmp_path):
        m, proof, _, _ = epoch_proofs
        checkpoint.CheckpointStore(tmp_path).save(
            Epoch(1), m.last_graph, m.last_scores, proof.to_raw("plonk").to_json(),
            peer_hashes=m.last_peer_hashes, attestations=m.snapshot_attestations(),
        )
        snap = ref_ckpt.CheckpointStore(tmp_path).load_latest()
        raw = ProofRaw.from_json(snap.proof_json)
        assert raw.backend == "plonk" and raw.proof == proof.proof
        ref = RefManager(RefManagerConfig(**group()), prover=provers[1])
        ref_wal.recover(ref, ref_ckpt.CheckpointStore(tmp_path), None)
        got = ref.get_proof(RefEpoch(1))
        assert (list(got.pub_ins), got.proof) == (proof.pub_ins, proof.proof)
        assert provers[1].verify(list(got.pub_ins), got.proof)

    def test_reference_checkpoint_recovers_in_the_port(self, epoch_proofs, provers, tmp_path):
        _, _, ref, ref_proof = epoch_proofs
        ref.converge_epoch(RefEpoch(1), alpha=0.1)
        ref_ckpt.CheckpointStore(tmp_path).save(
            RefEpoch(1), ref.last_graph, ref.last_scores, ref_proof.to_raw("plonk").to_json(),
            peer_hashes=ref.last_peer_hashes, attestations=ref.snapshot_attestations(),
        )
        port = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", **group()),
                       prover=provers[0])
        wal.recover(port, checkpoint.CheckpointStore(tmp_path), None)
        got = port.get_proof(Epoch(1))
        assert (got.pub_ins, got.proof) == (list(ref_proof.pub_ins), ref_proof.proof)
        assert provers[0].verify(got.pub_ins, got.proof)


class TestNotPorted:
    def test_aggregation_raises_naming_its_item(self, epoch_proofs):
        """Aggregation is ported (ROADMAP A5c (i-b)): the node folds its
        cached proof into the reference node's accumulator, byte for
        byte, and the accumulator passes its pairing check."""
        m, _, ref, _ = epoch_proofs
        ok, acc = m.aggregate_proofs([Epoch(1)])
        ref_ok, ref_acc = ref.aggregate_proofs([RefEpoch(1)])
        assert ok and ref_ok
        assert acc.to_bytes() == ref_acc.to_bytes()

    def test_verifier_artifact_raises_naming_a12(self, provers):
        """The EVM verifier is ported (ROADMAP A12): the port's artifact
        for the 2-peer statement is the bytecode the reference's
        ``generate_evm_verifier`` emits for the same key at the same
        quotient-chunk count, byte for byte, and the sample proof the
        port's generator proved verifies on the port's EVM."""
        from protocol_tpu.zk import evm_verifier as ref_ev
        from protocol_tpu_torch.zk.evm_verifier import evm_verify

        gen, pub, sample = provers[0].generate_verifier_artifact()
        assert provers[1].vk.digest == provers[0].vk.digest
        want = ref_ev.generate_evm_verifier(provers[1].vk, ref_ev.infer_n_t(provers[1].vk, sample),
                                            PARAMS[0])
        assert gen.to_bytes() == want.to_bytes()
        assert provers[0].verify(pub, sample)
        assert evm_verify(gen, pub, sample)[0]

    def test_graft_backend_raises_naming_a8_and_caches_no_proof(self, provers):
        """The graft kernels are ported (ROADMAP A8): the node proves under
        ``zk_backend="graft"`` on its own device, here the CPU its converge
        runs on.  A recording stub stands in for the PLONK prover so the
        case stays fast; ``tests/test_torch_zk_graft.py`` proves under graft."""
        import torch

        from protocol_tpu_torch.zk import graft

        seen = []

        class Recording:
            def prove(self, pub_ins, witness, *, seed=None):
                seen.append((graft.zk_backend(), graft.zk_device()))
                return b"recorded"

            def verify(self, pub_ins, proof):
                return proof == b"recorded"

        m = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", zk_backend="graft",
                                  check_circuit=False, **group()), prover=Recording())
        m.generate_initial_attestations()
        m.calculate_proofs(Epoch(2))
        assert seen == [("graft", torch.device("cpu"))]
        assert graft.zk_backend() == "native"
        assert m.get_proof(Epoch(2)).proof == b"recorded"

"""The port's checkpoints and write-ahead log against the reference
package's: a snapshot either package saves loads in the other with the
same columns and digests, a log either package writes replays in the
other to the same attestation cache, and a node killed at the
``epoch.post_converge`` fault point recovers from its disk to the fixed
point an uncrashed node reaches — in either package."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from protocol_tpu import chaos as ref_chaos
from protocol_tpu.node import checkpoint as ref_ckpt
from protocol_tpu.node import wal as ref_wal
from protocol_tpu.node.attestation import AttestationData as RefAttestationData
from protocol_tpu.node.epoch import Epoch as RefEpoch
from protocol_tpu.node.manager import Manager as RefManager
from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
from protocol_tpu.ops.gather_window import WindowPlan as RefWindowPlan
from protocol_tpu.trust.graph import TrustGraph as RefTrustGraph
from protocol_tpu_torch import chaos
from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.node import checkpoint, wal
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.ops.gather_window import WindowPlan, build_window_plan
from protocol_tpu_torch.trust.graph import TrustGraph
from protocol_tpu_torch.zk.proof import ProofRaw

REPO = pathlib.Path(__file__).resolve().parent.parent
SKS, PKS = keyset_from_raw(FIXED_SET)


@pytest.fixture(autouse=True)
def _reset_chaos():
    yield
    chaos.reset()
    ref_chaos.reset()


def make_att(i: int, sender: int = 0) -> Attestation:
    """Unique validly-signed attestation #i (scores sum to SCALE), the
    port's counterpart of ``tests/test_durability.py::make_att``."""
    d = i % 190
    scores = [200 + d, 200 - d, 200, 200, 200]
    _, msgs = calculate_message_hash(PKS, [scores])
    sig = sign(SKS[sender], PKS[sender], msgs[0])
    return Attestation(sig=sig, pk=PKS[sender], neighbours=list(PKS), scores=scores)


def wire(att: Attestation) -> bytes:
    return AttestationData.from_attestation(att).to_bytes()


def cache(manager) -> dict[int, tuple[int, ...]]:
    """Comparable view of an attestation cache: sender hash -> scores."""
    return {h: tuple(a.scores) for h, a in manager.attestations.items()}


def config(**kw) -> dict:
    return dict(prover="commitment", check_circuit=False, **kw)


def snapshot_inputs():
    """One epoch's state: a graph, float64 scores, peer hashes, a plan,
    the attestation rows and a commitment proof."""
    rng = np.random.default_rng(5)
    n, e = 40, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    pre = np.zeros(n, bool)
    pre[:3] = True
    scores = rng.random(n)
    hashes = [int(h) for h in rng.integers(1, 2**62, n)]
    # Field-sized hashes, two of them with zero low bytes.
    hashes[:3] = [2**253 + 17, (2**244 + 3) << 8, 0x5A << 240]
    plan = build_window_plan(src, dst, w, n=n)
    atts = [(5, wire(make_att(i, i % 5))) for i in range(3)]
    proof = ProofRaw(pub_ins=[b"\x01" * 32, b"\x02" * 32], proof=b"commit", backend="commitment")
    return dict(n=n, src=src, dst=dst, w=w, pre=pre, scores=scores, hashes=hashes,
                plan=plan, atts=atts, proof_json=proof.to_json())


def reference_reading(h: int) -> int:
    """What the reference's loader returns for peer hash ``h`` (ROADMAP
    §C R6): numpy hands the S32 row back without its trailing NUL bytes,
    which are the hash's low bytes, and the loader does not pad them."""
    return int.from_bytes(h.to_bytes(32, "big").rstrip(b"\0"), "big")


def save(store_mod, graph_cls, directory, inp, epoch_cls, plan=None):
    store = store_mod.CheckpointStore(directory)
    graph = graph_cls(inp["n"], inp["src"], inp["dst"], inp["w"], inp["pre"])
    store.save(epoch_cls(4), graph, inp["scores"], inp["proof_json"], plan=plan,
               peer_hashes=inp["hashes"], wal_seq=12, attestations=inp["atts"])
    return store


class TestCheckpointCrossLoad:
    @pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
    def test_snapshot_loads_in_the_other_package(self, tmp_path, direction):
        inp = snapshot_inputs()
        if direction == "port_to_reference":
            save(checkpoint, TrustGraph, tmp_path, inp, Epoch, inp["plan"])
            snap = ref_ckpt.CheckpointStore(tmp_path).load_latest()
            plan_cls = RefWindowPlan
        else:
            ref_plan = RefWindowPlan.from_arrays(inp["plan"].to_arrays(core_only=True))
            save(ref_ckpt, RefTrustGraph, tmp_path, inp, RefEpoch, ref_plan)
            snap = checkpoint.CheckpointStore(tmp_path).load_latest()
            plan_cls = WindowPlan
        assert snap is not None and snap.epoch.number == 4 and snap.wal_seq == 12
        assert snap.graph.n == inp["n"]
        for got, want in ((snap.graph.src, inp["src"]), (snap.graph.dst, inp["dst"]),
                          (snap.graph.weight, inp["w"]), (snap.graph.pre_trusted, inp["pre"])):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        assert snap.scores.dtype == np.float64
        np.testing.assert_array_equal(snap.scores, inp["scores"])
        if direction == "port_to_reference":
            assert snap.peer_hashes == [reference_reading(h) for h in inp["hashes"]]
            assert snap.peer_hashes[1:3] != inp["hashes"][1:3]
        else:
            assert snap.peer_hashes == inp["hashes"]
        assert snap.attestations == inp["atts"]
        assert snap.proof_json == inp["proof_json"]
        assert isinstance(snap.plan, plan_cls)
        assert snap.plan.fingerprint == inp["plan"].fingerprint
        for k in WindowPlan._CORE:
            np.testing.assert_array_equal(getattr(snap.plan, k), getattr(inp["plan"], k))

    def test_port_round_trips_hashes_with_zero_low_bytes(self, tmp_path):
        inp = snapshot_inputs()
        save(checkpoint, TrustGraph, tmp_path, inp, Epoch)
        assert checkpoint.CheckpointStore(tmp_path).load_latest().peer_hashes == inp["hashes"]

    def test_manifests_carry_the_same_digests(self, tmp_path):
        inp = snapshot_inputs()
        ref_plan = RefWindowPlan.from_arrays(inp["plan"].to_arrays(core_only=True))
        save(checkpoint, TrustGraph, tmp_path / "port", inp, Epoch, inp["plan"])
        save(ref_ckpt, RefTrustGraph, tmp_path / "ref", inp, RefEpoch, ref_plan)
        ours = json.loads((tmp_path / "port" / "manifest.json").read_text())
        theirs = json.loads((tmp_path / "ref" / "manifest.json").read_text())
        assert ours == theirs
        assert set(ours["epochs"]["4"]["columns"]) >= {"scores", "peer_hashes", "att_wire"}

    def test_corrupt_port_snapshot_falls_back_in_the_reference(self, tmp_path):
        inp = snapshot_inputs()
        store = checkpoint.CheckpointStore(tmp_path)
        graph = TrustGraph(inp["n"], inp["src"], inp["dst"], inp["w"], inp["pre"])
        for k in (1, 2):
            store.save(Epoch(k), graph, inp["scores"] * k, peer_hashes=inp["hashes"])
        path = tmp_path / "epoch_2.npz"
        path.write_bytes(path.read_bytes()[:40])
        for mod in (ref_ckpt, checkpoint):
            snap = mod.CheckpointStore(tmp_path).load_latest()
            assert snap.epoch.number == 1
            np.testing.assert_array_equal(snap.scores, inp["scores"])


class TestWALCrossReplay:
    def test_segments_are_byte_identical(self, tmp_path):
        payloads = [wal.encode_payload(5, wire(make_att(i, i % 5))) for i in range(4)]
        for mod, d in ((wal, tmp_path / "port"), (ref_wal, tmp_path / "ref")):
            log = mod.AttestationWAL(d, fsync=False)
            for p in payloads:
                log.append(p, flush=False)
            log.close()
        ours = sorted((tmp_path / "port").glob("wal_*.seg"))
        theirs = sorted((tmp_path / "ref").glob("wal_*.seg"))
        assert [p.name for p in ours] == [p.name for p in theirs]
        assert [p.read_bytes() for p in ours] == [p.read_bytes() for p in theirs]
        assert ours[0].read_bytes().startswith(b"ETWAL001")

    @pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
    def test_log_replays_to_the_same_cache(self, tmp_path, direction):
        atts = [make_att(i, i % 5) for i in range(6)] + [make_att(50, 0)]
        writer = Manager(ManagerConfig(**config()))
        if direction == "port_to_reference":
            writer.wal = wal.AttestationWAL(tmp_path / "wal")
            for att in atts:
                assert writer.apply_verified(att).accepted
            writer.wal.close()
            reader = RefManager(RefManagerConfig(**config()))
            report = ref_wal.recover(reader, None, ref_wal.AttestationWAL(tmp_path / "wal"))
        else:
            ref_writer = RefManager(RefManagerConfig(**config()))
            ref_writer.wal = ref_wal.AttestationWAL(tmp_path / "wal")
            for att in atts:
                raw = wire(att)
                ref_att = RefAttestationData.from_bytes(raw, 5).to_attestation(5)
                assert ref_writer.apply_verified(ref_att, raw=raw).accepted
                assert writer.apply_verified(att).accepted
            ref_writer.wal.close()
            reader = Manager(ManagerConfig(**config()))
            report = wal.recover(reader, None, wal.AttestationWAL(tmp_path / "wal"))
        assert report["wal_replayed"] == len(atts)
        assert cache(reader) == cache(writer)

    def test_torn_tail_drops_only_the_tail_in_both(self, tmp_path):
        log = wal.AttestationWAL(tmp_path)
        for i in range(3):
            log.append(wal.encode_payload(5, wire(make_att(i))))
        log.close()
        seg = sorted(tmp_path.glob("wal_*.seg"))[-1]
        seg.write_bytes(seg.read_bytes()[:-7])
        for mod in (wal, ref_wal):
            seqs = [seq for seq, _ in mod.AttestationWAL(tmp_path).replay()]
            assert seqs == [1, 2]


CRASH_SCRIPT = r"""
import pathlib, sys
sys.path.insert(0, sys.argv[2])
from tests.test_torch_durability import run_until_epoch_one
run_until_epoch_one(pathlib.Path(sys.argv[1]), crash=True)
"""


def run_until_epoch_one(directory: pathlib.Path, *, crash: bool):
    """A node on ``cuda-csr`` (on the CPU) with a WAL and checkpoints:
    three attestations, epoch 0 converged and checkpointed, one more
    attestation, then epoch 1 — killed at ``epoch.post_converge`` when
    ``crash`` (the process exits there), else returned."""
    m = Manager(ManagerConfig(**config(backend="cuda-csr", device="cpu")))
    store = checkpoint.CheckpointStore(directory / "ckpt")
    m.wal = wal.AttestationWAL(directory / "ckpt" / "wal")
    for i in range(3):
        assert m.apply_verified(make_att(i, i)).accepted
    result = m.converge_epoch(Epoch(0), alpha=0.1)
    store.save(Epoch(0), m.last_graph, result.scores, None, peer_hashes=m.last_peer_hashes,
               wal_seq=m.checkpoint_watermark(), attestations=m.snapshot_attestations())
    floor = store.retained_wal_floor()
    if floor is not None:
        m.wal.truncate_through(floor)
    assert m.apply_verified(make_att(123, 4)).accepted
    if crash:
        chaos.configure({"seed": 0, "faults": [{"point": "epoch.post_converge", "kind": "crash"}]})
    return m, m.converge_epoch(Epoch(1), alpha=0.1)


class TestCrashRecovery:
    def test_crash_at_post_converge_recovers_the_same_fixed_point(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-c", CRASH_SCRIPT, str(tmp_path / "crashed"), str(REPO)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == chaos.CRASH_EXIT_CODE, proc.stderr[-2000:]
        control_manager, control = run_until_epoch_one(tmp_path / "control", crash=False)

        recovered = Manager(ManagerConfig(**config(backend="cuda-csr", device="cpu")))
        store = checkpoint.CheckpointStore(tmp_path / "crashed" / "ckpt")
        report = wal.recover(recovered, store, wal.AttestationWAL(tmp_path / "crashed" / "ckpt" / "wal"))
        assert report["checkpoint_epoch"] == 0 and report["wal_replayed"] >= 1
        assert cache(recovered) == cache(control_manager)
        again = recovered.converge_epoch(Epoch(1), alpha=0.1)
        assert again.iterations == control.iterations
        assert float(np.abs(again.scores - control.scores).sum()) <= 1e-6

        # The reference recovers the port's crashed disk to the same point.
        ref = RefManager(RefManagerConfig(**config(backend="tpu-csr")))
        ref_report = ref_wal.recover(
            ref, ref_ckpt.CheckpointStore(tmp_path / "crashed" / "ckpt"),
            ref_wal.AttestationWAL(tmp_path / "crashed" / "ckpt" / "wal"),
        )
        assert ref_report["wal_replayed"] == report["wal_replayed"]
        assert cache(ref) == cache(recovered)
        ref_again = ref.converge_epoch(RefEpoch(1), alpha=0.1)
        assert ref_again.iterations == again.iterations
        assert float(np.abs(ref_again.scores - again.scores).sum()) <= 1e-6

    def test_checkpointed_proof_and_cache_recover_in_both(self, tmp_path):
        m = Manager(ManagerConfig(**config()))
        m.generate_initial_attestations()
        m.calculate_proofs(Epoch(2))
        proof = m.get_proof(Epoch(2))
        m.converge_epoch(Epoch(2), alpha=0.1)
        checkpoint.CheckpointStore(tmp_path).save(
            Epoch(2), m.last_graph, m.last_scores, proof.to_raw("commitment").to_json(),
            peer_hashes=m.last_peer_hashes, attestations=m.snapshot_attestations(),
        )
        port = Manager(ManagerConfig(**config()))
        wal.recover(port, checkpoint.CheckpointStore(tmp_path), None)
        ref = RefManager(RefManagerConfig(**config()))
        ref_wal.recover(ref, ref_ckpt.CheckpointStore(tmp_path), None)
        for got in (port.get_proof(Epoch(2)), ref.get_proof(RefEpoch(2))):
            assert (list(got.pub_ins), got.proof) == (proof.pub_ins, proof.proof)
        assert cache(port) == cache(ref) == cache(m)
        assert port.last_peer_hashes == ref.last_peer_hashes == m.last_peer_hashes

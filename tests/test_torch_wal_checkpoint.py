"""The port's write-ahead log and checkpoint store held to the
reference's suites (``tests/test_durability.py::TestWALSemantics`` and
``::TestCheckpointIntegrity``), case for case, and to the reference
package on the same bytes: the port writes the reference's WAL segments
byte for byte, and on every torn, flipped or truncated file the
reference's loader, reading what the port wrote, reaches the port's
outcome.

Covers exactly-once replay, the torn tail, a mid-log bit flip, segment
rotation and truncation, the applied watermark, a WAL error turned into
a rejection; the manifest's digests and WAL seq, fallback past a flipped
or truncated snapshot (at every region of the file), a corrupt manifest,
proof or plan sidecar, the legacy manifest, the block cursor, the
retained WAL floor and pruning.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from protocol_tpu import chaos as ref_chaos
from protocol_tpu.node import checkpoint as ref_ckpt
from protocol_tpu.node import wal as ref_wal
from protocol_tpu.node.epoch import Epoch as RefEpoch
from protocol_tpu_torch import chaos
from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.checkpoint import CheckpointStore, SnapshotCorrupt
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node import wal as port_wal
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.node.wal import AttestationWAL, decode_payload, encode_payload, recover
from protocol_tpu_torch.obs import metrics as obs_metrics
from protocol_tpu_torch.trust.graph import TrustGraph

SKS, PKS = keyset_from_raw(FIXED_SET)


@pytest.fixture(autouse=True)
def _reset_chaos():
    yield
    chaos.reset()
    ref_chaos.reset()


def make_att(i: int, sender: int = 0) -> Attestation:
    """Unique validly-signed attestation #i (scores sum to SCALE)."""
    d = i % 190
    scores = [200 + d, 200 - d, 200, 200, 200]
    _, msgs = calculate_message_hash(PKS, [scores])
    sig = sign(SKS[sender], PKS[sender], msgs[0])
    return Attestation(sig=sig, pk=PKS[sender], neighbours=list(PKS), scores=scores)


def wire(att: Attestation) -> bytes:
    return AttestationData.from_attestation(att).to_bytes()


def make_manager() -> Manager:
    return Manager(ManagerConfig(prover="commitment", check_circuit=False))


def small_graph(n: int = 4, seed: int = 3) -> TrustGraph:
    rng = np.random.default_rng(seed)
    e = 3 * n
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (src + 1 + rng.integers(0, n - 1, e).astype(np.int32)) % n
    pre = np.zeros(n, bool)
    pre[0] = True
    return TrustGraph(n, src, dst.astype(np.int32), rng.random(e).astype(np.float32), pre)


def cache_digests(manager: Manager) -> dict[int, tuple[int, ...]]:
    """Comparable view of the attestation cache: sender hash -> scores."""
    return {h: tuple(a.scores) for h, a in manager.attestations.items()}


def segments(directory) -> list[tuple[str, bytes]]:
    return [(p.name, p.read_bytes()) for p in sorted(directory.glob("wal_*.seg"))]


def seqs(mod, directory, **kw) -> list[int]:
    return [s for s, _ in mod.AttestationWAL(directory).replay(**kw)]


class TestWALSemantics:
    def test_append_replay_roundtrip(self, tmp_path):
        payloads = [encode_payload(5, wire(make_att(i, i))) for i in range(3)]
        wal = AttestationWAL(tmp_path / "port")
        assert [wal.append(p) for p in payloads] == [1, 2, 3]
        replayed = list(wal.replay())
        assert [s for s, _ in replayed] == [1, 2, 3]
        assert [p for _, p in replayed] == payloads
        n, wire_bytes = decode_payload(replayed[0][1])
        assert n == 5
        att = AttestationData.from_bytes(wire_bytes, n).to_attestation(n)
        assert att.scores == make_att(0, 0).scores
        ref = ref_wal.AttestationWAL(tmp_path / "ref")
        for p in payloads:
            ref.append(p)
        wal.close()
        ref.close()
        assert segments(tmp_path / "port") == segments(tmp_path / "ref")

    def test_replay_after_seq_skips_prefix(self, tmp_path):
        wal = AttestationWAL(tmp_path)
        for i in range(4):
            wal.append(encode_payload(5, wire(make_att(i, i % 5))))
        wal.close()
        assert seqs(port_wal, tmp_path, after_seq=2) == seqs(ref_wal, tmp_path, after_seq=2) == [3, 4]

    def test_crash_after_append_before_checkpoint_replays_exactly_once(self, tmp_path):
        m1 = make_manager()
        m1.wal = AttestationWAL(tmp_path / "wal")
        att = make_att(7, 2)
        assert m1.apply_verified(att).accepted
        # "Crash": abandon the process state; a fresh manager recovers
        # from disk alone.
        replayed0 = obs_metrics.WAL_REPLAYED.value()
        m2 = make_manager()
        report = recover(m2, None, AttestationWAL(tmp_path / "wal"))
        assert report["wal_replayed"] == 1
        assert obs_metrics.WAL_REPLAYED.value() - replayed0 == 1
        assert cache_digests(m2)[att.pk.hash()] == tuple(att.scores)

    def test_torn_tail_drops_only_the_tail_record(self, tmp_path):
        wal = AttestationWAL(tmp_path)
        for i in range(3):
            wal.append(encode_payload(5, wire(make_att(i, i))))
        wal.close()
        seg = sorted(tmp_path.glob("wal_*.seg"))[0]
        seg.write_bytes(seg.read_bytes()[:-7])  # crash mid-write of record 3
        assert seqs(port_wal, tmp_path) == seqs(ref_wal, tmp_path) == [1, 2]
        wal2 = AttestationWAL(tmp_path)
        assert [s for s, _ in wal2.replay()] == [1, 2]
        assert wal2.dropped_tail == 1
        # New appends continue past the highest VALID seq.
        assert wal2.append(encode_payload(5, wire(make_att(9, 4)))) == 3

    def test_mid_log_bitflip_stops_that_segment_conservatively(self, tmp_path):
        wal = AttestationWAL(tmp_path)
        for i in range(3):
            wal.append(encode_payload(5, wire(make_att(i, i))))
        wal.close()
        seg = sorted(tmp_path.glob("wal_*.seg"))[0]
        data = bytearray(seg.read_bytes())
        data[len(data) // 2] ^= 0xFF  # inside record 2's payload
        seg.write_bytes(bytes(data))
        replayed = seqs(port_wal, tmp_path)
        assert replayed in ([1], [1, 2]), replayed  # never a corrupt record
        assert replayed == seqs(ref_wal, tmp_path)

    def test_segment_rotation_and_truncation_bound_disk(self, tmp_path):
        payloads = [encode_payload(5, wire(make_att(i, i % 5))) for i in range(10)]
        wal = AttestationWAL(tmp_path / "port", segment_max_bytes=256)
        ref = ref_wal.AttestationWAL(tmp_path / "ref", segment_max_bytes=256)
        for p in payloads:
            wal.append(p)
            ref.append(p)
        assert wal.segment_count() > 2, "tiny segments must rotate"
        assert segments(tmp_path / "port") == segments(tmp_path / "ref")
        removed = wal.truncate_through(8)
        assert removed >= 1
        assert removed == ref.truncate_through(8)
        survivors = [s for s, _ in wal.replay(after_seq=8)]
        assert survivors == [9, 10], "records past the floor must survive"
        # Only whole segments at or below the floor were dropped.
        assert all(s <= 8 or s in (9, 10) for s, _ in wal.replay())
        wal.close()
        ref.close()
        assert segments(tmp_path / "port") == segments(tmp_path / "ref")

    def test_watermark_excludes_unapplied_records(self, tmp_path):
        marks = []
        for mod, d in ((port_wal, tmp_path / "port"), (ref_wal, tmp_path / "ref")):
            wal = mod.AttestationWAL(d)
            s1 = wal.append(b"a", flush=False)
            s2 = wal.append(b"b", flush=False)
            assert wal.applied_watermark() == s1 - 1, "both still pending"
            wal.mark_applied(s1)
            assert wal.applied_watermark() == s2 - 1, "s2 still pending"
            wal.mark_applied(s2)
            assert wal.applied_watermark() == s2
            marks.append((s1, s2))
        assert marks[0] == marks[1]

    def test_applied_watermark_tracks_pending(self, tmp_path):
        wal = AttestationWAL(tmp_path)
        s1 = wal.append(b"a")
        assert wal.applied_watermark() == s1 - 1
        wal.mark_applied(s1)
        assert wal.applied_watermark() == s1

    def test_wal_error_rejects_instead_of_accepting(self, tmp_path):
        m = make_manager()
        m.wal = AttestationWAL(tmp_path)
        chaos.configure({"seed": 1, "faults": [{"point": "ingest.pre_apply", "kind": "io-error"}]})
        results = m.add_attestations_bulk([make_att(1, 0)])
        assert not results[0].accepted
        assert results[0].reason == "wal-error"
        chaos.reset()
        assert m.add_attestations_bulk([make_att(1, 0)])[0].accepted


def latest(directory) -> tuple:
    """The epoch each package's store loads as the latest from
    ``directory`` (None for a cold start)."""
    port = CheckpointStore(directory).load_latest()
    ref = ref_ckpt.CheckpointStore(directory).load_latest()
    return (None if port is None else port.epoch.number,
            None if ref is None else ref.epoch.number)


class TestCheckpointIntegrity:
    def _save(self, store, number, wal_seq=None, scores=True):
        g = small_graph(seed=number)
        store.save(
            Epoch(number),
            g,
            np.ones(g.n) / g.n if scores else None,
            None,
            peer_hashes=list(range(100, 100 + g.n)) if scores else None,
            wal_seq=wal_seq,
        )
        return g

    def test_manifest_carries_digests_and_wal_seq(self, tmp_path):
        from protocol_tpu.trust.graph import TrustGraph as RefTrustGraph

        store = CheckpointStore(tmp_path / "port")
        g = self._save(store, 1, wal_seq=17)
        manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
        entry = manifest["epochs"]["1"]
        assert entry["wal_seq"] == 17
        assert set(entry["columns"]) >= {"n", "src", "dst", "weight", "scores"}
        assert store.load(Epoch(1)).wal_seq == 17
        ref = ref_ckpt.CheckpointStore(tmp_path / "ref")
        ref.save(RefEpoch(1), RefTrustGraph(g.n, g.src, g.dst, g.weight, g.pre_trusted),
                 np.ones(g.n) / g.n, None, peer_hashes=list(range(100, 100 + g.n)), wal_seq=17)
        theirs = json.loads((tmp_path / "ref" / "manifest.json").read_text())["epochs"]["1"]
        assert entry["columns"] == theirs["columns"]
        assert ref_ckpt.CheckpointStore(tmp_path / "port").load(RefEpoch(1)).wal_seq == 17

    def test_bit_flip_detected_and_falls_back(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        self._save(store, 2)
        path = tmp_path / "epoch_2.npz"
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0x01
        path.write_bytes(bytes(data))
        with pytest.raises(SnapshotCorrupt):
            store.load(Epoch(2))
        with pytest.raises(ref_ckpt.SnapshotCorrupt):
            ref_ckpt.CheckpointStore(tmp_path).load(RefEpoch(2))
        fallbacks0 = obs_metrics.CHECKPOINT_FALLBACKS.value()
        snap = store.load_latest()
        assert snap is not None and snap.epoch == Epoch(1)
        assert obs_metrics.CHECKPOINT_FALLBACKS.value() - fallbacks0 == 1
        assert latest(tmp_path) == (1, 1)

    def test_truncation_at_every_region_never_raises(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        self._save(store, 2)
        path = tmp_path / "epoch_2.npz"
        pristine = path.read_bytes()
        step = max(1, len(pristine) // 23)
        for cut in range(0, len(pristine), step):
            path.write_bytes(pristine[:cut])
            assert latest(tmp_path) == (1, 1), cut  # falls back, never raises
        path.write_bytes(pristine)
        assert latest(tmp_path) == (2, 2)

    def test_byte_flips_at_every_region_detected(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        self._save(store, 2)
        path = tmp_path / "epoch_2.npz"
        pristine = path.read_bytes()
        step = max(1, len(pristine) // 23)
        pristine_snap = store.load(Epoch(2))
        for off in range(0, len(pristine), step):
            data = bytearray(pristine)
            data[off] ^= 0xA5
            path.write_bytes(bytes(data))
            snap = store.load_latest()
            assert snap is not None, off
            if snap.epoch == Epoch(2):
                # A flip in zip metadata that no column reads may leave
                # the data intact: what loads must be the pristine data.
                assert np.array_equal(snap.graph.src, pristine_snap.graph.src), off
                assert np.array_equal(snap.graph.weight, pristine_snap.graph.weight), off
                assert np.array_equal(snap.scores, pristine_snap.scores), off
            else:
                assert snap.epoch == Epoch(1), off
            assert latest(tmp_path)[1] == snap.epoch.number, off
        path.write_bytes(pristine)

    def test_corrupt_manifest_degrades_to_directory_scan(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        self._save(store, 3)
        (tmp_path / "manifest.json").write_text("{not json")
        assert latest(tmp_path) == (3, 3)

    def test_all_snapshots_corrupt_is_a_cold_start(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        self._save(store, 2)
        for p in tmp_path.glob("epoch_*.npz"):
            p.write_bytes(b"garbage")
        assert latest(tmp_path) == (None, None)

    def test_corrupt_proof_degrades_to_none(self, tmp_path):
        store = CheckpointStore(tmp_path)
        store.save(Epoch(1), small_graph(), None, '{"fake": "proof"}')
        (tmp_path / "epoch_1.proof.json").write_text('{"tampered": 1}')
        assert store.load(Epoch(1)).proof_json is None  # digest mismatch, journaled
        assert ref_ckpt.CheckpointStore(tmp_path).load(RefEpoch(1)).proof_json is None

    def test_garbage_plan_sidecar_degrades_to_rebuild(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 1)
        (tmp_path / "epoch_1.plan.npz").write_bytes(b"\x00" * 40)
        assert store.load(Epoch(1)).plan is None
        assert ref_ckpt.CheckpointStore(tmp_path).load(RefEpoch(1)).plan is None

    def test_legacy_manifest_without_digests_still_loads(self, tmp_path):
        store = CheckpointStore(tmp_path)
        self._save(store, 4)
        (tmp_path / "manifest.json").write_text('{"latest_epoch": 4}')
        snap = store.load_latest()
        assert snap is not None and snap.epoch == Epoch(4)
        assert snap.wal_seq is None
        assert latest(tmp_path) == (4, 4)

    def test_block_cursor_roundtrip_and_survives_save(self, tmp_path):
        store = CheckpointStore(tmp_path)
        assert store.block_cursor() is None
        store.save_block_cursor(42)
        assert store.block_cursor() == 42
        self._save(store, 1)
        assert store.block_cursor() == 42, "save must not clobber the cursor"
        assert json.loads((tmp_path / "manifest.json").read_text())["latest_epoch"] == 1
        assert ref_ckpt.CheckpointStore(tmp_path).block_cursor() == 42

    def test_retained_wal_floor_is_minimum_over_kept_epochs(self, tmp_path):
        store = CheckpointStore(tmp_path, keep=2)
        self._save(store, 1, wal_seq=10)
        self._save(store, 2, wal_seq=20)
        assert store.retained_wal_floor() == 10
        self._save(store, 3, wal_seq=30)  # epoch 1 pruned
        assert store.retained_wal_floor() == 20
        assert ref_ckpt.CheckpointStore(tmp_path, keep=2).retained_wal_floor() == 20

    def test_prune_drops_manifest_entries_with_snapshots(self, tmp_path):
        store = CheckpointStore(tmp_path, keep=2)
        for k in (1, 2, 3):
            self._save(store, k, wal_seq=k * 10)
        manifest = json.loads((tmp_path / "manifest.json").read_text())
        assert sorted(manifest["epochs"]) == ["2", "3"]
        assert sorted(p.name for p in tmp_path.glob("epoch_*.npz")) == [
            "epoch_2.npz", "epoch_3.npz"]

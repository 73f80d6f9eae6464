"""The port's single-device node against the reference package's, on the
same signed attestations: ingest verdicts, epoch convergence on the
port's backends (``device="cpu"``) beside the reference's, warm-start
seeds and plan outcomes across a re-attestation sequence, commitment
proofs bit for bit, and the reference's manager warm-state and epoch
pipeline suites (``tests/test_epoch_pipeline.py``) run on the port."""

import dataclasses
import logging
import random
import time

import numpy as np
import pytest
import torch

from protocol_tpu.crypto import calculate_message_hash as ref_message_hash
from protocol_tpu.crypto.eddsa import SecretKey as RefSecretKey
from protocol_tpu.crypto.eddsa import sign as ref_sign
from protocol_tpu.node import attestation as ref_att
from protocol_tpu.node.bootstrap import keyset_from_raw as ref_keyset
from protocol_tpu.node.epoch import Epoch as RefEpoch
from protocol_tpu.node.manager import Manager as RefManager
from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
from protocol_tpu.obs.metrics import PLAN_OUTCOMES as REF_PLAN_OUTCOMES
from protocol_tpu_torch.analysis.budget import HOST_BACKENDS, KERNEL_INVARIANTS
from protocol_tpu_torch.crypto import calculate_message_hash, field
from protocol_tpu_torch.crypto.eddsa import SecretKey, sign
from protocol_tpu_torch.node import manager as manager_mod
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, NUM_NEIGHBOURS, keyset_from_raw
from protocol_tpu_torch.node.checkpoint import CheckpointStore
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.node.pipeline import EpochPipeline
from protocol_tpu_torch.obs import JOURNAL, RECOMPILES
from protocol_tpu_torch.obs import metrics as obs_metrics
from protocol_tpu_torch.obs.metrics import PLAN_OUTCOMES
from protocol_tpu_torch.obs.watchers import MemoryWatermarkWatcher
from protocol_tpu_torch.ops import _build
from protocol_tpu_torch.trust.backend import registered_backends
from protocol_tpu_torch.utils.codec import b58encode

#: The port's backend beside the reference backend it is held against.
PAIRS = {"cuda-windowed": "tpu-windowed", "cuda-csr": "tpu-csr", "native-cpu": "native-cpu"}
OUTCOMES = ("reuse", "delta", "rebuild")

#: Score rows of the bootstrap group that sum to SCALE and are not
#: uniform, so the open graph takes several iterations to converge.
ROWS = [
    [0, 400, 300, 200, 100],
    [250, 0, 250, 250, 250],
    [500, 300, 0, 100, 100],
    [100, 200, 300, 0, 400],
    [200, 200, 200, 400, 0],
]


def l1(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum())


def generated_group(n: int, seed: int) -> list[tuple[str, str]]:
    """``n`` seeded members as the bs58 secret-key pairs a config holds."""
    return [
        tuple(b58encode(part) for part in SecretKey.random(random.Random(seed * 1000 + i)).to_raw())
        for i in range(n)
    ]


def ref_attestation(fixed_set, sender: int, scores) -> ref_att.Attestation:
    """A reference attestation signed by member ``sender``."""
    sks, pks = ref_keyset(fixed_set)
    _, msgs = ref_message_hash(pks, [list(scores)])
    return ref_att.Attestation(
        sig=ref_sign(sks[sender], pks[sender], msgs[0]), pk=pks[sender],
        neighbours=list(pks), scores=list(scores),
    )


def to_port(att: ref_att.Attestation) -> Attestation:
    """The same attestation as the port's object, through the wire form."""
    raw = ref_att.AttestationData.from_attestation(att).to_bytes()
    return AttestationData.from_bytes(raw, len(att.neighbours)).to_attestation(len(att.neighbours))


def make_attestation(sender_idx=0, scores=None):
    """The port's counterpart of ``tests/test_node.py::make_attestation``."""
    sks, pks = keyset_from_raw(FIXED_SET)
    scores = scores or [200] * NUM_NEIGHBOURS
    _, msgs = calculate_message_hash(pks, [scores])
    sig = sign(sks[sender_idx], pks[sender_idx], msgs[0])
    return Attestation(sig=sig, pk=pks[sender_idx], neighbours=list(pks), scores=scores)


def pair(backend: str, fixed_set=FIXED_SET, **kw) -> tuple[Manager, RefManager]:
    """The port's manager on ``device="cpu"`` and the reference's, with
    the commitment prover and no circuit check."""
    common = dict(prover="commitment", check_circuit=False, fixed_set=list(fixed_set), **kw)
    device = {} if backend in HOST_BACKENDS else {"device": "cpu"}
    ours = Manager(ManagerConfig(backend=backend, num_neighbours=len(fixed_set), **device, **common))
    theirs = RefManager(RefManagerConfig(backend=PAIRS[backend], num_neighbours=len(fixed_set), **common))
    return ours, theirs


def ingest_rows(ours: Manager, theirs: RefManager, rows, fixed_set=FIXED_SET, senders=None):
    atts = [ref_attestation(fixed_set, i, row) for i, row in zip(senders or range(len(rows)), rows)]
    mine = ours.add_attestations_bulk([to_port(a) for a in atts])
    ref = theirs.add_attestations_bulk(atts)
    assert [(r.accepted, r.reason) for r in mine] == [(r.accepted, r.reason) for r in ref]
    assert all(r.accepted for r in mine)


def plan_outcomes(metric) -> dict[str, float]:
    return {k: metric.value(outcome=k) for k in OUTCOMES}


class TestIngestParity:
    def test_same_verdicts_bulk_and_single(self):
        good = ref_attestation(FIXED_SET, 0, ROWS[0])
        mismatch = ref_attestation(FIXED_SET, 1, ROWS[1])
        mismatch.neighbours = list(reversed(mismatch.neighbours))
        outsider_sk = RefSecretKey.random(random.Random(5))
        outsider = ref_attestation(FIXED_SET, 2, ROWS[2])
        _, msgs = ref_message_hash(outsider.neighbours, [outsider.scores])
        outsider.sig = ref_sign(outsider_sk, outsider_sk.public(), msgs[0])
        outsider.pk = outsider_sk.public()
        non_conserving = ref_attestation(FIXED_SET, 3, [999, 0, 0, 0, 0])
        bad_sig = ref_attestation(FIXED_SET, 4, ROWS[4])
        bad_sig.sig = type(bad_sig.sig)(bad_sig.sig.big_r, (bad_sig.sig.s + 1) % field.MODULUS)
        tampered = ref_attestation(FIXED_SET, 1, ROWS[1])
        tampered.scores = list(ROWS[3])  # conserving, but not what was signed
        atts = [good, mismatch, outsider, non_conserving, bad_sig, tampered]
        expected = [
            (True, None), (False, "group-mismatch"), (False, "sender-not-in-group"),
            (False, "non-conserving-scores"), (False, "bad-signature"), (False, "bad-signature"),
        ]
        ours, theirs = Manager(ManagerConfig(prover="commitment")), RefManager()
        mine = [(r.accepted, r.reason) for r in ours.add_attestations_bulk([to_port(a) for a in atts])]
        ref = [(r.accepted, r.reason) for r in theirs.add_attestations_bulk(atts)]
        assert mine == ref == expected
        single = [
            (r.accepted, r.reason)
            for r in (Manager(ManagerConfig(prover="commitment")).add_attestation(to_port(a)) for a in atts)
        ]
        assert single == expected
        assert sorted(ours.attestations) == sorted(theirs.attestations)
        for h, att in ours.attestations.items():
            assert att.scores == theirs.attestations[h].scores


class TestConvergeParity:
    @pytest.mark.parametrize("backend", list(PAIRS))
    def test_converge_epoch_matches_reference(self, backend):
        ours, theirs = pair(backend)
        ingest_rows(ours, theirs, ROWS)
        graph, ref_graph = ours.build_graph(), theirs.build_graph()
        np.testing.assert_array_equal(graph.src, ref_graph.src)
        np.testing.assert_array_equal(graph.weight, ref_graph.weight)
        mine = ours.converge_epoch(Epoch(1), alpha=0.1)
        ref = theirs.converge_epoch(RefEpoch(1), alpha=0.1)
        assert mine.iterations == ref.iterations > 1
        assert l1(mine.scores, ref.scores) <= 1e-6
        assert mine.backend == backend
        assert ours.last_peer_hashes == theirs.last_peer_hashes

    @pytest.mark.parametrize("backend", ["cuda-windowed", "cuda-csr"])
    def test_reattestation_sequence_matches_reference(self, backend):
        """Epoch 1 builds the plan; one re-attestation makes epoch 2 a
        delta; two make epoch 3 exceed the churn limit and rebuild; an
        unchanged epoch 4 reuses.  Warm seeds, delta rows, plan outcomes
        and iterations agree with the reference's at every epoch."""
        ours, theirs = pair(backend, plan_delta_max_churn=0.25)
        ingest_rows(ours, theirs, ROWS)
        changes = {2: [(0, [0, 100, 100, 100, 700])], 3: [(1, [100, 0, 100, 100, 700]),
                                                         (2, [300, 300, 0, 300, 100])]}
        seen = []
        for epoch in range(1, 5):
            for sender, row in changes.get(epoch, []):
                ingest_rows(ours, theirs, [row], senders=[sender])
            prep, ref_prep = ours.prepare_epoch(Epoch(epoch)), theirs.prepare_epoch(RefEpoch(epoch))
            assert (prep.t0 is None) == (ref_prep.t0 is None) == (epoch == 1)
            if prep.t0 is not None:
                np.testing.assert_allclose(prep.t0, ref_prep.t0, rtol=0, atol=1e-7)
            if ref_prep.delta_rows is None:
                assert prep.delta_rows is None
            else:
                np.testing.assert_array_equal(prep.delta_rows, ref_prep.delta_rows)
            before, ref_before = plan_outcomes(PLAN_OUTCOMES), plan_outcomes(REF_PLAN_OUTCOMES)
            mine = ours.converge_prepared(prep, alpha=0.1)
            ref = theirs.converge_prepared(ref_prep, alpha=0.1)
            got = {k: v - before[k] for k, v in plan_outcomes(PLAN_OUTCOMES).items()}
            want = {k: v - ref_before[k] for k, v in plan_outcomes(REF_PLAN_OUTCOMES).items()}
            assert got == want
            seen.append([k for k in OUTCOMES if got[k]])
            assert mine.iterations == ref.iterations
            assert l1(mine.scores, ref.scores) <= 1e-6
        if backend == "cuda-windowed":
            assert seen == [["rebuild"], ["delta"], ["rebuild"], ["reuse"]]
            assert ours.window_plan.fingerprint == theirs.window_plan.fingerprint
        else:
            assert seen == [[], [], [], []]

    def test_warm_t0_bit_equal_on_the_same_state(self):
        ours, theirs = pair("cuda-csr")
        hashes = [int(h) for h in np.random.default_rng(3).integers(1, 2**62, 9)]
        scores = np.random.default_rng(4).random(9)
        scores[2] = -1e-9  # negative dust is clipped
        for m in (ours, theirs):
            m.last_peer_hashes, m.last_scores = list(hashes), scores.copy()
        order = hashes[5:] + [77, 88] + hashes[:3]  # joins, leaves, reorder
        np.testing.assert_array_equal(ours._warm_t0(order), theirs._warm_t0(order))
        assert ours._warm_t0([1, 2]) is None and theirs._warm_t0([1, 2]) is None


class TestProofs:
    def test_commitment_proof_bit_equal(self):
        ours, theirs = pair("native-cpu")
        ours.generate_initial_attestations()
        theirs.generate_initial_attestations()
        ingest_rows(ours, theirs, [ROWS[1], ROWS[3]], senders=[1, 3])
        ours.calculate_proofs(Epoch(3))
        theirs.calculate_proofs(RefEpoch(3))
        mine, ref = ours.get_proof(Epoch(3)), theirs.get_proof(RefEpoch(3))
        assert mine.pub_ins == ref.pub_ins
        assert mine.proof == ref.proof
        assert theirs.prover.verify(mine.pub_ins, mine.proof)
        assert ours.prover.verify(ref.pub_ins, ref.proof)
        assert mine.to_raw("commitment").to_json() == ref.to_raw("commitment").to_json()

    def test_plonk_prover_raises_naming_the_roadmap_item(self, monkeypatch):
        """The PLONK prover is ported (``tests/test_torch_plonk_node.py``);
        what of it is not, the aggregation, raises naming its ROADMAP item.
        The graft kernels are ported (A8) and run on the node's device:
        with none named and no card, the prove raises before any keygen
        and with no proof cached, and does not fall back to the host."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        m = Manager(ManagerConfig(check_circuit=False, zk_backend="graft"))
        assert m.config.prover == "plonk"
        m.generate_initial_attestations()
        with pytest.raises(NotImplementedError, match=r"ROADMAP A5c \(i-b\)"):
            m.aggregate_proofs([Epoch(1)])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.calculate_proofs(Epoch(1))
        assert m._prover is None
        assert not m.cached_proofs

    def test_circuit_check_raises_naming_the_roadmap_item(self):
        """The circuit check is ported: it runs before every proof,
        passes on the bootstrap group's statement, and raises on one
        whose signatures do not cover its score rows, caching no proof."""
        m = Manager(ManagerConfig(prover="commitment"))
        assert m.config.check_circuit is True
        m.generate_initial_attestations()
        m.calculate_proofs(Epoch(1))
        assert Epoch(1) in m.cached_proofs
        h = next(iter(m.attestations))
        att = m.attestations[h]
        scores = list(att.scores)
        scores[0], scores[1] = scores[0] + 50, scores[1] - 50
        m.attestations[h] = dataclasses.replace(att, scores=scores)
        assert m.attestations[h].scores != att.scores
        with pytest.raises(AssertionError, match="not satisfied"):
            m.calculate_proofs(Epoch(2))
        assert Epoch(2) not in m.cached_proofs


class TestDeviceAndBudgets:
    def test_device_none_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Manager(ManagerConfig(backend="cuda-windowed", prover="commitment"))
        assert Manager(ManagerConfig(backend="native-cpu")).device is None
        m = Manager(ManagerConfig(backend="cuda-csr", device="cpu", prover="commitment"))
        assert m.device == torch.device("cpu")

    def test_every_card_backend_declares_its_kernels(self):
        for name in registered_backends():
            assert (name in HOST_BACKENDS) != (name in KERNEL_INVARIANTS), name
        assert KERNEL_INVARIANTS["cuda-csr"].expected_launches(7) == {
            "gather_ds_cumsum": 7, "block_total_scan": 7, "rowsum_tail": 7,
        }
        assert set(KERNEL_INVARIANTS["cuda-windowed"].launches_per_step) == {
            "gather_windowed", "prefix_bridge", "ds_cumsum_axis1", "block_total_scan", "rowsum_tail",
        }

    def test_undeclared_backend_is_logged(self, monkeypatch, caplog):
        m = Manager(ManagerConfig(backend="cuda-csr", device="cpu", prover="commitment"))
        m.generate_initial_attestations()
        with caplog.at_level(logging.WARNING, logger=manager_mod.__name__):
            m.converge_epoch(Epoch(1), alpha=0.1)
        assert "KERNEL_INVARIANTS" not in caplog.text
        monkeypatch.delitem(KERNEL_INVARIANTS, "cuda-csr")
        with caplog.at_level(logging.WARNING, logger=manager_mod.__name__):
            m.converge_epoch(Epoch(2), alpha=0.1)
        assert "no KERNEL_INVARIANTS declaration" in caplog.text

    def test_kernel_build_in_a_steady_state_epoch_is_an_anomaly(self, monkeypatch, caplog):
        monkeypatch.setattr(_build, "_LOADS", {})
        before = RECOMPILES.snapshot()
        _build._count("gather_window")
        with caplog.at_level(logging.WARNING):
            misses = RECOMPILES.observe(before, steady_state=True, epoch=4)
        assert misses == {"gather_window": 1}
        assert "BUILT kernel libraries" in caplog.text
        assert any(
            e.get("what") == "steady-state-recompile" and e.get("epoch") == 4
            for e in JOURNAL.tail(50)
        )
        assert RECOMPILES.observe(RECOMPILES.snapshot(), steady_state=True) == {}

    def test_memory_watcher_is_a_no_op_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

        class Span:
            name, attrs = "converge", {}

        w = MemoryWatermarkWatcher()
        w.on_open(Span)
        w.on_close(Span)
        assert w._enabled is False and Span.attrs == {}


class TestManagerWarmState:
    """``tests/test_epoch_pipeline.py::TestManagerWarmState`` on the port."""

    def _manager(self, **kw):
        m = Manager(
            ManagerConfig(
                backend="cuda-windowed", device="cpu", prover="commitment",
                check_circuit=False, **kw,
            )
        )
        m.generate_initial_attestations()
        return m

    def test_second_epoch_warm_starts_and_persists(self, tmp_path):
        m = self._manager()
        r1 = m.converge_epoch(Epoch(1), alpha=0.1)
        assert m.last_scores is not None and m.last_peer_hashes is not None
        assert len(m.last_peer_hashes) == len(r1.scores)
        prep = m.prepare_epoch(Epoch(2))
        assert prep.t0 is not None
        assert prep.t0.sum() == pytest.approx(1.0, rel=1e-6)
        np.testing.assert_allclose(prep.t0, r1.scores, atol=1e-9)
        r2 = m.converge_prepared(prep, alpha=0.1)
        np.testing.assert_allclose(r2.scores, r1.scores, rtol=1e-5)

    def test_warm_start_disabled_by_config(self):
        m = self._manager(warm_start=False)
        m.converge_epoch(Epoch(1), alpha=0.1)
        assert m.prepare_epoch(Epoch(2)).t0 is None

    def test_warm_t0_remaps_joins_and_leaves(self):
        m = self._manager()
        m.last_peer_hashes = [10, 20, 30]
        m.last_scores = np.array([0.5, 0.3, 0.2])
        t0 = m._warm_t0([10, 40, 30])
        np.testing.assert_allclose(t0, [0.5 / 0.7, 0.0, 0.2 / 0.7])
        assert m._warm_t0([7, 8]) is None

    def test_dirty_rows_feed_plan_delta(self):
        m = self._manager(plan_delta_max_churn=1.0)
        m.converge_epoch(Epoch(1), alpha=0.1)
        assert not m._dirty_hashes
        plan1 = m.window_plan
        m.add_attestation(make_attestation(sender_idx=0, scores=[400, 300, 150, 150, 0]))
        assert m._dirty_hashes
        prep = m.prepare_epoch(Epoch(2))
        assert prep.delta_rows is not None and prep.delta_rows.size == 1
        before = PLAN_OUTCOMES.value(outcome="delta")
        m.converge_prepared(prep, alpha=0.1)
        assert PLAN_OUTCOMES.value(outcome="delta") == before + 1
        assert m.window_plan is not plan1
        assert plan1.fingerprint in m.window_plan.lineage
        assert not m._dirty_hashes

    def test_churn_threshold_disables_delta(self):
        m = self._manager(plan_delta_max_churn=0.0)
        m.converge_epoch(Epoch(1), alpha=0.1)
        m.add_attestation(make_attestation(sender_idx=0, scores=[400, 300, 150, 150, 0]))
        assert m.prepare_epoch(Epoch(2)).delta_rows is None

    def test_checkpoint_restores_warm_state(self, tmp_path):
        m = self._manager()
        r1 = m.converge_epoch(Epoch(1), alpha=0.1)
        store = CheckpointStore(tmp_path)
        store.save(Epoch(1), m.last_graph, r1.scores, plan=m.window_plan,
                   peer_hashes=m.last_peer_hashes)
        snap = store.load_latest()
        assert snap.peer_hashes == m.last_peer_hashes
        m2 = self._manager()
        m2.restore_warm_state(graph=snap.graph, plan=snap.plan, scores=snap.scores,
                              peer_hashes=snap.peer_hashes)
        prep = m2.prepare_epoch(Epoch(2))
        assert prep.t0 is not None
        np.testing.assert_allclose(prep.t0, r1.scores, atol=1e-9)
        before = PLAN_OUTCOMES.value(outcome="reuse")
        m2.converge_prepared(prep, alpha=0.1)
        assert PLAN_OUTCOMES.value(outcome="reuse") == before + 1


class TestEpochPipeline:
    """``tests/test_epoch_pipeline.py::TestEpochPipeline`` on the port."""

    def _manager(self, backend="cuda-sparse", **kw):
        m = Manager(
            ManagerConfig(backend=backend, device="cpu", prover="commitment",
                          check_circuit=False, **kw)
        )
        m.generate_initial_attestations()
        return m

    def test_sequential_epochs_warm_start(self):
        m = self._manager()
        with EpochPipeline(m, alpha=0.1) as pipe:
            pipe.submit(Epoch(1))
            assert pipe.drain(60)
            pipe.submit(Epoch(2))
            assert pipe.drain(60)
        o1, o2 = pipe.outcomes[1], pipe.outcomes[2]
        assert o1.error is None and o2.error is None
        assert o2.result.iterations <= o1.result.iterations
        assert pipe.coalesced == 0 and pipe.completed == 2

    def test_backpressure_coalesces_instead_of_dropping(self):
        m = self._manager()

        def slow_stage(prepared):
            time.sleep(0.5)
            return m.converge_prepared(prepared, alpha=0.1)

        before = obs_metrics.EPOCH_TICKS_COALESCED.value()
        with EpochPipeline(m, device_stage=slow_stage, queue_depth=1) as pipe:
            for k in range(1, 6):
                pipe.submit(Epoch(k))
                time.sleep(0.05)
            assert pipe.drain(60)
        assert pipe.coalesced >= 1
        assert pipe.completed + pipe.coalesced == 5
        assert 5 in pipe.outcomes
        assert obs_metrics.EPOCH_TICKS_COALESCED.value() - before == pipe.coalesced

    def test_device_failure_does_not_kill_the_pipeline(self):
        m = self._manager()
        calls = []

        def flaky_stage(prepared):
            calls.append(prepared.epoch.number)
            if prepared.epoch.number == 1:
                raise RuntimeError("prover exploded")
            return m.converge_prepared(prepared, alpha=0.1)

        with EpochPipeline(m, device_stage=flaky_stage) as pipe:
            pipe.submit(Epoch(1))
            assert pipe.drain(60)
            pipe.submit(Epoch(2))
            assert pipe.drain(60)
        assert isinstance(pipe.outcomes[1].error, RuntimeError)
        assert pipe.outcomes[2].error is None
        assert calls == [1, 2]

    def test_failed_epoch_keeps_dirty_accounting(self):
        m = self._manager("cuda-windowed", plan_delta_max_churn=1.0)
        m.converge_epoch(Epoch(1), alpha=0.1)
        m.add_attestation(make_attestation(sender_idx=1, scores=[0, 500, 300, 100, 100]))
        dirty = set(m._dirty_hashes)
        assert dirty
        m.prepare_epoch(Epoch(2))
        assert m._dirty_hashes == dirty
        prep3 = m.prepare_epoch(Epoch(3))
        assert prep3.delta_rows is not None
        m.converge_prepared(prep3, alpha=0.1)
        assert not m._dirty_hashes

    def test_unbindable_card_fails_the_epoch_not_the_worker(self):
        """The worker binds the manager's card before its first epoch;
        where that fails, the epoch's outcome carries the error and the
        pipeline drains — nothing runs on the CPU instead."""
        m = self._manager()
        m.device = torch.device("cuda", 0)
        with EpochPipeline(m, alpha=0.1) as pipe:
            pipe.submit(Epoch(1))
            assert pipe.drain(60)
        assert pipe.outcomes[1].error is not None and pipe.outcomes[1].result is None
        assert m.last_scores is None

    def test_pipeline_matches_the_reference_on_a_generated_group(self):
        """Three pipeline epochs on a seeded 8-member group: the same
        scores as the reference's sequential epochs, with the
        commitment proof of the last one bit for bit."""
        group = generated_group(8, seed=2)
        rng = np.random.default_rng(2)
        rows = []
        for i in range(8):
            w = rng.integers(0, 5, 8)
            w[i] = 0
            w[(i + 1) % 8] += 1
            row = (w * 1000 // w.sum()).astype(int)
            row[(i + 1) % 8] += 1000 - row.sum()
            rows.append([int(x) for x in row])
        ours, theirs = pair("cuda-csr", fixed_set=group)
        ingest_rows(ours, theirs, rows, fixed_set=group)
        with EpochPipeline(ours, alpha=0.1) as pipe:
            for k in range(1, 4):
                pipe.submit(Epoch(k))
                assert pipe.drain(60)
        for k in range(1, 4):
            ref = theirs.converge_epoch(RefEpoch(k), alpha=0.1)
            mine = pipe.outcomes[k].result
            assert pipe.outcomes[k].error is None
            assert mine.iterations == ref.iterations
            assert l1(mine.scores, ref.scores) <= 1e-6
        ours.calculate_proofs(Epoch(3))
        theirs.calculate_proofs(RefEpoch(3))
        assert ours.get_proof(Epoch(3)).proof == theirs.get_proof(RefEpoch(3)).proof


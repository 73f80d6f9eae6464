"""The port's admission plane (``protocol_tpu_torch.ingest``) beside the
reference's (``protocol_tpu.ingest``).

Two halves:

- the reference's own suite (``tests/test_ingest.py``, all but the
  HTTP route, which belongs to the server) re-targeted at the port:
  sharded dedup, rate limits, the verify worker pool with crash
  recovery, the ``IngestPlane`` pipeline and the manager's uniform
  ``IngestResult``;
- parity: the same inputs through both packages — dedup shard
  placement, dedup and policy verdicts, ``verify_batch``, and one
  seeded attestation stream (fresh, replayed, stale-nonce, badly
  signed and structurally invalid items, rate-limit and spam pressure,
  epoch rotations and a burst past the submit queue) through both
  planes with injected clocks, verdict and reason item by item.

Everything runs on the CPU: the plane touches no device.
"""

import random
import threading
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

from protocol_tpu.crypto import calculate_message_hash as ref_message_hash
from protocol_tpu.crypto.eddsa import SecretKey as RefSecretKey
from protocol_tpu.crypto.eddsa import sign as ref_sign
from protocol_tpu.ingest import IngestPlane as RefIngestPlane
from protocol_tpu.ingest import IngestPlaneConfig as RefIngestPlaneConfig
from protocol_tpu.ingest.dedup import ShardedDedupCache as RefShardedDedupCache
from protocol_tpu.ingest.dedup import _shard_index as ref_shard_index
from protocol_tpu.ingest.ratelimit import AdmissionPolicy as RefAdmissionPolicy
from protocol_tpu.ingest.ratelimit import RateLimitConfig as RefRateLimitConfig
from protocol_tpu.ingest.workers import verify_batch as ref_verify_batch
from protocol_tpu.node import attestation as ref_att
from protocol_tpu.node.bootstrap import keyset_from_raw as ref_keyset
from protocol_tpu.node.manager import Manager as RefManager
from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
from protocol_tpu_torch.crypto import (
    calculate_message_hash,
    field,
    group_pks_hash,
    message_hash_batch,
)
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.ingest import (
    SHED_REASON,
    IngestPlane,
    IngestPlaneConfig,
    ShardedDedupCache,
)
from protocol_tpu_torch.ingest.dedup import _shard_index
from protocol_tpu_torch.ingest.ratelimit import AdmissionPolicy, RateLimitConfig
from protocol_tpu_torch.ingest.workers import (
    CRASH_MARKER,
    VerifyCrashed,
    VerifyPool,
    verify_batch,
)
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.manager import IngestResult, Manager, ManagerConfig
from protocol_tpu_torch.obs import metrics as obs_metrics

SKS, PKS = keyset_from_raw(FIXED_SET)
GROUP_HASH = group_pks_hash(PKS)
#: Reasons only the plane gives: the direct path has no dedup, nonce,
#: rate or queue gate.
PLANE_ONLY = {"duplicate", "stale-nonce", "rate-limited", "spam-score", SHED_REASON}


def make_att(i: int, sender: int = 0, bad_sig: bool = False) -> Attestation:
    """Unique validly-signed attestation #i (scores sum to SCALE)."""
    d = i % 190
    scores = [200 + d, 200 - d, 200, 200, 200]
    _, msgs = calculate_message_hash(PKS, [scores])
    sig = sign(SKS[sender], PKS[sender], msgs[0] + (1 if bad_sig else 0))
    return Attestation(sig=sig, pk=PKS[sender], neighbours=list(PKS), scores=scores)


def work_item(att) -> tuple:
    return (
        att.sig.big_r.x,
        att.sig.big_r.y,
        att.sig.s,
        att.pk.point.x,
        att.pk.point.y,
        tuple(att.scores),
    )


def fresh_manager() -> Manager:
    return Manager(ManagerConfig(prover="commitment"))


def open_plane(manager=None, **kw) -> IngestPlane:
    defaults = dict(
        workers=0,
        batch_size=8,
        rate=RateLimitConfig(rate=1e6, burst=1e6),
    )
    defaults.update(kw)
    return IngestPlane(manager or fresh_manager(), IngestPlaneConfig(**defaults))


# ---------------------------------------------------------------------------
# The reference's suite, re-targeted at the port
# ---------------------------------------------------------------------------


class TestMessageHashBatch:
    def test_parity_with_reference_path(self):
        rows = [[200] * 5, [100, 300, 200, 150, 250], [999, 1, 0, 0, 0]]
        ph, ref = calculate_message_hash(PKS, rows)
        assert ph == GROUP_HASH
        assert message_hash_batch(GROUP_HASH, rows) == ref

    def test_multi_chunk_rows_match_sponge(self):
        # Rows wider than the sponge width take two absorb rounds.
        from protocol_tpu_torch.crypto import PoseidonSponge, permute

        rows = [[i * 7 + j for j in range(7)] for i in range(3)]
        expected = []
        for row in rows:
            sponge = PoseidonSponge()
            sponge.update(row)
            expected.append(permute([GROUP_HASH, sponge.squeeze(), 0, 0, 0])[0])
        assert message_hash_batch(GROUP_HASH, rows) == expected


class TestShardedDedup:
    def test_duplicate_rejected(self):
        cache = ShardedDedupCache(n_shards=4)
        sender = (1, 2)
        assert cache.admit(sender, b"d1") is None
        assert cache.admit(sender, b"d1") == "duplicate"
        assert cache.admit(sender, b"d2") is None

    def test_nonce_monotonic(self):
        cache = ShardedDedupCache()
        sender = (3, 4)
        assert cache.admit(sender, b"a", nonce=5) is None
        # Out-of-order and replayed nonces both die as stale.
        assert cache.admit(sender, b"b", nonce=5) == "stale-nonce"
        assert cache.admit(sender, b"c", nonce=4) == "stale-nonce"
        assert cache.admit(sender, b"d", nonce=6) is None
        # A nonce-less submission from the same sender still dedups by
        # digest only.
        assert cache.admit(sender, b"e") is None

    def test_epoch_rotation_forgets_after_two_epochs(self):
        cache = ShardedDedupCache()
        sender = (5, 6)
        assert cache.admit(sender, b"x") is None
        cache.rotate_all()
        assert cache.admit(sender, b"x") == "duplicate"  # previous gen
        cache.rotate_all()
        cache.rotate_all()
        assert cache.admit(sender, b"x") is None  # aged out

    def test_overflow_rotates_bounded(self):
        cache = ShardedDedupCache(n_shards=1, hashes_per_shard=8)
        sender = (7, 8)
        for i in range(64):
            cache.admit(sender, bytes([i]))
        assert len(cache) <= 16  # two generations of 8

    def test_shard_count_must_be_positive(self):
        with pytest.raises(ValueError):
            ShardedDedupCache(n_shards=0)


class TestAdmissionPolicy:
    def test_exhaustion_then_refill(self):
        clock = [0.0]
        policy = AdmissionPolicy(
            RateLimitConfig(rate=10.0, burst=3.0), clock=lambda: clock[0]
        )
        sender = (1, 1)
        assert [policy.check(sender) for _ in range(3)] == [None] * 3
        assert policy.check(sender) == "rate-limited"
        # Refill: 0.2s at 10/s = 2 tokens.
        clock[0] += 0.2
        assert policy.check(sender) is None
        assert policy.check(sender) is None
        assert policy.check(sender) == "rate-limited"

    def test_whitelist_bypass(self):
        sender = (2, 2)
        policy = AdmissionPolicy(
            RateLimitConfig(rate=1.0, burst=1.0, whitelist=frozenset({sender}))
        )
        assert all(policy.check(sender) is None for _ in range(50))

    def test_spam_score_from_rejection_history(self):
        clock = [0.0]
        policy = AdmissionPolicy(
            RateLimitConfig(rate=1e6, burst=1e6, spam_threshold=2.0),
            clock=lambda: clock[0],
        )
        sender = (3, 3)
        assert policy.check(sender) is None
        for _ in range(20):  # downstream verdicts: all garbage
            policy.record_outcome(sender, False)
        assert policy.score(sender) > 2.0
        assert policy.check(sender) == "spam-score"


class TestVerifyPool:
    def test_inline_verdicts(self):
        good, bad = make_att(1), make_att(2, bad_sig=True)
        assert verify_batch(GROUP_HASH, [work_item(good), work_item(bad)]) == [
            True,
            False,
        ]

    def test_pooled_verdicts_and_crash_recovery(self):
        good, bad = make_att(3), make_att(4, bad_sig=True)
        pool = VerifyPool(workers=1)
        try:
            assert pool.verify(GROUP_HASH, [work_item(good), work_item(bad)]) == [
                True,
                False,
            ]
            restarts0 = obs_metrics.INGEST_WORKER_RESTARTS.value()
            # A batch whose worker dies on every attempt must come back
            # as VerifyCrashed (the caller rejects it with a reason
            # code), never hang or vanish.
            with pytest.raises(VerifyCrashed):
                pool.verify(GROUP_HASH, [work_item(good), CRASH_MARKER])
            assert obs_metrics.INGEST_WORKER_RESTARTS.value() > restarts0
            # The pool respawned: the next batch verifies normally.
            assert pool.verify(GROUP_HASH, [work_item(good)]) == [True]
        finally:
            pool.close()

    def test_crash_retry_succeeds_on_respawned_pool(self):
        """First attempt dies (broken executor), the retry lands on the
        rebuilt pool — the in-flight batch is retried, not dropped."""

        class FlakyExecutor:
            def submit(self, fn, *args):
                raise BrokenProcessPool("worker died")

            def shutdown(self, wait=True, cancel_futures=False):
                pass

        pool = VerifyPool(workers=0)
        pool._executor = FlakyExecutor()
        retried0 = obs_metrics.INGEST_VERIFY_BATCHES.value(outcome="retried")
        try:
            good = make_att(5)
            # The restart rebuilds an inline pool: the retry verifies on
            # the calling thread.
            pool._make = lambda: None
            assert pool.verify(GROUP_HASH, [work_item(good)]) == [True]
            assert (
                obs_metrics.INGEST_VERIFY_BATCHES.value(outcome="retried")
                > retried0
            )
        finally:
            pool.close()


class TestIngestPlane:
    def test_accept_replay_badsig_and_nonces(self):
        manager = fresh_manager()
        with open_plane(manager) as plane:
            futs = [plane.submit(make_att(i, sender=i % 5)) for i in range(6)]
            replay = plane.submit(make_att(2, sender=2))
            bad = plane.submit(make_att(40, bad_sig=True))
            n5 = plane.submit(make_att(50, sender=1), nonce=5)
            stale = plane.submit(make_att(51, sender=1), nonce=4)
            assert plane.drain(30)
            assert all(f.result().accepted for f in futs)
            assert replay.result().reason == "duplicate"
            assert bad.result().reason == "bad-signature"
            assert n5.result().accepted
            assert stale.result().reason == "stale-nonce"
            # Accepted attestations landed in the manager's cache.
            assert len(manager.attestations) == 5
            stats = plane.stats()
            assert stats["accepted"] == 7 and stats["pending"] == 0

    def test_structural_rejects_never_reach_verify(self):
        manager = fresh_manager()
        with open_plane(manager) as plane:
            calls = []
            original = plane.pool.verify
            plane.pool.verify = lambda *a: (calls.append(1), original(*a))[1]
            att = make_att(1)
            outsider = Attestation(
                sig=att.sig,
                pk=att.pk,
                neighbours=list(reversed(att.neighbours)),
                scores=att.scores,
            )
            fut = plane.submit(outsider)
            assert plane.drain(30)
            assert fut.result().reason == "group-mismatch"
            assert not calls  # rejected before any signature work

    def test_rate_exhaustion_then_refill_through_plane(self):
        clock = [0.0]
        manager = fresh_manager()
        with open_plane(
            manager, rate=RateLimitConfig(rate=10.0, burst=2.0)
        ) as plane:
            plane.policy = AdmissionPolicy(
                RateLimitConfig(rate=10.0, burst=2.0), clock=lambda: clock[0]
            )
            futs = [plane.submit(make_att(i)) for i in range(4)]
            assert plane.drain(30)
            verdicts = [f.result() for f in futs]
            assert sum(v.accepted for v in verdicts) == 2
            assert {v.reason for v in verdicts if not v.accepted} == {
                "rate-limited"
            }
            clock[0] += 1.0  # refill 10 tokens (capped at burst=2)
            futs = [plane.submit(make_att(100 + i)) for i in range(2)]
            assert plane.drain(30)
            assert all(f.result().accepted for f in futs)

    def test_full_queue_sheds_with_reason(self):
        manager = fresh_manager()
        hold = threading.Event()
        with open_plane(
            manager, submit_queue_max=1, batch_queue_max=1, batch_size=1
        ) as plane:
            plane.pool.verify = lambda *a: (hold.wait(10), [True])[1]
            futs = [plane.submit(make_att(i)) for i in range(12)]
            time.sleep(0.2)  # let the pipeline wedge against the hold
            shed = [
                f for f in futs if f.done() and f.result().reason == SHED_REASON
            ]
            assert shed, "bounded intake never shed under a wedged verifier"
            assert plane.shed == len(shed)
            assert (
                obs_metrics.INGEST_SHED.value(stage="submit") >= len(shed)
            )
            hold.set()
            assert plane.drain(30)

    def test_worker_crash_rejects_with_reason_never_drops(self):
        manager = fresh_manager()
        with open_plane(manager) as plane:
            def crashed(*a):
                raise VerifyCrashed("worker died twice")

            plane.pool.verify = crashed
            futs = [plane.submit(make_att(i)) for i in range(3)]
            assert plane.drain(30)
            assert [f.result().reason for f in futs] == ["verify-crashed"] * 3
            assert plane.stats()["pending"] == 0

    def test_epoch_rotation_reopens_dedup(self):
        manager = fresh_manager()
        with open_plane(manager) as plane:
            att = make_att(7)
            assert plane.submit(att).result(10).accepted
            assert plane.submit(att).result(10).reason == "duplicate"
            plane.advance_epoch()
            plane.advance_epoch()
            assert plane.submit(att).result(10).accepted

    def test_close_resolves_pending_futures(self):
        manager = fresh_manager()
        hold = threading.Event()
        plane = open_plane(manager, batch_size=1)
        plane.start()
        plane.pool.verify = lambda *a: (hold.wait(10), [True])[1]
        futs = [plane.submit(make_att(i)) for i in range(4)]
        hold.set()
        plane.close(drain=False)
        for f in futs:
            assert f.result(timeout=10) is not None  # never left hanging


class TestManagerUniformIngestResult:
    def test_single_item_matches_bulk_shape(self):
        m = fresh_manager()
        ok = m.add_attestation(make_att(1))
        assert isinstance(ok, IngestResult) and ok.accepted
        bad = m.add_attestation(make_att(2, bad_sig=True))
        assert (bad.accepted, bad.reason) == (False, "bad-signature")
        att = make_att(3)
        att.neighbours = list(reversed(att.neighbours))
        assert m.add_attestation(att).reason == "group-mismatch"
        # Identical verdict objects from the bulk path.
        assert m.add_attestations_bulk([make_att(4)])[0].accepted

    def test_apply_verified_skips_checks(self):
        m = fresh_manager()
        att = make_att(5)
        assert m.apply_verified(att).accepted
        assert m.attestations[att.pk.hash()] is att


# ---------------------------------------------------------------------------
# Parity with the reference on the same inputs
# ---------------------------------------------------------------------------


def seeded_senders(seed: int, n: int) -> list[tuple[int, int]]:
    """``n`` sender keys: field-sized random coordinates, the group's
    real keys first."""
    rng = random.Random(seed)
    keys = [(pk.point.x, pk.point.y) for pk in PKS]
    keys += [(rng.randrange(field.MODULUS), rng.randrange(field.MODULUS)) for _ in range(n)]
    return keys[:n]


class TestDedupParity:
    @pytest.mark.parametrize("n_shards", [1, 2, 7, 16, 64, 1000])
    def test_shard_placement_bit_identical(self, n_shards):
        for sender in seeded_senders(11, 500):
            assert _shard_index(sender, n_shards) == ref_shard_index(sender, n_shards)

    def test_same_admission_verdicts(self):
        rng = np.random.default_rng(12)
        senders = seeded_senders(13, 9)
        ours = ShardedDedupCache(n_shards=4, hashes_per_shard=16, senders_per_shard=3)
        theirs = RefShardedDedupCache(n_shards=4, hashes_per_shard=16, senders_per_shard=3)
        mine, ref = [], []
        for step in range(2000):
            sender = senders[int(rng.integers(len(senders)))]
            digest = bytes([int(rng.integers(40))])
            nonce = None if rng.random() < 0.3 else int(rng.integers(30))
            mine.append(ours.admit(sender, digest, nonce))
            ref.append(theirs.admit(sender, digest, nonce))
            if step % 97 == 0:
                ours.rotate_all()
                theirs.rotate_all()
            assert len(ours) == len(theirs)
        assert mine == ref
        assert {"duplicate", "stale-nonce", None} <= set(mine)


class TestPolicyParity:
    def test_same_verdicts_and_scores_under_one_clock(self):
        rng = np.random.default_rng(21)
        clock = [0.0]
        cfg = dict(rate=5.0, burst=4.0, spam_threshold=2.5, max_senders=4)
        senders = seeded_senders(22, 6)
        white = senders[5]
        ours = AdmissionPolicy(
            RateLimitConfig(**cfg, whitelist=frozenset({white})), clock=lambda: clock[0]
        )
        theirs = RefAdmissionPolicy(
            RefRateLimitConfig(**cfg, whitelist=frozenset({white})), clock=lambda: clock[0]
        )
        mine, ref = [], []
        for _ in range(3000):
            clock[0] += float(rng.choice([0.0, 0.0, 0.0, 0.01, 0.05, 0.3]))
            sender = senders[int(rng.integers(len(senders)))]
            if rng.random() < 0.3:
                accepted = bool(rng.random() < 0.75)
                ours.record_outcome(sender, accepted)
                theirs.record_outcome(sender, accepted)
                continue
            mine.append((ours.check(sender), ours.score(sender)))
            ref.append((theirs.check(sender), theirs.score(sender)))
        assert mine == ref
        assert {"rate-limited", "spam-score", None} <= {r for r, _ in mine}


class TestVerifyBatchParity:
    def test_same_verdicts_as_the_reference(self):
        atts = [make_att(i, sender=i % 5, bad_sig=i % 3 == 0) for i in range(12)]
        items = [work_item(a) for a in atts]
        assert verify_batch(GROUP_HASH, items) == ref_verify_batch(GROUP_HASH, items)
        assert verify_batch(GROUP_HASH, items) == [i % 3 != 0 for i in range(12)]


def ref_attestation(sender: int, scores, *, sign_scores=None, sk=None):
    """A reference attestation by group member ``sender`` (or by the
    outsider key ``sk``), signed over ``sign_scores`` (default: its
    own scores)."""
    sks, pks = ref_keyset(FIXED_SET)
    _, msgs = ref_message_hash(pks, [list(sign_scores or scores)])
    signer, pk = (sk, sk.public()) if sk is not None else (sks[sender], pks[sender])
    return ref_att.Attestation(
        sig=ref_sign(signer, pk, msgs[0]), pk=pk, neighbours=list(pks), scores=list(scores)
    )


def to_port(att: ref_att.Attestation) -> Attestation:
    """The same attestation as the port's object, through the wire form."""
    raw = ref_att.AttestationData.from_attestation(att).to_bytes()
    return AttestationData.from_bytes(raw, len(att.neighbours)).to_attestation(len(att.neighbours))


def seeded_stream(seed: int, n_items: int = 48):
    """A seeded admission stream over the bootstrap group: ``(burst,
    steps)``.  ``burst`` is submitted before the plane starts, into a
    submit queue of ``BURST_QUEUE`` slots (the rest shed).  Each step is
    ``(clock advance, rotate epochs, reference attestation, nonce)``."""
    rng = np.random.default_rng(seed)
    outsider = RefSecretKey.random(random.Random(seed))
    made: list[ref_att.Attestation] = []
    nonces = [0] * 5

    def row(d: int) -> list[int]:
        return [200 + d, 200 - d, 200, 200, 200]

    def fresh(sender: int):
        att = ref_attestation(sender, row(int(rng.integers(-150, 150))))
        made.append(att)
        return att

    burst = []
    for i in range(BURST_QUEUE + 4):
        sender = i % 5
        if i in (3, 7):
            burst.append((made[0], None))  # a replay inside the burst
            continue
        nonces[sender] += 1
        burst.append((fresh(sender), nonces[sender]))
    steps = []
    kinds = ["fresh"] * 5 + ["replay", "stale", "bad-sig", "bad-sig", "mismatch",
                             "outsider", "non-conserving", "nonceless"]
    for _ in range(n_items):
        dt = float(rng.choice([0.0, 0.0, 0.0, 0.05, 0.2, 1.0]))
        rotate = int(rng.random() < 0.08)
        sender = int(rng.integers(5))
        kind = kinds[int(rng.integers(len(kinds)))]
        nonce = None
        if kind == "fresh":
            nonces[sender] += 1
            att, nonce = fresh(sender), nonces[sender]
        elif kind == "nonceless":
            att = fresh(sender)
        elif kind == "replay":
            att = made[int(rng.integers(len(made)))]
        elif kind == "stale":
            att, nonce = fresh(sender), int(rng.integers(0, nonces[sender] + 1))
        elif kind == "bad-sig":
            d = int(rng.integers(-150, 150))
            att = ref_attestation(sender, row(d), sign_scores=row(d + 1))
            nonces[sender] += 1
            nonce = nonces[sender]
        elif kind == "mismatch":
            att = fresh(sender)
            att = ref_att.Attestation(
                sig=att.sig, pk=att.pk, neighbours=list(reversed(att.neighbours)),
                scores=att.scores,
            )
        elif kind == "outsider":
            att = ref_attestation(0, row(int(rng.integers(-150, 150))), sk=outsider)
        else:  # non-conserving
            att = ref_attestation(sender, [300, 200, 200, 200, 200])
        steps.append((dt, rotate, att, nonce))
    return burst, steps


#: Submit-queue slots of the stream's planes: the burst overfills it.
BURST_QUEUE = 12
STREAM_RATE = dict(rate=2.0, burst=3.0, spam_threshold=3.0)


def run_stream(package: str, burst, steps, workers: int = 0) -> tuple[list, dict]:
    """Push the stream through one package's plane, draining after each
    step so every verdict (and its feedback into the spam score) lands
    before the next admission: ``([(accepted, reason), ...], the
    manager's cache as {pk hash: scores})``."""
    clock = [0.0]
    if package == "port":
        manager = Manager(ManagerConfig(prover="commitment"))
        plane = IngestPlane(manager, IngestPlaneConfig(
            workers=workers, batch_size=4, submit_queue_max=BURST_QUEUE,
            rate=RateLimitConfig(**STREAM_RATE)))
        plane.policy = AdmissionPolicy(RateLimitConfig(**STREAM_RATE), clock=lambda: clock[0])
        convert = to_port
    else:
        manager = RefManager(RefManagerConfig(prover="commitment"))
        plane = RefIngestPlane(manager, RefIngestPlaneConfig(
            workers=0, batch_size=4, submit_queue_max=BURST_QUEUE,
            rate=RefRateLimitConfig(**STREAM_RATE)))
        plane.policy = RefAdmissionPolicy(RefRateLimitConfig(**STREAM_RATE), clock=lambda: clock[0])
        convert = lambda att: att  # noqa: E731
    try:
        futures = [plane.submit(convert(att), nonce=nonce) for att, nonce in burst]
        plane.start()
        assert plane.drain(60)
        for dt, rotate, att, nonce in steps:
            clock[0] += dt
            for _ in range(rotate):
                plane.advance_epoch()
            futures.append(plane.submit(convert(att), nonce=nonce))
            assert plane.drain(60)
        verdicts = [(f.result().accepted, f.result().reason) for f in futures]
    finally:
        plane.close()
    cache = {h: list(a.scores) for h, a in manager.attestations.items()}
    return verdicts, cache


@pytest.fixture(scope="module")
def stream():
    burst, steps = seeded_stream(31)
    return burst, steps, run_stream("reference", burst, steps)


class TestPlaneStreamParity:
    @pytest.mark.parametrize("workers", [0, 1])
    def test_same_verdicts_item_by_item(self, stream, workers):
        burst, steps, (ref_verdicts, ref_cache) = stream
        verdicts, cache = run_stream("port", burst, steps, workers=workers)
        assert len(verdicts) == len(burst) + len(steps)
        for i, (mine, ref) in enumerate(zip(verdicts, ref_verdicts)):
            assert mine == ref, (i, mine, ref)
        assert cache == ref_cache

    def test_stream_reaches_every_verdict(self, stream):
        _, _, (ref_verdicts, _) = stream
        reasons = {r for _, r in ref_verdicts}
        assert reasons >= {
            None, "duplicate", "stale-nonce", "bad-signature", "group-mismatch",
            "sender-not-in-group", "non-conserving-scores", "rate-limited",
            "spam-score", SHED_REASON,
        }, reasons

    def test_plane_agrees_with_the_direct_path(self, stream):
        """Where the plane's gates let an item through to the checks the
        direct path makes (structure, signature), both give the same
        verdict."""
        burst, steps, (ref_verdicts, _) = stream
        atts = [to_port(att) for att, _ in burst] + [to_port(att) for _, _, att, _ in steps]
        direct = Manager(ManagerConfig(prover="commitment")).add_attestations_bulk(atts)
        compared = 0
        for (accepted, reason), d in zip(ref_verdicts, direct):
            if reason in PLANE_ONLY:
                continue
            assert (accepted, reason) == (d.accepted, d.reason)
            compared += 1
        assert compared > len(atts) // 3

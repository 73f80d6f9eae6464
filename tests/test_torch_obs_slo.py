"""The port's SLO engine, pod trace stitcher and straggler watcher
(``protocol_tpu_torch.obs.{slo,podtrace,watchers}``) beside the
reference's.

The reference's suites re-targeted at the port: all of
``tests/test_podtrace.py`` (clock-offset estimation, the multi-host
stitcher under skewed and drifting clocks, out-of-order arrival and
partial stitches, exact skew math, the ``/trace/pod`` route, the
straggler watcher and the pod SLO objectives) and
``tests/test_obs_fleet.py::TestSLOEngine``.  Then parity: the same
published per-host files stitch to the same pod trace in both packages,
the same observations give the same straggler verdicts, and the same
objectives evaluate to the same document.
"""

from __future__ import annotations

import json

import pytest

from protocol_tpu_torch.obs.journal import JOURNAL
from protocol_tpu_torch.obs.metrics import POD_STRAGGLER
from protocol_tpu_torch.obs.podtrace import (
    POD_TRACES,
    PodTraceStore,
    clock_sync_samples,
    compute_phase_skew,
    directory_epochs,
    directory_hosts,
    estimate_offset,
    phase_durations,
    publish_epoch_trace,
    stitch_epoch,
)
from protocol_tpu_torch.obs.slo import SLOEngine, pod_objectives
from protocol_tpu_torch.obs.metrics import METRICS
from protocol_tpu_torch.obs.slo import SLObjective, default_objectives, seed_violation
from protocol_tpu_torch.obs.trace import Tracer
from protocol_tpu_torch.obs.watchers import StragglerWatcher


def _trace(start_monotonic: float, duration: float, phases: dict[str, tuple]):
    """A serialized epoch_tick tree: {phase: (start_offset_s, dur_s)}."""
    return {
        "name": "epoch_tick",
        "span_id": 1,
        "start_monotonic": start_monotonic,
        "start_offset_s": 0.0,
        "duration_s": duration,
        "attrs": {},
        "children": [
            {
                "name": name,
                "span_id": i + 2,
                "start_offset_s": off,
                "duration_s": dur,
                "attrs": {},
                "children": [],
            }
            for i, (name, (off, dur)) in enumerate(phases.items())
        ],
    }


def _sync(offset: float, base: float = 100.0, n: int = 3):
    """Exact sync samples for a host whose unix = monotonic + offset."""
    return [
        {"monotonic": base + i, "unix": base + i + offset} for i in range(n)
    ]


# ---------------------------------------------------------------------------
# clock offset estimation
# ---------------------------------------------------------------------------


class TestClockOffset:
    def test_exact_offset_recovered(self):
        assert estimate_offset(_sync(4_999_000.25)) == pytest.approx(
            4_999_000.25
        )

    def test_median_absorbs_preempted_pair(self):
        # One pair split by an 80s "preemption" between the clock
        # reads; the median ignores it (the NTP-filter argument).
        samples = _sync(5.0, n=2) + [{"monotonic": 200.0, "unix": 285.0}]
        assert estimate_offset(samples) == pytest.approx(5.0)

    def test_empty_and_malformed_samples(self):
        assert estimate_offset([]) is None
        assert estimate_offset([{"monotonic": 1.0}, "junk"]) is None

    def test_live_samples_pair_real_clocks(self):
        samples = clock_sync_samples(3)
        assert len(samples) == 3
        off = estimate_offset(samples)
        assert off is not None and off != 0.0


# ---------------------------------------------------------------------------
# exact skew + attribution math
# ---------------------------------------------------------------------------


class TestSkewMath:
    def test_max_minus_median(self):
        skew = compute_phase_skew({"plan": {0: 1.0, 1: 2.0, 2: 6.0}})
        assert skew == {"plan": pytest.approx(4.0)}

    def test_two_host_median_is_mean(self):
        skew = compute_phase_skew({"converge": {0: 0.1, 1: 0.5}})
        assert skew == {"converge": pytest.approx(0.2)}

    def test_single_host_phase_skipped(self):
        assert compute_phase_skew({"checkpoint": {0: 3.0}}) == {}

    def test_phase_durations_first_match_depth_first(self):
        t = _trace(0.0, 2.0, {"plan": (0.0, 0.5), "converge": (0.5, 1.0)})
        # A nested duplicate must not shadow the first (depth-first) hit.
        t["children"][0]["children"] = [
            {"name": "converge", "start_offset_s": 0.1, "duration_s": 9.9,
             "attrs": {}, "children": []}
        ]
        assert phase_durations(t) == {
            "plan": pytest.approx(0.5),
            "converge": pytest.approx(1.0),
        }


# ---------------------------------------------------------------------------
# publish + directory scan
# ---------------------------------------------------------------------------


class TestPublish:
    def test_publish_without_stored_trace_returns_none(self, tmp_path):
        t = Tracer()
        assert publish_epoch_trace(tmp_path, 0, 7, tracer=t) is None

    def test_round_trip_and_directory_scan(self, tmp_path):
        path = publish_epoch_trace(
            tmp_path, 3, 12,
            trace=_trace(10.0, 1.0, {"plan": (0.0, 1.0)}),
            sync=_sync(5.0),
        )
        assert path is not None and path.name == "podtrace-h003-e000012.json"
        rec = json.loads(path.read_text())
        assert rec["host"] == 3 and rec["epoch"] == 12
        assert directory_hosts(tmp_path, 12) == [3]
        assert directory_epochs(tmp_path) == [12]


# ---------------------------------------------------------------------------
# the stitcher
# ---------------------------------------------------------------------------


def _publish_pair(tmp_path, *, skew=0.0):
    """Two hosts with wildly different monotonic bases and clock
    offsets whose wall-time roots sit 0.1s apart; host 1's checkpoint
    runs ``skew`` seconds longer."""
    publish_epoch_trace(
        tmp_path, 0, 5,
        trace=_trace(1000.0, 2.0, {
            "plan": (0.0, 0.5), "converge": (0.5, 1.0),
            "checkpoint": (1.5, 0.3),
        }),
        sync=_sync(4_999_000.0, base=990.0),
        barrier={"enter_monotonic": 1000.5, "wait_seconds": 0.04},
    )
    publish_epoch_trace(
        tmp_path, 1, 5,
        trace=_trace(50.0, 1.9, {
            "plan": (0.0, 0.5), "converge": (0.5, 1.0),
            "checkpoint": (1.5, 0.3 + skew),
        }),
        sync=_sync(4_999_950.1, base=40.0),
        barrier={"enter_monotonic": 50.7, "wait_seconds": 0.01},
    )


class TestStitcher:
    def test_skewed_clocks_align_exactly(self, tmp_path):
        _publish_pair(tmp_path, skew=0.4)
        store = PodTraceStore()
        s = stitch_epoch(
            tmp_path, 5, expected_hosts=2, store=store,
            straggler_watcher=StragglerWatcher(),
        )
        assert s["complete"] and s["hosts"] == [0, 1]
        # Offsets recovered exactly despite disjoint monotonic bases.
        assert s["clock_offsets_s"]["0"] == pytest.approx(4_999_000.0)
        assert s["clock_offsets_s"]["1"] == pytest.approx(4_999_950.1)
        # host0 root lands at wall 5_000_000.0, host1 at +0.1.
        assert s["start_unix"] == pytest.approx(5_000_000.0)
        assert s["children"][1]["start_offset_s"] == pytest.approx(0.1)
        # Checkpoint skew: max 0.7 - median(mean of 0.3, 0.7) = 0.2.
        assert s["phase_skew_s"]["checkpoint"] == pytest.approx(0.2)
        assert s["phase_skew_s"]["converge"] == pytest.approx(0.0)
        # Barrier arrivals: 0.5 vs 0.1 + 0.7 -> spread 0.3.
        assert s["barrier"]["spread_s"] == pytest.approx(0.3)
        assert s["barrier"]["waits_s"] == {"0": 0.04, "1": 0.01}
        # Attribution: (0.5 + 1.0 + 0.3[+skew]) / root.
        assert s["phase_attribution"]["0"] == pytest.approx(0.9, abs=1e-3)
        assert store.get(5)["epoch"] == 5

    def test_drifting_clock_sample_noise_filtered(self, tmp_path):
        _publish_pair(tmp_path)
        # Corrupt host 1's file with one preempted sync pair; the
        # median keeps the stitch exact.
        path = tmp_path / "podtrace-h001-e000005.json"
        rec = json.loads(path.read_text())
        rec["clock_sync"].append({"monotonic": 40.0, "unix": 4_999_999_999.0})
        path.write_text(json.dumps(rec))
        s = stitch_epoch(tmp_path, 5, store=PodTraceStore(),
                         straggler_watcher=StragglerWatcher())
        assert s["clock_offsets_s"]["1"] == pytest.approx(4_999_950.1)

    def test_out_of_order_and_numeric_host_sort(self, tmp_path):
        # Arrival order 10, 2, 0 — the stitch must sort hosts
        # numerically (lexically "10" < "2").
        for host in (10, 2, 0):
            publish_epoch_trace(
                tmp_path, host, 3,
                trace=_trace(100.0 * host + 1.0, 1.0, {"plan": (0.0, 1.0)}),
                sync=_sync(-100.0 * host, base=100.0 * host + 0.5),
            )
        s = stitch_epoch(tmp_path, 3, store=PodTraceStore(),
                         straggler_watcher=StragglerWatcher())
        assert s["hosts"] == [0, 2, 10]
        assert [c["attrs"]["host"] for c in s["children"]] == [0, 2, 10]

    def test_missing_host_partial_stitch(self, tmp_path):
        _publish_pair(tmp_path)
        store = PodTraceStore()
        s = stitch_epoch(tmp_path, 5, expected_hosts=3, store=store,
                         straggler_watcher=StragglerWatcher())
        assert not s["complete"]
        assert s["missing_hosts"] == [2]
        assert store.last_missing_hosts() == 1

    def test_no_records_returns_none(self, tmp_path):
        assert stitch_epoch(tmp_path, 9) is None

    def test_degraded_record_without_sync_still_lands(self, tmp_path):
        _publish_pair(tmp_path)
        path = tmp_path / "podtrace-h001-e000005.json"
        rec = json.loads(path.read_text())
        rec["clock_sync"] = []
        path.write_text(json.dumps(rec))
        s = stitch_epoch(tmp_path, 5, store=PodTraceStore(),
                         straggler_watcher=StragglerWatcher())
        assert s["hosts"] == [0, 1]
        assert s["children"][1]["attrs"].get("clock_degraded") is True
        assert "1" not in s["clock_offsets_s"]

    def test_graft_parks_until_local_epoch_closes(self, tmp_path):
        # The stitching host's own epoch root may still be open (or not
        # yet stored) when the stitch lands — the pod_stitch span must
        # ride Tracer.graft's parking and attach once the root closes.
        _publish_pair(tmp_path)
        t = Tracer()
        s = stitch_epoch(tmp_path, 5, store=PodTraceStore(),
                         straggler_watcher=StragglerWatcher(), graft_into=t)
        assert s is not None
        assert t.get_trace(5) is None  # parked, nothing stored yet
        with t.epoch(5):
            pass
        names = [c["name"] for c in t.get_trace(5)["children"]]
        assert "pod_stitch" in names


# ---------------------------------------------------------------------------
# stitched-trace store ring
# ---------------------------------------------------------------------------


class TestPodTraceRoute:
    """GET /trace/pod through the node router — the serve half of the
    stitch exchange ("any host can answer")."""

    class _FakeConfig:
        def __init__(self, fleet_dir):
            self.fleet_dir = str(fleet_dir)

    class _FakeNode:
        def __init__(self, fleet_dir):
            self.config = TestPodTraceRoute._FakeConfig(fleet_dir)

    def test_latest_prefers_newer_published_epoch(self, tmp_path):
        """A host whose local store lags the exchange (it was not the
        tick-time stitcher) must serve the newest PUBLISHED epoch as
        latest, stitching it on demand — not its stale store entry."""
        from protocol_tpu_torch.node.server import handle_request

        POD_TRACES.reset()
        try:
            POD_TRACES.put(7, {"epoch": 7, "hosts": [0], "missing_hosts": []})
            for host in (0, 1):
                publish_epoch_trace(
                    tmp_path,
                    host,
                    9,
                    trace=_trace(
                        1000.0 + host,
                        1.0,
                        {"converge": (0.0, 0.5 + 0.2 * host)},
                    ),
                    sync=_sync(5_000.0, base=1000.0 + host),
                )
            status, body = handle_request(
                "GET",
                "/trace/pod/latest",
                None,
                node=self._FakeNode(tmp_path),
            )
            assert status == 200
            doc = json.loads(body)
            assert doc["epoch"] == 9
            assert doc["hosts"] == [0, 1]
        finally:
            POD_TRACES.reset()

    def test_store_only_serves_without_node(self):
        """The dryrun probe path: manager=None, node=None — the route
        answers from the stitch store alone."""
        from protocol_tpu_torch.node.server import handle_request

        POD_TRACES.reset()
        try:
            POD_TRACES.put(3, {"epoch": 3, "hosts": [0, 1], "missing_hosts": []})
            status, body = handle_request("GET", "/trace/pod/latest", None)
            assert status == 200
            assert json.loads(body)["epoch"] == 3
            status, _ = handle_request("GET", "/trace/pod/99", None)
            assert status == 404
        finally:
            POD_TRACES.reset()

    def test_no_epochs_anywhere_404s(self):
        from protocol_tpu_torch.node.server import handle_request

        POD_TRACES.reset()
        status, body = handle_request("GET", "/trace/pod/latest", None)
        assert status == 404
        assert "no pod epochs" in body


class TestPodTraceStore:
    def test_ring_eviction(self):
        store = PodTraceStore(keep_epochs=3)
        for e in range(5):
            store.put(e, {"epoch": e, "missing_hosts": []})
        assert store.epochs() == [2, 3, 4]
        assert store.latest_epoch() == 4
        assert store.get(0) is None

    def test_last_missing_tracks_newest_stitch(self):
        store = PodTraceStore()
        assert store.last_missing_hosts() is None
        store.put(1, {"missing_hosts": [2, 3]})
        assert store.last_missing_hosts() == 2
        store.put(2, {"missing_hosts": []})
        assert store.last_missing_hosts() == 0


# ---------------------------------------------------------------------------
# straggler watcher
# ---------------------------------------------------------------------------


class TestStragglerWatcher:
    def test_k_consecutive_epochs_flag(self):
        w = StragglerWatcher(ratio=1.5, k=2, min_seconds=0.05)
        slow = {"checkpoint": {0: 0.1, 1: 0.1, 2: 0.5}}
        r1 = w.observe(1, slow)
        assert r1["exceeded"] == {2: ["checkpoint"]} and not r1["flagged"]
        r2 = w.observe(2, slow)
        assert r2["flagged"] == [2]
        assert w.flagged() == {2: {"epoch": 2, "phases": ["checkpoint"],
                                   "streak": 2}}
        assert POD_STRAGGLER.value(host="2") == 1.0

    def test_clean_epoch_resets_streak_and_unflags(self):
        w = StragglerWatcher(ratio=1.5, k=2, min_seconds=0.05)
        slow = {"plan": {0: 0.1, 1: 0.9}}
        clean = {"plan": {0: 0.1, 1: 0.1}}
        w.observe(1, slow)
        w.observe(2, clean)  # streak broken before k
        w.observe(3, slow)
        assert w.observe(4, slow)["flagged"] == [1]
        w.observe(5, clean)
        assert w.flagged() == {}
        assert POD_STRAGGLER.value(host="1") == 0.0

    def test_min_seconds_floor_ignores_tiny_phases(self):
        w = StragglerWatcher(ratio=1.5, k=1, min_seconds=0.05)
        # 3x the median but only 2ms over it: microsecond-scale jitter.
        r = w.observe(1, {"plan": {0: 0.001, 1: 0.003}})
        assert r["exceeded"] == {} and not r["flagged"]

    def test_flag_journals_anomaly(self):
        w = StragglerWatcher(ratio=1.5, k=1, min_seconds=0.05)
        w.observe(7, {"converge": {0: 0.1, 1: 0.8}})
        events = [
            e for e in JOURNAL.tail(50)
            if e.get("kind") == "anomaly" and e.get("what") == "pod-straggler"
        ]
        assert events and events[-1]["host"] == 1

    def test_missing_host_keeps_streak(self):
        w = StragglerWatcher(ratio=1.5, k=2, min_seconds=0.05)
        w.observe(1, {"plan": {0: 0.1, 1: 0.9}})
        # Host 1 vanished (partial stitch) — its streak must survive.
        w.observe(2, {"plan": {0: 0.1}})
        assert w.observe(3, {"plan": {0: 0.1, 1: 0.9}})["flagged"] == [1]


# ---------------------------------------------------------------------------
# pod SLO objectives
# ---------------------------------------------------------------------------


class TestPodSLO:
    def test_stitch_completeness_reads_store(self):
        engine = SLOEngine()
        for obj in pod_objectives():
            engine.register(obj)
        POD_TRACES.put(1, {"missing_hosts": [3]})
        try:
            doc = engine.evaluate()
            comp = doc["objectives"]["pod-stitch-completeness"]
            assert comp["value"] == 1 and not comp["ok"]
            POD_TRACES.put(2, {"missing_hosts": []})
            doc = engine.evaluate()
            assert doc["objectives"]["pod-stitch-completeness"]["ok"]
        finally:
            POD_TRACES.reset()

    def test_skew_objective_trips_on_seeded_skew(self):
        from protocol_tpu_torch.obs.metrics import POD_PHASE_SKEW_SECONDS

        engine = SLOEngine()
        for obj in pod_objectives(phase_skew_p99_s=0.2):
            engine.register(obj)
        POD_PHASE_SKEW_SECONDS.observe(0.3, phase="checkpoint")
        doc = engine.evaluate()
        skew = doc["objectives"]["pod-phase-skew-p99"]
        assert skew["value"] is not None and skew["value"] > 0.2
        assert not skew["ok"] and not doc["ok"]


# ---------------------------------------------------------------------------
# tests/test_obs_fleet.py::TestSLOEngine
# ---------------------------------------------------------------------------


class TestSLOEngine:
    def test_ok_and_violation_verdicts(self):
        engine = SLOEngine()
        value = {"v": 1.0}
        engine.register(
            SLObjective(
                name="test-max",
                description="d",
                target=2.0,
                value_fn=lambda: value["v"],
            )
        )
        out = engine.evaluate()
        assert out["ok"] and out["objectives"]["test-max"]["ok"]
        value["v"] = 3.0
        out = engine.evaluate()
        assert not out["ok"]
        assert out["objectives"]["test-max"]["value"] == 3.0

    def test_no_data_counts_as_ok(self):
        engine = SLOEngine()
        engine.register(
            SLObjective(
                name="test-none", description="d", target=1.0, value_fn=lambda: None
            )
        )
        assert engine.evaluate()["ok"]

    def test_min_direction(self):
        engine = SLOEngine()
        engine.register(
            SLObjective(
                name="test-min",
                description="d",
                target=5.0,
                direction="min",
                value_fn=lambda: 4.0,
            )
        )
        assert not engine.evaluate()["ok"]

    def test_burn_rate_and_transition_counter(self):
        from protocol_tpu_torch.obs.metrics import SLO_VIOLATIONS

        engine = SLOEngine()
        value = {"v": 0.0}
        engine.register(
            SLObjective(
                name="test-burn",
                description="d",
                target=1.0,
                value_fn=lambda: value["v"],
                window=4,
            )
        )
        v0 = SLO_VIOLATIONS.value(objective="test-burn")
        engine.evaluate()  # ok
        value["v"] = 9.0
        engine.evaluate()  # violating (transition)
        engine.evaluate()  # still violating (no new transition)
        out = engine.evaluate()
        assert SLO_VIOLATIONS.value(objective="test-burn") == v0 + 1
        assert out["objectives"]["test-burn"]["burn_rate"] == 0.75

    def test_value_fn_exception_is_no_data(self):
        engine = SLOEngine()
        engine.register(
            SLObjective(
                name="test-raise",
                description="d",
                target=1.0,
                value_fn=lambda: 1 / 0,
            )
        )
        out = engine.evaluate()
        assert out["ok"]
        assert out["objectives"]["test-raise"]["value"] is None

    def test_default_objective_set(self):
        names = {o.name for o in default_objectives(epoch_interval_s=10)}
        assert {
            "freshness-p99",
            "proof-lag-p99",
            "epoch-cadence",
            "shed-rate",
            "residual-stall",
            "score-drift-linf",
        } <= names
        cadence = next(
            o for o in default_objectives(epoch_interval_s=10)
            if o.name == "epoch-cadence"
        )
        assert cadence.target == 30.0

    def test_seeded_violation_always_fails(self):
        engine = SLOEngine()
        seed_violation(engine)
        out = engine.evaluate()
        assert not out["ok"]
        assert not out["objectives"]["seeded-violation"]["ok"]

    def test_histogram_quantile(self):
        reg = type(METRICS)()
        h = reg.histogram("eigentrust_test_q", "t", buckets=(1.0, 2.0, 4.0))
        assert h.quantile(0.99) is None
        for v in (0.5, 1.5, 1.5, 3.0):
            h.observe(v)
        q50 = h.quantile(0.5)
        assert 1.0 <= q50 <= 2.0
        assert h.quantile(1.0) == 4.0
        h.observe(100.0)  # lands in +Inf: quantile clamps to last bound
        assert h.quantile(1.0) == 4.0


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _publish_both(directory, *, skew=0.4):
    """The pair of host files ``_publish_pair`` writes, through the
    reference's publisher into ``directory / "ref"`` and the port's into
    ``directory / "port"``."""
    from protocol_tpu.obs import podtrace as ref_podtrace

    for publish, sub in ((ref_podtrace.publish_epoch_trace, "ref"), (publish_epoch_trace, "port")):
        d = directory / sub
        for host, (base, dur, off, sync_base, wait) in enumerate(
            ((1000.0, 2.0, 4_999_000.0, 990.0, 0.04), (50.0, 1.9, 4_999_950.1, 40.0, 0.01))
        ):
            publish(
                d, host, 5,
                trace=_trace(base, dur, {
                    "plan": (0.0, 0.5), "converge": (0.5, 1.0),
                    "checkpoint": (1.5, 0.3 + (skew if host else 0.0)),
                }),
                sync=_sync(off, base=sync_base),
                barrier={"enter_monotonic": base + 0.5 + 0.2 * host, "wait_seconds": wait},
            )
    return directory / "ref", directory / "port"


def _without_clock_reads(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    doc.pop("stitched_unix", None)
    doc.pop("stitch_seconds", None)
    return doc


class TestParity:
    def test_published_files_are_the_same_json(self, tmp_path):
        ref_dir, port_dir = _publish_both(tmp_path)
        names = sorted(p.name for p in ref_dir.iterdir())
        assert names == sorted(p.name for p in port_dir.iterdir())
        for name in names:
            ours = json.loads((port_dir / name).read_text())
            theirs = json.loads((ref_dir / name).read_text())
            ours.pop("taken_unix", None)
            theirs.pop("taken_unix", None)
            assert ours == theirs

    def test_same_files_stitch_to_the_same_pod_trace(self, tmp_path):
        from protocol_tpu.obs import podtrace as ref_podtrace
        from protocol_tpu.obs.watchers import StragglerWatcher as RefStragglerWatcher

        ref_dir, _ = _publish_both(tmp_path)
        ours = stitch_epoch(ref_dir, 5, expected_hosts=3, store=PodTraceStore(),
                            straggler_watcher=StragglerWatcher())
        theirs = ref_podtrace.stitch_epoch(ref_dir, 5, expected_hosts=3,
                                           store=ref_podtrace.PodTraceStore(),
                                           straggler_watcher=RefStragglerWatcher())
        assert _without_clock_reads(ours) == _without_clock_reads(theirs)
        assert not ours["complete"] and ours["missing_hosts"] == [2]

    def test_straggler_verdicts_equal(self):
        import random

        from protocol_tpu.obs.watchers import StragglerWatcher as RefStragglerWatcher

        rng = random.Random(3)
        ours = StragglerWatcher(ratio=1.5, k=2, min_seconds=0.05)
        theirs = RefStragglerWatcher(ratio=1.5, k=2, min_seconds=0.05)
        for epoch in range(40):
            per_phase = {
                phase: {h: rng.choice((0.1, 0.12, 0.5, 0.9)) for h in range(rng.randint(1, 4))}
                for phase in ("plan", "converge", "checkpoint")
            }
            assert ours.observe(epoch, per_phase) == theirs.observe(epoch, per_phase)
            assert ours.flagged() == theirs.flagged()
            assert ours.streaks() == theirs.streaks()

    def test_same_objectives_evaluate_to_the_same_document(self):
        from protocol_tpu.obs import slo as ref_slo

        values = iter([0.5, 3.0, 3.0, 0.2, None, 7.0] * 2)
        seq = [next(values) for _ in range(12)]

        def engines(mod):
            engine = mod.SLOEngine()
            feed = iter(seq)
            engine.register(mod.SLObjective(name="max", description="d", target=2.0,
                                            value_fn=lambda: next(feed), window=4))
            engine.register(mod.SLObjective(name="min", description="d", target=1.0,
                                            direction="min", value_fn=lambda: 4.0))
            return engine

        ours, theirs = engines(__import__("protocol_tpu_torch.obs.slo", fromlist=["x"])), \
            engines(ref_slo)
        for _ in range(6):
            a, b = ours.evaluate(), theirs.evaluate()
            for doc in (a, b):
                doc.pop("evaluated_unix", None)
            assert a == b

    def test_default_objectives_equal(self):
        from protocol_tpu.obs import slo as ref_slo
        from protocol_tpu_torch.obs.slo import default_objectives

        def view(objs):
            return [(o.name, o.description, o.target, o.direction, o.window, o.unit)
                    for o in objs]

        kw = dict(epoch_interval_s=10, freshness_p99_s=120.0, proof_lag_p99_s=60.0)
        assert view(default_objectives(**kw)) == view(ref_slo.default_objectives(**kw))
        assert view(pod_objectives(phase_skew_p99_s=0.5)) == view(
            ref_slo.pod_objectives(phase_skew_p99_s=0.5))

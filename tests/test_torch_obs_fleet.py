"""The port's fleet observability (``protocol_tpu_torch.obs.fleet`` and
``obs.export``) beside the reference's.

The reference's suites (``tests/test_obs_fleet.py``: fleet aggregation,
snapshot staleness, lineage across the spawn boundary and through the
admission plane, worker flight dumps) re-targeted at the port; then
parity: the Prometheus exposition of equal registries and the merged
fleet exposition of the same snapshots are byte-identical to the
reference's, and a snapshot of the port's registry merges in the
reference's aggregator to the same text."""

from __future__ import annotations

import json
import math
import os

import pytest

from protocol_tpu.obs import export as ref_export
from protocol_tpu.obs import fleet as ref_fleet
from protocol_tpu.obs.metrics import MetricsRegistry as RefMetricsRegistry
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.obs import export
from protocol_tpu_torch.obs.fleet import (
    FleetAggregator,
    fleet_prometheus_text,
    load_directory,
    publish_snapshot,
    registry_snapshot,
)
from protocol_tpu_torch.obs.lineage import LINEAGE
from protocol_tpu_torch.obs.metrics import FRESHNESS_SECONDS, METRICS, MetricsRegistry


def _manager(prover: str = "commitment") -> Manager:
    mgr = Manager(ManagerConfig(prover=prover))
    mgr.generate_initial_attestations()
    return mgr


# ---------------------------------------------------------------------------
# Lineage across the spawn boundary
# ---------------------------------------------------------------------------


class TestLineageSpawnBoundary:
    def test_proof_job_carries_lineage_ids(self):
        mgr = _manager()
        t = LINEAGE
        # The tracker is process-global: entries an earlier test in this
        # process left applied but unbound would join epoch 5's cohort.
        t.reset()
        t.configure(1)
        try:
            lid = t.maybe_begin()
            t.mark(lid, "applied")
            t.bind_epoch(5)
            job = mgr.build_proof_job(Epoch(5))
            assert job.lineage == (lid,)
            assert all(isinstance(x, int) for x in job.lineage)
        finally:
            t.configure(0)
            t.reset()

    def test_unsampled_job_lineage_is_empty(self):
        LINEAGE.configure(0)
        LINEAGE.reset()
        mgr = _manager()
        job = mgr.build_proof_job(Epoch(5))
        assert job.lineage == ()

    def test_lineage_and_seed_are_independent(self):
        """Sampling must never perturb proof bytes: job_seed ignores
        the lineage payload."""
        from dataclasses import replace

        from protocol_tpu_torch.prover import job_seed

        mgr = _manager()
        job = mgr.build_proof_job(Epoch(6))
        assert job_seed(job) == job_seed(replace(job, lineage=(1, 2, 3)))

    def test_spawned_worker_echoes_lineage_and_ships_metrics(self):
        """The spawn-boundary round trip: a pooled worker returns the
        flat lineage tuple AND its own registry snapshot (pid differs
        from the parent's)."""
        from dataclasses import replace

        from protocol_tpu_torch.prover.workers import ProverPool

        mgr = _manager()
        job = replace(mgr.build_proof_job(Epoch(7)), lineage=(11, 23))
        pool = ProverPool(workers=1)
        try:
            result = pool.prove(job)
        finally:
            pool.close()
        assert result.lineage == (11, 23)
        assert result.metrics is not None
        assert result.metrics["pid"] != os.getpid()
        assert result.metrics["source"] == f"prover-{result.metrics['pid']}"
        # The worker's own span-fed histograms rode back with the proof.
        assert "eigentrust_phase_seconds" in result.metrics["metrics"]


# ---------------------------------------------------------------------------
# Fleet aggregation
# ---------------------------------------------------------------------------


class TestFleetAggregation:
    def test_snapshot_skips_empty_and_carries_pid(self):
        snap = registry_snapshot()
        assert snap["pid"] == os.getpid()
        assert snap["version"] == 1
        # skip_empty: only touched metrics ship.
        for entry in snap["metrics"].values():
            assert entry.get("samples") or entry.get("hist")

    def test_render_merges_with_process_labels(self):
        agg = FleetAggregator()
        reg_worker = type(METRICS)()  # fresh registry as "the worker"
        c = reg_worker.counter("eigentrust_test_fleet_total", "t", ("kind",))
        c.inc(3, kind="x")
        h = reg_worker.histogram("eigentrust_test_fleet_seconds", "t", buckets=(1.0,))
        h.observe(0.5)
        agg.ingest("worker-1", registry_snapshot(reg_worker, source="worker-1"))
        text = fleet_prometheus_text(aggregator=agg)
        assert (
            'eigentrust_test_fleet_total{kind="x",process="worker-1"} 3' in text
        )
        assert 'process="node"' in text
        assert (
            'eigentrust_test_fleet_seconds_count{process="worker-1"} 1' in text
        )

    def test_reingest_same_source_never_double_counts(self):
        agg = FleetAggregator()
        reg = type(METRICS)()
        c = reg.counter("eigentrust_test_refleet_total", "t")
        c.inc(5)
        snap = registry_snapshot(reg, source="w")
        agg.ingest("w", snap)
        agg.ingest("w", registry_snapshot(reg, source="w"))  # re-ship
        text = fleet_prometheus_text(aggregator=agg)
        assert 'eigentrust_test_refleet_total{process="w"} 5' in text
        assert text.count("eigentrust_test_refleet_total{") == 1

    def test_directory_exchange_round_trip(self, tmp_path):
        reg = type(METRICS)()
        reg.counter("eigentrust_test_dir_total", "t").inc(2)
        path = publish_snapshot(tmp_path, "A", reg)
        assert path.exists()
        # A half-written sibling must not break the merge.
        (tmp_path / "fleet-B.json").write_text("{not json")
        agg = FleetAggregator()
        ingested = load_directory(tmp_path, agg)
        assert ingested == ["proc-A"]
        text = fleet_prometheus_text(aggregator=agg)
        assert 'eigentrust_test_dir_total{process="proc-A"} 2' in text

    def test_directory_skips_own_pid(self, tmp_path):
        publish_snapshot(tmp_path, "self")
        agg = FleetAggregator()
        assert load_directory(tmp_path, agg, skip_pid=os.getpid()) == []

    def test_version_mismatch_is_skipped(self):
        agg = FleetAggregator()
        agg.ingest("old", {"version": 0, "metrics": {}})
        assert agg.sources() == []


class TestFleetStaleness:
    """Snapshot TTL: a silently dead host's last snapshot must drop out
    of the merge and surface as stale, not be trusted forever."""

    def _decoy(self, tmp_path, name: str, age_s: float, now: float):
        """A snapshot whose taken_unix is ``age_s`` in the fake past."""
        reg = type(METRICS)()
        reg.counter(f"eigentrust_test_stale_{name}_total", "t").inc(1)
        path = publish_snapshot(tmp_path, name, reg)
        snap = json.loads(path.read_text())
        snap["taken_unix"] = now - age_s
        path.write_text(json.dumps(snap))

    def test_decoy_stale_snapshot_evicted(self, tmp_path):
        from protocol_tpu_torch.obs.metrics import FLEET_STALE_SOURCES

        now = 1_000_000.0
        self._decoy(tmp_path, "dead", age_s=120.0, now=now)
        self._decoy(tmp_path, "live", age_s=3.0, now=now)
        agg = FleetAggregator()
        ingested = load_directory(
            tmp_path, agg, max_age_s=30.0, clock=lambda: now
        )
        assert ingested == ["proc-live"]
        assert agg.sources() == ["proc-live"]
        assert agg.stale() == {"proc-dead": pytest.approx(120.0)}
        assert FLEET_STALE_SOURCES.value() == 1.0
        text = fleet_prometheus_text(aggregator=agg)
        assert "eigentrust_test_stale_live_total" in text
        assert "eigentrust_test_stale_dead_total" not in text
        agg.reset()
        assert FLEET_STALE_SOURCES.value() == 0.0

    def test_fresh_reingest_clears_stale_mark(self, tmp_path):
        now = 1_000_000.0
        self._decoy(tmp_path, "flappy", age_s=120.0, now=now)
        agg = FleetAggregator()
        load_directory(tmp_path, agg, max_age_s=30.0, clock=lambda: now)
        assert "proc-flappy" in agg.stale()
        self._decoy(tmp_path, "flappy", age_s=1.0, now=now)  # came back
        load_directory(tmp_path, agg, max_age_s=30.0, clock=lambda: now)
        assert agg.stale() == {}
        assert agg.sources() == ["proc-flappy"]
        agg.reset()

    def test_no_ttl_keeps_old_snapshots(self, tmp_path):
        # Worker pools publish once and exit; without a TTL the old
        # keep-forever behavior must hold.
        now = 1_000_000.0
        self._decoy(tmp_path, "old", age_s=9_999.0, now=now)
        agg = FleetAggregator()
        assert load_directory(tmp_path, agg) == ["proc-old"]
        assert agg.stale() == {}
        agg.reset()


# ---------------------------------------------------------------------------
# Worker flight-recorder dumps (spawn-boundary post-mortems)
# ---------------------------------------------------------------------------


class TestWorkerFlightDumps:
    def test_collect_reads_journals_and_deletes(self, tmp_path):
        from protocol_tpu_torch.obs.journal import JOURNAL, collect_worker_dumps

        dump = tmp_path / "flight-prover-123.jsonl"
        events = [{"kind": "span", "name": "msm", "seq": i} for i in range(30)]
        dump.write_text("".join(json.dumps(e) + "\n" for e in events))
        recovered = collect_worker_dumps(tmp_path, pool="prover", tail_events=5)
        assert len(recovered) == 6  # tail_events + the dump marker slot
        assert recovered[-1]["name"] == "msm"
        assert not dump.exists()
        tail = JOURNAL.tail(5)
        assert any(e["kind"] == "worker-flight-tail" for e in tail)

    def test_collect_empty_or_missing_dir(self, tmp_path):
        from protocol_tpu_torch.obs.journal import collect_worker_dumps

        assert collect_worker_dumps(None, pool="x") == []
        assert collect_worker_dumps(tmp_path / "absent", pool="x") == []

    def test_worker_init_installs_sigterm_handler(self, tmp_path):
        """The worker-bootstrap half, exercised in a child process:
        install the handler, then deliver SIGTERM to itself."""
        import subprocess
        import sys

        code = f"""
import json, os, signal, sys
sys.path.insert(0, {json.dumps(os.getcwd())})
from protocol_tpu_torch.obs.journal import JOURNAL, install_worker_dump_handler
install_worker_dump_handler({json.dumps(str(tmp_path))}, pool="prover")
JOURNAL.record("test-event", n=1)
os.kill(os.getpid(), signal.SIGTERM)
"""
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, timeout=60
        )
        assert proc.returncode == 143, proc.stderr.decode()
        dumps = list(tmp_path.glob("flight-prover-*.jsonl"))
        assert len(dumps) == 1
        lines = [json.loads(x) for x in dumps[0].read_text().splitlines()]
        assert any(e.get("kind") == "test-event" for e in lines)
        assert lines[-1]["kind"] == "journal-dump"

    def test_terminated_prover_worker_leaves_its_tail(self):
        """The pool half: a worker killed by SIGTERM (a timed-out
        prover) dumps its ring, and the rebuilt pool collects it."""
        from protocol_tpu_torch.prover.workers import ProverPool

        pool = ProverPool(workers=1, timeout_s=60)
        try:
            pool.prewarm((2, 1, 1000, 1000), "commitment", None)
            gen = pool.generation
            pool._restart(gen)
            assert pool.generation == gen + 1
            tail = pool.take_flight_tail()
            assert tail and tail[-1]["kind"] == "journal-dump"
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# End-to-end: lineage through the ingest plane
# ---------------------------------------------------------------------------


class TestLineageThroughIngestPlane:
    def test_accepted_attestation_walks_the_stages(self):
        from protocol_tpu_torch.ingest import IngestPlane, IngestPlaneConfig

        mgr = _manager()
        LINEAGE.configure(1)
        LINEAGE.reset()
        before = FRESHNESS_SECONDS.count(stage="applied")
        atts = list(mgr.attestations.values())
        try:
            with IngestPlane(mgr, IngestPlaneConfig(workers=0)) as plane:
                future = plane.submit(atts[0])
                result = future.result(timeout=30)
                assert result.accepted, result
                assert plane.drain(timeout=30)
            assert FRESHNESS_SECONDS.count(stage="applied") == before + 1
            snap = LINEAGE.snapshot()
            assert snap["by_stage"].get("applied") == 1
            # The epoch absorbs it; its proof completes it.
            bound = LINEAGE.bind_epoch(12)
            assert len(bound) == 1
            assert len(LINEAGE.epoch_proved(12)) == 1
        finally:
            LINEAGE.configure(0)
            LINEAGE.reset()

    def test_rejected_attestation_drops_lineage(self):
        from protocol_tpu_torch.ingest import IngestPlane, IngestPlaneConfig

        mgr = _manager()
        LINEAGE.configure(1)
        LINEAGE.reset()
        atts = list(mgr.attestations.values())
        try:
            with IngestPlane(mgr, IngestPlaneConfig(workers=0)) as plane:
                # Same digest twice: the second dies in dedup.
                plane.submit(atts[0]).result(timeout=30)
                result = plane.submit(atts[0]).result(timeout=30)
                assert not result.accepted
                assert plane.drain(timeout=30)
            snap = LINEAGE.snapshot()
            assert snap["live"] == 1  # only the accepted one survives
        finally:
            LINEAGE.configure(0)
            LINEAGE.reset()


# ---------------------------------------------------------------------------
# Parity: the expositions are the reference's, byte for byte
# ---------------------------------------------------------------------------


def fill(registry) -> None:
    """The same metrics and samples in either package's registry:
    labelled and bare counters, a gauge, histograms observed and not,
    values that exercise the number format and label escaping."""
    c = registry.counter("eigentrust_par_events_total", 'help with "quotes"\nand \\', ("kind", "why"))
    c.inc(3, kind="x", why='quote " and \\ and\nnewline')
    c.inc(2.5, kind="y", why="")
    registry.counter("eigentrust_par_bare_total", "").inc(1e16)
    g = registry.gauge("eigentrust_par_depth", "depth", ("stage",))
    g.set(-0.125, stage="submit")
    g.set(math.inf, stage="verify")
    registry.gauge("eigentrust_par_unset", "never set")
    h = registry.histogram("eigentrust_par_seconds", "seconds", ("phase",), buckets=(0.001, 0.5, 2.0))
    for v in (0.0005, 0.3, 0.3, 1.5, 9.0):
        h.observe(v, phase="msm")
    h.observe(1e-9, phase="ntt")
    registry.histogram("eigentrust_par_idle_seconds", "unobserved", buckets=(1.0,))


def snapshot_pair(source: str) -> tuple[dict, dict]:
    ours, theirs = MetricsRegistry(), RefMetricsRegistry()
    fill(ours)
    fill(theirs)
    return (registry_snapshot(ours, source=source, skip_empty=False),
            ref_fleet.registry_snapshot(theirs, source=source, skip_empty=False))


class TestExpositionParity:
    def test_prometheus_text_byte_identical(self):
        ours, theirs = MetricsRegistry(), RefMetricsRegistry()
        fill(ours)
        fill(theirs)
        text = export.prometheus_text(ours)
        assert text == ref_export.prometheus_text(theirs)
        assert 'why="quote \\" and \\\\ and\\nnewline"' in text
        assert export.metrics_json(ours) == ref_export.metrics_json(theirs)

    def test_registry_snapshots_equal(self):
        ours, theirs = snapshot_pair("w")
        assert {k: v for k, v in ours.items() if k != "taken_unix"} == {
            k: v for k, v in theirs.items() if k != "taken_unix"
        }
        assert json.loads(json.dumps(ours))["metrics"] == ours["metrics"]

    @pytest.mark.parametrize("skip_empty", [True, False])
    def test_fleet_text_byte_identical_for_the_same_snapshots(self, skip_empty):
        local, ref_local = MetricsRegistry(), RefMetricsRegistry()
        local.counter("eigentrust_par_local_total", "local", ("k",)).inc(7, k="a")
        ref_local.counter("eigentrust_par_local_total", "local", ("k",)).inc(7, k="a")
        agg, ref_agg = FleetAggregator(), ref_fleet.FleetAggregator()
        for source in ("prover-12", "ingest-verify-7", "proc-A"):
            ours, _ = snapshot_pair(source)
            if skip_empty:
                ours["metrics"] = {k: v for k, v in ours["metrics"].items()
                                   if v.get("samples") or v.get("hist")}
            snap = json.loads(json.dumps(ours))  # as it crosses a process
            agg.ingest(source, snap)
            ref_agg.ingest(source, snap)
        text = fleet_prometheus_text(local, agg, local_process="node-7")
        assert text == ref_fleet.fleet_prometheus_text(ref_local, ref_agg, local_process="node-7")
        assert 'eigentrust_par_events_total{kind="x",why="quote \\" and \\\\ and\\nnewline",process="prover-12"} 3' in text
        assert 'eigentrust_par_local_total{k="a",process="node-7"} 7' in text

    def test_directory_merge_across_packages(self, tmp_path):
        """A snapshot the port publishes merges in the reference's
        aggregator, and the reference's in the port's, to equal text."""
        ours, theirs = MetricsRegistry(), RefMetricsRegistry()
        fill(ours)
        fill(theirs)
        publish_snapshot(tmp_path, "port", ours)
        ref_fleet.publish_snapshot(tmp_path, "ref", theirs)
        agg, ref_agg = FleetAggregator(), ref_fleet.FleetAggregator()
        assert load_directory(tmp_path, agg) == ref_fleet.load_directory(tmp_path, ref_agg)
        assert agg.sources() == ["proc-port", "proc-ref"]
        empty, ref_empty = MetricsRegistry(), RefMetricsRegistry()
        text = fleet_prometheus_text(empty, agg)
        assert text == ref_fleet.fleet_prometheus_text(ref_empty, ref_agg)
        port_rows = [ln.replace('process="proc-port"', "P") for ln in text.splitlines()
                     if 'process="proc-port"' in ln]
        ref_rows = [ln.replace('process="proc-ref"', "P") for ln in text.splitlines()
                    if 'process="proc-ref"' in ln]
        assert port_rows == ref_rows and port_rows


class TestProfileSession:
    def test_no_dir_is_a_no_op(self):
        with export.profile_session(None):
            pass

    def test_trace_written_on_the_cpu(self, tmp_path):
        import torch

        with export.profile_session(str(tmp_path)):
            torch.ones(8).sum()
        assert list(tmp_path.iterdir()), "the session wrote no trace"

"""The port's flight recorder, logging setup and score-drift monitor
(``protocol_tpu_torch/obs/{journal,trace,watchers}.py``) held to the
reference's suites (``tests/test_obs.py::TestFlightRecorder``,
``::TestConfigureLogging``, ``::TestScoreDriftMonitor``), case for case,
and to the reference package's own output: with the clock pinned, the
port's journal files, its dump and its ring are the reference's byte for
byte; a log record formats to the reference's line; the drift reports
are the reference's.
"""

from __future__ import annotations

import json
import logging
import time

import pytest

from protocol_tpu.obs import trace as ref_trace
from protocol_tpu.obs.journal import FlightRecorder as RefFlightRecorder
from protocol_tpu.obs.watchers import ScoreDriftMonitor as RefScoreDriftMonitor
from protocol_tpu_torch.obs import JOURNAL, TRACER
from protocol_tpu_torch.obs import metrics as obs_metrics
from protocol_tpu_torch.obs.journal import FlightRecorder
from protocol_tpu_torch.obs.trace import SpanContextFilter, configure_logging
from protocol_tpu_torch.obs.watchers import ScoreDriftMonitor


@pytest.fixture
def pinned_clock(monkeypatch):
    """Every ``time.time()`` reads one instant, so two journals' lines
    compare byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


class TestFlightRecorder:
    def test_ring_is_bounded_and_tail_ordered(self, pinned_clock):
        rec, ref = FlightRecorder(max_events=64), RefFlightRecorder(max_events=64)
        for i in range(500):
            rec.record("tick", i=i)
            ref.record("tick", i=i)
        assert len(rec) == 64
        tail = rec.tail(10)
        assert [e["i"] for e in tail] == list(range(490, 500))
        assert all(e["kind"] == "tick" for e in tail)
        seqs = [e["seq"] for e in rec.tail()]
        assert seqs == sorted(seqs)
        assert rec.tail() == ref.tail()

    def test_batched_writer_lands_events_on_disk(self, tmp_path, pinned_clock):
        written = []
        for cls, name in ((FlightRecorder, "port.jsonl"), (RefFlightRecorder, "ref.jsonl")):
            rec = cls(max_events=128).configure(tmp_path / name)
            for i in range(20):
                rec.record("span", name=f"s{i}", duration_s=0.1)
            rec.close()
            written.append((tmp_path / name).read_bytes())
        lines = [json.loads(x) for x in written[0].decode().splitlines()]
        assert [e["name"] for e in lines] == [f"s{i}" for i in range(20)]
        assert written[0] == written[1]

    def test_rotation_keeps_recent_window(self, tmp_path, pinned_clock):
        written = []
        for cls, name in ((FlightRecorder, "port.jsonl"), (RefFlightRecorder, "ref.jsonl")):
            rec = cls(max_events=50, max_bytes=2000).configure(tmp_path / name)
            for i in range(400):
                rec.record("tick", i=i)
            rec.close()
            written.append((tmp_path / name).read_bytes())
        assert len(written[0]) < 10_000  # bounded, not 400 lines' worth
        lines = [json.loads(x) for x in written[0].decode().splitlines()]
        assert lines  # the recent window survived
        assert lines[-1]["i"] == 399
        assert written[0] == written[1]

    def test_dump_writes_ring_plus_marker(self, tmp_path, pinned_clock):
        dumps = []
        for cls, name in ((FlightRecorder, "port"), (RefFlightRecorder, "ref")):
            rec = cls(max_events=32)
            for i in range(5):
                rec.record("tick", i=i)
            dumps.append(rec.dump(tmp_path / name / "mortem.jsonl", reason="test").read_bytes())
        lines = [json.loads(x) for x in dumps[0].decode().splitlines()]
        assert len(lines) == 6
        assert lines[-1]["kind"] == "journal-dump"
        assert lines[-1]["reason"] == "test" and lines[-1]["events"] == 5
        assert dumps[0] == dumps[1]

    def test_record_never_raises_on_unserializable(self, tmp_path):
        rec = FlightRecorder().configure(tmp_path / "j.jsonl")
        rec.record("weird", obj=object())  # json falls back to str()
        rec.close()
        line = json.loads((tmp_path / "j.jsonl").read_text().splitlines()[0])
        assert "object object" in line["obj"]

    def test_span_close_feeds_global_journal(self):
        before = len(JOURNAL.tail())
        with TRACER.span("journal_unit_phase"):
            pass
        events = JOURNAL.tail()
        assert len(events) > before
        assert any(e["kind"] == "span" and e.get("name") == "journal_unit_phase" for e in events)


class TestConfigureLogging:
    def _fresh_root(self):
        root = logging.getLogger()
        saved = (root.handlers[:], root.level)
        root.handlers[:] = []
        return root, saved

    def _restore(self, root, saved):
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])

    def test_installs_handler_on_pristine_root(self):
        root, saved = self._fresh_root()
        try:
            configure_logging()
            assert len(root.handlers) == 1
            handler = root.handlers[0]
            assert any(isinstance(f, SpanContextFilter) for f in handler.filters)
            # The format resolves: a record through the handler must not
            # raise on the %(epoch)s / %(span)s columns.
            record = logging.LogRecord("x", logging.INFO, __file__, 1, "hello", (), None)
            for f in handler.filters:
                f.filter(record)
            line = handler.format(record)
            assert "epoch=-" in line
            # The reference's handler formats the same record to the same line.
            root.handlers[:] = []
            ref_trace.configure_logging()
            assert root.handlers[0].format(record) == line
        finally:
            self._restore(root, saved)

    def test_respects_existing_root_handler(self):
        root, saved = self._fresh_root()
        try:
            mine = logging.StreamHandler()
            fmt = logging.Formatter("%(message)s")
            mine.setFormatter(fmt)
            root.addHandler(mine)
            configure_logging()
            configure_logging()  # idempotent
            assert root.handlers == [mine]  # no second handler
            assert mine.formatter is fmt  # formatter untouched
            # ...but the span filter was attached exactly once.
            assert len([f for f in mine.filters if isinstance(f, SpanContextFilter)]) == 1
        finally:
            self._restore(root, saved)

    def test_records_carry_span_context(self):
        holder = {}

        class Capture(logging.Handler):
            def emit(self, record):
                holder["r"] = record

        logger = logging.getLogger("protocol_tpu_torch.test_obs")
        handler = Capture()
        handler.addFilter(SpanContextFilter())
        logger.addHandler(handler)
        try:
            with TRACER.epoch(11):
                with TRACER.span("prove"):
                    logger.warning("inside")
            r = holder["r"]
            assert r.epoch == 11 and r.span == "prove" and r.span_id > 0
        finally:
            logger.removeHandler(handler)


class TestScoreDriftMonitor:
    def test_first_epoch_has_no_drift_then_l1_linf(self):
        reports = []
        for cls in (ScoreDriftMonitor, RefScoreDriftMonitor):
            mon = cls(top_k=2)
            first = mon.observe(1, [10, 11, 12], [0.5, 0.3, 0.2])
            second = mon.observe(2, [10, 11, 13], [0.4, 0.35, 0.25])
            reports.append((first, second, mon.last()))
        first, second, last = reports[0]
        assert first["l1"] is None and first["top_movers"] == []
        assert abs(second["l1"] - 0.15) < 1e-12
        assert abs(second["linf"] - 0.1) < 1e-12
        assert second["joined"] == 1 and second["departed"] == 1
        movers = second["top_movers"]
        assert movers[0]["peer_hash"] == hex(10)
        assert abs(movers[0]["delta"] + 0.1) < 1e-12
        assert last["epoch"] == 2
        assert reports[0] == reports[1]

    def test_residual_stall_detection(self):
        mon, ref = ScoreDriftMonitor(), RefScoreDriftMonitor()
        before = obs_metrics.RESIDUAL_STALLS.value()
        ok = mon.observe(1, [1], [1.0], residuals=[0.5, 0.4, 0.41, 0.2])
        assert ok["residual_increases"] == 1 and not ok["stalled"]
        bad = mon.observe(2, [1], [1.0], residuals=[0.5, 0.6, 0.4, 0.55])
        assert bad["residual_increases"] == 2 and bad["stalled"]
        assert obs_metrics.RESIDUAL_STALLS.value() == before + 1
        assert ref.observe(1, [1], [1.0], residuals=[0.5, 0.4, 0.41, 0.2]) == ok
        assert ref.observe(2, [1], [1.0], residuals=[0.5, 0.6, 0.4, 0.55]) == bad

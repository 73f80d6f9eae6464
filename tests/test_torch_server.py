"""The port's node server (``protocol_tpu_torch.node.server``): the
reference's HTTP and daemon suites re-targeted at the port, on the CPU
(``device="cpu"`` for the card backends, the commitment prover).

- ``tests/test_node.py``'s ``TestHandleRequest``, ``TestConfigAndFixtures``
  and ``TestNodeEndToEnd``;
- ``tests/test_obs.py``'s ``TestEndpoints`` and
  ``TestDeepAttributionEndpoints``;
- ``tests/test_obs_fleet.py``'s ``TestServerSurfaces``;
- ``tests/test_durability.py::test_healthz_walks_recovering_to_ok`` and
  ``tests/test_aux.py::test_node_restores_proof_from_checkpoint``;
- ``tests/test_epoch_pipeline.py::TestPipelinedNode``, driven through
  the pipeline's submit instead of the wall clock.

Then the port's own points: the config's ``device`` field, a ``tpu-*``
backend name refused when the node is built, the boot order over the
socket (``recovering``, then ``ok``, then the loops), the epoch loop's
Skip semantics and dropped-tick counter with a scripted clock, the
chain-event loop, and the async proving plane served over ``/proof``.
No test waits on the epoch clock: ticks are driven through
``Node._epoch_tick`` or the pipeline, and the loop's clock is scripted.
"""

from __future__ import annotations

import asyncio
import json
import re
import time

import numpy as np
import pytest

from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import SecretKey, sign
from protocol_tpu_torch.models.graphs import erdos_renyi
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import (
    FIXED_SET,
    INITIAL_SCORE,
    NUM_NEIGHBOURS,
    keyset_from_raw,
    read_bootstrap_csv,
)
from protocol_tpu_torch.node.checkpoint import CheckpointStore
from protocol_tpu_torch.node.config import ProtocolConfig
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.ethereum import AttestationCreatedEvent, FixtureEventSource
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.node.server import Node, handle_request, node_health
from protocol_tpu_torch.node.server import main as server_main
from protocol_tpu_torch.obs import METRICS, TIMELINE, TRACER
from protocol_tpu_torch.obs import metrics as obs_metrics
from protocol_tpu_torch.obs.slo import SLO_ENGINE, SLObjective
from protocol_tpu_torch.zk.proof import ProofRaw

LOCAL = ((127, 0, 0, 1), 0)

_LABEL_RE = r"[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    rf"(\{{{_LABEL_RE}(,{_LABEL_RE})*\}})?"
    r" (-?[0-9.]+(e[+-]?[0-9]+)?|\+Inf|-Inf|NaN)$"
)


def parse_prometheus(text: str) -> dict:
    """Every non-comment line must be a well-formed sample; returns
    {sample_name_with_labels: value} (``tests/test_obs.py``'s parser)."""
    samples = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ", line), line
            continue
        assert _SAMPLE_RE.match(line), f"unparseable sample line: {line!r}"
        name_labels, value = line.rsplit(" ", 1)
        samples[name_labels] = float(value)
    return samples


def make_attestation(sender_idx=0, scores=None) -> Attestation:
    sks, pks = keyset_from_raw(FIXED_SET)
    scores = scores or [200] * NUM_NEIGHBOURS
    _, msgs = calculate_message_hash(pks, [scores])
    sig = sign(sks[sender_idx], pks[sender_idx], msgs[0])
    return Attestation(sig=sig, pk=pks[sender_idx], neighbours=list(pks), scores=scores)


def node_config(**kw) -> ProtocolConfig:
    """A socket node on a free local port whose epoch clock never ticks
    in a test, on the CPU."""
    base = dict(epoch_interval=3600, endpoint=LOCAL, prover="commitment", device="cpu")
    base.update(kw)
    return ProtocolConfig(**base)


async def request(port: int, method: str, path: str, body: bytes = b""):
    """One HTTP/1.1 exchange; (status, headers, body bytes), or
    (None, {}, b"") when the server closed the connection unanswered."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = f"{method} {path} HTTP/1.1\r\nhost: t\r\n"
    if body:
        head += f"content-length: {len(body)}\r\n"
    writer.write((head + "\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    if not raw:
        return None, {}, b""
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers, payload


def port_of(node: Node) -> int:
    return node._server.sockets[0].getsockname()[1]


# ---------------------------------------------------------------------------
# tests/test_node.py
# ---------------------------------------------------------------------------


class TestHandleRequest:
    def _ready_manager(self):
        m = Manager(ManagerConfig(prover="commitment"))
        m.generate_initial_attestations()
        m.calculate_proofs(Epoch(0))
        return m

    def test_unknown_route_404(self):
        status, body = handle_request("GET", "/non_existing_route", Manager())
        assert (status, body) == (404, "InvalidRequest")

    def test_score_query(self):
        m = self._ready_manager()
        status, body = handle_request("GET", "/score", m)
        assert status == 200
        raw = ProofRaw.from_json(body)
        assert raw.to_proof().pub_ins == [INITIAL_SCORE] * NUM_NEIGHBOURS

    def test_score_without_proof_400(self):
        status, body = handle_request("GET", "/score", Manager())
        assert (status, body) == (400, "InvalidQuery")

    def test_post_rejected(self):
        status, _ = handle_request("POST", "/score", self._ready_manager())
        assert status == 404


class TestConfigAndFixtures:
    def test_protocol_config_parses_reference_shape(self):
        cfg = ProtocolConfig.load("data/protocol-config.json")
        assert cfg.epoch_interval == 10
        assert cfg.host == "0.0.0.0" and cfg.port == 3000
        assert cfg.trust_backend == "native-cpu"
        assert cfg.device is None

    def test_prover_config_parsed(self):
        cfg = ProtocolConfig.from_json('{"prover": "plonk", "srs_path": "/tmp/srs.bin"}')
        assert cfg.prover == "plonk" and cfg.srs_path == "/tmp/srs.bin"
        assert ProtocolConfig.from_json("{}").prover == "plonk"
        assert ProtocolConfig.from_json('{"prover": "commitment"}').prover == "commitment"

    def test_unknown_prover_rejected(self):
        with pytest.raises(ValueError, match="unknown prover"):
            Manager(ManagerConfig(prover="Plonk"))

    def test_bootstrap_csv(self):
        nodes = read_bootstrap_csv("data/bootstrap-nodes.csv")
        assert [n.name for n in nodes] == ["Alice", "Bob", "Charlie", "Chuck", "Craig"]
        assert nodes[0].secret_key().public() == keyset_from_raw(FIXED_SET)[1][0]

    def test_event_fixture_roundtrip(self, tmp_path):
        att = make_attestation()
        payload = AttestationData.from_attestation(att).to_bytes()
        ev = AttestationCreatedEvent(
            creator="0x" + "11" * 20, about="0x" + "00" * 20, key=bytes(32), val=payload
        )
        path = tmp_path / "events.jsonl"
        path.write_text(ev.to_json() + "\n")
        events = list(FixtureEventSource(path).replay())
        assert len(events) == 1
        decoded = AttestationData.from_bytes(events[0].val, NUM_NEIGHBOURS).to_attestation(
            NUM_NEIGHBOURS
        )
        assert decoded.pk == att.pk

    def test_pipeline_fields_parsed(self):
        cfg = ProtocolConfig.from_json(
            '{"epoch_pipeline": true, "warm_start": false, "plan_delta_max_churn": 0.2}'
        )
        assert (cfg.epoch_pipeline, cfg.warm_start, cfg.plan_delta_max_churn) == (True, False, 0.2)
        base = ProtocolConfig.from_json("{}")
        assert base.epoch_pipeline is False and base.warm_start is True


class TestNodeEndToEnd:
    def test_http_server_serves_score(self):
        async def scenario():
            node = Node.from_config(node_config())
            await node.start()
            node.manager.calculate_proofs(Epoch(0))
            response = await request(port_of(node), "GET", "/score")
            await node.stop()
            return response

        status, _, body = asyncio.run(scenario())
        assert status == 200
        raw = ProofRaw.from_json(body.decode())
        assert raw.to_proof().pub_ins == [INITIAL_SCORE] * NUM_NEIGHBOURS


# ---------------------------------------------------------------------------
# tests/test_obs.py
# ---------------------------------------------------------------------------


def ticked_manager(backend="cuda-sparse"):
    """A manager with one full epoch of work driven under the epoch
    trace root, exactly as Node._epoch_tick does."""
    m = Manager(ManagerConfig(prover="commitment", backend=backend, device="cpu"))
    m.generate_initial_attestations()
    with TRACER.epoch(4):
        with TRACER.span("prove"):
            m.calculate_proofs(Epoch(4))
        m.converge_epoch(Epoch(4), alpha=0.1)
    return m


class TestEndpoints:
    def test_metrics_endpoint_prometheus_parses(self):
        METRICS.reset()
        m = ticked_manager()
        status, body = handle_request("GET", "/metrics", m)
        assert status == 200
        samples = parse_prometheus(body)
        assert samples["eigentrust_graph_peers"] == 5
        assert samples["eigentrust_convergence_iterations"] >= 1

    def test_residual_histogram_length_equals_iterations(self):
        METRICS.reset()
        m = ticked_manager()
        result = m.cached_results[Epoch(4)]
        _, body = handle_request("GET", "/metrics", m)
        samples = parse_prometheus(body)
        assert samples["eigentrust_convergence_residual_count"] == result.iterations
        assert len(result.residuals) == result.iterations

    def test_trace_endpoint_span_tree_nesting(self):
        m = ticked_manager()
        status, body = handle_request("GET", "/trace/4", m)
        assert status == 200
        tree = json.loads(body)
        assert tree["name"] == "epoch_tick"
        names = [c["name"] for c in tree["children"]]
        assert names[0] == "prove"
        assert "build_graph" in names and "converge" in names
        prove_children = [c["name"] for c in tree["children"][0]["children"]]
        assert prove_children == ["power_iterate", "circuit_check", "snark"]

    def test_trace_latest_and_errors(self):
        m = ticked_manager()
        status, body = handle_request("GET", "/trace/latest", m)
        assert status == 200 and json.loads(body)["name"] == "epoch_tick"
        status, _ = handle_request("GET", "/trace/notanint", m)
        assert status == 400
        status, body = handle_request("GET", "/trace/123456789", m)
        assert status == 404 and "no trace" in json.loads(body)["error"]

    def test_status_lists_traced_epochs(self):
        m = ticked_manager()
        status, body = handle_request("GET", "/status", m)
        doc = json.loads(body)
        assert 4 in doc["traced_epochs"]
        assert doc["backend"] == "cuda-sparse"

    def test_metrics_content_type_over_socket(self):
        async def scenario():
            node = Node.from_config(node_config())
            await node.start()
            response = await request(port_of(node), "GET", "/metrics")
            await node.stop()
            return response

        status, headers, body = asyncio.run(scenario())
        assert status == 200
        assert headers["content-type"].startswith("text/plain; version=0.0.4")
        parse_prometheus(body.decode())

    def test_bulk_ingest_rejection_reasons_counted(self):
        METRICS.reset()
        good = make_attestation(0)
        bad_sig = make_attestation(1)
        bad_sig.sig = sign(SecretKey.random(), SecretKey.random().public(), 1)
        bad_sum = make_attestation(2, scores=[1, 0, 0, 0, 0])
        m = Manager()
        results = m.add_attestations_bulk([good, bad_sig, bad_sum])
        assert [r.accepted for r in results] == [True, False, False]
        assert obs_metrics.ATTESTATIONS_ACCEPTED.value() == 1
        assert obs_metrics.ATTESTATIONS_REJECTED.value(reason="bad-signature") == 1
        assert obs_metrics.ATTESTATIONS_REJECTED.value(reason="non-conserving-scores") == 1
        _, body = handle_request("GET", "/metrics", m)
        assert 'eigentrust_attestations_rejected_total{reason="bad-signature"} 1' in body

    def test_checkpoint_counters(self, tmp_path):
        METRICS.reset()
        store = CheckpointStore(tmp_path)
        store.save(Epoch(1), erdos_renyi(30, seed=2))
        store.load_latest()
        assert obs_metrics.CHECKPOINT_SAVES.value() == 1
        assert obs_metrics.CHECKPOINT_RESTORES.value() == 1


class TestDeepAttributionEndpoints:
    def test_drift_endpoint_after_tick(self):
        from protocol_tpu_torch.obs.watchers import DRIFT

        DRIFT.reset()
        m = ticked_manager()
        status, body = handle_request("GET", "/scores/drift", m)
        assert status == 200
        drift = json.loads(body)
        assert drift["epoch"] == 4
        assert drift["peers"] == 5
        assert "stalled" in drift and "top_movers" in drift

    def test_flight_endpoint_serves_jsonl_tail(self):
        m = ticked_manager()
        status, body = handle_request("GET", "/debug/flight", m)
        assert status == 200
        events = [json.loads(line) for line in body.splitlines() if line]
        assert events, "flight recorder empty after a full tick"
        assert "span" in {e["kind"] for e in events}
        status, limited = handle_request("GET", "/debug/flight?n=3", m)
        assert status == 200
        assert len(limited.splitlines()) == 3
        status, _ = handle_request("GET", "/debug/flight?n=bogus", m)
        assert status == 400

    def test_flight_tail_replays_ingest_rejection(self):
        from protocol_tpu_torch.obs import JOURNAL

        bad_sig = make_attestation(1)
        bad_sig.sig = sign(SecretKey.random(), SecretKey.random().public(), 1)
        m = Manager()
        m.add_attestations_bulk([bad_sig])
        rejects = [e for e in JOURNAL.tail() if e["kind"] == "ingest-reject"]
        assert rejects and rejects[-1]["reason"] == "bad-signature"


# ---------------------------------------------------------------------------
# tests/test_obs_fleet.py, tests/test_durability.py, tests/test_aux.py
# ---------------------------------------------------------------------------


def fleet_manager() -> Manager:
    m = Manager(ManagerConfig(prover="commitment"))
    m.generate_initial_attestations()
    return m


class TestServerSurfaces:
    def test_healthz_without_node_reports_from_globals(self):
        status, body = handle_request("GET", "/healthz", fleet_manager())
        health = json.loads(body)
        assert status in (200, 503)
        assert health["status"] in ("ok", "degraded", "failed")
        assert "epoch" in health["components"]

    def test_healthz_degraded_before_first_epoch_then_ok(self):
        TIMELINE.reset()
        status, health = node_health(None)
        assert status == 200
        assert health["status"] == "degraded"
        assert "no-epoch-yet" in health["degraded"]
        TIMELINE.record(1, tick_ended_unix=time.time())
        status, health = node_health(None)
        assert health["status"] == "ok"
        TIMELINE.reset()

    def test_healthz_failed_when_epoch_loop_stalls(self):
        TIMELINE.reset()
        TIMELINE.record(1, tick_ended_unix=time.time() - 1000.0)
        node = Node.from_config(ProtocolConfig(epoch_interval=2, prover="commitment", device="cpu"))
        status, health = node_health(node)
        assert status == 503
        assert health["status"] == "failed"
        assert "epoch-loop-stalled" in health["problems"]
        TIMELINE.reset()

    def test_timeline_endpoint(self):
        TIMELINE.record(41, phases={"converge": 0.5})
        mgr = fleet_manager()
        status, body = handle_request("GET", "/timeline/41", mgr)
        assert status == 200
        assert json.loads(body)["phases"]["converge"] == 0.5
        status, _ = handle_request("GET", "/timeline/latest", mgr)
        assert status == 200
        status, _ = handle_request("GET", "/timeline/999999999", mgr)
        assert status == 404
        status, _ = handle_request("GET", "/timeline/nope", mgr)
        assert status == 400
        TIMELINE.reset()

    def test_slo_endpoint_evaluates(self):
        SLO_ENGINE.register(
            SLObjective(name="test-endpoint", description="d", target=1.0, value_fn=lambda: 0.5)
        )
        try:
            status, body = handle_request("GET", "/slo", fleet_manager())
            assert status == 200
            assert json.loads(body)["objectives"]["test-endpoint"]["ok"]
        finally:
            SLO_ENGINE.unregister("test-endpoint")

    def test_fleet_scrape_endpoint(self):
        status, body = handle_request("GET", "/metrics/fleet", fleet_manager())
        assert status == 200
        assert 'process="node"' in body

    def test_healthz_walks_recovering_to_ok(self, tmp_path):
        cfg = ProtocolConfig(device="cpu")
        cfg.checkpoint_dir = str(tmp_path / "ckpt")
        node = Node.from_config(cfg)
        node._recovery = {"state": "recovering"}
        status, body = node_health(node)
        assert status == 200
        assert "recovering" in body["degraded"]
        assert body["components"]["recovery"]["state"] == "recovering"
        node._recovery = {"state": "ok", "wal_replayed": 5, "seconds": 0.1}
        status, body = node_health(node)
        assert "recovering" not in body["degraded"]
        assert body["components"]["recovery"]["wal_replayed"] == 5

    def test_node_restores_proof_from_checkpoint(self, tmp_path):
        """Restart path: a new node serves the checkpointed proof before
        any epoch has run."""
        m = Manager(ManagerConfig(prover="commitment"))
        m.generate_initial_attestations()
        m.calculate_proofs(Epoch(41))
        store = CheckpointStore(tmp_path)
        store.save(Epoch(41), m.build_graph(), None, m.get_proof(Epoch(41)).to_raw().to_json())

        async def scenario():
            node = Node.from_config(node_config(checkpoint_dir=str(tmp_path)))
            await node.start()
            status, body = handle_request("GET", "/score", node.manager)
            await node.stop()
            return status, body

        status, body = asyncio.run(scenario())
        assert status == 200
        assert ProofRaw.from_json(body).to_proof().pub_ins == m.get_proof(Epoch(41)).pub_ins


# ---------------------------------------------------------------------------
# tests/test_epoch_pipeline.py::TestPipelinedNode
# ---------------------------------------------------------------------------


class TestPipelinedNode:
    def test_node_ticks_through_pipeline(self):
        """``"epoch_pipeline": true`` routes epochs through the
        double-buffered engine; the second epoch warm starts and the
        shutdown drains in-flight work.  The epochs are submitted as the
        epoch loop submits them, without waiting on its clock."""

        async def scenario():
            node = Node.from_config(
                node_config(trust_backend="cuda-sparse", device="cpu", epoch_pipeline=True)
            )
            await node.start()
            assert node._pipeline is not None
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, node._pipeline.submit, Epoch(1))
            # The queue holds one epoch and a full queue coalesces, so epoch
            # 2 goes in only once the worker has taken epoch 1.
            deadline = 60.0
            while not node._pipeline._queue.empty() and deadline > 0:
                await asyncio.sleep(0.01)
                deadline -= 0.01
            await loop.run_in_executor(None, node._pipeline.submit, Epoch(2))
            deadline = 60.0
            while node._pipeline.completed < 2 and deadline > 0:
                await asyncio.sleep(0.05)
                deadline -= 0.05
            await node.stop()
            return node

        node = asyncio.run(scenario())
        assert node._pipeline.completed >= 2
        assert node.manager.last_scores is not None
        assert TRACER.latest_epoch() is not None
        assert node.manager.cached_results[Epoch(2)].backend == "cuda-sparse"


# ---------------------------------------------------------------------------
# The port's own points
# ---------------------------------------------------------------------------


class TestConfigDevice:
    def test_device_field_reaches_the_manager(self):
        cfg = ProtocolConfig.from_json('{"trust_backend": "cuda-windowed", "device": "cpu"}')
        assert cfg.device == "cpu"
        node = Node.from_config(cfg)
        assert node.manager.config.device == "cpu"
        assert str(node.manager.device) == "cpu"

    def test_device_unset_raises_without_a_card(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = ProtocolConfig.from_json('{"trust_backend": "cuda-windowed"}')
        assert cfg.device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Node.from_config(cfg)

    def test_default_backend_is_a_card_rung(self, monkeypatch):
        """A config that names no backend converges on the card, and
        raises where there is none: the CPU is only ever asked for."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = ProtocolConfig.from_json("{}")
        assert (cfg.trust_backend, cfg.device) == ("cuda-windowed", None)
        assert ProtocolConfig().trust_backend == "cuda-windowed"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Node.from_config(cfg)

    def test_entry_point_requires_a_config(self, capsys):
        with pytest.raises(SystemExit) as exc:
            server_main([])
        assert exc.value.code == 2
        assert "--config" in capsys.readouterr().err

    def test_host_backend_takes_no_device(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        node = Node.from_config(ProtocolConfig.load("data/protocol-config.json"))
        assert node.manager.device is None

    @pytest.mark.parametrize("name", ["tpu-windowed", "tpu-sparse", "tpu-sharded:tpu-windowed"])
    def test_tpu_backend_name_raises_when_the_node_is_built(self, name):
        cfg = ProtocolConfig(trust_backend=name, device="cpu")
        with pytest.raises(ValueError, match="unknown trust backend"):
            Node.from_config(cfg)


class _SmallPlonkProver:
    """The piece of a PLONK prover that aggregation reads: a ``vk`` and
    its transcript, here of the one-gate statement ``3·4 + 5 = 17`` on a
    small seeded setup, and ``prove(seed)``, a proof of it."""

    TRANSCRIPT = "poseidon"

    def __init__(self):
        from protocol_tpu_torch.zk import plonk
        from protocol_tpu_torch.zk.kzg import Setup

        self._plonk = plonk
        self._pk = plonk.compile_circuit(self._circuit(), srs=Setup.generate(6, seed=b"agg"))
        self.vk = self._pk.vk

    @staticmethod
    def _circuit():
        from protocol_tpu_torch.zk.cs import ConstraintSystem
        from protocol_tpu_torch.zk.gadgets import StdGate

        cs = ConstraintSystem()
        std = StdGate(cs)
        out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
        cs.copy(cs.assign(cs.column("instance", "instance"), 0, 17), out)
        return cs

    def prove(self, seed: bytes) -> bytes:
        return self._plonk.prove(self._pk, self._circuit(), [17], seed=seed,
                                 transcript=self.TRANSCRIPT)


class TestAggregateRoute:
    """``/aggregate`` answers as the reference's does: the bad queries
    its 400s, cached PLONK proofs a 200 body with the folded
    accumulator."""

    def test_bad_queries_answer_the_references_400s(self):
        mgr = Manager(ManagerConfig(prover="commitment"))
        for path in ("/aggregate", "/aggregate?epochs=", "/aggregate?epochs=x",
                     "/aggregate?epochs=9"):
            assert handle_request("GET", path, mgr) == (400, "InvalidQuery"), path

    def test_commitment_prover_rejects_aggregation(self):
        from protocol_tpu_torch.node.errors import EigenError

        mgr = Manager(ManagerConfig(prover="commitment"))
        mgr.generate_initial_attestations()
        mgr.calculate_proofs(Epoch(1))
        with pytest.raises(EigenError):
            mgr.aggregate_proofs([Epoch(1)])
        assert handle_request("GET", "/aggregate?epochs=1", mgr)[0] == 400

    def test_bad_query_over_the_socket(self):
        async def scenario():
            node = Node.from_config(node_config())
            await node.start()
            response = await request(port_of(node), "GET", "/aggregate?epochs=x")
            await node.stop()
            return response

        status, headers, body = asyncio.run(scenario())
        assert (status, body) == (400, b"InvalidQuery")
        assert headers["content-type"] == "application/json"

    def test_cached_plonk_proofs_answer_200_over_the_socket(self):
        """Two cached proofs fold into the accumulator ``accumulate``
        gives on the same proofs, served with ``ok`` true; a tampered
        member answers 200 with ``ok`` false, as the reference does."""
        from protocol_tpu_torch.zk.aggregator import Snark, accumulate
        from protocol_tpu_torch.zk.proof import Proof

        prover = _SmallPlonkProver()
        mgr = Manager(ManagerConfig(prover="plonk", device="cpu"), prover=prover)
        for n, seed in ((3, b"m0"), (7, b"m1")):
            mgr.cached_proofs[Epoch(n)] = Proof(pub_ins=[17], proof=prover.prove(seed))

        async def scenario(path):
            node = Node(config=node_config(prover="plonk", ingest_plane=False), manager=mgr)
            await node.start()
            response = await request(port_of(node), "GET", path)
            await node.stop()
            return response

        acc = accumulate([Snark(prover.vk, [17], mgr.cached_proofs[Epoch(n)].proof, "poseidon")
                          for n in (3, 7)])
        status, headers, body = asyncio.run(scenario("/aggregate?epochs=3,7"))
        assert status == 200 and headers["content-type"] == "application/json"
        assert json.loads(body) == {"ok": True, "epochs": [3, 7],
                                    "accumulator": acc.to_bytes().hex()}
        good = mgr.cached_proofs[Epoch(7)]
        bad = bytearray(good.proof)
        bad[11] ^= 1
        mgr.cached_proofs[Epoch(7)] = Proof(pub_ins=good.pub_ins, proof=bytes(bad))
        status, _, body = asyncio.run(scenario("/aggregate?epochs=3,7"))
        assert status == 200 and json.loads(body)["ok"] is False


class TestBootOrder:
    def test_socket_up_then_recovering_then_ok_then_loops(self, tmp_path):
        """The reference's boot order: the socket answers while recovery
        runs (``/healthz`` shows ``recovering``), then ``ok``, and the
        epoch and event loops start only after recovery landed."""
        from protocol_tpu_torch.node import server as server_mod

        seen = {}

        async def scenario():
            node = Node.from_config(node_config(checkpoint_dir=str(tmp_path / "ckpt")))
            real = node._recover_state
            loop = asyncio.get_running_loop()

            def slow_recover():
                seen["port"] = port_of(node)
                seen["tasks_during"] = len(node._tasks)
                fut = asyncio.run_coroutine_threadsafe(
                    request(seen["port"], "GET", "/healthz"), loop)
                seen["during"] = fut.result(timeout=30)
                real()

            node._recover_state = slow_recover
            await node.start()
            seen["after"] = await request(port_of(node), "GET", "/healthz")
            seen["tasks_after"] = len(node._tasks)
            await node.stop()

        asyncio.run(scenario())
        status, _, body = seen["during"]
        during = json.loads(body)
        assert status == 200 and during["components"]["recovery"]["state"] == "recovering"
        assert "recovering" in during["degraded"]
        assert seen["tasks_during"] == 0
        after = json.loads(seen["after"][2])
        assert after["components"]["recovery"]["state"] == "ok"
        assert "recovering" not in after["degraded"]
        assert seen["tasks_after"] == 2
        assert server_mod.HEALTH_VERDICTS == ("ok", "degraded", "failed")


class TestEpochLoop:
    def _run_loop(self, monkeypatch, numbers, tick):
        """Drive ``Node._epoch_loop`` with a scripted clock: no sleep,
        the boundaries ``numbers`` in turn, ``tick`` as the tick."""
        node = Node.from_config(node_config())
        script = iter(numbers)
        ran = []

        class Done(Exception):
            pass

        def current_epoch(interval):
            try:
                return Epoch(next(script))
            except StopIteration:
                raise Done from None

        monkeypatch.setattr(Epoch, "secs_until_next_epoch", staticmethod(lambda interval: 0))
        monkeypatch.setattr(Epoch, "current_epoch", staticmethod(current_epoch))

        def record(epoch):
            ran.append(epoch.number)
            tick(epoch)

        node._epoch_tick = record
        with pytest.raises(Done):
            asyncio.run(node._epoch_loop())
        return ran

    def test_skip_semantics_count_dropped_ticks(self, monkeypatch):
        before = obs_metrics.EPOCH_TICKS_DROPPED.value()
        ran = self._run_loop(monkeypatch, [3, 4, 7, 8, 10], lambda e: None)
        assert ran == [3, 4, 7, 8, 10]
        assert obs_metrics.EPOCH_TICKS_DROPPED.value() - before == 2 + 1

    def test_failed_tick_is_journaled_and_the_loop_goes_on(self, monkeypatch):
        from protocol_tpu_torch.obs import JOURNAL

        def tick(epoch):
            if epoch.number == 5:
                raise RuntimeError("boom")

        ran = self._run_loop(monkeypatch, [5, 6], tick)
        assert ran == [5, 6]
        failed = [e for e in JOURNAL.tail() if e.get("what") == "epoch-tick-failed"]
        assert failed and failed[-1]["epoch"] == 5 and "boom" in failed[-1]["error"]


class TestEventLoop:
    def test_fixture_events_reach_the_cache_through_the_plane(self, tmp_path):
        rows = [[0, 400, 300, 200, 100], [250, 0, 250, 250, 250]]
        path = tmp_path / "events.jsonl"
        path.write_text("".join(
            AttestationCreatedEvent(
                creator="0x" + f"{i + 1:040x}", about="0x" + "00" * 20, key=bytes(32),
                val=AttestationData.from_attestation(make_attestation(i, row)).to_bytes(),
            ).to_json() + "\n"
            for i, row in enumerate(rows)
        ))

        async def scenario():
            node = Node.from_config(node_config(event_fixture=str(path)))
            await node.start()
            deadline = time.monotonic() + 30
            want = sorted(map(tuple, rows))
            while time.monotonic() < deadline:
                got = sorted(tuple(a.scores) for a in node.manager.attestations.values())
                if all(r in got for r in want):
                    break
                await asyncio.sleep(0.05)
            stats = node._ingest.stats()
            await node.stop()
            return node, stats

        node, stats = asyncio.run(scenario())
        scores = sorted(tuple(a.scores) for a in node.manager.attestations.values())
        assert all(tuple(r) in scores for r in rows)
        assert stats["accepted"] >= 2


class TestTickOnTheNode:
    def test_tick_converges_checkpoints_and_serves(self, tmp_path):
        """One ``_epoch_tick`` on a ``cuda-windowed`` node on the CPU, run
        on the event loop's default executor as the epoch loop runs it:
        the proof, the converge on the node's device, the checkpoint
        with the window plan, and every read route answering."""

        async def scenario():
            node = Node.from_config(node_config(
                trust_backend="cuda-windowed", device="cpu",
                checkpoint_dir=str(tmp_path / "ckpt"), profile_dir=str(tmp_path / "prof"),
            ))
            await node.start()
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, node._epoch_tick, Epoch(7))
            port = port_of(node)
            out = {}
            for path in ("/score", "/proof/latest", "/proof/7", "/status", "/metrics",
                         "/metrics/fleet", "/slo", "/healthz", "/timeline/7", "/scores/drift",
                         "/debug/flight?n=5", "/trace/7", "/trace/pod", "/nope"):
                out[path] = await request(port, "GET", path)
            await node.stop()
            return node, out

        node, out = asyncio.run(scenario())
        assert {p: r[0] for p, r in out.items()} == {
            **{p: 200 for p in out}, "/trace/pod": 404, "/nope": 404}
        assert json.loads(out["/status"][2])["backend"] == "cuda-windowed"
        assert json.loads(out["/proof/7"][2])["state"] == "proved"
        result = node.manager.cached_results[Epoch(7)]
        assert result.backend == "cuda-windowed" and result.iterations > 0
        snap = CheckpointStore(tmp_path / "ckpt").load_latest()
        assert snap.epoch.number == 7 and snap.plan is not None
        np.testing.assert_array_equal(snap.scores, np.asarray(result.scores, np.float64))
        assert ProofRaw.from_json(snap.proof_json).to_json() == out["/score"][2].decode()
        assert list((tmp_path / "prof" / "epoch_7").iterdir())
        trace = json.loads(out["/trace/7"][2])
        assert [c["name"] for c in trace["children"]][0] == "prove"
        assert "checkpoint" in [c["name"] for c in trace["children"]]


class TestAsyncProvingNode:
    def test_ticks_enqueue_and_proof_route_serves_the_landed_proof(self, tmp_path):
        """``async_prover`` with ``prover_workers=0``: each tick enqueues
        its proof at the tick's end, the plane proves it on its
        dispatcher thread and installs it, and ``/proof/<n>`` serves the
        proof with its lifecycle; it equals the sync prove's bytes."""

        async def scenario():
            node = Node.from_config(node_config(
                trust_backend="cuda-windowed", device="cpu", async_prover=True,
                prover_workers=0, checkpoint_dir=str(tmp_path / "ckpt"),
            ))
            await node.start()
            loop = asyncio.get_running_loop()
            for k in (1, 2):
                await loop.run_in_executor(None, node._epoch_tick, Epoch(k))
            assert await loop.run_in_executor(None, node._prover_plane.drain, 30)
            out = {p: await request(port_of(node), "GET", p)
                   for p in ("/proof/1", "/proof/2", "/proof/latest", "/proof/3", "/healthz")}
            await node.stop()
            return node, out

        node, out = asyncio.run(scenario())
        for k in (1, 2):
            status, _, body = out[f"/proof/{k}"]
            doc = json.loads(body)
            assert status == 200 and doc["state"] == "proved" and doc["epoch"] == k
        assert json.loads(out["/proof/latest"][2])["epoch"] == 2
        assert out["/proof/3"][0] == 404
        health = json.loads(out["/healthz"][2])
        assert health["components"]["prover"]["configured"] is True
        assert health["components"]["prover"]["failed"] == 0
        sync = Manager(ManagerConfig(prover="commitment"))
        sync.generate_initial_attestations()
        sync.calculate_proofs(Epoch(2))
        assert node.manager.get_proof(Epoch(2)).proof == sync.get_proof(Epoch(2)).proof

"""The port's node server beside the reference's, on the same fixture.

A port node (``cuda-windowed`` on ``device="cpu"``) and a reference node
(``tpu-windowed``) boot on the same chain-event fixture, admit it
through their admission planes, and take ``_epoch_tick(Epoch(1))`` and
``(Epoch(2))`` as their epoch loops would.  Then, over each node's
socket:

- ``/score`` and ``/proof/<n>`` bodies are equal byte for byte;
- ``/status`` and ``/healthz`` are equal but for the backend's name and
  the timings;
- ``/metrics`` carries the same metric names;
- each checkpoint loads in the other package with the same graph,
  scores within rtol 1e-3 / atol 1e-8 and the same proof, and a node of
  each package booted on the other's checkpoint directory serves the
  other's ``/score`` bytes.

The same under ``prover="plonk"`` (the 2-peer statement on
``data/srs-15.bin``, keys from the disk cache), where ``/aggregate`` over
the proved epochs answers the same 200 body in both packages, directly
and over the socket.  Last, ``ProtocolConfig.load`` of the committed
config equals the reference's field for field.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest

from protocol_tpu.node import checkpoint as ref_ckpt
from protocol_tpu.node.config import ProtocolConfig as RefProtocolConfig
from protocol_tpu.node.epoch import Epoch as RefEpoch
from protocol_tpu.node.manager import Manager as RefManager
from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
from protocol_tpu.node.server import Node as RefNode
from protocol_tpu.prover.jobs import prover_for as ref_prover_for
from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.node import checkpoint
from protocol_tpu_torch.node.attestation import Attestation, AttestationData
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.config import ProtocolConfig
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.ethereum import AttestationCreatedEvent
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.node.server import Node
from protocol_tpu_torch.prover.jobs import prover_for

REPO = pathlib.Path(__file__).resolve().parent.parent
SRS = str(REPO / "data" / "srs-15.bin")
LOCAL = ((127, 0, 0, 1), 0)
#: Score rows of the bootstrap group that sum to SCALE and are not
#: uniform, so the open graph takes several iterations to converge.
ROWS = [
    [0, 400, 300, 200, 100],
    [250, 0, 250, 250, 250],
    [500, 300, 0, 100, 100],
    [100, 200, 300, 0, 400],
    [200, 200, 200, 400, 0],
]
#: The 2-peer statement's rows (k = 13 on the committed SRS).
ROWS2 = [[300, 700], [600, 400]]
PARAMS2 = (2, 1, 1000, 1000)
READ_ROUTES = ("/score", "/proof/1", "/proof/2", "/proof/latest", "/status", "/healthz",
               "/metrics", "/timeline/2", "/trace/pod", "/aggregate?epochs=x", "/nope")


def write_fixture(path: pathlib.Path, fixed_set, rows) -> pathlib.Path:
    """A JSONL of AttestationCreated events carrying each member's row."""
    sks, pks = keyset_from_raw(fixed_set)
    _, msgs = calculate_message_hash(pks, rows)
    lines = []
    for i, (row, msg) in enumerate(zip(rows, msgs)):
        att = Attestation(sig=sign(sks[i], pks[i], msg), pk=pks[i], neighbours=list(pks),
                          scores=list(row))
        lines.append(AttestationCreatedEvent(
            creator="0x" + f"{i + 1:040x}", about="0x" + "00" * 20, key=bytes(32),
            val=AttestationData.from_attestation(att).to_bytes(),
        ).to_json())
    path.write_text("\n".join(lines) + "\n")
    return path


async def request(port: int, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nhost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    if not raw:
        return None, {}, b""
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    return int(lines[0].split()[1]), dict(ln.split(": ", 1) for ln in lines[1:]), payload


def reset_globals():
    """Both packages' process-global registries to a fresh process's
    state, so the surfaces compare only what this test did."""
    import protocol_tpu.obs as ref_obs
    import protocol_tpu.utils.telemetry as ref_tel
    import protocol_tpu_torch.obs as obs
    import protocol_tpu_torch.utils.telemetry as tel

    for pkg, t in ((obs, tel), (ref_obs, ref_tel)):
        for reg in (pkg.METRICS, pkg.TIMELINE, pkg.TRACER, pkg.SLO_ENGINE, pkg.DRIFT):
            reg.reset()
        t.TELEMETRY.reset()


def scores_of(manager) -> dict[int, set]:
    return sorted(tuple(a.scores) for a in manager.attestations.values())


async def run_pair(ours: Node, theirs: RefNode, rows, epochs=(1, 2), routes=READ_ROUTES):
    """Boot both nodes, wait until each admitted the fixture, tick both,
    read every route from both sockets, stop both."""
    await ours.start()
    await theirs.start()
    want = sorted(map(tuple, rows))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if scores_of(ours.manager) == want and scores_of(theirs.manager) == want:
            break
        await asyncio.sleep(0.05)
    assert scores_of(ours.manager) == want and scores_of(theirs.manager) == want
    loop = asyncio.get_running_loop()
    for k in epochs:
        await loop.run_in_executor(None, ours._epoch_tick, Epoch(k))
        await loop.run_in_executor(None, theirs._epoch_tick, RefEpoch(k))
    out = {}
    for path in routes:
        out[path] = (await request(ours._server.sockets[0].getsockname()[1], path),
                     await request(theirs._server.sockets[0].getsockname()[1], path))
    await ours.stop()
    await theirs.stop()
    return out


def metric_names(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def without_timings(health: dict) -> dict:
    health = json.loads(json.dumps(health))
    health["components"]["epoch"].pop("seconds_since_last_tick")
    health["components"]["recovery"].pop("seconds", None)
    return health


def check_cross_load(port_dir, ref_dir, rtol=1e-3, atol=1e-8):
    """Each package's snapshot loads in the other with the same graph,
    proof and scores."""
    for directory in (port_dir, ref_dir):
        mine = checkpoint.CheckpointStore(directory).load_latest()
        theirs = ref_ckpt.CheckpointStore(directory).load_latest()
        assert mine.epoch.number == theirs.epoch.number == 2
        for got, want in ((mine.graph.src, theirs.graph.src), (mine.graph.dst, theirs.graph.dst),
                          (mine.graph.weight, theirs.graph.weight)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mine.scores, theirs.scores)
        assert mine.proof_json == theirs.proof_json
        assert mine.attestations == theirs.attestations
    port_snap = checkpoint.CheckpointStore(port_dir).load_latest()
    ref_snap = ref_ckpt.CheckpointStore(ref_dir).load_latest()
    np.testing.assert_allclose(port_snap.scores, ref_snap.scores, rtol=rtol, atol=atol)
    assert port_snap.proof_json == ref_snap.proof_json


async def serve_score(node) -> bytes:
    await node.start()
    status, _, body = await request(node._server.sockets[0].getsockname()[1], "/score")
    await node.stop()
    assert status == 200
    return body


class TestCommitmentNodes:
    def test_surfaces_and_checkpoints_equal_the_references(self, tmp_path):
        reset_globals()
        fixture = write_fixture(tmp_path / "events.jsonl", FIXED_SET, ROWS)
        common = dict(epoch_interval=3600, endpoint=LOCAL, prover="commitment",
                      event_fixture=str(fixture), wal_fsync=False)
        ours = Node.from_config(ProtocolConfig(
            trust_backend="cuda-windowed", device="cpu", checkpoint_dir=str(tmp_path / "port"),
            **common))
        theirs = RefNode.from_config(RefProtocolConfig(
            trust_backend="tpu-windowed", checkpoint_dir=str(tmp_path / "ref"), **common))
        out = asyncio.run(run_pair(ours, theirs, ROWS))

        for path in ("/score", "/proof/1", "/proof/2", "/proof/latest", "/timeline/2",
                     "/trace/pod", "/aggregate?epochs=x", "/nope"):
            (s1, h1, b1), (s2, h2, b2) = out[path]
            assert s1 == s2, path
            assert h1["content-type"] == h2["content-type"], path
            if path != "/timeline/2":
                assert b1 == b2, path
        assert out["/score"][0][0] == 200 and json.loads(out["/proof/2"][0][2])["epoch"] == 2
        timeline = [json.loads(r[2]) for r in out["/timeline/2"]]
        assert set(timeline[0]) == set(timeline[1])
        assert set(timeline[0]["phases"]) == set(timeline[1]["phases"])

        status = [json.loads(r[2]) for r in out["/status"]]
        assert (status[0]["backend"], status[1]["backend"]) == ("cuda-windowed", "tpu-windowed")
        for doc in status:
            doc.pop("backend")
            doc["telemetry"]["timers"] = sorted(doc["telemetry"]["timers"])
        assert status[0] == status[1]

        health = [without_timings(json.loads(r[2])) for r in out["/healthz"]]
        assert out["/healthz"][0][0] == out["/healthz"][1][0] == 200
        assert health[0] == health[1]
        assert health[0]["status"] == "ok"

        ours_names, theirs_names = (metric_names(r[2].decode()) for r in out["/metrics"])
        assert ours_names == theirs_names

        # Epoch 1 converges cold, epoch 2 warm from epoch 1's fixed point.
        for k, cold in ((1, True), (2, False)):
            res = ours.manager.cached_results[Epoch(k)]
            ref_res = theirs.manager.cached_results[RefEpoch(k)]
            assert res.iterations == ref_res.iterations
            assert (res.iterations > 1) == cold
            np.testing.assert_allclose(res.scores, ref_res.scores, rtol=1e-3, atol=1e-8)
        check_cross_load(tmp_path / "port", tmp_path / "ref")

        # A node of each package boots on the other's checkpoint directory
        # (snapshot, then the WAL tail) and serves the other's /score.
        quiet = dict(epoch_interval=3600, endpoint=LOCAL, prover="commitment", wal_fsync=False)
        port_on_ref = Node.from_config(ProtocolConfig(
            trust_backend="cuda-windowed", device="cpu", checkpoint_dir=str(tmp_path / "ref"),
            **quiet))
        ref_on_port = RefNode.from_config(RefProtocolConfig(
            trust_backend="tpu-windowed", checkpoint_dir=str(tmp_path / "port"), **quiet))
        assert asyncio.run(serve_score(port_on_ref)) == out["/score"][1][2]
        assert asyncio.run(serve_score(ref_on_port)) == out["/score"][0][2]
        assert scores_of(port_on_ref.manager) == scores_of(theirs.manager)
        np.testing.assert_allclose(port_on_ref.manager.last_scores, ref_res.scores,
                                   rtol=1e-3, atol=1e-8)


class TestPlonkNodes:
    def test_plonk_surfaces_equal_and_aggregate_is_the_one_difference(self, tmp_path):
        """Every PLONK surface, ``/aggregate`` included, answers as the
        reference's does."""
        reset_globals()
        group = dict(num_neighbours=2, num_iter=1, fixed_set=list(FIXED_SET[:2]))
        fixture = write_fixture(tmp_path / "events.jsonl", FIXED_SET[:2], ROWS2)
        common = dict(epoch_interval=3600, endpoint=LOCAL, prover="plonk", srs_path=SRS,
                      event_fixture=str(fixture), wal_fsync=False)
        ours = Node(
            config=ProtocolConfig(trust_backend="cuda-windowed", device="cpu",
                                  checkpoint_dir=str(tmp_path / "port"), **common),
            manager=Manager(ManagerConfig(backend="cuda-windowed", device="cpu", srs_path=SRS,
                                          **group), prover=prover_for(PARAMS2, "plonk", SRS)),
        )
        theirs = RefNode(
            config=RefProtocolConfig(trust_backend="tpu-windowed",
                                     checkpoint_dir=str(tmp_path / "ref"), **common),
            manager=RefManager(RefManagerConfig(backend="tpu-windowed", srs_path=SRS, **group),
                               prover=ref_prover_for(PARAMS2, "plonk", SRS)),
        )
        assert ours.manager.config.check_circuit and theirs.manager.config.check_circuit
        out = asyncio.run(run_pair(ours, theirs, ROWS2,
                                   routes=("/score", "/proof/1", "/proof/2", "/status")))
        for path in ("/score", "/proof/1", "/proof/2"):
            (s1, _, b1), (s2, _, b2) = out[path]
            assert (s1, b1) == (s2, b2), path
        proof = ours.manager.get_proof(Epoch(2))
        assert ours.manager.prover.verify(proof.pub_ins, proof.proof)
        assert json.loads(out["/score"][0][2])["backend"] == "plonk"
        check_cross_load(tmp_path / "port", tmp_path / "ref")

        from protocol_tpu.node.server import handle_request as ref_handle_request
        from protocol_tpu_torch.node.server import handle_request

        # /aggregate: the same accumulator, byte for byte, in the same body.
        status, body = ref_handle_request("GET", "/aggregate?epochs=1,2", theirs.manager)
        assert status == 200 and json.loads(body)["ok"] is True
        assert handle_request("GET", "/aggregate?epochs=1,2", ours.manager) == (status, body)
        ok, acc = ours.manager.aggregate_proofs([Epoch(1), Epoch(2)])
        assert ok and acc.to_bytes().hex() == json.loads(body)["accumulator"]

        async def over_the_socket():
            node = Node(config=ProtocolConfig(epoch_interval=3600, endpoint=LOCAL,
                                              prover="plonk", ingest_plane=False),
                        manager=ours.manager)
            await node.start()
            port = node._server.sockets[0].getsockname()[1]
            got = await request(port, "/aggregate?epochs=1,2")
            still = await request(port, "/score")
            await node.stop()
            return got, still

        got, still = asyncio.run(over_the_socket())
        assert (got[0], got[2]) == (200, body.encode()), got
        assert still[0] == 200 and still[2] == out["/score"][0][2]


class TestConfigParity:
    def test_committed_config_loads_field_for_field(self):
        ours = dataclasses.asdict(ProtocolConfig.load(REPO / "data" / "protocol-config.json"))
        theirs = dataclasses.asdict(RefProtocolConfig.load(REPO / "data" / "protocol-config.json"))
        assert ours.pop("device") is None
        assert ours == theirs

    def test_defaults_and_every_field_parse_the_same(self):
        fields = {f.name for f in dataclasses.fields(RefProtocolConfig)}
        assert {f.name for f in dataclasses.fields(ProtocolConfig)} == fields | {"device"}
        # The port's two own defaults: the card (device None) and a card
        # rung where the reference defaults to its host backend.
        ours = dataclasses.asdict(ProtocolConfig())
        assert (ours.pop("device"), ours.pop("trust_backend")) == (None, "cuda-windowed")
        theirs = dataclasses.asdict(RefProtocolConfig())
        assert theirs.pop("trust_backend") == "native-cpu"
        assert ours == theirs
        doc = {
            "epoch_interval": 7, "endpoint": [[127, 0, 0, 1], 4000], "trust_backend": "x",
            "event_fixture": "e.jsonl", "checkpoint_dir": "c", "wal": False, "wal_dir": "w",
            "wal_segment_bytes": 99, "wal_fsync": False, "chaos": {"seed": 1},
            "epoch_pipeline": True, "warm_start": False, "plan_delta_max_churn": 0.5,
            "ingest_plane": False, "ingest_workers": 2, "ingest_batch_size": 8,
            "ingest_queue_max": 9, "ingest_rate_rps": 1.5, "ingest_rate_burst": 2.5,
            "ingest_whitelist_pretrusted": False, "prover": "commitment", "async_prover": True,
            "prover_workers": 3, "prover_queue_max": 4, "prove_timeout_s": 5.0,
            "prover_omp_threads": 6, "srs_path": "s", "profile_dir": "p", "journal_path": "j",
            "lineage_sample_every": 0, "fleet_dir": "f", "slo_freshness_p99_s": 1.0,
            "slo_proof_lag_p99_s": 2.0, "fleet_stale_after_s": 3.0, "straggler_ratio": 4.0,
            "straggler_epochs": 5, "slo_pod_skew_p99_s": 6.0, "device": "cpu",
        }
        ours = dataclasses.asdict(ProtocolConfig.from_json(json.dumps(doc)))
        theirs = dataclasses.asdict(RefProtocolConfig.from_json(json.dumps(doc)))
        assert ours.pop("device") == "cpu"
        assert ours == theirs

"""The port's asynchronous proving plane (``protocol_tpu_torch.prover``)
beside the reference's (``protocol_tpu.prover``).

The reference's suite (``tests/test_prover_plane.py``) re-targeted at
the port: the flat ``ProofJob``, the lifecycle state machine, supersede
under backpressure, crash recovery in spawned workers, the per-process
prover cache, the span graft and the server's ``/proof/<epoch>`` route
(its bodies equal the reference's but for the timings).  Then parity
and the port's own field:

- the port's sync (``Manager.calculate_proofs``), in-process
  (``prove_job``) and pooled (a spawned, prewarmed worker) PLONK proofs
  of one statement equal the reference's ``prove_job`` bytes for the
  same ``ProofJob`` payload (2 peers, the committed ``data/srs-15.bin``,
  the disk key cache);
- ``ProofJob.zk_device`` carries the node's device to the prove: a
  graft prove on a dispatcher thread with ``zk_device="cpu"`` equals
  the native one, and with ``zk_device=None`` and no card it raises —
  it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import time

import pytest
import torch

from protocol_tpu.prover.jobs import ProofJob as RefProofJob
from protocol_tpu.prover.jobs import job_seed as ref_job_seed
from protocol_tpu.prover.jobs import prove_job as ref_prove_job
from protocol_tpu_torch.node.bootstrap import FIXED_SET
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.prover import (
    CRASH_MARKER,
    ProofJob,
    ProvingPlane,
    ProvingPlaneConfig,
    crash_once_marker,
    job_seed,
    prove_job,
)
from protocol_tpu_torch.prover import jobs as jobs_mod
from protocol_tpu_torch.prover.jobs import prover_for

SRS = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "srs-15.bin")


def _manager(prover: str = "commitment", n: int | None = None, **kw) -> Manager:
    cfg = (
        ManagerConfig(prover=prover, **kw)
        if n is None
        else ManagerConfig(
            prover=prover,
            num_neighbours=n,
            num_iter=1,
            fixed_set=list(FIXED_SET[:n]),
            **kw,
        )
    )
    mgr = Manager(cfg)
    mgr.generate_initial_attestations()
    return mgr


# ---------------------------------------------------------------------------
# The reference's suite, re-targeted at the port
# ---------------------------------------------------------------------------


class TestProofJob:
    def test_job_is_flat_and_picklable(self):
        mgr = _manager()
        job = mgr.build_proof_job(Epoch(1))
        clone = pickle.loads(pickle.dumps(job))
        assert clone == job
        assert all(isinstance(x, int) for row in job.ops for x in row)
        assert len(job.sigs) == len(job.pks) == len(job.ops) == 5

    def test_seed_binds_the_statement(self):
        mgr = _manager()
        j1 = mgr.build_proof_job(Epoch(1))
        j2 = mgr.build_proof_job(Epoch(1))
        assert job_seed(j1) == job_seed(j2)
        # A different epoch or a perturbed score row changes the seed.
        assert job_seed(j1) != job_seed(mgr.build_proof_job(Epoch(2)))
        rows = [list(r) for r in j1.ops]
        rows[0][0] += 1
        perturbed = ProofJob(
            epoch=j1.epoch,
            ops=tuple(tuple(r) for r in rows),
            sigs=j1.sigs,
            pks=j1.pks,
            params=j1.params,
            prover=j1.prover,
        )
        assert job_seed(j1) != job_seed(perturbed)

    def test_prove_job_spans_carry_attribution(self):
        mgr = _manager()
        result = prove_job(mgr.build_proof_job(Epoch(3)))
        names = [c["name"] for c in result.spans["children"]]
        assert names == ["power_iterate", "circuit_check", "snark"]
        assert result.spans["name"] == "prove"
        assert result.prove_seconds > 0


class TestLifecycle:
    def test_submit_to_proved(self):
        from protocol_tpu_torch.obs.metrics import PROOF_LAG_EPOCHS

        mgr = _manager()
        landed = []
        with ProvingPlane(
            ProvingPlaneConfig(workers=0),
            on_proved=lambda r: landed.append(r.epoch),
        ) as plane:
            status = plane.submit(mgr.build_proof_job(Epoch(4)))
            assert status.state in ("queued", "proving", "proved")
            assert plane.drain(timeout=30)
            final = plane.status(4)
            assert final.state == "proved"
            assert final.prove_seconds > 0
            assert final.lag_seconds >= final.prove_seconds * 0.5
            assert landed == [4]
            assert PROOF_LAG_EPOCHS.value() == 0
            assert plane.stats()["completed"] == 1

    def test_supersede_keeps_newest_never_drops_silently(self):
        from protocol_tpu_torch.obs.metrics import PROOFS_SUPERSEDED

        mgr = _manager()
        superseded0 = PROOFS_SUPERSEDED.value()
        jobs = {
            k: dataclasses.replace(mgr.build_proof_job(Epoch(k)), chaos="sleep:0.4")
            for k in range(1, 5)
        }
        with ProvingPlane(ProvingPlaneConfig(workers=0, queue_depth=1)) as plane:
            for k in range(1, 5):
                plane.submit(jobs[k])
            assert plane.drain(timeout=60)
            states = {k: plane.status(k).state for k in range(1, 5)}
        # Epoch 1 went straight to a dispatcher; 2 and 3 were displaced
        # from the one-slot queue by their successors; 4 (the newest)
        # must prove.  Nothing may be missing or failed.
        assert states[4] == "proved", states
        assert all(s in ("proved", "superseded") for s in states.values()), states
        assert "superseded" in states.values(), states
        sup = [k for k, s in states.items() if s == "superseded"]
        assert 4 not in sup
        assert PROOFS_SUPERSEDED.value() - superseded0 == len(sup)
        for k in sup:
            assert plane.status(k).reason.startswith("superseded-by-")

    def test_queue_never_blocks_submit(self):
        mgr = _manager()
        with ProvingPlane(ProvingPlaneConfig(workers=0, queue_depth=1)) as plane:
            t0 = time.perf_counter()
            for k in range(1, 8):
                job = mgr.build_proof_job(Epoch(k))
                plane.submit(dataclasses.replace(job, chaos="sleep:0.3"))
            submit_wall = time.perf_counter() - t0
            assert submit_wall < 0.5, submit_wall  # 7 submits, ~0 blocking
            assert plane.drain(timeout=60)

    def test_undrained_close_resolves_stragglers(self):
        mgr = _manager()
        plane = ProvingPlane(ProvingPlaneConfig(workers=0, queue_depth=2)).start()
        for k in (1, 2, 3):
            job = mgr.build_proof_job(Epoch(k))
            plane.submit(dataclasses.replace(job, chaos="sleep:0.5"))
        plane.close(drain=False)
        states = {k: plane.status(k).state for k in (1, 2, 3) if plane.status(k)}
        assert states, "lifecycle lost the queued epochs"
        assert all(
            s in ("proved", "failed", "superseded") for s in states.values()
        ), states


class TestCrashRecovery:
    def test_crash_once_retries_to_proved(self, tmp_path):
        from protocol_tpu_torch.obs.metrics import PROVER_WORKER_RESTARTS

        mgr = _manager()
        restarts0 = PROVER_WORKER_RESTARTS.value()
        job = dataclasses.replace(
            mgr.build_proof_job(Epoch(6)),
            chaos=crash_once_marker(str(tmp_path / "crash.flag")),
        )
        with ProvingPlane(
            ProvingPlaneConfig(workers=1, max_retries=1, prove_timeout_s=120)
        ) as plane:
            gen0 = plane.pool.generation
            plane.submit(job)
            assert plane.drain(timeout=120)
            status = plane.status(6)
            assert status.state == "proved", status
            # The crash rebuilt the executor exactly once (generation
            # guard) and counted a restart.
            assert plane.pool.generation == gen0 + 1
        assert PROVER_WORKER_RESTARTS.value() - restarts0 == 1
        assert (tmp_path / "crash.flag").exists()

    def test_crash_past_retries_fails_with_reason(self):
        from protocol_tpu_torch.obs.metrics import PROOFS_FAILED

        mgr = _manager()
        failed0 = PROOFS_FAILED.value()
        job = dataclasses.replace(mgr.build_proof_job(Epoch(7)), chaos=CRASH_MARKER)
        with ProvingPlane(
            ProvingPlaneConfig(workers=1, max_retries=1, prove_timeout_s=120)
        ) as plane:
            plane.submit(job)
            assert plane.drain(timeout=120)
            status = plane.status(7)
            assert status.state == "failed"
            assert status.reason == "prover-crashed"
            assert plane.stats()["failed"] == 1
        assert PROOFS_FAILED.value() - failed0 == 1


class TestBitEquality:
    def test_commitment_sync_inline_and_pooled_identical(self):
        mgr = _manager()
        mgr.calculate_proofs(Epoch(9))
        sync_proof = mgr.cached_proofs[Epoch(9)]
        inline = prove_job(mgr.build_proof_job(Epoch(9)))
        assert inline.proof == sync_proof.proof
        assert list(inline.pub_ins) == list(sync_proof.pub_ins)
        with ProvingPlane(
            ProvingPlaneConfig(workers=1, prove_timeout_s=120),
            on_proved=lambda r: mgr.install_proof(r.epoch, r.pub_ins, r.proof),
        ) as plane:
            plane.submit(mgr.build_proof_job(Epoch(10)))
            assert plane.drain(timeout=120)
        pooled = mgr.cached_proofs[Epoch(10)]
        # Epoch 10's pooled proof must equal its in-process equivalent.
        assert pooled.proof == prove_job(mgr.build_proof_job(Epoch(10))).proof


class TestOmpThreads:
    def test_omp_threads_is_kept_and_changes_no_bits(self):
        """The reference's knob, kept for parity: a worker gets
        ``OMP_NUM_THREADS``, but the port's zk runtime is built without
        OpenMP, so the proof (and the speed) stay the same."""
        from protocol_tpu_torch.prover.workers import ProverPool
        from protocol_tpu_torch.zk import native as znative

        flags = znative.CXX_FLAGS + tuple(f for fs in znative.SOURCE_FLAGS.values() for f in fs)
        assert not any("openmp" in f for f in flags)
        job = _manager().build_proof_job(Epoch(5))
        pool = ProverPool(workers=1, omp_threads=3)
        try:
            assert pool.prove(job).proof == prove_job(job).proof
            _, executor = pool._snapshot()
            assert executor.submit(os.getenv, "OMP_NUM_THREADS").result(60) == "3"
        finally:
            pool.close()


class TestProverCache:
    def test_prover_cached_per_params(self):
        p1 = prover_for((5, 10, 1000, 1000), "commitment", None)
        p2 = prover_for((5, 10, 1000, 1000), "commitment", None)
        p3 = prover_for((2, 1, 1000, 1000), "commitment", None)
        assert p1 is p2
        assert p1 is not p3


class TestTraceGraft:
    def test_graft_into_stored_trace(self):
        from protocol_tpu_torch.obs.trace import Tracer

        tracer = Tracer()
        with tracer.epoch(1):
            with tracer.span("converge"):
                pass
        assert tracer.graft(1, {"name": "prove", "children": []})
        names = [c["name"] for c in tracer.get_trace(1)["children"]]
        assert names == ["converge", "prove"]
        # Under a named parent, depth-first.
        assert tracer.graft(1, {"name": "snark"}, parent_name="prove")
        prove = tracer.get_trace(1)["children"][1]
        assert prove["children"][0]["name"] == "snark"

    def test_early_graft_pends_until_trace_stores(self):
        from protocol_tpu_torch.obs.trace import Tracer

        tracer = Tracer()
        # The async proof lands while epoch 2's root span is still
        # open: the graft parks and applies when the trace stores.
        assert not tracer.graft(2, {"name": "prove", "children": []})
        with tracer.epoch(2):
            pass
        names = [c["name"] for c in tracer.get_trace(2)["children"]]
        assert names == ["prove"]

    def test_graft_for_evicted_epoch_is_dropped(self):
        from protocol_tpu_torch.obs.trace import Tracer

        tracer = Tracer(keep_epochs=2)
        for k in (1, 2, 3):
            with tracer.epoch(k):
                pass
        assert not tracer.graft(1, {"name": "prove"})
        assert tracer.get_trace(1) is None

    def test_plane_grafts_the_prove_under_the_epoch_trace(self):
        from protocol_tpu_torch.obs import TRACER

        mgr = _manager()
        with TRACER.epoch(906):
            with TRACER.span("converge"):
                pass
        with ProvingPlane(ProvingPlaneConfig(workers=0)) as plane:
            plane.submit(mgr.build_proof_job(Epoch(906)))
            assert plane.drain(timeout=60)
        prove = next(c for c in TRACER.get_trace(906)["children"] if c["name"] == "prove")
        assert [c["name"] for c in prove["children"]] == ["power_iterate", "circuit_check", "snark"]


# ---------------------------------------------------------------------------
# PLONK proofs: the port's three paths against the reference's prove_job
# ---------------------------------------------------------------------------


def ref_job(job: ProofJob) -> RefProofJob:
    """The reference's ``ProofJob`` with the same payload (the port's
    one extra field, ``zk_device``, has no counterpart)."""
    fields = {f.name for f in dataclasses.fields(RefProofJob)}
    return RefProofJob(**{k: v for k, v in dataclasses.asdict(job).items() if k in fields})


@pytest.fixture(scope="module")
def plonk_manager():
    """A default-configuration 2-peer node of the port (``prover="plonk"``,
    ``check_circuit=True``) on the committed SRS; the parent builds (or
    loads) the disk key cache first, as a node does before its workers
    prewarm."""
    mgr = _manager(prover="plonk", n=2, srs_path=SRS)
    mgr.warm_prover()
    return mgr


@pytest.fixture(scope="module")
def reference_proof(plonk_manager):
    return ref_prove_job(ref_job(plonk_manager.build_proof_job(Epoch(12))))


class TestPlonkPaths:
    def test_seed_is_the_references(self, plonk_manager):
        job = plonk_manager.build_proof_job(Epoch(12))
        assert job_seed(job) == ref_job_seed(ref_job(job))
        assert job_seed(dataclasses.replace(job, zk_device="cuda:3", zk_backend="graft")) == job_seed(job)

    def test_sync_equals_the_reference_prove_job(self, plonk_manager, reference_proof):
        plonk_manager.calculate_proofs(Epoch(12))
        sync = plonk_manager.cached_proofs[Epoch(12)]
        assert sync.proof == reference_proof.proof
        assert list(sync.pub_ins) == list(reference_proof.pub_ins)

    def test_in_process_equals_the_reference_prove_job(self, plonk_manager, reference_proof):
        result = prove_job(plonk_manager.build_proof_job(Epoch(12)))
        assert result.proof == reference_proof.proof
        assert result.pub_ins == tuple(reference_proof.pub_ins)
        assert result.lineage == () and result.metrics["pid"] == os.getpid()
        snark = next(c for c in result.spans["children"] if c["name"] == "snark")
        assert {"msm", "ntt", "witness_gen"} <= {c["name"] for c in snark["children"]}

    def test_pooled_equals_the_reference_prove_job(self, plonk_manager, reference_proof):
        from protocol_tpu_torch.obs.fleet import FLEET

        cfg = plonk_manager.config
        results = []
        with ProvingPlane(
            ProvingPlaneConfig(workers=1, prove_timeout_s=600),
            on_proved=results.append,
        ) as plane:
            plane.prewarm((cfg.num_neighbours, cfg.num_iter, cfg.initial_score, cfg.scale),
                          cfg.prover, cfg.srs_path)
            plane.submit(plonk_manager.build_proof_job(Epoch(12)))
            assert plane.drain(timeout=600)
            assert plane.status(12).state == "proved"
        (result,) = results
        assert result.proof == reference_proof.proof
        assert result.pub_ins == tuple(reference_proof.pub_ins)
        # The worker's registry merged into the fleet under its source.
        assert result.metrics["pid"] != os.getpid()
        assert result.metrics["source"] in FLEET.sources()


# ---------------------------------------------------------------------------
# ProofJob.zk_device: the node's device reaches the prove
# ---------------------------------------------------------------------------


def mul_add_statement():
    """out = 3*4 + 5 bound to the public instance: a real PLONK circuit
    small enough to prove under graft's plain versions in seconds."""
    from protocol_tpu_torch.zk import cs, gadgets

    c = cs.ConstraintSystem()
    std = gadgets.StdGate(c)
    out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
    c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
    return c, [17]


class SmallPlonkProver:
    """A stand-in epoch prover for ``prover_for``'s cache: whatever the
    statement, it proves the small circuit with the job's seed under
    the active engine, so ``prove_job``'s backend and device selection
    is exercised by a real PLONK prove."""

    def __init__(self):
        from protocol_tpu_torch.zk import kzg, plonk

        self.plonk = plonk
        self.circuit, self.instance = mul_add_statement()
        self.pk = plonk.compile_circuit(self.circuit, srs=kzg.Setup.generate(5, seed=b"plane-small"))
        self.engines = []

    def prove(self, pub_ins, witness, *, seed=None):
        from protocol_tpu_torch.zk import graft as zk_graft

        engine = (zk_graft.zk_backend(),
                  str(zk_graft.zk_device()) if zk_graft.zk_backend() == "graft" else None)
        self.engines.append(engine)
        return self.plonk.prove(self.pk, self.circuit, self.instance, seed=seed, transcript="keccak")

    def verify(self, pub_ins, proof):
        return self.plonk.verify(self.pk.vk, self.instance, proof, transcript="keccak")


@pytest.fixture
def small_prover():
    """A job whose ``prover_for`` key maps to :class:`SmallPlonkProver`."""
    mgr = _manager(prover="plonk", n=2, check_circuit=False, srs_path="small-plonk-statement")
    job = mgr.build_proof_job(Epoch(3))
    key = (tuple(job.params), job.prover, job.srs_path)
    prover = jobs_mod._PROVERS[key] = SmallPlonkProver()
    try:
        yield job, prover
    finally:
        jobs_mod._PROVERS.pop(key, None)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestZkDevice:
    def test_build_proof_job_carries_the_nodes_device(self):
        mgr = _manager(backend="cuda-windowed", device="cpu", zk_backend="graft")
        job = mgr.build_proof_job(Epoch(1))
        assert (job.zk_backend, job.zk_device) == ("graft", "cpu")
        assert _manager().build_proof_job(Epoch(1)).zk_device is None  # the card
        assert _manager(device="cpu").build_proof_job(Epoch(1)).zk_device == "cpu"
        assert pickle.loads(pickle.dumps(job)) == job

    def test_graft_on_a_dispatcher_thread_equals_native(self, small_prover):
        from protocol_tpu_torch.zk import graft as zk_graft

        job, prover = small_prover
        native = prove_job(dataclasses.replace(job, zk_backend="native"))
        zk_graft.reset_phase_stats()
        results = []
        with ProvingPlane(ProvingPlaneConfig(workers=0), on_proved=results.append) as plane:
            plane.submit(dataclasses.replace(job, zk_backend="graft", zk_device="cpu"))
            assert plane.drain(timeout=300)
            assert plane.status(job.epoch).state == "proved"
        (graft,) = results
        assert graft.proof == native.proof
        assert prover.engines == [("native", None), ("graft", "cpu")]
        stats = zk_graft.phase_stats()
        assert stats["msm"]["calls"] > 0 and stats["ntt"]["calls"] > 0

    def test_graft_without_a_card_raises_never_falls_back(self, small_prover, no_cuda):
        job, prover = small_prover
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prove_job(dataclasses.replace(job, zk_backend="graft", zk_device=None))
        with ProvingPlane(ProvingPlaneConfig(workers=0, max_retries=0)) as plane:
            plane.submit(dataclasses.replace(job, zk_backend="graft", zk_device=None))
            assert plane.drain(timeout=60)
            assert plane.status(job.epoch).state == "failed"
        assert prover.engines == []  # nothing proved, on any device

    def test_graft_prewarm_builds_the_point_cache_on_the_device(self, plonk_manager):
        from protocol_tpu_torch.prover.workers import ProverPool

        cfg = plonk_manager.config
        params = (cfg.num_neighbours, cfg.num_iter, cfg.initial_score, cfg.scale)
        srs = prover_for(params, cfg.prover, cfg.srs_path).vk.srs
        getattr(srs, "_graft_points", {}).clear()
        pool = ProverPool(workers=0)
        pool.prewarm(params, cfg.prover, cfg.srs_path)
        assert not getattr(srs, "_graft_points", {})  # native warms the key only
        pool.prewarm(params, cfg.prover, cfg.srs_path, zk_backend="graft", zk_device="cpu")
        assert list(srs._graft_points) == [torch.device("cpu")]

    def test_graft_prewarm_without_a_card_raises(self, plonk_manager, no_cuda):
        from protocol_tpu_torch.prover.workers import ProverPool

        cfg = plonk_manager.config
        params = (cfg.num_neighbours, cfg.num_iter, cfg.initial_score, cfg.scale)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ProverPool(workers=0).prewarm(params, cfg.prover, cfg.srs_path, zk_backend="graft")

    def test_native_ignores_the_device(self, small_prover, no_cuda):
        job, prover = small_prover
        result = prove_job(dataclasses.replace(job, zk_backend="native", zk_device=None))
        assert prover.verify(result.pub_ins, result.proof)
        assert prover.engines == [("native", None)]


@pytest.mark.slow
def test_two_peer_graft_prove_job_on_the_cpu_equals_the_reference(plonk_manager, reference_proof):
    """The real 2-peer statement (k = 13) through ``prove_job`` under
    graft with ``zk_device="cpu"``: the reference's native bytes.  The
    plain versions take minutes a Montgomery-heavy MSM at this size."""
    job = dataclasses.replace(plonk_manager.build_proof_job(Epoch(12)), zk_backend="graft",
                              zk_device="cpu")
    assert prove_job(job).proof == reference_proof.proof


# ---------------------------------------------------------------------------
# The server's /proof route
# ---------------------------------------------------------------------------


class TestProofRoute:
    def test_proof_endpoint_serves_proof_and_lifecycle(self):
        import json

        from protocol_tpu_torch.node.server import handle_request

        mgr = _manager()
        with ProvingPlane(
            ProvingPlaneConfig(workers=0),
            on_proved=lambda r: mgr.install_proof(r.epoch, r.pub_ins, r.proof),
        ) as plane:
            plane.submit(mgr.build_proof_job(Epoch(20)))
            assert plane.drain(timeout=30)
            status, body = handle_request("GET", "/proof/20", mgr, plane)
            obj = json.loads(body)
            assert status == 200 and obj["state"] == "proved"
            assert obj["epoch"] == 20 and obj["proof"]
            status, body = handle_request("GET", "/proof/latest", mgr, plane)
            assert status == 200 and json.loads(body)["epoch"] == 20
            status, body = handle_request("GET", "/proof/999", mgr, plane)
            assert status == 404
            status, _ = handle_request("GET", "/proof/abc", mgr, plane)
            assert status == 400

    def test_proof_endpoint_without_plane(self):
        import json

        from protocol_tpu_torch.node.server import handle_request

        mgr = _manager()
        mgr.calculate_proofs(Epoch(21))
        status, body = handle_request("GET", "/proof/21", mgr)
        assert status == 200 and json.loads(body)["state"] == "proved"
        status, _ = handle_request("GET", "/proof/5", mgr)
        assert status == 404

    def test_proof_bodies_equal_the_references(self):
        """The same statement proved through each package's plane: the
        ``/proof`` bodies are equal but for the lifecycle's timings, and
        the misses answer the same."""
        import json

        from protocol_tpu.node.epoch import Epoch as RefEpoch
        from protocol_tpu.node.manager import Manager as RefManager
        from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
        from protocol_tpu.node.server import handle_request as ref_handle_request
        from protocol_tpu.prover import ProvingPlane as RefProvingPlane
        from protocol_tpu.prover import ProvingPlaneConfig as RefProvingPlaneConfig
        from protocol_tpu_torch.node.server import handle_request

        timings = ("prove_seconds", "lag_seconds", "submitted_unix", "finished_unix",
                   "queue_seconds")
        mgr = _manager()
        ref = RefManager(RefManagerConfig(prover="commitment"))
        ref.generate_initial_attestations()
        bodies = {}
        for name, m, Plane, Config, handle, epoch in (
            ("port", mgr, ProvingPlane, ProvingPlaneConfig, handle_request, Epoch),
            ("ref", ref, RefProvingPlane, RefProvingPlaneConfig, ref_handle_request, RefEpoch),
        ):
            with Plane(Config(workers=0),
                       on_proved=lambda r, m=m: m.install_proof(r.epoch, r.pub_ins, r.proof)) as plane:
                plane.submit(m.build_proof_job(epoch(20)))
                assert plane.drain(timeout=30)
                out = {}
                for path in ("/proof/20", "/proof/latest", "/proof/999", "/proof/abc"):
                    status, body = handle(path=path, method="GET", manager=m, plane=plane)
                    if status == 200:
                        body = {k: v for k, v in json.loads(body).items() if k not in timings}
                    out[path] = (status, body)
                bodies[name] = out
        assert bodies["port"] == bodies["ref"]
        assert bodies["port"]["/proof/20"][1]["state"] == "proved"

"""The port's concurrency pass (``protocol_tpu_torch.analysis.concurrency``)
against the reference's, and its lock witness on the port's node, on the
CPU.

- ``analyze_sources`` gives the reference's findings on the same
  sources: the reference's seeded fixtures and the reference's whole
  tree (paths mapped to the port's).
- The port's real tree has zero unwaived findings, every waiver is live,
  and a stale one is an error.
- The reference's ``LockWitness`` units, real-fix regressions and the
  three-epoch stress (``tests/test_concurrency_stress.py``) re-targeted
  at the port's node on ``cuda-windowed`` with ``device="cpu"``: zero
  witness violations.
"""

import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from protocol_tpu.analysis.concurrency import analyze_sources as ref_analyze_sources
from protocol_tpu.analysis.fixtures import FIXTURES as REF_FIXTURES
from protocol_tpu_torch.analysis.concurrency import (
    WAIVERS,
    analyze_sources,
    build_static_model,
    run_concurrency_pass,
)
from protocol_tpu_torch.analysis.concurrency.checker import (
    StaticConcurrencyModel,
    _tree_sources,
    analyze_models,
)
from protocol_tpu_torch.analysis.concurrency.model import build_program_model
from protocol_tpu_torch.analysis.concurrency.waivers import Waiver
from protocol_tpu_torch.analysis.concurrency.witness import LockWitness
from protocol_tpu_torch.crypto import calculate_message_hash
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.ingest import IngestPlane, IngestPlaneConfig
from protocol_tpu_torch.ingest.ratelimit import RateLimitConfig
from protocol_tpu_torch.node.attestation import Attestation
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.node.epoch import Epoch
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.node.pipeline import EpochPipeline
from protocol_tpu_torch.node.server import handle_request
from protocol_tpu_torch.obs import metrics as obs_metrics
from protocol_tpu_torch.obs import prometheus_text

REPO = Path(__file__).resolve().parent.parent
SKS, PKS = keyset_from_raw(FIXED_SET)


def ported(rel_path: str) -> str:
    return "protocol_tpu_torch/" + rel_path.split("/", 1)[1]


def keyed(findings, port: bool) -> set[tuple[str, str, int]]:
    return {(f.rule, f.file if port else ported(f.file), f.line) for f in findings}


def config(**kw) -> ManagerConfig:
    return ManagerConfig(prover="commitment", check_circuit=False, device="cpu", **kw)


def make_att(i: int, sender: int = 0) -> Attestation:
    """Unique validly-signed attestation #i (scores sum to SCALE)."""
    d = i % 190
    scores = [200 + d, 200 - d, 200, 200, 200]
    _, msgs = calculate_message_hash(PKS, [scores])
    sig = sign(SKS[sender], PKS[sender], msgs[0])
    return Attestation(sig=sig, pk=PKS[sender], neighbours=list(PKS), scores=scores)


@pytest.fixture(autouse=True)
def one_thread():
    """The node's converges here are small; one intra-op thread keeps the
    stress about the node's threads, not torch's, on a busy host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def static_model() -> StaticConcurrencyModel:
    """The analyzer's guard map and lock-order graph for the port's tree."""
    return build_static_model()


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------


class TestParity:
    @pytest.mark.parametrize(
        "name", sorted(n for n, f in REF_FIXTURES.items() if f.kind == "concurrency")
    )
    def test_reference_fixture_sources(self, name):
        source, rel_path = REF_FIXTURES[name].build()
        ref = ref_analyze_sources({rel_path: source})
        port = analyze_sources({ported(rel_path): source})
        assert ref
        assert keyed(port, True) == keyed(ref, False)

    def test_reference_tree(self):
        """The reference's whole package through both analyzers, unwaived:
        the same findings at the same lines."""
        sources = {
            str(p.relative_to(REPO)): p.read_text()
            for p in sorted((REPO / "protocol_tpu").rglob("*.py"))
        }
        ref = ref_analyze_sources(sources)
        port = analyze_sources({ported(rel): src for rel, src in sources.items()})
        assert keyed(port, True) == keyed(ref, False)


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def real_pass():
    return run_concurrency_pass()


class TestRealTree:
    def test_zero_unwaived_and_every_waiver_live(self, real_pass):
        live, section = real_pass
        assert live == [], [f.render() for f in live]
        assert section["stale_waivers"] == []
        assert {w["symbol"] for w in section["waived"]} == {w.symbol for w in WAIVERS}
        assert all(w.file.startswith("protocol_tpu_torch/") for w in WAIVERS)
        assert section["confined_trees"] == [
            "protocol_tpu_torch/evm/", "protocol_tpu_torch/client/",
            "protocol_tpu_torch/crypto/", "protocol_tpu_torch/models/",
        ]

    def test_roots_cover_the_node_threads(self, real_pass):
        _, section = real_pass
        files = {r["file"] for r in section["roots"]}
        for f in ("protocol_tpu_torch/node/pipeline.py", "protocol_tpu_torch/ingest/plane.py",
                  "protocol_tpu_torch/node/server.py", "protocol_tpu_torch/obs/journal.py"):
            assert f in files, f

    def test_stale_waiver_is_an_error(self):
        bogus = Waiver("unguarded-rmw", "protocol_tpu_torch/node/manager.py", "Nobody.x", "test")
        models = build_program_model(_tree_sources(REPO))
        findings, section, _ = analyze_models(models, WAIVERS + (bogus,))
        assert [f.rule for f in findings] == ["stale-waiver"]
        assert [s["symbol"] for s in section["stale_waivers"]] == ["Nobody.x"]


# ---------------------------------------------------------------------------
# the lock witness (tests/test_concurrency_stress.py, re-targeted)
# ---------------------------------------------------------------------------


class TestLockWitnessUnit:
    def test_install_wraps_and_uninstall_restores(self):
        orig = threading.Lock
        w = LockWitness()
        with w:
            assert threading.Lock is not orig
            lock = threading.Lock()
            with lock:
                pass
        assert threading.Lock is orig
        assert len(w.report()["locks"]) == 1

    def test_order_edges_and_waits_recorded(self):
        w = LockWitness()
        with w:
            a = threading.Lock()
            b = threading.Lock()
            for _ in range(3):
                with a:
                    with b:
                        pass
        rep = w.report()
        assert len(rep["locks"]) == 2
        (edge, count), = rep["order_edges"].items()
        assert count == 3

    def test_contention_histogram_feeds_metrics(self):
        before = sum(n for _, n in obs_metrics.LOCK_WAIT_SECONDS.samples())
        w = LockWitness()
        with w:
            lock = threading.Lock()
            with lock:
                pass
        after = sum(n for _, n in obs_metrics.LOCK_WAIT_SECONDS.samples())
        assert after > before

    def test_watched_writes_record_thread_and_guards(self):
        w = LockWitness()
        with w:
            lock = threading.Lock()

            class Box:
                def __init__(self):
                    self.val = 0

            box = Box()
            w.watch(box, ["val"])
            with lock:
                box.val = 1
            box.val = 2
        writes = w.writes[("Box", "val")]
        assert len(writes) == 2
        assert len(writes[0][1]) == 1  # under the lock
        assert writes[1][1] == ()  # bare

    def test_cross_check_passes_on_consistent_run(self):
        w = LockWitness()
        with w:
            a = threading.Lock()
            with a:
                pass
        assert w.cross_check(StaticConcurrencyModel()) == []

    def test_cross_check_flags_cycle(self):
        w = LockWitness()
        with w:
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        assert any("cyclic" in v for v in w.cross_check(StaticConcurrencyModel()))

    def test_cross_check_flags_runtime_only_edge(self):
        w = LockWitness()
        with w:
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
        static = StaticConcurrencyModel(
            lock_sites={"T._a": a._site, "T._b": b._site}, order_edges=set(),
        )
        assert any("T._a -> T._b" in v for v in w.cross_check(static))

    def test_cross_check_flags_bare_crossthread_write_of_guarded_attr(self):
        w = LockWitness()
        with w:
            guard = threading.Lock()

            class State:
                def __init__(self):
                    self.x = 0

            s = State()
            w.watch(s, ["x"])
            with guard:
                s.x = 1

            def rogue():
                s.x = 2

            t = threading.Thread(target=rogue)
            t.start()
            t.join()
        static = StaticConcurrencyModel(
            guard_map={("State", "x"): frozenset({"State._g"})},
            lock_sites={"State._g": guard._site},
        )
        assert any("State.x" in v for v in w.cross_check(static))

    def test_witness_sites_are_repo_relative(self):
        w = LockWitness()
        with w:
            lock = threading.Lock()
        assert lock._site[0] == "tests/test_torch_concurrency.py"


class TestRealFixRegressions:
    def test_plane_tallies_consistent_under_concurrent_verdicts(self):
        manager = Manager(config())
        plane = IngestPlane(manager, IngestPlaneConfig(
            workers=0, batch_size=8, submit_queue_max=4096,
            rate=RateLimitConfig(rate=1e6, burst=1e6),
        ))
        n_per_thread, n_threads = 40, 4
        with plane:
            def submitter(tid: int):
                for i in range(n_per_thread):
                    plane.submit(make_att(i if tid % 2 else 1000 + tid * 100 + i))

            threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert plane.drain(timeout=30)
            stats = plane.stats()
        total = stats["accepted"] + stats["shed"] + sum(stats["rejections"].values())
        assert total == n_per_thread * n_threads
        assert stats["pending"] == 0

    def test_pipeline_counters_balance_under_concurrent_submit(self):
        manager = SimpleNamespace(prepare_epoch=lambda epoch: SimpleNamespace(epoch=epoch))
        pipe = EpochPipeline(manager, queue_depth=1,  # type: ignore[arg-type]
                             device_stage=lambda prepared: time.sleep(0.005))
        n_per_thread, n_threads = 25, 2
        with pipe:
            def submitter(tid: int):
                for i in range(n_per_thread):
                    pipe.submit(Epoch(tid * 1000 + i))

            threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert pipe.drain(timeout=30)
        assert pipe.completed + pipe.coalesced == n_per_thread * n_threads
        assert pipe.completed >= 1

    def test_warm_state_pair_never_tears(self):
        m = Manager(config())
        state_a = (np.array([0.25, 0.75]), [10, 20])
        state_b = (np.array([0.75, 0.25]), [20, 10])
        with m._state_lock:
            m.last_scores, m.last_peer_hashes = state_a
        stop = threading.Event()

        def flipper():
            flip = False
            while not stop.is_set():
                with m._state_lock:
                    m.last_scores, m.last_peer_hashes = state_b if flip else state_a
                flip = not flip

        t = threading.Thread(target=flipper)
        t.start()
        try:
            for _ in range(2000):
                np.testing.assert_allclose(m._warm_t0([10, 20]), [0.25, 0.75])
        finally:
            stop.set()
            t.join()


class TestConcurrencyStress:
    N_EPOCHS = 3

    def test_node_paths_under_witness_no_violations(self, static_model):
        """Scrapes, ingest and three pipelined epochs of the port's node on
        ``cuda-windowed`` (the plain path), all concurrent, under the lock
        witness: zero cross-check violations, no deadlock."""
        witness = LockWitness()
        errors: list[BaseException] = []
        with witness:
            manager = Manager(config(backend="cuda-windowed"))
            manager.generate_initial_attestations()
            plane = IngestPlane(manager, IngestPlaneConfig(
                workers=0, batch_size=8, submit_queue_max=4096,
                rate=RateLimitConfig(rate=1e6, burst=1e6),
            ))
            pipe = EpochPipeline(manager, alpha=0.1)
            for obj in (manager, pipe, plane):
                attrs = [attr for (cls, attr) in static_model.guard_map
                         if cls == type(obj).__name__]
                witness.watch(obj, attrs)
            stop = threading.Event()

            def guarded(fn):
                def run():
                    try:
                        fn()
                    except BaseException as exc:  # noqa: BLE001
                        errors.append(exc)

                return run

            def scraper():
                while not stop.is_set():
                    prometheus_text()
                    handle_request("GET", "/metrics", manager)
                    handle_request("GET", "/debug/flight?n=50", manager)
                    handle_request("GET", "/status", manager)

            def ingester():
                i = 0
                while not stop.is_set():
                    plane.submit(make_att(i, sender=i % len(PKS)))
                    i += 1
                    time.sleep(0.001)

            workers = [threading.Thread(target=guarded(scraper), name=f"scrape-{i}")
                       for i in range(2)]
            workers.append(threading.Thread(target=guarded(ingester), name="ingest-load"))
            with plane, pipe:
                for t in workers:
                    t.start()
                try:
                    for n in range(self.N_EPOCHS):
                        pipe.submit(Epoch(n + 1))
                        assert pipe.drain(timeout=120), "pipeline deadlock"
                finally:
                    stop.set()
                    for t in workers:
                        t.join(timeout=10)
                assert plane.drain(timeout=30), "ingest plane deadlock"
            violations = witness.cross_check(static_model)
        assert errors == [], errors
        assert violations == [], violations
        assert pipe.completed == self.N_EPOCHS
        for n in range(self.N_EPOCHS):
            assert pipe.outcomes[n + 1].error is None
        stats = plane.stats()
        assert stats["pending"] == 0 and stats["accepted"] >= 1
        assert any("protocol_tpu_torch/" in site for site in witness.report()["locks"])
        assert sum(n for _, n in obs_metrics.LOCK_WAIT_SECONDS.samples()) > 0

    def test_witness_observed_guarded_writes(self, static_model):
        witness = LockWitness()
        with witness:
            manager = Manager(config(backend="cuda-csr"))
            manager.generate_initial_attestations()
            attrs = [attr for (cls, attr) in static_model.guard_map if cls == "Manager"]
            witness.watch(manager, attrs)
            manager.converge_epoch(Epoch(1), alpha=0.1)
            violations = witness.cross_check(static_model)
        assert violations == []
        observed = {attr for (cls, attr) in witness.writes if cls == "Manager"}
        assert {"last_scores", "last_peer_hashes"} <= observed

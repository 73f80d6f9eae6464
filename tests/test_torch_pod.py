"""The port's pod against the reference's: per-host plans, the pod's
converge, the sharded durability plane and the dry run.

The hosts are gloo ranks on the CPU, spawned by ``run_ranks`` in three
module-scoped launches (1, 2 and 3 hosts) over ``scale_free(1024, 8192,
seed=16)`` and one churned epoch of it; the reference runs in this
process.  Held:

- each host's plan arrays against the reference's own host functions
  run here for that host (``partition_delta``, ``build_window_plan``,
  ``_partition_plan_arrays(plan, 1, rows_per_shard=, s_max=)``, the
  maxima over all hosts), byte for byte: cold, and after the churned
  epoch both delta-updated and rebuilt; each plan outcome is the one the
  reference's rule gives;
- a 1-host pod against the port's ``ShardedWindowPlan`` on a 1-rank
  group, array for array, and their converges, bit for bit;
- the 2-host converge: the same bits on both hosts, within L1 1e-5 of
  the reference's single-device ``converge_windowed`` (its sharded
  windowed converge raises on this tree's jax, ROADMAP §C R1);
- ``PodDurability`` as the reference's tests hold it, and its stamps and
  manifests loading in the reference's and the other way round;
- ``python -m protocol_tpu_torch.parallel.dryrun_pod --smoke --device cpu
  --chaos-host-loss`` exits 0.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from protocol_tpu.node.pod import PodDurability as RefPodDurability
from protocol_tpu.ops import gather_window as jgw
from protocol_tpu.parallel.partition import HostPartition as RefHostPartition
from protocol_tpu.parallel.sharded import _partition_plan_arrays as j_partition
from protocol_tpu.trust.backend import get_backend as jget
from protocol_tpu.trust.graph import TrustGraph as JGraph
from protocol_tpu_torch.models.churn import churn_cohort_dims, sender_centric_churn
from protocol_tpu_torch.models.graphs import scale_free
from protocol_tpu_torch.node.pod import PodDurability
from protocol_tpu_torch.ops.gather_window import BLOCK_ROWS
from protocol_tpu_torch.parallel import dryrun, dryrun_pod
from protocol_tpu_torch.parallel.launch import run_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 16
KW = dict(tol=1e-6, max_iter=60)
TIMEOUT_S = 300


def graphs():
    """The bootstrap graph and one epoch of 1 % sender-centric churn of
    it: ``(g0, rows, g1)``."""
    g0 = scale_free(1024, 8192, seed=SEED)
    cohort, deg = churn_cohort_dims(g0, 0.01)
    rows, g1, _ = sender_centric_churn(np.random.default_rng(SEED), g0, cohort_size=cohort,
                                       deg=deg)
    return g0, rows, g1


def steps():
    """Cold; the churned epoch from the cold plan with its hint (delta
    where the host owns churn); the churned epoch built anew; the same
    graph again from that plan (reuse)."""
    g0, rows, g1 = graphs()
    return [(g0, None, False), (g1, rows, True), (g1, rows, False), (g1, None, True)]


def launch(size, jobs):
    return run_ranks(size, dryrun.jobs_rank, jobs, backend="gloo", device="cpu",
                     timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def one_host():
    g0, _, _ = graphs()
    return launch(1, [
        (dryrun_pod.pod_plans_rank, (steps(), SEED, True)),
        (dryrun_pod.converge_pod_rank, ([g0], [None], dict(tol=0.0, max_iter=30), SEED, 2)),
        (dryrun.converge_rank, (g0, ("cuda-windowed",), dict(alpha=0.1, tol=0.0, max_iter=30))),
    ])[0]


@pytest.fixture(scope="module")
def two_hosts():
    g0, _, _ = graphs()
    return launch(2, [
        (dryrun_pod.pod_plans_rank, (steps(), SEED)),
        (dryrun_pod.converge_pod_rank, ([g0], [None], KW, SEED, 2)),
    ])


@pytest.fixture(scope="module")
def three_hosts():
    return launch(3, [(dryrun_pod.pod_plans_rank, (steps(), SEED))])


def reference_hosts(graph, n_hosts: int, rows=None, plans=None) -> list[dict]:
    """The reference's host functions for every host of an ``n_hosts``
    pod, in this process: each host's local edges and plan (built, or
    resolved from ``plans[h]`` by the reference's rule), the pod's shape
    maxima, and each host's ``_partition_plan_arrays``."""
    g = JGraph(graph.n, graph.src, graph.dst, graph.weight, graph.pre_trusted).drop_self_edges()
    w, dangling = g.row_normalized()
    owner = RefHostPartition(n_hosts, seed=SEED).assign_ids(g.n)
    hosts = []
    for h in range(n_hosts):
        owned, lsrc, ldst, lw = jgw.partition_delta(rows, g.src, g.dst, w, owner, h)
        fp = jgw.graph_fingerprint(g.n, lsrc, ldst, lw)
        outcome, plan = "rebuild", None
        if plans is not None and plans[h].fingerprint == fp:
            outcome, plan = "reuse", plans[h]
        elif plans is not None and owned is not None and owned.size:
            plan = jgw.try_plan_delta(plans[h], lsrc, ldst, lw, n=g.n, rows=owned, fingerprint=fp)
            outcome = "delta" if plan is not None else "rebuild"
        if plan is None:
            plan = jgw.build_window_plan(lsrc, ldst, lw, n=g.n)
        hosts.append(dict(plan=plan, outcome=outcome, local_edges=int(lsrc.shape[0]),
                          owner=owner, dangling=dangling.astype(np.float32)))
    rps = max(-(-hst["plan"].n_rows // BLOCK_ROWS) * BLOCK_ROWS for hst in hosts)
    s_max = max(j_partition(hst["plan"], 1, rows_per_shard=rps)["s_max"] for hst in hosts)
    for hst in hosts:
        hst["parts"] = j_partition(hst["plan"], 1, rows_per_shard=rps, s_max=s_max)
        hst.update(rows_per_shard=rps, s_max=s_max)
    return hosts


def assert_host_equal(rec: dict, ref: dict, graph) -> None:
    """One host's plan record against the reference's arrays for it: the
    plan rows whole, the live runs (one pad run where there is none) and
    the pointers, byte for byte."""
    parts = ref["parts"]
    live = max(int(parts["dst_ptr"][0, -1]), 1)
    assert (rec["rows_per_shard"], rec["s_max"]) == (ref["rows_per_shard"], ref["s_max"])
    assert rec["fingerprint"] == ref["plan"].fingerprint
    assert rec["local_edges"] == ref["local_edges"]
    for name in ("wid", "local", "weight"):
        assert rec[name].tobytes() == parts[name].tobytes(), name
    for name in ("seg_end", "seg_first", "seg_perm"):
        assert rec[name].tobytes() == parts[name][0, :live].tobytes(), name
    assert rec["dst_ptr"].tobytes() == parts["dst_ptr"][0].tobytes()
    assert rec["p"].tobytes() == graph.pre_trust_vector().tobytes()
    assert rec["dangling"].tobytes() == ref["dangling"].tobytes()
    assert np.array_equal(rec["owner"], ref["owner"])


class TestPodPlanBuild:
    @pytest.mark.parametrize("n_hosts", [2, 3])
    def test_host_arrays_equal_the_reference_cold_and_after_churn(self, n_hosts, two_hosts,
                                                                 three_hosts):
        results = {2: two_hosts, 3: three_hosts}[n_hosts]
        g0, rows, g1 = graphs()
        cold = reference_hosts(g0, n_hosts)
        expect = [
            cold,
            reference_hosts(g1, n_hosts, rows, plans=[h["plan"] for h in cold]),
            reference_hosts(g1, n_hosts, rows),
        ]
        expect.append(reference_hosts(g1, n_hosts, None, plans=[h["plan"] for h in expect[2]]))
        for step, (graph, want) in enumerate(zip((g0, g1, g1, g1), expect)):
            for h in range(n_hosts):
                rec = results[h][0][step]
                assert (rec["host_id"], rec["n_hosts"], rec["local_shards"]) == (h, n_hosts, 1)
                assert rec["plan_outcome"] == want[h]["outcome"], (step, h)
                assert_host_equal(rec, want[h], graph)
        outcomes = [[results[h][0][s]["plan_outcome"] for h in range(n_hosts)] for s in range(4)]
        assert outcomes[0] == outcomes[2] == ["rebuild"] * n_hosts
        assert outcomes[3] == ["reuse"] * n_hosts
        assert "delta" in outcomes[1]
        # The delta-updated and the rebuilt churned plans are the same arrays.
        for h in range(n_hosts):
            for name in dryrun_pod.PLAN_ARRAYS:
                assert np.array_equal(results[h][0][1][name], results[h][0][2][name]), name

    def test_hosts_share_the_shape_and_split_the_edges(self, three_hosts):
        g0 = graphs()[0].drop_self_edges()
        cold = [r[0][0] for r in three_hosts]
        assert len({(r["rows_per_shard"], r["s_max"], r["table_entries"]) for r in cold}) == 1
        assert sum(r["local_edges"] for r in cold) == g0.nnz
        assert all(r["build_seconds"] > 0 and r["sync_unix"] > 0 for r in cold)
        reuse = [r[0][3] for r in three_hosts]
        assert all(r["build_seconds"] == 0.0 for r in reuse)

    def test_single_host_pod_matches_sharded_plan(self, one_host):
        g0 = graphs()[0]
        for rec in one_host[0]:
            sp = rec["sharded"]
            assert (rec["n"], rec["rows_per_shard"], rec["table_entries"]) == (
                sp["n"], sp["rows_per_shard"], sp["table_entries"])
            assert rec["fingerprint"] == sp["fingerprint"]
            for name in dryrun_pod.PLAN_ARRAYS:
                assert rec[name].tobytes() == sp[name].tobytes(), name
        cold = one_host[0][0]
        assert cold["host_id"] == 0 and cold["n_hosts"] == 1 and cold["interpret"]
        assert np.array_equal(cold["owner"], np.zeros(g0.n, np.int32))
        assert cold["local_edges"] == g0.drop_self_edges().nnz
        assert cold["plan_outcome"] == "rebuild" and cold["build_seconds"] > 0
        assert cold["barrier_wait_seconds"] >= 0.0

    def test_single_host_pod_converge_bit_identical(self, one_host):
        pod = one_host[1]["epochs"][0]
        sharded = one_host[2]["cuda-windowed"]
        assert pod["iterations"] == sharded["iterations"] == 30
        # The backend's result carries the float32 scores as float64.
        assert pod["scores"].tobytes() == sharded["scores"].astype(np.float32).tobytes()
        assert sharded["scores"].astype(np.float32).astype(np.float64).tobytes() == (
            sharded["scores"].tobytes())
        assert pod["all_reduce"] == {"calls": 30, "bytes": 30 * 4 * 1024}

    def test_t0_is_a_fresh_copy(self, one_host):
        assert all(rec["t0_fresh"] for rec in one_host[0])


class TestPodConverge:
    def test_two_hosts_agree_and_match_the_reference(self, two_hosts):
        g0 = graphs()[0]
        recs = [r[1]["epochs"][0] for r in two_hosts]
        assert recs[0]["scores"].tobytes() == recs[1]["scores"].tobytes()
        assert recs[0]["residual"] == recs[1]["residual"]
        assert recs[0]["scores_sha256"] == recs[1]["scores_sha256"]
        theirs = jget("tpu-windowed").converge(
            JGraph(g0.n, g0.src, g0.dst, g0.weight, g0.pre_trusted), alpha=0.1, **KW)
        l1 = float(np.abs(recs[0]["scores"].astype(np.float64) - theirs.scores).sum())
        assert l1 <= 1e-5, l1
        it = recs[0]["iterations"]
        for rec in recs:
            # One all-reduce of 4n bytes a step; the plain versions on the
            # CPU launch no kernel.
            assert rec["all_reduce"] == {"calls": it, "bytes": it * 4 * g0.n}
            assert rec["budget_findings"] == []
            assert set(rec["launches"].values()) == {0}
        assert all(r[1]["loaded_forbidden"] == [] for r in two_hosts)
        assert set(two_hosts[0][1]["step_wall_ms"]) == {"step", "partial_ct", "all_reduce", "damp"}


class TestPodDurability:
    def _pod(self, cls, root, host, n=2):
        return cls(root, host, n, fsync=False)

    def test_host_id_validation(self, tmp_path):
        with pytest.raises(ValueError):
            PodDurability(tmp_path, 2, 2)

    def test_seal_requires_complete_stamp_set(self, tmp_path):
        h0, h1 = self._pod(PodDurability, tmp_path, 0), self._pod(PodDurability, tmp_path, 1)
        h0.publish_shard(3, wal_seq=7, columns={"graph": "aa"})
        assert h0.seal_epoch(3) is None
        assert h0.load_manifest() is None
        h1.publish_shard(3, wal_seq=9, columns={"graph": "bb"})
        manifest = h0.seal_epoch(3)
        assert manifest is not None and manifest["epoch"] == 3
        loaded = h1.load_manifest()
        assert loaded == manifest
        assert h1.my_stamp(loaded)["wal_seq"] == 9
        assert h0.my_stamp(loaded)["columns"] == {"graph": "aa"}

    def test_recovery_reads_newest_sealed_not_newest_published(self, tmp_path):
        h0, h1 = self._pod(PodDurability, tmp_path, 0), self._pod(PodDurability, tmp_path, 1)
        for e in (1, 2):
            h0.publish_shard(e, wal_seq=e, columns={})
            h1.publish_shard(e, wal_seq=e, columns={})
            h0.seal_epoch(e)
        h0.publish_shard(3, wal_seq=3, columns={})
        assert h1.load_manifest()["epoch"] == 2
        assert h0.load_manifest()["epoch"] == 2

    def test_stamps_are_atomic_no_tmp_litter(self, tmp_path):
        h0 = self._pod(PodDurability, tmp_path, 0, n=1)
        h0.publish_shard(1, wal_seq=0, columns={"a": "b"})
        h0.seal_epoch(1)
        assert not list(tmp_path.glob("manifests/*.tmp"))
        stamp = json.loads((tmp_path / "manifests" / "shard-e00000001-h000.json").read_text())
        assert stamp["n_hosts"] == 1

    def test_wal_and_checkpoints_shard_per_host(self, tmp_path):
        h0, h1 = self._pod(PodDurability, tmp_path, 0), self._pod(PodDurability, tmp_path, 1)
        s0 = h0.wal.append(b"host0-att", flush=True)
        s1 = h1.wal.append(b"host1-att", flush=True)
        assert [p for _, p in h0.wal.replay()] == [b"host0-att"]
        assert [p for _, p in h1.wal.replay()] == [b"host1-att"]
        assert s0 == s1
        assert (tmp_path / "host-000" / "wal").is_dir()
        assert (tmp_path / "host-001" / "checkpoints").is_dir()

    @pytest.mark.parametrize("writer, reader", [(PodDurability, RefPodDurability),
                                                (RefPodDurability, PodDurability)],
                             ids=["port-to-reference", "reference-to-port"])
    def test_stamps_and_manifests_cross_load(self, tmp_path, writer, reader):
        hosts = [self._pod(writer, tmp_path, h) for h in (0, 1)]
        for e in (4, 5):
            for h, pd in enumerate(hosts):
                pd.publish_shard(e, wal_seq=10 * e + h, columns={"graph": f"g{e}{h}"},
                                 extra={"scores_sha256": "ab" * 32, "residual": 1e-7})
        assert hosts[0].seal_epoch(4) is not None
        for h in (0, 1):
            pd = self._pod(reader, tmp_path, h)
            manifest = pd.load_manifest()
            assert manifest["epoch"] == 4 and manifest["n_hosts"] == 2
            assert pd.my_stamp(manifest)["wal_seq"] == 40 + h
            assert pd.my_stamp(manifest)["columns"] == {"graph": f"g4{h}"}
        assert self._pod(reader, tmp_path, 1).seal_epoch(5)["epoch"] == 5

    def test_files_equal_the_references_byte_for_byte(self, tmp_path):
        for cls, root in ((PodDurability, tmp_path / "port"), (RefPodDurability, tmp_path / "ref")):
            pds = [self._pod(cls, root, h) for h in (0, 1)]
            for h, pd in enumerate(pds):
                pd.publish_shard(7, wal_seq=h, columns={"scores": "cd", "graph": "ef"},
                                 extra={"residual": 5e-7})
            pds[0].seal_epoch(7)
        names = sorted(p.name for p in (tmp_path / "port" / "manifests").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "ref" / "manifests").iterdir())
        for name in names:
            assert ((tmp_path / "port" / "manifests" / name).read_bytes()
                    == (tmp_path / "ref" / "manifests" / name).read_bytes()), name


class TestDryrun:
    def test_wal_record_round_trip(self):
        dst, w = np.array([3, 9, 1], np.uint32), np.array([0.5, 0.25, 0.25], np.float32)
        e, row, d, ww = dryrun_pod.decode_row(dryrun_pod.encode_row(2, 77, dst, w))
        assert (e, row) == (2, 77) and np.array_equal(d, dst) and np.array_equal(ww, w)

    def test_smoke_with_host_loss_exits_0(self, tmp_path):
        out = tmp_path / "pod.json"
        proc = subprocess.run(
            [sys.executable, "-m", "protocol_tpu_torch.parallel.dryrun_pod", "--smoke",
             "--device", "cpu", "--chaos-host-loss", "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["ok"] and summary["residual_bit_identity"]
        assert summary["warm_vs_cold_l1"] < dryrun_pod.SCORE_TOL
        assert summary["chaos"]["ok"] and summary["chaos"]["crashed_as_planned"]
        assert summary["chaos"]["lost_acked"] == [[], []]
        report = json.loads(out.read_text())
        assert [ep["plan_outcome"] for ep in report["workers"][0]["epochs"]][0] == "rebuild"
        assert all(w["loaded_forbidden"] == [] and w["trace_pod_served"] is not False
                   for w in report["workers"])
        assert report["chaos"]["crashed_host_recovery"]["acked_epochs_replayed"] == [1]

    def test_resume_continues_the_pod_from_its_sealed_manifest(self, tmp_path, capsys):
        """``--resume`` relaunches a pod in its ``--workdir``: every host
        recovers the newest sealed manifest and runs only the epochs past
        it."""
        common = ["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "pod")]
        assert dryrun_pod.main(common + ["--epochs", "2"]) == 0
        out = tmp_path / "resume.json"
        assert dryrun_pod.main(common + ["--epochs", "3", "--resume", "--out", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["resume"] and report["reference"] is None
        for w in report["workers"]:
            assert w["recovery"]["manifest_epoch"] == 1 and w["recovery"]["lost_acked_epochs"] == []
            assert w["recovery"]["checkpoint_matches_stream"]
            assert [ep["epoch"] for ep in w["epochs"]] == [2]
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"]

"""The port's crash matrix (``protocol_tpu_torch/tools/crash_matrix.py``)
against the reference's tool (``tools/crash_matrix.py``): the same
workload bytes and parent-side bookkeeping, the same fault registry, a
counting-mode control that reaches every point the reference's reaches
as often where the stream decides it, and three matrix entries run for
real through child processes on the CPU (``--device cpu``: the
``cuda-csr`` backend's plain versions), each holding every recovery
invariant, beside a self-check that a recovered cache missing one
acknowledged record fails its entry.  The full smoke matrix is ``-m
slow``."""

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import crash_matrix as ref_cm  # noqa: E402

from protocol_tpu_torch import chaos  # noqa: E402
from protocol_tpu_torch.tools import crash_matrix as cm  # noqa: E402

#: The smoke scale of both tools (120 peers, 600 events, 3 epochs).
PORT_ARGS = ["--smoke", "--device", "cpu"]


def within(seconds, fn, args, *rest, **kw):
    """``fn(args, *rest, **kw)`` with a time limit: on the limit, every
    child the run started (``args.children``) is killed and the call
    raises."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(fn, args, *rest, **kw)
        try:
            return future.result(timeout=seconds)
        except concurrent.futures.TimeoutError:
            for child in args.children:
                if child.proc.poll() is None:
                    child.proc.kill()
            raise


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke stream and the port's counting-mode control on the CPU,
    with the reference's control on the same stream beside it (the
    reference's smoke backend, ``native-cpu``)."""
    tmp = tmp_path_factory.mktemp("crash_matrix")
    args = cm.parse_args(PORT_ARGS)
    stream = cm.build_stream(args.peers, args.events, args.neighbours, args.seed)
    ref_args = argparse.Namespace(backend="native-cpu", fsync=True, neighbours=args.neighbours,
                                  batch=args.batch, epochs=args.epochs, seed=args.seed)

    def reference_control():
        child = ref_cm.Child(tmp / "reference", ref_args, {"seed": args.seed, "faults": []})
        crashed, _ = ref_cm.run_stream(child, stream, ref_args)
        state = child.call(op="state")
        child.close()
        return crashed, state["hits"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        ref_future = pool.submit(reference_control)
        control, _, _ = within(90, cm.control_run, args, stream, tmp / "port")
        ref_crashed, ref_hits = ref_future.result(timeout=90)
    assert ref_crashed is None
    return dict(args=args, stream=stream, control=control, ref_hits=ref_hits, tmp=tmp)


class TestHelpers:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_build_stream_matches_the_reference(self, seed):
        port = cm.build_stream(50, 40, 8, seed)
        ref = ref_cm.build_stream(50, 40, 8, seed)
        assert port == ref
        assert [cm.sender_of(w) for w in port] == [ref_cm.sender_of(w) for w in ref]
        assert [cm.digest_of(w) for w in port] == [ref_cm.digest_of(w) for w in ref]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_bookkeeping_matches_the_reference(self, seed):
        stream = cm.build_stream(50, 40, 8, seed)
        args = argparse.Namespace(batch=7, epochs=3)
        bounds = cm.batch_bounds(stream, args)
        assert bounds == ref_cm.batch_bounds(stream, args)
        for upto in range(len(bounds) + 1):
            assert cm.expected_cache(stream, args, upto) == ref_cm.expected_cache(stream, args, upto)
        for wire in stream:
            sender = cm.sender_of(wire)
            assert cm.sender_hash_str(sender) == ref_cm.sender_hash_str(sender)
        rng = np.random.default_rng(seed)
        a = {str(k): float(v) for k, v in zip(rng.integers(0, 30, 20), rng.random(20))}
        b = {str(k): float(v) for k, v in zip(rng.integers(0, 30, 20), rng.random(20))}
        assert cm.score_l1(a, b) == ref_cm.score_l1(a, b)

    def test_lost_attestations_reads_the_acked_prefix(self):
        """Every acked sender present: nothing lost; one acked sender
        dropped from the cache: exactly that one lost."""
        stream = cm.build_stream(50, 40, 8, 0)
        args = argparse.Namespace(batch=7, epochs=3)
        cache = {cm.sender_hash_str(s): d for s, d in cm.expected_cache(stream, args, 6).items()}
        assert cm.lost_attestations(stream, args, 3, cache) == []
        first = cm.sender_of(stream[0])
        del cache[cm.sender_hash_str(first)]
        assert cm.lost_attestations(stream, args, 3, cache) == [first[:16]]


def test_registry_matches_the_reference():
    import protocol_tpu.node.checkpoint  # noqa: F401
    import protocol_tpu.node.ethereum  # noqa: F401
    import protocol_tpu.node.server  # noqa: F401
    import protocol_tpu.node.wal  # noqa: F401
    import protocol_tpu_torch.node.checkpoint  # noqa: F401
    import protocol_tpu_torch.node.ethereum  # noqa: F401
    import protocol_tpu_torch.node.server  # noqa: F401
    import protocol_tpu_torch.node.wal  # noqa: F401
    from protocol_tpu import chaos as ref_chaos

    assert chaos.registry() == ref_chaos.registry()
    assert len(chaos.registry()) == 12


def test_control_hits_every_point_the_reference_hits(smoke):
    """The counting-mode control reaches every point the reference's
    reaches, as often where the stream decides the count; its proofs
    landed every epoch and its children converged on no card."""
    hits, ref_hits = smoke["control"]["hits"], smoke["ref_hits"]
    assert {p for p, n in ref_hits.items() if n} <= {p for p, n in hits.items() if n}
    for point in ("ingest.pre_apply", "wal.append", "wal.post_append", "wal.pre_truncate",
                  "epoch.post_converge"):
        assert hits[point] == ref_hits[point], point
    assert hits["ingest.pre_apply"] == smoke["args"].events == 600
    assert smoke["control"]["state"]["proofs"] == [0, 1, 2]
    assert not any(smoke["control"]["state"]["launches"].values())
    rows = cm.matrix_faults(chaos.registry(), hits)
    assert len(rows) == 14 and sum(rec for _, _, rec in rows) == 1


def _tampering_child(selfcheck_dir, victim_hash):
    """A ``Child`` whose first ``state`` reply under ``selfcheck_dir``
    lacks the record of ``victim_hash``, an acknowledged sender."""

    class Tampering(cm.Child):
        tampered = False

        def call(self, **cmd):
            reply = super().call(**cmd)
            if (reply is not None and cmd.get("op") == "state" and not self.tampered
                    and selfcheck_dir in self.workdir.parents):
                self.tampered = True
                del reply["cache"][victim_hash]
            return reply

    return Tampering


@pytest.fixture(scope="module")
def entries(smoke):
    """Three matrix rows through real children, and the self-check row,
    four at a time."""
    args, stream, control, tmp = (smoke[k] for k in ("args", "stream", "control", "tmp"))
    rows = {row[1]["kind"] + ":" + row[0]: row for row in cm.matrix_faults(chaos.registry(),
                                                                           control["hits"])}
    chosen = {"crash": rows["crash:wal.post_append"], "torn": rows["torn:wal.append"],
              "double": rows["crash:wal.replay"], "selfcheck": rows["crash:wal.post_append"]}
    selfcheck_dir = tmp / "selfcheck"
    victim = cm.sender_hash_str(cm.sender_of(stream[0]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cm, "Child", _tampering_child(selfcheck_dir, victim))
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            futures = {
                name: pool.submit(within, 120, cm.run_entry, args, stream, point, fault, control,
                                  selfcheck_dir if name == "selfcheck" else tmp / "matrix",
                                  crash_in_recovery=rec)
                for name, (point, fault, rec) in chosen.items()
            }
            return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", ["crash", "torn", "double"])
def test_entry_holds_every_invariant(entries, name):
    e = entries[name]
    assert e["ok"], e
    assert e["lost_attestations"] == 0
    assert e["cache_matches_control"] is True
    assert e["score_l1"] <= cm.SCORE_TOL
    assert e["proofs_landed"] >= 1
    assert e["recovery_seconds"] >= 0 and e["recovery_seconds"] == e["recovery"]["seconds"]
    assert e["acked_batches"] >= 1 and e["crashed_at"]


def test_entries_crash_where_scheduled(entries):
    assert entries["crash"]["point"] == "wal.post_append"
    assert entries["crash"]["crashed_at"].startswith("apply_batch:")
    assert entries["torn"]["fault"] == "torn"
    assert entries["torn"]["crashed_at"].startswith("apply_batch:")
    # The torn record died in the batch's buffer (the WAL flushes once a
    # batch), as in the reference's recorded round: no bad record replays.
    assert entries["torn"]["recovery"]["wal_bad_records"] == 0
    # The double crash: the restart died in its own replay, the third
    # boot replayed the tail clean.
    assert entries["double"]["recovery_crash_rc"] == chaos.CRASH_EXIT_CODE
    assert entries["double"]["recovery"]["wal_replayed"] >= 2


def test_a_lost_acknowledged_record_fails_its_entry(entries):
    """The self-check: the same row as ``crash`` with one acknowledged
    record missing from the recovered cache fails, for that reason."""
    e = entries["selfcheck"]
    assert not e["ok"]
    assert e["lost_attestations"] == 1
    assert e["cache_matches_control"] is True and e["score_l1"] <= cm.SCORE_TOL
    assert e["error"] == "invariant violated (see fields)"


def test_the_matrix_raises_without_a_card(monkeypatch):
    """``--device`` unset means the card: no card, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm.main(["--smoke", "--skip-node-phase", "--skip-pod-phase"])


def test_smoke_scale_keeps_a_card_backend():
    args = cm.parse_args(PORT_ARGS)
    assert (args.peers, args.events, args.epochs, args.backend) == (120, 600, 3, "cuda-csr")
    assert args.node_backend == "cuda-csr"
    assert set(cm.STEP_SOURCES["cuda-csr"]) == {"gather_ds_cumsum", "compensated_scan",
                                                "rowsum_tail"}


@pytest.mark.slow
def test_full_smoke_matrix_on_the_cpu(tmp_path):
    """``python -m protocol_tpu_torch.tools.crash_matrix --smoke --device
    cpu --skip-pod-phase`` exits 0: 14 matrix rows and the node restart,
    every one ok, every point exercised."""
    out = tmp_path / "CHAOS_smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "protocol_tpu_torch.tools.crash_matrix", *PORT_ARGS,
         "--skip-pod-phase", "--jobs", "4", "--out", str(out)],
        cwd=REPO, env=cm.child_env(), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["ok"] and report["device"] == "cpu" and report["not_exercised"] == []
    assert len(report["entries_detail"]) == 15
    assert all(e["ok"] for e in report["entries_detail"])
    node = report["entries_detail"][-1]
    assert node["point"] == "node.restart" and node["healthz_walk"][-1] == "ok"
    assert "recovering" in node["healthz_walk"]

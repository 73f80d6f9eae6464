"""The port's epoch pipe (``protocol_tpu_torch/tools/epoch_pipe.py``)
against the reference's tool (``tools/epoch_pipe.py``) on the CPU, at
the same small scale (2,000 peers, 12,000 edges, 3 epochs): every
epoch's churned graph bit for bit, the same iteration counts, the same
delta-applies, nothing dropped or coalesced, both warm fixed points on
their cold ones; every converge held against the plain versions on the
same inputs (``--against-plain``), and that check tripping on a changed
iteration count or score; a forced rebuild failing the port's delta
check; and no card, no run."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import epoch_pipe as ref_pipe  # noqa: E402

from protocol_tpu_torch.tools import epoch_pipe  # noqa: E402

SCALE = ["--peers", "2000", "--edges", "12000", "--epochs", "3"]


def _recording(monkeypatch, manager_cls, graphs: list):
    """Record each converged epoch's graph (its columns as numpy) on the
    way into ``manager_cls.converge_prepared``."""
    original = manager_cls.converge_prepared

    def converge_prepared(self, prepared, **kw):
        g = prepared.graph
        graphs.append({"n": g.n, "src": np.asarray(g.src).copy(), "dst": np.asarray(g.dst).copy(),
                       "weight": np.asarray(g.weight).copy(),
                       "pre_trusted": np.asarray(g.pre_trusted).copy()})
        return original(self, prepared, **kw)

    monkeypatch.setattr(manager_cls, "converge_prepared", converge_prepared)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both tools' reports and the graphs each converged, epoch by epoch."""
    from protocol_tpu.node.manager import Manager as RefManager

    from protocol_tpu_torch.node.manager import Manager

    tmp = tmp_path_factory.mktemp("epoch_pipe")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        ref_graphs: list = []
        _recording(mp, RefManager, ref_graphs)
        rc = ref_pipe.main([*SCALE, "--out", str(tmp / "ref.json")])
        out["reference"] = (rc, json.loads((tmp / "ref.json").read_text()), ref_graphs)
    with pytest.MonkeyPatch.context() as mp:
        port_graphs: list = []
        _recording(mp, Manager, port_graphs)
        rc = epoch_pipe.main([*SCALE, "--device", "cpu", "--against-plain",
                              "--out", str(tmp / "port.json")])
        out["port"] = (rc, json.loads((tmp / "port.json").read_text()), port_graphs)
    return out


def test_both_tools_pass(runs):
    assert runs["reference"][0] == 0
    rc, report, _ = runs["port"]
    assert rc == 0, report["failed_checks"]
    assert report["ok"] and report["failed_checks"] == [] and report["device"] == "cpu"
    assert report["nvidia_smi"] is None


def test_every_epoch_converges_the_reference_graph_bit_for_bit(runs):
    ref, port = runs["reference"][2], runs["port"][2]
    assert len(ref) == len(port) == 3
    for e, (a, b) in enumerate(zip(ref, port)):
        assert a["n"] == b["n"], e
        for col in ("src", "dst", "weight", "pre_trusted"):
            assert a[col].dtype == b[col].dtype, (e, col)
            assert np.array_equal(a[col], b[col]), (e, col)


def test_iterations_and_plan_outcomes_equal_the_reference(runs):
    ref, port = runs["reference"][1], runs["port"][1]
    assert port["cold_iterations"] == ref["cold_iterations"]
    assert port["warm_iterations"] == ref["warm_iterations"]
    assert [e["iterations"] for e in port["per_epoch"]] == [
        e["iterations"] for e in ref["per_epoch"]]
    assert all(w < port["cold_iterations"] for w in port["warm_iterations"])
    assert port["plan_delta_applies"] == ref["plan_delta_applies"] >= 2
    assert [e["plan_outcome"] for e in port["per_epoch"]] == [["rebuild"], ["delta"], ["delta"]]
    assert [e["warm"] for e in port["per_epoch"]] == [e["warm"] for e in ref["per_epoch"]]
    assert [e["edges_churned"] for e in port["per_epoch"]] == [
        e["edges_churned"] for e in ref["per_epoch"]]


def test_nothing_dropped_and_both_fixed_points_hold(runs):
    ref, port = runs["reference"][1], runs["port"][1]
    for report in (ref, port):
        assert report["dropped_ticks"] == 0 and report["coalesced_ticks"] == 0
        assert report["warm_vs_cold_l1"] <= epoch_pipe.SCORE_TOL


def test_the_plain_versions_launch_no_kernel(runs):
    _, report, _ = runs["port"]
    assert all(k == 0 for k in report["launches"].values())
    for entry in report["per_epoch"]:
        assert entry["launch_findings"] == []
        assert set(entry["launches"]) >= {"gather_windowed", "prefix_bridge", "ds_cumsum_axis1",
                                          "block_total_scan", "rowsum_tail"}


def test_every_converge_equals_the_plain_versions_on_the_same_inputs(runs):
    """Each epoch's converge and the final graph's cold one, run again
    from the same graph, seed and plan: on the CPU the same bits."""
    _, report, _ = runs["port"]
    plain = report["against_plain"]
    assert plain["failed"] == []
    assert [c["converge"] for c in plain["converges"]] == [
        "epoch 0", "epoch 1", "epoch 2", "final graph, cold"]
    assert [c["iterations"] for c in plain["converges"]] == [
        report["cold_iterations"], *report["warm_iterations"], report["cold_iterations"]]
    assert all(c["l1"] == 0.0 for c in plain["converges"])


@pytest.mark.parametrize("change", ["iterations", "scores"])
def test_the_plain_check_trips_on_a_changed_converge(change):
    """One more iteration, or scores moved by 2e-6 in L1, against the
    plain versions' converge of the same inputs is a failed check."""
    from protocol_tpu_torch.models.graphs import scale_free
    from protocol_tpu_torch.trust.backend import get_backend

    graph = scale_free(300, 1500, seed=7)
    backend = get_backend(epoch_pipe.BACKEND, device="cpu")
    res = backend.converge(graph, **epoch_pipe.CONVERGE)
    scores, iterations = np.array(res.scores), int(res.iterations)
    assert epoch_pipe.against_plain(
        [("same", graph, None, backend.last_plan, scores, iterations)])["failed"] == []
    if change == "iterations":
        iterations += 1
    else:
        scores[0] += 2 * epoch_pipe.PLAIN_L1
    got = epoch_pipe.against_plain([("moved", graph, None, backend.last_plan, scores, iterations)])
    assert len(got["failed"]) == 1 and got["failed"][0].startswith("moved: ")


def test_launch_findings_hold_the_card_budget():
    """On the card an epoch must launch K1, K5-K8 once a step and
    nothing else; an extra launch or a missing one is a finding."""
    want = {"gather_windowed": 7, "prefix_bridge": 7, "ds_cumsum_axis1": 7,
            "block_total_scan": 7, "rowsum_tail": 7, "gather_ds_cumsum": 0}
    assert epoch_pipe.launch_findings("cuda", 7, want) == []
    assert epoch_pipe.launch_findings("cuda", 7, {**want, "gather_ds_cumsum": 1})
    assert epoch_pipe.launch_findings("cuda", 7, {**want, "rowsum_tail": 6})
    assert epoch_pipe.launch_findings("cpu", 7, dict.fromkeys(want, 0)) == []
    assert epoch_pipe.launch_findings("cpu", 7, want)


def test_a_forced_rebuild_fails_the_delta_check(monkeypatch, tmp_path):
    """With the delta/rebuild crossover at 0 every churned epoch
    rebuilds its plan, and the pipe exits 1 on its delta check alone."""
    monkeypatch.setattr(epoch_pipe, "PLAN_DELTA_MAX_CHURN", 0.0)
    out = tmp_path / "rebuild.json"
    rc = epoch_pipe.main([*SCALE, "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 1 and not report["ok"]
    assert report["plan_delta_applies"] == 0
    assert [e["plan_outcome"] for e in report["per_epoch"]] == [["rebuild"]] * 3
    assert report["failed_checks"] == ["expected >= 2 plan delta-applies, saw 0.0"]


def test_the_pipe_raises_without_a_card(monkeypatch, tmp_path):
    """``--device`` unset means the card: no card, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        epoch_pipe.main([*SCALE, "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
